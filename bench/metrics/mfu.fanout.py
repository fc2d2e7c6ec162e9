"""mfu.fanout: the forward FLOPs of the window's served requests (logits
at every prompt position, as the ``infer`` call computes them;
``yardstick/flops.py::forward``) over the window's time at the bf16
peak, in percent."""
from bench.yardstick.readers import mfu as read  # noqa: F401
