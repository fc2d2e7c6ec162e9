"""mfu.generate: the model FLOPs of the window's prefills and decode
steps (``yardstick/flops.py``) over the window's time at the bf16 peak,
in percent."""
from bench.yardstick.readers import mfu as read  # noqa: F401
