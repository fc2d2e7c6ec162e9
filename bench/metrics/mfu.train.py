"""mfu.train: the model FLOPs of the window's training steps (no remat
recompute; ``yardstick/flops.py::train_step``) over the window's time at
the bf16 peak, in percent."""
from bench.yardstick.readers import mfu as read  # noqa: F401
