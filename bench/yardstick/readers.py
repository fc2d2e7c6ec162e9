"""What several per-layer readers share (``bench/metrics/``): the model
FLOPs of the window's work over its time at the bf16 peak, and the
device's idle share of a traced window."""
from bench.yardstick.costs import BF16_FLOP_PER_S


def mfu(ctx):
    """Percent of the bf16 peak the window's model FLOPs took."""
    if not ctx.flops or not ctx.window_s:
        return None
    return 100.0 * ctx.flops / (ctx.window_s * BF16_FLOP_PER_S)


def idle(ctx):
    """Percent of the traced window in which no kernel, copy or set ran on
    the card (``yardstick/trace.py``)."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
