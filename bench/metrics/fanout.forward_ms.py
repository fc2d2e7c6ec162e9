"""fanout.forward_ms: the mean over the window's calls of the per-call
replay of the slot's captured forward and its argmax (the port's
faasm_serve_call_forward_ms: CUDA events on the slot's stream), in ms."""


def read(ctx):
    return ctx.extra.get("forward_ms")
