"""fanout.param_copy_ms: the mean over the window's calls of the per-call
copy of the model's leaves from pinned host memory into an executor's
slot (the port's faasm_serve_param_h2d_ms: CUDA events on the slot's
stream), in ms."""


def read(ctx):
    return ctx.extra.get("param_copy_ms")
