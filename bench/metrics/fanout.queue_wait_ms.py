"""fanout.queue_wait_ms: the mean over the window's calls of each request's
latency less the call body (the port's faasm_serve_infer_ms): its wait
in the runtime, in ms."""


def read(ctx):
    return ctx.extra.get("queue_wait_ms")
