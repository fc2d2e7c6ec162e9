"""fanout.stats_ms: the mean over the window's calls of the per-call
serve/stats pull, add and int8 push (the port's
faasm_serve_call_stats_ms: host clock, lock waits included), in ms."""


def read(ctx):
    return ctx.extra.get("stats_ms")
