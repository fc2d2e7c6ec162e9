"""roofline.k6.decode: K6's frozen bound summed over the decode steps of
the traced batches (step j of a batch attends to prompt + 1 + j
positions in every attention call), over K6's time in the trace, in
percent."""
from bench.yardstick import costs
from bench.yardstick.flops import attn_apps

KERNELS = ("decode_kernel",)


def read(ctx):
    n, sec = ctx.trace.count(KERNELS), ctx.trace.seconds(KERNELS)
    if not n or sec <= 0:
        return None
    m, t = ctx.model, ctx.traffic
    calls_per_step = attn_apps(m)
    steps = t["new_tokens"] - 1
    batches = n / (calls_per_step * steps)
    if batches != int(batches):
        return None
    per_batch = calls_per_step * sum(
        costs.bound_s(*costs.k6(t["batch"], m["n_heads"], m["n_kv_heads"],
                                m["head_dim"], 2, t["prompt"] + 1 + j))
        for j in range(steps))
    return 100.0 * batches * per_batch / sec
