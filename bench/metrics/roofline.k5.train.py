"""roofline.k5.train: K5's frozen bound at the training forward's shape
(B, S, S, causal, bf16, with the log-sum-exp), times the K5 calls in the
trace, over K5's time in the trace, in percent."""
from bench.yardstick import costs

KERNELS = ("flash_tc_kernel", "flash_fwd_kernel")


def read(ctx):
    n, sec = ctx.trace.count(KERNELS), ctx.trace.seconds(KERNELS)
    if not n or sec <= 0:
        return None
    m, t = ctx.model, ctx.traffic
    call = costs.bound_s(*costs.k5(t["batch"], t["seq"], t["seq"],
                                   m["n_heads"], m["n_kv_heads"],
                                   m["head_dim"], True, 2, stats=True))
    return 100.0 * n * call / sec
