"""train.flash_bwd_ms: the plain flash backward's device time a training
step, summed over its calls, one a layer and microbatch (the port's
faasm_train_flash_bwd_ms: CUDA events captured in the step), in ms."""
from bench.yardstick.histograms import per_step_ms


def read(ctx):
    return per_step_ms("faasm_train_flash_bwd_ms")
