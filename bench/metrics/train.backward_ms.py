"""train.backward_ms: autograd's backward's device time a training step,
the remat recompute and the plain flash backward included (the port's
faasm_train_backward_ms: CUDA events captured in the step), in ms."""
from bench.yardstick.histograms import per_step_ms


def read(ctx):
    return per_step_ms("faasm_train_backward_ms")
