"""train.update_ms: the gradient norm's and the SGD update's device time a
training step (the port's faasm_train_update_ms: CUDA events captured in
the step), in ms."""
from bench.yardstick.histograms import per_step_ms


def read(ctx):
    return per_step_ms("faasm_train_update_ms")
