"""train.forward_ms: the forward's device time a training step, summed
over the step's microbatches (the port's faasm_train_forward_ms: CUDA events
captured in the step around each microbatch's loss), in ms."""
from bench.yardstick.histograms import per_step_ms


def read(ctx):
    return per_step_ms("faasm_train_forward_ms")
