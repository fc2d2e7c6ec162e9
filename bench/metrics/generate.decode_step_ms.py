"""generate.decode_step_ms: the mean device time of one decode replay (the
port's faasm_serve_decode_step_ms: CUDA events around each replay of the
traced batches), in ms."""
from bench.yardstick.histograms import mean_ms


def read(ctx):
    return mean_ms("faasm_serve_decode_step_ms")
