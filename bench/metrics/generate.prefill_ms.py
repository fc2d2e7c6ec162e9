"""generate.prefill_ms: the mean device time of a batch's prefill replay
(the port's faasm_serve_prefill_ms: CUDA events around the replay, taken
at every batch of the run), in ms."""
from bench.yardstick.histograms import mean_ms


def read(ctx):
    return mean_ms("faasm_serve_prefill_ms")
