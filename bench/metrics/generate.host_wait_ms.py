"""generate.host_wait_ms: the mean device time a traced batch spends between
its first and last events with none of its replays running, i.e. the card
waiting on the program's host (the port's faasm_serve_host_wait_ms), in
ms."""
from bench.yardstick.histograms import mean_ms


def read(ctx):
    return mean_ms("faasm_serve_host_wait_ms")
