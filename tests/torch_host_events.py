"""The timing events of the port's stand-in captures on the CPU (the
tests' ``CudaCapture`` stand-ins hand them out from ``event``): a CUDA
timing event's ``record``, ``query``, ``elapsed_time`` and
``synchronize`` on the host clock."""
import time


class HostStamp:
    """A timing event on the host clock; the host has always run it."""

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3

    def synchronize(self):
        pass
