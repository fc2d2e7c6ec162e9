"""What the readers of the program's device spans share: the histograms of
the port's process registry (``repro_torch.telemetry``), read after the
run.  A scrape first reads every span whose events have completed, the
last traced step's among them.  A program that observed nothing under a
name (one without the span) gives None."""

DROPPED = "faasm_telemetry_device_spans_dropped_total"
STEP = ("faasm_train_forward_ms", "faasm_train_backward_ms",
        "faasm_train_update_ms")


def histogram(name: str):
    from repro_torch.telemetry import metrics
    reg = metrics.registry()
    reg.collect()
    h = reg.get(name)
    if h is None or not getattr(h, "count", 0):
        return None
    return h


def mean_ms(name: str):
    """The mean of the histogram ``name``."""
    h = histogram(name)
    return None if h is None else h.sum / h.count


def _count(name: str) -> int:
    h = histogram(name)
    return 0 if h is None else h.count


def whole_steps():
    """The training steps whose spans were all read: the count of
    ``faasm_train_update_ms`` (one update a step), where no span was dropped
    and the forward and backward were each read the same whole number of
    times a step (once a microbatch); else None (a step read in part)."""
    from repro_torch.telemetry import metrics
    dropped = metrics.registry().get(DROPPED)
    forward, backward, steps = (_count(n) for n in STEP)
    if (dropped is not None and dropped.value) or not steps:
        return None
    if forward != backward or forward % steps:
        return None
    return steps


def per_step_ms(name: str):
    """The sum of the histogram ``name`` over the run's whole training
    steps, per step; None where a step was read in part
    (:func:`whole_steps`) or ``name`` was not read the same number of times
    in each step.  Every armed step is in the sum, an eager one too."""
    h, steps = histogram(name), whole_steps()
    if h is None or steps is None or h.count % steps:
        return None
    return h.sum / steps
