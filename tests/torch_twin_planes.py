"""Fixtures shared by the port's tests of its runtime and state planes
(the twins ``tests/test_torch_{chaos,cow_state,faaslet,state,
runtime_cases,telemetry,sanitizer,codec_tiers,wire_fabric}.py`` and
``tests/test_torch_{runtime,paper,coldstart}.py``); a test file imports
the ones it needs into its namespace.

The port's sanitizer is its own (``repro_torch.analysis.sanitizer``):
``tests/conftest.py`` drives the reference's, so ``port_sanitize`` turns
the port's on for ``sanitize``-marked tests (and under
``FAASM_SANITIZE=1``) before the test builds its tiers (locks are
instrumented at construction), and fails a test on any report it did
not take.  ``port_planes_disarmed`` disarms the port's fault, telemetry
and cost-model planes after every test, as conftest does the
reference's.
"""
import os

import pytest

_SANITIZE_ENV = os.environ.get("FAASM_SANITIZE") == "1"


@pytest.fixture(autouse=True)
def port_sanitize(request):
    from repro_torch.analysis import sanitizer
    marked = request.node.get_closest_marker("sanitize") is not None
    if not (_SANITIZE_ENV or marked):
        yield
        return
    sanitizer.enable()
    sanitizer.reset()
    try:
        yield
        leftovers = sanitizer.take_reports()
    finally:
        sanitizer.disable()
    if leftovers:
        pytest.fail("repro_torch sanitizer reports:\n\n"
                    + "\n\n".join(str(r) for r in leftovers), pytrace=False)


@pytest.fixture(autouse=True)
def port_planes_disarmed():
    yield
    from repro_torch import faults, telemetry
    from repro_torch.state import wire
    faults.disarm()
    telemetry.disable()
    wire.disable_cost_model()
