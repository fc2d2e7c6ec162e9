"""The Faaslet SFI invariants of ``tests/test_faaslet.py`` through the
port: bounds checking, shared regions, resource budgets, the snapshot
round trip and the hypothesis SFI property with its settings, run
through ``repro_torch.core.faaslet``.  Each twin asserts what its
reference test asserts, under the same names.  The port's sanitizer
(``sanitize``-marked tests, ``FAASM_SANITIZE=1``), fault, telemetry and
cost-model planes are handled by the fixtures of
``tests/torch_twin_planes.py``.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro_torch.core.faaslet import (Faaslet, FaasletMemoryFault,
                                      ResourceLimitExceeded, WASM_PAGE)
from torch_twin_planes import port_planes_disarmed, port_sanitize  # noqa: F401



def test_private_memory_bounds():
    f = Faaslet("fn", "h0", memory_limit=4 * WASM_PAGE)
    f.brk(100)
    f.write(0, b"abc")
    assert bytes(f.read(0, 3)) == b"abc"
    with pytest.raises(FaasletMemoryFault):
        f.read(98, 3)                               # crosses brk
    with pytest.raises(FaasletMemoryFault):
        f.read(-1, 1)
    with pytest.raises(FaasletMemoryFault):
        f.write(100, b"x")                          # at brk


def test_brk_respects_memory_limit():
    f = Faaslet("fn", "h0", memory_limit=2 * WASM_PAGE)
    f.brk(2 * WASM_PAGE)
    with pytest.raises(FaasletMemoryFault):
        f.brk(2 * WASM_PAGE + 1)
    old = f.sbrk(0)
    assert old == 2 * WASM_PAGE


def test_shared_region_zero_copy():
    """Two Faaslets mapping the same backing see each other's writes."""
    backing = np.zeros(256, np.uint8)
    a = Faaslet("fa", "h0")
    b = Faaslet("fb", "h0")
    ra = a.map_shared_region("k", backing)
    rb = b.map_shared_region("k", backing)
    a.write(ra.base + 10, b"\x42")
    assert b.read(rb.base + 10, 1)[0] == 0x42       # same memory
    assert backing[10] == 0x42


def test_shared_region_bounds_and_readonly():
    backing = np.zeros(100, np.uint8)
    f = Faaslet("fn", "h0")
    r = f.map_shared_region("k", backing, writable=False)
    with pytest.raises(FaasletMemoryFault):
        f.read(r.base + 98, 4)                      # crosses region end
    with pytest.raises(FaasletMemoryFault):
        f.write(r.base, b"x")                       # read-only region


def test_unmapped_gap_between_regions_traps():
    f = Faaslet("fn", "h0", memory_limit=WASM_PAGE)
    backing = np.zeros(10, np.uint8)
    r = f.map_shared_region("k", backing)
    with pytest.raises(FaasletMemoryFault):
        f.read(r.base - 1, 1)                       # below the region
    with pytest.raises(FaasletMemoryFault):
        f.read(f.brk_value + 1, 1)                  # above brk, below region


def test_resource_budgets():
    f = Faaslet("fn", "h0", net_budget=100)
    f.usage.charge_net(n_out=90)
    with pytest.raises(ResourceLimitExceeded):
        f.usage.charge_net(n_in=20)
    g = Faaslet("fn", "h0", cpu_budget_ns=1000)
    with pytest.raises(ResourceLimitExceeded):
        g.usage.charge_cpu(2000)


def test_snapshot_restore_roundtrip():
    f = Faaslet("fn", "h0")
    f.brk(64)
    f.write(0, b"initialised state!")
    snap = f.snapshot_arena()
    g = Faaslet("fn", "h1")
    g.restore_arena(snap, 64)
    assert bytes(g.read(0, 18)) == b"initialised state!"
    assert g.brk_value == 64


@settings(max_examples=30, deadline=None)
@given(brk=st.integers(0, 2 * WASM_PAGE),
       addr=st.integers(-10, 3 * WASM_PAGE),
       length=st.integers(0, WASM_PAGE))
def test_property_sfi_no_escape(brk, addr, length):
    """Every in-bounds access succeeds; every out-of-bounds access traps."""
    f = Faaslet("fn", "h0", memory_limit=2 * WASM_PAGE)
    f.brk(brk)
    in_bounds = 0 <= addr and addr + length <= brk
    if in_bounds:
        assert len(f.read(addr, length)) == length
    else:
        with pytest.raises(FaasletMemoryFault):
            f.read(addr, length)
