"""What one device does in a traced step: FLOPs, bytes, collectives, memory.

Counterpart of ``repro.distributed.hlo_analysis``, which parses the XLA
HLO text of the compiled SPMD program; torch has no such text.  The port
runs the step itself under ``FakeTensorMode`` (shapes, no data) inside a
:class:`CostCounter`, a dispatch mode that sees every ATen op a device
runs and counts, for that device:

  * FLOPs: 2 · |out| · Π(contracting) of each mm / addmm / bmm / baddbmm
    (an einsum reaches ATen as these) and of each convolution (forward and
    backward), by ``torch.utils.flop_counter``'s formulas, as
    ``_dot_flops`` counts a ``dot``;
  * bytes: each op's operands plus its result, the eager counterpart of a
    fusion node's operands and result (views, ``empty`` and metadata ops
    move nothing and count nothing);
  * collective bytes and counts by kind (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``), from the functional collectives
    that ``DTensor`` issues, the bytes those of the operands;
  * a hand-written kernel on the fake route (``kernels/common.py::
    dispatch``) adds its package's ``ops.cost`` formula, and its calls are
    counted by kernel (:attr:`Costs.kernels`);
  * peak live memory: the bytes of the storages the step makes, alive at
    once (``weakref`` on each storage), above what was live when the
    counter opened.

**Per device, not global.**  A ``DTensor`` op is not counted where it
stands: the mode defers it (``NotImplemented``) so that ``DTensor``
dispatches it to local ops on each rank's shards, and those are what it
counts.  A dispatch mode sees a ``DTensor`` op before it is split (that
is what ``FlopCounterMode`` counts: the global figure), so a counter of
the op itself would report every device doing the whole mesh's work.
``DTensor``'s sharding propagation also runs each new op once at global
shapes to learn its output's metadata
(``ShardingPropagator._propagate_tensor_meta_non_cached``); while it is
open the counter wraps that method with a flag, and those runs are not
counted.

The reference's XLA-only fields (``bf16_convert_*``, ``transcendentals``)
have no counterpart.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import common

COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_aten = torch.ops.aten
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten.lift_fresh.default,
             _aten.sym_size.int, _aten.sym_stride.int, _aten.sym_numel.default,
             _aten.sym_storage_offset.default, _aten._local_scalar_dense.default}


@dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    collective: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    warnings: List[str] = field(default_factory=list)
    kernels: Dict[str, int] = field(default_factory=dict)
    peak_bytes: float = 0.0        # live storages made by the step, at most

    @property
    def collective_bytes(self) -> float:
        return sum(self.collective.values())


def _flop_fn(func):
    from torch.utils.flop_counter import flop_registry
    return flop_registry.get(func._overloadpacket)


def _tensor_bytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


class _Propagating:
    """A thread-local flag that ``DTensor``'s metadata run at global shapes
    is under way: :meth:`wrap` returns ``fn`` setting it for each call."""

    def __init__(self):
        self.local = threading.local()

    def wrap(self, fn):
        def flagged(*args, **kwargs):
            self.local.depth = getattr(self.local, "depth", 0) + 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.local.depth -= 1
        return flagged

    @property
    def active(self) -> bool:
        return getattr(self.local, "depth", 0) > 0


_META_RUN = "_propagate_tensor_meta_non_cached"   # ShardingPropagator's


class CostCounter(TorchDispatchMode):
    """``with CostCounter() as c: step(...)`` counts one device's share of
    what ``step`` runs into ``c.costs`` (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self._live = 0
        self._seen: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._prop = _Propagating()
        self._saved = None

    # -- entering and leaving ---------------------------------------------------

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self._saved = ShardingPropagator.__dict__.get(_META_RUN)
        if self._saved is None:      # a torch whose DTensor names it apart
            self.costs.warnings.append(
                f"ShardingPropagator.{_META_RUN} not found: DTensor's "
                f"metadata runs at global shapes may be counted")
        else:
            setattr(ShardingPropagator, _META_RUN,
                    self._prop.wrap(self._saved))
        common.open_cost_sink(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        out = super().__exit__(*exc)
        common.close_cost_sink(self)
        if self._saved is not None:
            setattr(ShardingPropagator, _META_RUN, self._saved)
        return out

    # -- what a hand-written kernel's fake route reports --------------------------

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        c = self.costs
        c.flops += flops
        c.bytes += nbytes
        c.kernels[name] = c.kernels.get(name, 0) + 1

    # -- every ATen op ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # count the local ops it runs
        out = func(*args, **kwargs)
        if self._prop.active:
            return out
        ins = [x for x in tree_flatten((args, kwargs))[0]
               if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
        self._count(func, ins, outs, args, kwargs, out)
        self._track(outs)
        return out

    def _count(self, func, ins, outs, args, kwargs, out) -> None:
        c = self.costs
        ns = func.namespace
        if ns == "_c10d_functional" or ns == "_c10d_functional_autograd":
            kind = COLLECTIVES.get(func._overloadpacket.__name__)
            if kind is not None:
                c.collective[kind] = c.collective.get(kind, 0.0) + \
                    _tensor_bytes(ins)
                c.collective_counts[kind] = \
                    c.collective_counts.get(kind, 0.0) + 1
                c.bytes += _tensor_bytes(ins) + _tensor_bytes(outs)
            return
        if ns == "prim" or func in _NO_BYTES or func.is_view:
            return
        fn = _flop_fn(func)
        if fn is not None:
            c.flops += fn(*args, **kwargs, out_val=out)
        c.bytes += _tensor_bytes(ins) + _tensor_bytes(outs)

    def _track(self, outs) -> None:
        for t in outs:
            try:
                st = t.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue
            key = st._cdata
            with self._lock:
                if key in self._seen:
                    continue
                n = st.nbytes()
                self._seen[key] = n
                self._live += n
                self.costs.peak_bytes = max(self.costs.peak_bytes, self._live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            self._live -= self._seen.pop(key, 0)


def local_bytes(tensors) -> int:
    """Bytes one rank holds of ``tensors`` (a ``DTensor``'s local shard)."""
    total = 0
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        d = common.as_dtensor(t)
        t = d.to_local() if d is not None else t
        total += t.numel() * t.element_size()
    return total
