"""Per-architecture sharding rules: DP / TP (Megatron) / EP / SP / FSDP.

Counterpart of ``repro.distributed.sharding``, with its rule table
unchanged.  ``ShardingRules`` maps every parameter, optimizer-state, batch
and cache leaf to a spec on the production mesh:

  * **TP** over the ``model`` axis: QKV / MLP-up column-parallel, O / MLP-down
    row-parallel, vocab-parallel embeddings, experts expert-parallel.
  * **FSDP/ZeRO** over the ``data`` axis (over ``("pod", "data")`` above
    4e11 parameters): the *other* matrix dimension of each weight is
    sharded over data and all-gathered per layer; optimizer state inherits
    the same spec.
  * **DP** over ``("pod", "data")``: batch dims.
  * **SP for caches**: KV caches shard heads over ``model`` when the head
    count divides it, otherwise the cache *sequence* dim shards over
    ``model``; the 500k-token batch-1 cell shards sequence over every axis.
  * SSM archs: batch shards over ``(data, model)`` jointly where divisible.

Every assignment is divisibility-guarded: a dim that does not divide the
axis size stays unsharded.

A spec is a tuple with a ``PartitionSpec``'s content: one entry per
tensor dim, ``None`` (unsharded), an axis name, or a tuple of axis names
(the first the major one).  :func:`placements` turns a spec into the
DTensor placements of a ``DeviceMesh``, one per mesh dim.

The reference matches ``jax.tree_util.keystr`` paths of a tree whose
stacked layers carry a leading (L, ...) axis.  The port's parameters are
the dotted ``named_parameters()`` names of per-layer ``nn.ModuleList``
entries, so each name is rewritten to the reference's path
(:func:`reference_path`) and the rule is applied to the stacked shape:
a port leaf's spec is the reference's spec of the stacked leaf with the
layer axis's entry dropped.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import axis_names, axis_sizes

Spec = tuple


def _axis_entry(axes):
    """Collapse an axis collection into a canonical spec entry:
    ``[] -> None``, ``['model'] -> 'model'`` (scalar, not a 1-tuple),
    ``['pod', 'data'] -> ('pod', 'data')``."""
    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return axes[0]
    return axes


def _has_axis(entry, name: str) -> bool:
    """Membership test on a spec entry that may be None, a scalar or a tuple."""
    if entry is None:
        return False
    if isinstance(entry, str):
        return entry == name
    return name in entry


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


_LAYER_INDEX = re.compile(r"^(.*?\blayers)\.(\d+)(\..*)$")


def reference_path(name: str) -> Tuple[str, Optional[str]]:
    """(the reference's keystr path of a port parameter name, the stack it
    sits in or None): ``layers.3.attn.wq`` -> (``['layers']['attn']['wq']``,
    ``layers``); ``encoder.layers.0.mlp.w_up`` -> (``['encoder']['layers']
    ['mlp']['w_up']``, ``encoder.layers``); ``first_layers.0.attn.wq`` (a
    list of unstacked layers) -> (``['first_layers'][0]['attn']['wq']``,
    None)."""
    m = _LAYER_INDEX.match(name)
    stack = None
    if m and not m.group(1).endswith("first_layers"):
        stack = m.group(1)
        name = m.group(1) + m.group(3)
    parts = []
    for p in name.split("."):
        parts.append(f"[{p}]" if p.isdigit() else f"['{p}']")
    return "".join(parts), stack


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


@dataclasses.dataclass
class ShardingRules:
    mesh: Any
    cfg: ModelConfig
    fsdp: bool = True

    def __post_init__(self):
        names = axis_names(self.mesh)
        self.sizes = axis_sizes(self.mesh)
        self.model_ax = "model" if "model" in names else None
        self.data_axs = tuple(a for a in names if a != "model")
        self.model_size = self.sizes.get("model", 1)
        self.data_size = math.prod(self.sizes[a] for a in self.data_axs) \
            if self.data_axs else 1
        # trillion-scale params: extend FSDP across the pod axis too (ZeRO-3
        # over DCI) — weights must not be pod-replicated.
        fsdp_pod = (self.cfg.param_count() > 4e11 and "pod" in names)
        if not self.fsdp or "data" not in names:
            self.fsdp_ax = None
            self.fsdp_size = 1
        elif fsdp_pod:
            self.fsdp_ax = ("pod", "data")
            self.fsdp_size = self.sizes["pod"] * self.sizes["data"]
        else:
            self.fsdp_ax = "data"
            self.fsdp_size = self.sizes.get("data", 1)

    # -- helpers ------------------------------------------------------------------

    def _maybe(self, ax, size: int, dim: int):
        """Assign axis only if the dim divides its size."""
        if ax is None or dim % max(size, 1) != 0 or size == 1:
            return None
        return ax

    def _model(self, dim: int):
        return self._maybe(self.model_ax, self.model_size, dim)

    def _fsdp(self, dim: int):
        return self._maybe(self.fsdp_ax, self.fsdp_size, dim)

    def _batch_axes(self, b: int, wide: bool = False):
        """Axes for a batch dim; ``wide`` also folds in the model axis (SSM DP)."""
        axs = []
        rem = b
        for a in self.data_axs + ((("model",) if wide and self.model_ax else ())):
            sz = self.sizes[a]
            if rem % sz == 0:
                axs.append(a)
                rem //= sz
        return _axis_entry(axs)

    # -- parameter rules ----------------------------------------------------------

    def _param_rule(self, path: str, shape: tuple) -> Spec:
        """The reference's rule for the leaf at keystr ``path`` of (stacked)
        ``shape``."""
        nd = len(shape)
        name = path.split("'")[-2] if "'" in path else path

        def tail(*axes):
            """Spec for the trailing len(axes) dims; leading dims unsharded."""
            axes = list(axes)
            lead = nd - len(axes)
            if lead < 0:
                axes = axes[-nd:] if nd else []
                lead = 0
            return tuple([None] * lead + axes)

        ssm_weight = ".mamba" in path or "'mamba'" in path

        if name == "embed":
            return tail(self._model(shape[0]), self._fsdp(shape[1]))
        if name == "unembed":
            return tail(self._fsdp(shape[0]), self._model(shape[1]))

        if "moe" in path and name in ("w_gate", "w_up") and nd >= 3:
            return tail(self._model(shape[nd - 3]),       # experts
                        self._fsdp(shape[nd - 2]), None)
        if "moe" in path and name == "w_down" and nd >= 3:
            return tail(self._model(shape[nd - 3]), None,
                        self._fsdp(shape[nd - 1]))
        if name == "router":
            return tail(self._fsdp(shape[nd - 2]), None)

        if ssm_weight:
            # SSM weights: FSDP only (head counts rarely divide the model axis)
            if name == "w_in":
                return tail(self._fsdp(shape[nd - 2]), None)
            if name == "w_out":
                return tail(None, self._fsdp(shape[nd - 1]))
            if name == "conv_w":
                return tail(None, None)
            return tail(*([None] * min(nd, 1)))

        if name in ("wq", "wk", "wv"):
            return tail(self._fsdp(shape[nd - 2]), self._model(shape[nd - 1]))
        if name == "wo":
            return tail(self._model(shape[nd - 2]), self._fsdp(shape[nd - 1]))
        if name in ("bq", "bk", "bv", "b_up"):
            return tail(self._model(shape[nd - 1]))
        if name in ("w_gate", "w_up"):                         # dense / shared MLP
            return tail(self._fsdp(shape[nd - 2]), self._model(shape[nd - 1]))
        if name == "w_down":
            return tail(self._model(shape[nd - 2]), self._fsdp(shape[nd - 1]))

        # norms, small vectors, biases on d_model: replicated
        return tuple([None] * nd)

    def params_specs(self, params) -> Dict[str, Spec]:
        """{parameter name: spec} for a parameter module or a mapping of
        names to tensors or shapes.  A leaf of a stack of L layers is ruled
        as the reference's (L, ...) leaf and keeps the spec of its own
        dims."""
        named = dict(params.named_parameters() if hasattr(
            params, "named_parameters") else params.items())
        depth: Dict[str, int] = {}
        for name in named:
            m = _LAYER_INDEX.match(name)
            if m and not m.group(1).endswith("first_layers"):
                depth[m.group(1)] = max(depth.get(m.group(1), 0),
                                        int(m.group(2)) + 1)
        out = {}
        for name, leaf in named.items():
            path, stack = reference_path(name)
            shape = _shape(leaf)
            if stack is None:
                out[name] = self._param_rule(path, shape)
            else:
                out[name] = self._param_rule(path, (depth[stack],) + shape)[1:]
        return out

    # -- optimizer state: inherit the param spec where shapes match -----------------

    def opt_specs(self, opt_state, params) -> Any:
        """The optimizer state's specs, field by field: a module of the
        parameters' class (momentum, moments) gets {name: spec} by shape as
        the reference matches leaves, a tensor (the step) its replicated
        spec, ``()`` stays ``()``."""
        pspecs = self.params_specs(params)
        named = dict(params.named_parameters() if hasattr(
            params, "named_parameters") else params.items())
        by_shape: Dict[tuple, Spec] = {}
        for name, leaf in named.items():
            by_shape.setdefault(_shape(leaf), pspecs[name])

        def rule(leaf):
            return by_shape.get(_shape(leaf), tuple([None] * len(_shape(leaf))))

        def field(v):
            if hasattr(v, "named_parameters"):
                return {n: rule(p) for n, p in v.named_parameters()}
            if hasattr(v, "shape"):
                return rule(v)
            return v
        return type(opt_state)(*(field(v) for v in opt_state))

    # -- batch / activation rules ------------------------------------------------------

    def _wide_batch(self) -> bool:
        """SSM/hybrid archs do pure DP across every axis (incl. model)."""
        return self.cfg.family in ("ssm", "hybrid")

    def batch_specs(self, input_specs: Mapping[str, Any],
                    shape: ShapeConfig = None) -> Dict[str, Any]:
        wide = self._wide_batch()
        out = {}
        for k, v in input_specs.items():
            if k == "cache":
                out[k] = self.cache_specs(v)
            else:
                s = _shape(v)
                out[k] = tuple([self._batch_axes(s[0], wide=wide)]
                               + [None] * (len(s) - 1))
        return out

    def cache_specs(self, cache_shapes: Mapping[str, Any]) -> Dict[str, Spec]:
        """Cache leaves: (L, B, S, K, D) attn / (L, B, W, C) conv /
        (L, B, H, P, N) ssm.  Two leaves the reference's cache does not
        hold: the encoder/decoder's ``pos`` table stays replicated, its
        (B,) ``cross_len`` takes the batch's axes."""
        wide = self._wide_batch()
        out = {}
        for key, leaf in cache_shapes.items():
            shape = _shape(leaf)
            if key == "pos":
                out[key] = tuple([None] * len(shape))
                continue
            if key == "cross_len":
                out[key] = (self._batch_axes(shape[0], wide=wide),)
                continue
            out[key] = self._cache_rule(f"['{key}']", shape, wide)
        return out

    def _cache_rule(self, name: str, shape: tuple, wide: bool) -> Spec:
        nd = len(shape)
        batch_dim = 1                      # all caches are (L, B, ...)
        b_axes = self._batch_axes(shape[batch_dim], wide=wide)
        spec = [None] * nd
        spec[batch_dim] = b_axes
        if ("'k'" in name or "'v'" in name or "'ck'" in name
                or "'cv'" in name or "first_" in name) and nd == 5:
            L, B, S, K, D = shape
            model_used = _has_axis(b_axes, "model")
            if self._model(K) is not None and not model_used:
                spec[3] = self._model(K)
                model_used = True
            # sequence-parallel cache: any axis not already used shards S
            # (few KV heads -> model; batch-1 long-context -> data too).
            seq_axes = []
            rem = S
            if b_axes is None:
                for a in self.data_axs:
                    if rem % self.sizes[a] == 0:
                        seq_axes.append(a)
                        rem //= self.sizes[a]
            if (self.model_ax and not model_used
                    and rem % self.model_size == 0):
                seq_axes.append(self.model_ax)
            spec[2] = _axis_entry(seq_axes)
        elif "'ssm'" in name and nd == 5:
            L, B, H, Pd, N = shape
            if not _has_axis(b_axes, "model"):
                if self._model(N) is not None and \
                        not _has_axis(b_axes, self.model_ax or ""):
                    spec[4] = self._model(N)
        elif "'conv'" in name and nd == 4:
            L, B, W, C = shape
            if not _has_axis(b_axes, "model"):
                if self._model(C) is not None and \
                        not _has_axis(b_axes, self.model_ax or ""):
                    spec[3] = self._model(C)
        return tuple(spec)

    # -- logits / outputs --------------------------------------------------------------

    def logits_spec(self, batch: int) -> Spec:
        b_axes = self._batch_axes(batch, wide=self._wide_batch())
        return (b_axes, self._model(self.cfg.vocab_size))

    def scalar_spec(self) -> Spec:
        return ()

    # -- the layout a weight is used in ---------------------------------------------

    def compute_spec(self, spec: Spec) -> Spec:
        """``spec`` with the FSDP axes dropped: the layout a weight is used
        in once gathered, its tensor-parallel and expert shards kept."""
        fsdp = set(entry_axes(self.fsdp_ax))
        return tuple(_axis_entry([a for a in entry_axes(e) if a not in fsdp])
                     for e in spec)


def placements(spec: Spec, mesh, ndim: Optional[int] = None) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim ``d``'s entry names that axis, else
    ``Replicate()``.  An entry naming two axes (``("pod", "data")``)
    shards its dim over both, major first, as DTensor nests shards in
    mesh-dim order: the rank at (p, d) holds chunk p * |data| + d, the
    block ``NamedSharding`` gives that device.  ``ndim`` pads a spec
    shorter than the tensor with unsharded dims."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    spec = tuple(spec) + (None,) * max(0, (ndim or 0) - len(spec))
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec}: axis {a!r} shards two dims")
            where[a] = d
    return [Shard(where[a]) if a in where else Replicate() for a in names]


def gather_on_read(params, rules: ShardingRules, mesh):
    """Make every FSDP-sharded weight of ``params`` (a module of
    ``DTensor`` parameters placed by ``rules``) read as its gathered
    compute layout (:meth:`ShardingRules.compute_spec`): each module
    holding one gets a subclass of its class with a property per such
    weight that all-gathers it over the FSDP axes at every read.  A layer
    therefore gathers its weights when it runs (and again when remat
    recomputes it), as GSPMD does; the gradient reaches the sharded leaf
    reduce-scattered.  ``named_parameters()``, the optimizer and the
    checkpointer still see the sharded leaves.  Returns ``params``."""
    specs = rules.params_specs(params)
    by_module: Dict[str, Dict[str, list]] = {}
    for name, spec in specs.items():
        want = rules.compute_spec(spec)
        if want == spec:
            continue
        mod, _, leaf = name.rpartition(".")
        by_module.setdefault(mod, {})[leaf] = placements(want, mesh, len(spec))
    for mod, leaves in by_module.items():
        m = params.get_submodule(mod) if mod else params
        if getattr(type(m), "_reads_gathered", False):
            continue
        props = {leaf: property(_gathered(leaf, pl, mesh))
                 for leaf, pl in leaves.items()}
        props["_reads_gathered"] = True
        m.__class__ = type(type(m).__name__, (type(m),), props)
    return params


def _gathered(leaf: str, pl, mesh):
    def read(self):
        return self._parameters[leaf].redistribute(mesh, pl)
    return read
