"""The port's ShardingRules against the reference's.

Twins of ``tests/test_sharding_rules.py`` (same architectures, same
stand-in mesh that carries names and sizes only), then, for every
architecture of the registry at full width on both production meshes,
every parameter's spec against the reference's (a port leaf's spec is
the reference's spec of the stacked (L, ...) leaf without the layer
axis's entry); ``Model.init_shapes``, ``cache_specs`` and ``input_specs``
against the reference's shapes and dtypes; and, on small meshes, each
rank's shard under ``placements`` against the shard JAX's
``NamedSharding`` gives the device at the same mesh position.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.configs import shape_applicable as jshape_applicable
from repro.distributed.sharding import ShardingRules as JRules
from repro.models import ExecConfig as JExec
from repro.models import build_model as jbuild
from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.configs.base import SHAPES
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models import build_model
from repro_torch.models.weights import _stacked_at

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH_LIST = ["qwen1.5-0.5b", "starcoder2-7b", "kimi-k2-1t-a32b",
             "mamba2-130m", "zamba2-1.2b", "whisper-tiny", "internvl2-2b"]
MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Axis-name/shape stand-in (rules only read names + sizes)."""

    def __init__(self, shape_map):
        self.axis_names = tuple(shape_map)
        self.shape = dict(shape_map)
        self.size = int(np.prod(list(shape_map.values())))


def _rules(cfg, shape_map=None):
    return ShardingRules(FakeMesh(shape_map or {"data": 16, "model": 16}),
                         cfg)


def _specs(arch, shape_map=None):
    cfg = get_config(arch)
    return _rules(cfg, shape_map).params_specs(build_model(cfg).init_shapes())


# -- twins of tests/test_sharding_rules.py ------------------------------------

@pytest.mark.parametrize("arch", ARCH_LIST)
def test_param_specs_cover_every_leaf(arch):
    cfg = get_config(arch)
    shapes = dict(build_model(cfg).init_shapes().named_parameters())
    rules = _rules(cfg)
    specs = rules.params_specs(shapes)
    assert specs.keys() == shapes.keys()
    for name, leaf in shapes.items():
        spec = specs[name]
        assert isinstance(spec, tuple), (name, spec)
        assert len(spec) <= leaf.ndim, (name, spec, leaf.shape)
        # every sharded dim must divide the axis product
        for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            total = int(np.prod([rules.mesh.shape[a] for a in axes]))
            assert dim % total == 0, (name, spec, leaf.shape)


def test_tp_rules_megatron_pattern():
    specs = _specs("granite-3-8b")
    assert specs["layers.0.attn.wq"] == ("data", "model")     # column parallel
    assert specs["layers.0.attn.wo"] == ("model", "data")     # row parallel
    assert specs["layers.0.mlp.w_gate"] == ("data", "model")
    assert specs["layers.0.mlp.w_down"] == ("model", "data")
    # granite vocab (49155) doesn't divide 16 -> guard degrades to fsdp-only
    assert specs["embed"] == (None, "data")
    assert _specs("qwen3-4b")["embed"] == ("model", "data")   # vocab parallel


def test_moe_expert_parallel_rules():
    specs = _specs("kimi-k2-1t-a32b")
    assert specs["layers.0.moe.w_gate"] == ("model", "data", None)
    assert specs["layers.0.moe.w_down"] == ("model", None, "data")


def test_divisibility_guard_degrades_not_fails():
    # mamba2-130m: 24 SSD heads don't divide model=16 -> A_log replicated
    specs = _specs("mamba2-130m")
    assert specs["layers.0.mamba.A_log"] == (None,)
    assert specs["layers.0.mamba.w_in"] == ("data", None)


def test_cache_specs_head_vs_sequence_sharding():
    # granite kv=8 < model=16 -> cache shards sequence on model
    shape = get_shape("decode_32k")
    cfg = get_config("granite-3-8b")
    cache = build_model(cfg).cache_specs(shape.global_batch, shape.seq_len)
    specs = _rules(cfg).cache_specs(cache)
    assert specs["k"][3] is None or specs["k"][3] != "model"
    assert specs["k"][2] == "model"                # sequence-parallel cache
    # qwen1.5 kv=16 == model -> heads shard
    cfg2 = get_config("qwen1.5-0.5b")
    cache2 = build_model(cfg2).cache_specs(shape.global_batch, shape.seq_len)
    assert _rules(cfg2).cache_specs(cache2)["k"][3] == "model"


def test_long_context_batch1_shards_sequence_everywhere():
    cfg = get_config("zamba2-1.2b")
    shape = get_shape("long_500k")
    cache = build_model(cfg).cache_specs(1, shape.seq_len)
    k_spec = _rules(cfg).cache_specs(cache)["k"]
    assert k_spec[1] is None                       # batch 1: unsharded
    # zamba kv=32 divides model -> heads shard; 524288 seq shards over data
    assert k_spec[3] == "model"
    assert k_spec[2] in ("data", ("data",))


def test_opt_state_inherits_param_specs():
    from repro_torch.optim import SGD
    cfg = get_config("qwen3-4b")
    shapes = build_model(cfg).init_shapes()
    rules = _rules(cfg)
    opt = SGD(lr=0.1, momentum=0.9)
    ospecs = rules.opt_specs(opt.init(shapes), shapes)
    pspecs = rules.params_specs(shapes)
    assert ospecs.momentum["layers.0.attn.wq"] == pspecs["layers.0.attn.wq"]
    assert ospecs.step == ()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_logits_scalar_and_axes_equal_the_reference(mesh):
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh
    fake = FakeMesh(MESHES[mesh])
    for arch in ("qwen1.5-0.5b", "granite-3-8b", "mamba2-130m"):
        rules = ShardingRules(fake, get_config(arch))
        jrules = JRules(fake, jget_config(arch))
        for batch in (1, 4, 128, 256):
            assert rules.logits_spec(batch) == tuple(jrules.logits_spec(batch))
        assert rules.scalar_spec() == tuple(jrules.scalar_spec())
    assert tmesh.data_axes(fake) == jmesh.data_axes(fake)
    for name in ("pod", "data", "model", "pipe"):
        assert tmesh.axis_size(fake, name) == jmesh.axis_size(fake, name)


# -- every leaf against the reference -----------------------------------------

def _ref_leaf(tree, name):
    """The reference tree's entry for a port parameter name and whether it
    is a stacked (L, ...) leaf."""
    parts = name.split(".")
    j = _stacked_at(parts)
    node = tree
    for p in (parts if j < 0 else parts[:j] + parts[j + 1:]):
        node = node[int(p)] if isinstance(node, (list, tuple)) else node[p]
    return node, j >= 0


@pytest.fixture(scope="module")
def ref_shapes():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = jbuild(jget_config(arch),
                                 JExec(backend="xla")).init_shapes()
        return cache[arch]
    return get


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_equal_the_reference(arch, mesh, ref_shapes):
    jshapes = ref_shapes(arch)
    jspecs = JRules(FakeMesh(MESHES[mesh]), jget_config(arch)).params_specs(
        jshapes)
    specs = _specs(arch, MESHES[mesh])
    for name, spec in specs.items():
        jspec, stacked = _ref_leaf(jspecs, name)
        want = tuple(jspec)[1:] if stacked else tuple(jspec)
        assert spec == want, (arch, mesh, name, spec, tuple(jspec))


def _meta_like(x, y):
    assert tuple(x.shape) == tuple(y.shape), (x.shape, y.shape)
    assert str(x.dtype).replace("torch.", "") == str(y.dtype), (x.dtype,
                                                                y.dtype)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_specs_equal_the_reference(arch, ref_shapes):
    cfg, jcfg = get_config(arch), jget_config(arch)
    model, jmodel = build_model(cfg), jbuild(jcfg, JExec(backend="xla"))
    jshapes = ref_shapes(arch)
    for name, p in model.init_shapes().named_parameters():
        leaf, stacked = _ref_leaf(jshapes, name)
        want = jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype) if stacked \
            else leaf
        _meta_like(p, want)
    for sid in SHAPES:
        shape, jshape = get_shape(sid), jget_shape(sid)
        if not jshape_applicable(jcfg, jshape)[0]:
            continue
        got, want = model.input_specs(shape), jmodel.input_specs(jshape)
        assert got.keys() == want.keys(), (arch, sid)
        for k in want:
            if k != "cache":
                _meta_like(got[k], want[k])
                continue
            extra = set(got[k]) - set(want[k])     # the port's own leaves
            assert extra == ({"pos", "cross_len"} if cfg.family == "encdec"
                             else set()), (arch, sid, extra)
            for c in want[k]:
                _meta_like(got[k][c], want[k][c])


# -- each rank's shard against JAX's ------------------------------------------

SHARD_SCRIPT = textwrap.dedent("""\
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    import numpy as np
    import torch
    import torch.distributed as dist
    from jax.sharding import NamedSharding, PartitionSpec as P
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.tensor import distribute_tensor
    from repro.launch.mesh import make_mesh as jmesh
    from repro_torch.distributed.sharding import placements
    from repro_torch.launch.mesh import make_mesh

    CASES = [
        ((2, 4), ("data", "model"), [("data", "model"), ("model", "data"),
                                     ("data", None), (None, "model")]),
        ((2, 2, 2), ("pod", "data", "model"),
         [(("pod", "data"), "model"), (("pod", "data", "model"), None),
          ("model", ("pod", "data")), (("data", "model"), "pod")]),
    ]
    x = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    bad = []
    for shape, axes, specs in CASES:
        jm = jmesh(shape, axes)
        for spec in specs:
            arr = jax.device_put(x, NamedSharding(jm, P(*spec)))
            by_dev = {s.device: np.asarray(s.data) for s in
                      arr.addressable_shards}
            for rank in range(8):
                dist.init_process_group("fake", rank=rank, world_size=8,
                                        store=FakeStore())
                mesh = make_mesh(shape, axes, device_type="cpu")
                coord = tuple(mesh.get_coordinate())
                got = distribute_tensor(torch.from_numpy(x), mesh,
                                        placements(spec, mesh, 2),
                                        src_data_rank=None).to_local()
                dist.destroy_process_group()
                want = by_dev[jm.devices[coord]]
                if not np.array_equal(got.numpy(), want):
                    bad.append([list(shape), str(spec), rank])
    print(json.dumps({"bad": bad}))
""")


def test_local_shards_equal_the_jax_shards():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", SHARD_SCRIPT],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["bad"] == []
