"""The port's dry-run and its counter against the reference's.

  * twins of ``tests/test_dryrun_mini.py``: the four single-mesh cells on
    a (2, 4) mesh and the multi-pod cell on (2, 2, 2), each traced in a
    process of its own over its own fake process group;
  * the counter (``distributed/cost_analysis.py``): a matmul counts 2 M N
    K over the devices its placements split it across, a Python loop of 5
    five times, collectives by kind and count, and a fake-tensor call of
    each kernel wrapper returns the kernel's shapes and dtypes, reports
    its ``ops.cost`` and launches nothing;
  * ``model_flops`` equal to the reference's for every arch x shape;
  * FLOP parity: on the plain route (the reference's ``backend="xla"``)
    the FLOPs of qwen1.5-0.5b ``train`` and zamba2-1.2b ``prefill`` at
    the mini shape are within 5% of the reference's ``hlo_analysis``
    count of the same program on one device, and per device on the (2,
    4) mesh held against the reference's count there (see the test's
    docstring);
  * each kernel's ``ops.cost`` equal to the formula ``chip_smoke.py`` held
    inline before, at the shapes of ``PERF.md``'s kernel table.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.distributed.cost_analysis import CostCounter
from repro_torch.launch.dryrun import fake_mesh, fake_world, model_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

# one mini cell, the twin of tests/test_dryrun_mini.py's SCRIPT: smoke
# config, loss chunks of 16, ShapeConfig("mini_<kind>", kind, 32, 4), SGD
CELL = textwrap.dedent("""\
    import json, math, sys
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.dryrun import count_step, fake_mesh, fake_world
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.optim import SGD

    arch, kind, mesh_kind, backend = sys.argv[1:5]
    shape_, axes = {"single": ((2, 4), ("data", "model")),
                    "multi": ((2, 2, 2), ("pod", "data", "model")),
                    "one": ((1, 1), ("data", "model"))}[mesh_kind]
    cfg = smoke_config(arch)
    model = build_model(cfg, ExecConfig(backend=backend, loss_chunk=16))
    shape = ShapeConfig("mini_" + kind, kind, 32, 4)
    with fake_world(math.prod(shape_)):
        rules = ShardingRules(fake_mesh(shape_, axes), cfg)
        costs, arg_bytes, _ = count_step(model, rules, shape, SGD(lr=0.1))
    print(json.dumps({"ok": True, "flops": costs.flops,
                      "collective_bytes": costs.collective_bytes,
                      "kernels": costs.kernels}))
""")
MINI = [("qwen1.5-0.5b", "train", "single"),
        ("deepseek-moe-16b", "train", "single"),
        ("mamba2-130m", "decode", "single"),
        ("zamba2-1.2b", "prefill", "single"),
        ("qwen1.5-0.5b", "train", "multi")]


@pytest.fixture(scope="module")
def mini_cells():
    """The five cells, each in a process of its own, all at once."""
    procs = {c: subprocess.Popen(
        [sys.executable, "-c", CELL, *c, "torch"], env=ENV, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in MINI}
    out = {}
    for c, p in procs.items():
        stdout, stderr = p.communicate(timeout=540)
        assert p.returncode == 0, stderr[-3000:]
        out[c] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("arch,kind", [c[:2] for c in MINI[:4]])
def test_mini_dryrun_single_mesh(mini_cells, arch, kind):
    rec = mini_cells[(arch, kind, "single")]
    assert rec["ok"] and rec["flops"] > 0


def test_mini_dryrun_multi_pod(mini_cells):
    rec = mini_cells[("qwen1.5-0.5b", "train", "multi")]
    assert rec["ok"]
    assert rec["collective_bytes"] > 0        # pod-axis gradient reduction


# -- the counter -----------------------------------------------------------------

def _fake_dtensor(shape, mesh, placements, dtype=torch.float32, grad=False):
    from repro_torch.kernels.common import from_local
    from torch.distributed.tensor import Shard
    local = list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(m)
    t = from_local(torch.empty(local, dtype=dtype), mesh, placements, shape)
    return t.detach().requires_grad_(grad)


def test_counter_counts_each_device_not_the_mesh():
    """A (2, 4) mesh: A (64, 128) sharded on rows over ``data``, B (128,
    256) on columns over ``model``: each device multiplies (32, 128) by
    (128, 64), an eighth of 2 M N K; ``FlopCounterMode``, which sees the
    DTensor op before it is split, reports the whole mesh's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    M, K, N = 64, 128, 256
    with fake_world(8):
        mesh = fake_mesh((2, 4), ("data", "model"))
        with FakeTensorMode():
            a = _fake_dtensor((M, K), mesh, [Shard(0), Replicate()])
            b = _fake_dtensor((K, N), mesh, [Replicate(), Shard(1)])
            with CostCounter() as c:
                a @ b
            with FlopCounterMode(display=False) as g:
                a @ b
    assert c.costs.flops == 2 * M * N * K / 8
    assert g.get_total_flops() == 2 * M * N * K


def test_counter_counts_a_python_loop_each_time():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x, w = torch.empty(32, 64), torch.empty(64, 16)
        with CostCounter() as once:
            x @ w
        with CostCounter() as five:
            for _ in range(5):
                x @ w
    assert once.costs.flops == 2 * 32 * 64 * 16
    assert five.costs.flops == 5 * once.costs.flops
    assert five.costs.bytes == 5 * once.costs.bytes


def test_counter_counts_collectives_by_kind():
    """Shard -> Replicate is an all-gather of the shard, Partial ->
    Replicate an all-reduce, Partial -> Shard a reduce-scatter; the
    bytes are the operands' (one rank's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate, Shard
    with fake_world(8):
        mesh = fake_mesh((2, 4), ("data", "model"))
        with FakeTensorMode():
            s = _fake_dtensor((64, 32), mesh, [Replicate(), Shard(0)])
            p = _fake_dtensor((64, 32), mesh, [Replicate(), Partial()])
            with CostCounter() as c:
                s.redistribute(mesh, [Replicate(), Replicate()])
                p.redistribute(mesh, [Replicate(), Replicate()])
                p.redistribute(mesh, [Replicate(), Shard(0)])
                p.redistribute(mesh, [Replicate(), Shard(0)])
    assert c.costs.collective_counts == {"all-gather": 1, "all-reduce": 1,
                                         "reduce-scatter": 2}
    assert c.costs.collective == {"all-gather": 16 * 32 * 4,
                                  "all-reduce": 64 * 32 * 4,
                                  "reduce-scatter": 2 * 64 * 32 * 4}


def _kernel_calls():
    """(name, call on fake operands, expected output shapes and dtypes,
    expected ``ops.cost``)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.kernels.moe_gmm import ops as gops
    from repro_torch.kernels.ssd_scan import ssd
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.state_push import ops as spo
    bf, f32 = torch.bfloat16, torch.float32
    e = lambda *s, dtype=bf: torch.empty(s, dtype=dtype)
    B, S, H, K, D = 2, 48, 8, 2, 64
    R = 10
    return [
        ("flash_attention",
         lambda: flash_attention(e(B, S, H, D), e(B, S, K, D), e(B, S, K, D)),
         [((B, S, H, D), bf)], fops.cost(B, S, S, H, K, D, True, 2)),
        ("decode_attention",
         lambda: decode_attention(e(B, H, D), e(B, S, K, D), e(B, S, K, D),
                                  e(B, dtype=torch.int32)),
         [((B, H, D), bf)], dops.cost(B, S, H, K, D, 2)),
        ("moe_gmm",
         lambda: gmm(e(40, 64), e(8, 64, 32), e(8, dtype=torch.int32)),
         [((40, 32), bf)], gops.cost(40, 64, 32, 8, 2)),
        ("ssd_scan",
         lambda: ssd(e(B, 64, 4, 16), e(B, 64, 4, dtype=f32), e(4, dtype=f32),
                     e(B, 64, 1, 16), e(B, 64, 1, 16), e(4, dtype=f32),
                     chunk=32, initial_state=e(B, 4, 16, 16, dtype=f32)),
         [((B, 64, 4, 16), bf), ((B, 4, 16, 16), f32)],
         sops.cost(B, 64, 4, 16, 1, 16, 32, 2)),
        ("state_push.quantize_delta",
         lambda: spo.quantize_rows(e(R, 128, dtype=f32), e(R, 128, dtype=f32),
                                   with_residual=True),
         [((R, 128), torch.int8), ((R, 1), f32), ((R, 128), f32)],
         spo.cost("quantize_delta", R)),
        ("state_push.apply_delta",
         lambda: spo.apply_rows(e(R, 128, dtype=f32),
                                e(R, 128, dtype=torch.int8),
                                e(R, 1, dtype=f32)),
         [((R, 128), f32)], spo.cost("apply_delta", R)),
        ("state_push.push",
         lambda: spo.push_rows(*(e(R, 128, dtype=f32) for _ in range(3))),
         [((R, 128), f32)], spo.cost("push", R)),
    ]


def _launch_total():
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.moe_gmm import ops as gops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.state_push import ops as spo
    return (sum(c.value for c in (fops.LAUNCHES, dops.LAUNCHES,
                                  gops.LAUNCHES, sops.LAUNCHES))
            + sum(c.value for c in spo.LAUNCHES.values()))


@pytest.mark.parametrize("case", range(7))
def test_a_fake_kernel_call_reports_its_cost_and_launches_nothing(case):
    from torch._subclasses.fake_tensor import FakeTensorMode
    n0 = _launch_total()
    with FakeTensorMode():
        name, call, want, cost = _kernel_calls()[case]
        with CostCounter() as c:
            out = call()
    outs = [t for t in (out if isinstance(out, tuple) else (out,))
            if t is not None]
    assert [(tuple(t.shape), t.dtype) for t in outs] == want
    assert c.costs.kernels == {name: 1}
    assert c.costs.flops == cost[0]
    assert c.costs.bytes == cost[1]          # allocations move no bytes
    assert _launch_total() == n0


# -- against the reference -------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_equal_the_reference(arch):
    from repro.configs import get_config as jget_config
    from repro.configs import get_shape as jget_shape
    from repro.launch import dryrun as jdryrun
    for sid in SHAPES:
        assert model_flops(get_config(arch), get_shape(sid)) == \
            jdryrun.model_flops(jget_config(arch), jget_shape(sid))


REF_CELL = textwrap.dedent("""\
    import os, sys
    n = 1 if sys.argv[3] == "one" else 8
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    import json
    from repro.configs import smoke_config, ShapeConfig
    from repro.models import build_model, ExecConfig
    from repro.distributed.sharding import ShardingRules
    from repro.distributed.hlo_analysis import analyze
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import make_step_for_shape, dummy_args
    from repro.optim import SGD

    arch, kind = sys.argv[1], sys.argv[2]
    mesh = make_mesh((1, 1) if n == 1 else (2, 4), ("data", "model"))
    cfg = smoke_config(arch)
    model = build_model(cfg, ExecConfig(backend="xla", loss_chunk=16))
    rules = ShardingRules(mesh, cfg)
    shape = ShapeConfig("mini_" + kind, kind, 32, 4)
    opt = SGD(lr=0.1)
    with mesh:
        jitted, args = make_step_for_shape(model, rules, shape, optimizer=opt)
        compiled = jitted.lower(*dummy_args(model, shape, args, opt)).compile()
        costs = analyze(compiled.as_text())
    print(json.dumps({"flops": costs.flops}))
""")
PARITY = [("qwen1.5-0.5b", "train"), ("zamba2-1.2b", "prefill")]


@pytest.fixture(scope="module")
def parity_counts():
    """Each parity cell's count by both packages, on one device and on the
    (2, 4) mesh, every count in a process of its own, all at once."""
    runs = {}
    for arch, kind in PARITY:
        for where in ("one", "single"):
            runs[("ref", arch, kind, where)] = [REF_CELL, arch, kind, where]
            runs[("port", arch, kind, where)] = [CELL, arch, kind, where,
                                                 "torch"]
    env = dict(ENV, JAX_PLATFORMS="cpu")
    procs = {k: subprocess.Popen([sys.executable, "-c", *v], env=env,
                                 cwd=REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, v in runs.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=540)
        assert p.returncode == 0, (k, stderr[-3000:])
        out[k] = json.loads(stdout.strip().splitlines()[-1])["flops"]
    return out


@pytest.mark.parametrize("arch,kind", PARITY)
def test_plain_route_flops_match_the_reference(parity_counts, arch, kind):
    """One device: the two counters agree within 5% on the same program
    (a dot's 2 |out| Π(contracting), convolutions, remat, the chunked
    loss, C·Bᵀ once per SSD group).  The (2, 4) mesh, per device: the
    port's count is no more than 5% above the reference's and within 5%
    of an even split of the reference's one-device count over the 8
    devices; where GSPMD's own count is such an even split (zamba2's
    prefill), the port's is within 5% of it.  GSPMD's qwen train count is
    22.6% above an even split: its weight-stationary layout at a batch of
    4 gathers the tokens and splits attention and the loss over half the
    mesh, where the port splits them over all of it."""
    one = parity_counts[("port", arch, kind, "one")]
    ref_one = parity_counts[("ref", arch, kind, "one")]
    mesh = parity_counts[("port", arch, kind, "single")]
    ref_mesh = parity_counts[("ref", arch, kind, "single")]
    print(f"{arch} {kind}: one device port {one:.6g} ref {ref_one:.6g}; "
          f"(2, 4) per device port {mesh:.6g} ref {ref_mesh:.6g}, "
          f"even split of ref {ref_one / 8:.6g}")
    assert one == pytest.approx(ref_one, rel=0.05)
    assert mesh <= ref_mesh * 1.05
    assert mesh == pytest.approx(ref_one / 8, rel=0.05)
    if ref_mesh == pytest.approx(ref_one / 8, rel=0.05):
        assert mesh == pytest.approx(ref_mesh, rel=0.05)


# -- each kernel's cost, one home -------------------------------------------------

def _old_flash(B, S, Sk, H, K, D, causal, stats=False):
    """``chip_smoke.py``'s inline K5 formula before the move (prefill rows;
    with ``stats`` its training rows)."""
    pairs = S * (S + 1) // 2 if causal else S * Sk
    q, kv = B * S * H * D, B * Sk * K * D
    nbytes = (2 * (2 * q + 2 * kv) + 4 * B * H * S) if stats else \
        2 * (q + kv + kv + q)
    return 4 * D * B * H * pairs, nbytes


@pytest.mark.parametrize("shape", [
    (4, 512, 512, 16, 16, 64, True), (1, 16, 16, 16, 16, 64, True),
    (4, 512, 512, 32, 8, 128, True), (4, 512, 512, 36, 4, 128, True),
    (4, 1500, 1500, 6, 6, 64, False), (4, 512, 1500, 6, 6, 64, False),
    (4, 768, 768, 16, 8, 128, True), (4, 4096, 4096, 16, 16, 64, True)])
def test_flash_cost_is_the_old_formula(shape):
    from repro_torch.kernels.flash_attention import ops
    assert ops.cost(*shape, 2) == _old_flash(*shape)
    assert ops.cost(*shape, 2, stats=True) == _old_flash(*shape, stats=True)


@pytest.mark.parametrize("B,S,H,K,D,n", [
    (4, 544, 16, 16, 64, 543), (4, 544, 36, 4, 128, 543),
    (4, 1500, 6, 6, 64, 1500), (1, 18, 32, 32, 64, 17)])
def test_decode_cost_is_the_old_formula(B, S, H, K, D, n):
    from repro_torch.kernels.decode_attention import ops
    q = B * H * D
    assert ops.cost(B, S, H, K, D, 2, n) == \
        (4 * D * B * H * n, 2 * (q + 2 * B * n * K * D + q))


@pytest.mark.parametrize("T,d,f,E,active", [
    (24, 2048, 1408, 64, 24), (24, 1408, 2048, 64, 20),
    (12288, 2048, 1408, 64, 64)])
def test_gmm_cost_is_the_old_formula(T, d, f, E, active):
    from repro_torch.kernels.moe_gmm import ops
    assert ops.cost(T, d, f, E, 2, active) == \
        (2 * T * d * f, 2 * (active * d * f + T * d + T * f))


@pytest.mark.parametrize("Bt,S,H,P,G,N,Q", [
    (4, 512, 24, 64, 1, 128, 256), (4, 512, 64, 64, 1, 64, 256),
    (1, 16, 24, 64, 1, 128, 16), (4, 4096, 24, 64, 1, 128, 256)])
def test_ssd_cost_is_the_old_formula(Bt, S, H, P, G, N, Q):
    from repro_torch.kernels.ssd_scan import ops
    nc = -(-S // Q)
    pairs = Q * (Q + 1) // 2
    old = (Bt * G * nc * 2 * pairs * N, Bt * H * nc * 2 * pairs * P,
           Bt * H * nc * 4 * Q * N * P)
    x, bc, st = Bt * S * H * P, Bt * S * G * N, Bt * H * P * N
    nbytes = (2 * x + 4 * Bt * S * H + 2 * (bc + bc) + 8 * H + 4 * st
              + 2 * x + 4 * st)
    assert ops.flop_parts(Bt, S, H, P, G, N, Q) == old
    assert ops.cost(Bt, S, H, P, G, N, Q, 2) == (sum(old), nbytes)


@pytest.mark.parametrize("R", [1187, (16 << 20) // 128])
def test_state_push_cost_is_the_old_formula(R):
    from repro_torch.kernels.state_push import ops
    quant = (9 * R * 128, R * 128 * (4 + 4 + 1 + 4) + R * 4)
    assert ops.cost("quantize_delta", R) == quant
    assert ops.cost("quantize_fp8", R) == quant
    assert ops.cost("apply_delta", R) == (2 * R * 128,
                                          R * 128 * (4 + 1 + 4) + R * 4)
    assert ops.cost("push", R) == (2 * R * 128, R * 128 * 16)
