"""The port's multi-device pieces against the reference's, on the CPU.

Ranks are gloo processes (``torch.multiprocessing``), started by a
subprocess of their own so that each test has its own time limit and the
test process keeps no process group:

  * the GPipe pipeline (``distributed/pipeline.py``) over 4 stages against
    the reference's pipelined output (``repro.distributed.pipeline`` over
    4 XLA host devices) on the same numpy inputs, and its bubble;
  * the elastic round trip (``distributed/elastic.py``) on (2, 4) and
    (4, 2) meshes of 8 ranks, bitwise;
  * the collective cost models against the reference's;
  * a smoke-config train step of qwen1.5-0.5b, of qwen3-4b (one KV
    head over four ``model`` ranks) and of zamba2-1.2b (its Mamba layers'
    heads split over ``model``), placed on a (2, 4) mesh by
    ``ShardingRules`` against the one-device step (f32: loss 1e-4, each
    gradient leaf and updated parameter 1e-3 relative L2), and zamba2's
    prefill against the one-device prefill (logits and cache, 1e-4).
"""
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

# the pipeline's inputs, the same numpy draws on both sides
INPUTS = textwrap.dedent("""\
    import numpy as np
    L, d, n_micro, mb = 8, 16, 4, 2
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((L, d, d)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((L, d)) * 0.1).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
""")

REF_PIPELINE = textwrap.dedent("""\
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp
    from repro.distributed.pipeline import make_pipeline_fn, split_stages
    from repro.launch.mesh import make_mesh
    """) + INPUTS + textwrap.dedent("""\
    mesh = make_mesh((4,), ("pipe",))

    def block_fn(h, lp):
        return jnp.tanh(h @ lp["w"] + lp["b"])

    staged = split_stages({"w": jnp.asarray(W), "b": jnp.asarray(b)}, 4)
    with mesh:
        got = jax.jit(make_pipeline_fn(block_fn, mesh, n_micro))(
            staged, jnp.asarray(x))
    print(json.dumps(np.asarray(got).tolist()))
""")

# a launcher of N gloo ranks running ``body(rank)``; rank 0's result is
# printed as JSON
RANKS = textwrap.dedent("""\
    import json, queue, socket, sys
    import torch.multiprocessing as mp

    def _run(rank, world, port, q):
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            out = body(rank)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            q.put(out)

    def launch(world):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        q = mp.get_context("spawn").Queue()
        ranks = mp.start_processes(_run, args=(world, port, q), nprocs=world,
                                   start_method="spawn", join=False)
        while True:          # drain before the ranks join; a failed rank raises
            try:
                out = q.get(timeout=1)
                break
            except queue.Empty:
                ranks.join(timeout=0)
        while not ranks.join():
            pass
        print(json.dumps(out))
""")

PORT_PIPELINE = RANKS + textwrap.dedent("""\
    def body(rank):
        import torch
    """) + textwrap.indent(INPUTS, "    ") + textwrap.dedent("""\
        from repro_torch.distributed.pipeline import (make_pipeline_fn,
                                                      pipeline_stats,
                                                      split_stages)
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((4,), ("pipe",), device_type="cpu")
        fn = make_pipeline_fn(lambda h, lp: torch.tanh(h @ lp["w"] + lp["b"]),
                              mesh, n_micro)
        got = fn(split_stages({"w": torch.from_numpy(W),
                               "b": torch.from_numpy(b)}, 4),
                 torch.from_numpy(x))
        return {"out": got.tolist(),
                "bubble": pipeline_stats(4, n_micro)["bubble_fraction"]}

    if __name__ == "__main__":
        launch(4)
""")

MESH_STEP = RANKS + textwrap.dedent("""\
    def _bytes(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in _bytes(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in _bytes(v)]
        import numpy as np
        return [np.asarray(getattr(tree, "bits", tree)).tobytes()]

    class Tap:
        def __init__(self, opt):
            self.opt, self.grads = opt, None

        def init(self, params):
            return self.opt.init(params)

        def update(self, grads, state, params):
            self.grads = {k: g.detach().clone() for k, g in grads.items()}
            return self.opt.update(grads, state, params)

    # the dense decoder (heads and KV heads sharded over model; a
    # vocabulary of 257 split unevenly over the 4 model ranks), a GQA one
    # (one KV head over 4 model ranks: each rank's query head reads a
    # slice of the replicated K/V) and the hybrid (a batch of 4 leaves the
    # model axis to its Mamba layers' heads)
    ARCHS = ("qwen1.5-0.5b", "qwen3-4b", "zamba2-1.2b")

    def body(rank):
        import numpy as np
        import torch
        from repro_torch.configs import smoke_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.data import PipelineConfig, make_batch
        from repro_torch.distributed.elastic import (reshard_params,
                                                     reshard_train_state,
                                                     to_host)
        from repro_torch.distributed.sharding import ShardingRules
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import (make_prefill_step,
                                              make_step_for_shape,
                                              make_train_step)
        from repro_torch.models import ExecConfig, build_model
        from repro_torch.models.weights import (from_jax_params, init_params,
                                                to_jax_params, trainable)
        from repro_torch.optim import SGD
        cfg = smoke_config("qwen1.5-0.5b").with_overrides(
            dtype="float32", param_dtype="float32")
        host = to_jax_params(init_params(cfg, torch.Generator().manual_seed(0),
                                         "cpu"), cfg)
        # SGD's state with momentum: its step and a tree like the params'
        state = to_host(SGD(lr=0.1, momentum=0.9).init(from_jax_params(
            host, cfg, "cpu")))
        out = {"roundtrip": {}}
        for shape in ((2, 4), (4, 2)):       # rescale 2x4 -> 4x2
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            back = to_host(reshard_params(host, cfg, mesh))
            p2, s2 = reshard_train_state(host, state, cfg, mesh)
            out["roundtrip"][str(shape)] = (
                _bytes(back) == _bytes(host)
                and _bytes(to_host(p2)) == _bytes(host)
                and _bytes(to_host(s2.momentum)) == _bytes(state.momentum)
                and bool(to_host(s2.step) == state.step))
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        shape = ShapeConfig("mini_train", "train", 32, 4)
        rl2 = lambda a, b: float(torch.linalg.norm((a - b).double())
                                 / max(torch.linalg.norm(b.double()), 1e-30))
        for arch in ARCHS:
            cfg = smoke_config(arch).with_overrides(dtype="float32",
                                                    param_dtype="float32")
            host = to_jax_params(init_params(
                cfg, torch.Generator().manual_seed(0), "cpu"), cfg)
            rules = ShardingRules(mesh, cfg)
            model = build_model(cfg, ExecConfig(loss_chunk=16))
            batch = {k: torch.from_numpy(v) for k, v in
                     make_batch(cfg, shape, PipelineConfig(seed=0), 0).items()}
            tap, tap1 = Tap(SGD(lr=0.1)), Tap(SGD(lr=0.1))
            params = trainable(reshard_params(host, cfg, mesh, rules=rules))
            step, _ = make_step_for_shape(model, rules, shape, optimizer=tap)
            _, _, m = step(params, tap.init(params), batch)
            grads = {k: g.full_tensor() for k, g in tap.grads.items()}
            after = {n: p.full_tensor() for n, p in params.named_parameters()}
            p1 = trainable(from_jax_params(host, cfg, "cpu"))
            _, _, m1 = make_train_step(model, tap1, shape)(p1, tap1.init(p1),
                                                           batch)
            out[arch] = dict(
                loss=float(m["loss"]), loss1=float(m1["loss"]),
                grads={n: rl2(grads[n], tap1.grads[n]) for n in grads},
                params={n: rl2(after[n], q)
                        for n, q in p1.named_parameters()})
        # zamba2's prefill: logits, and the conv tails and SSD states its
        # head-split Mamba layers write into the cache
        cfg = smoke_config("zamba2-1.2b").with_overrides(
            dtype="float32", param_dtype="float32")
        host = to_jax_params(init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), cfg)
        rules = ShardingRules(mesh, cfg)
        model = build_model(cfg, ExecConfig())
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 32), dtype=np.int32))
        step, _ = make_prefill_step(model, rules,
                                    ShapeConfig("mini_prefill", "prefill", 32, 4))
        logits, cache, _ = step(reshard_params(host, cfg, mesh, rules=rules),
                                tokens, model.init_cache(4, 32, "cpu"))
        with torch.no_grad():
            logits1, cache1, _ = model.prefill(
                from_jax_params(host, cfg, "cpu"), tokens,
                model.init_cache(4, 32, "cpu"))
        out["prefill"] = {"logits": rl2(logits.full_tensor(), logits1),
                          **{k: rl2(cache[k].full_tensor(), cache1[k])
                             for k in cache1}}
        # the SSD scan with x split by heads over model and two groups of
        # B and C held whole: each rank's heads read their own group
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.kernels.ssd_scan import ssd
        g = torch.Generator().manual_seed(1)
        x, B_, C_ = (torch.randn(s, generator=g) for s in
                     ((2, 32, 8, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
        dt_ = torch.rand((2, 32, 8), generator=g) + 0.1
        A_, D_ = -torch.rand(8, generator=g) - 0.1, torch.randn(8, generator=g)
        heads = [Replicate(), Shard(2)]
        put = lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=None)
        y, fin = ssd(put(x, heads), put(dt_, heads),
                     *(put(t, [Replicate()] * 2) for t in (A_, B_, C_, D_)),
                     chunk=16)
        y1, fin1 = ssd(x, dt_, A_, B_, C_, D_, chunk=16)
        out["ssd_groups"] = max(rl2(y.full_tensor(), y1),
                                rl2(fin.full_tensor(), fin1))
        return out

    if __name__ == "__main__":
        launch(8)
""")


def _json(script, timeout, where):
    """Run ``script`` as a file (spawned ranks import it) under ``where``;
    its last line of output as JSON."""
    path = where / "script.py"
    path.write_text(script)
    proc = subprocess.Popen([sys.executable, str(path)], env=ENV, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:             # the script's ranks too, whatever became of it
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


def test_pipeline_parallel_matches_the_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = np.asarray(_json(REF_PIPELINE, 300, tmp_path / "ref"), np.float32)
    got = _json(PORT_PIPELINE, 300, tmp_path / "port")
    assert float(np.abs(np.asarray(got["out"], np.float32) - ref).max()) < 1e-5
    assert got["bubble"] == 3 / 7


@pytest.fixture(scope="module")
def mesh_step(tmp_path_factory):
    return _json(MESH_STEP, 600, tmp_path_factory.mktemp("mesh_step"))


@pytest.mark.parametrize("shape", ["(2, 4)", "(4, 2)"])
def test_elastic_reshard_roundtrip(mesh_step, shape):
    assert mesh_step["roundtrip"][shape] is True


def test_collective_cost_models_equal_the_reference():
    from repro.distributed import collectives as ref
    from repro_torch.distributed import collectives as port
    for nbytes, n in ((1 << 20, 16), (3_000_000, 2), (12345, 512)):
        assert port.ring_allreduce_bytes(nbytes, n) == \
            ref.ring_allreduce_bytes(nbytes, n)
        assert port.allgather_bytes(nbytes, n) == ref.allgather_bytes(nbytes, n)
        assert port.collective_seconds(nbytes) == ref.collective_seconds(nbytes)
        assert port.collective_seconds(nbytes, 400e9) == \
            ref.collective_seconds(nbytes, 400e9)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-4b", "zamba2-1.2b"])
def test_mesh_train_step_matches_the_one_device_step(mesh_step, arch):
    got = mesh_step[arch]
    assert got["loss"] == pytest.approx(got["loss1"], rel=1e-4, abs=1e-4)
    worst = {k: v for k, v in got["grads"].items() if v > 1e-3}
    assert not worst, worst
    moved = {k: v for k, v in got["params"].items() if v > 1e-3}
    assert not moved, moved


def test_mesh_prefill_matches_the_one_device_prefill(mesh_step):
    """zamba2's smoke prefill on the (2, 4) mesh (f32): logits and every
    cache leaf within 1e-4 relative L2 of the one-device prefill."""
    worst = {k: v for k, v in mesh_step["prefill"].items() if v > 1e-4}
    assert not worst, worst


def test_ssd_split_by_heads_reads_each_heads_group(mesh_step):
    """The SSD scan with x sharded by heads over 4 ranks and B and C of 2
    groups held whole equals the one-device scan (f32, 1e-5 relative L2):
    each rank's heads read their own group."""
    assert mesh_step["ssd_groups"] < 1e-5
