"""The end-to-end tests of ``tests/test_system.py`` through the port on the
CPU, under the same names and with the reference's assertions: HOGWILD
SGD as chained ``weight_update`` Faaslets over shared state
(``SparseMatrixReadOnly``, ``VectorAsync``) converges; inference Faaslets
restore from Proto-Faaslets and find their forward in the runtime's
executable cache (the eager forward on the CPU, built at the first call,
where the reference jits one at upload); a smoke LM's loss falls through
the train step.  No JAX: the runtime
runs its state plane on ``device="cpu"``, and the train step is
``launch/steps.py::make_train_step``'s, which the launchers capture on the
card.
"""
import time

import numpy as np
import torch

from repro_torch.core import FaasmRuntime, FunctionDef, await_all, chain
from repro_torch.data import accuracy, hinge_loss, make_sparse_dataset
from repro_torch.state.ddo import SparseMatrixReadOnly, VectorAsync
from torch_twin_planes import port_planes_disarmed, port_sanitize  # noqa: F401


def test_hogwild_sgd_through_runtime_converges():
    """Listing-1 reproduction: chained weight_update Faaslets training a
    linear classifier on planted sparse data, shared weights via VectorAsync.
    The paper's claim: parallel HOGWILD updates through shared memory still
    converge."""
    X, y, w_true = make_sparse_dataset(64, 256, density=0.15, seed=0)
    rt = FaasmRuntime(n_hosts=2, capacity=4, device="cpu")
    try:
        SparseMatrixReadOnly.create(rt.global_tier, "train_x", X)
        rt.global_tier.set("labels", y.astype(np.float32).tobytes(), host="up")
        VectorAsync.create(rt.global_tier, "weights", np.zeros(64, np.float32))

        def weight_update(api):
            lo, hi = np.frombuffer(api.read_call_input(), np.int32)
            mat = SparseMatrixReadOnly(api, "train_x")
            labels = np.frombuffer(bytes(api.get_state("labels",
                                                       writable=False)),
                                   np.float32)
            w = VectorAsync(api, "weights")
            w.pull(track_delta=True)
            lr = 0.05
            for c, rows, vals in mat.columns(int(lo), int(hi)):
                margin = float(labels[c] * (w.values[rows] * vals).sum())
                if margin < 1.0:                     # hinge subgradient
                    w.add(rows, lr * labels[c] * vals)
            w.push_delta()
            return 0

        def sgd_main(api):
            n_workers, n_epochs, n_cols = 4, 4, 256
            for _ in range(n_epochs):
                args = []
                per = n_cols // n_workers
                for wi in range(n_workers):
                    args.append(np.asarray([wi * per, (wi + 1) * per],
                                           np.int32).tobytes())
                cids = chain(api, "weight_update", args)
                rcs = await_all(api, cids)
                assert all(r == 0 for r in rcs)
            return 0

        rt.upload(FunctionDef("weight_update", weight_update))
        rt.upload(FunctionDef("sgd_main", sgd_main))
        cid = rt.invoke("sgd_main")
        assert rt.wait(cid, timeout=120) == 0, rt.call(cid).error
        w_final = np.frombuffer(rt.global_tier.get("weights", host="t"),
                                np.float32)
        assert hinge_loss(w_final, X, y) < hinge_loss(np.zeros(64, np.float32),
                                                      X, y) * 0.5
        assert accuracy(w_final, X, y) > 0.8
    finally:
        rt.shutdown()


def test_inference_serving_with_proto_faaslets():
    """Inference Faaslets share model weights through the local tier and cold
    starts restore from Proto-Faaslets (µs-scale) instead of re-initialising.
    The port's CPU forward is eager and needs no compile, so where the
    reference's first call pays its jit's and eager ops' compiles, the
    port's first call builds the cache's entry (the bound parameters' warm
    forward); the init runs once, at upload, and fills the snapshot."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import bind_params, host_leaves
    from repro_torch.models import ExecConfig, build_model

    cfg = smoke_config("qwen1.5-0.5b")
    model = build_model(cfg, ExecConfig(loss_chunk=0))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    leaves = host_leaves(params)

    rt = FaasmRuntime(n_hosts=1, capacity=4, device="cpu")
    try:
        inits, hits = [], []

        def _build_fwd():
            fwd = torch.no_grad()(lambda p, t: model.logits(p, t))
            p = bind_params(cfg, leaves, torch.device("cpu"))
            fwd(p, torch.zeros((1, 8), dtype=torch.int32))
            return fwd

        def init(api):
            # heavyweight init: the weight layout, in the (picklable)
            # snapshot; the forward lands in the ExecutableCache at first use
            inits.append(1)
            return {"params": leaves}                 # picklable

        def infer(api):
            state = api.host.user_state(api.faaslet)
            fwd, hit, _ = api.runtime.exec_cache.get_or_build(
                ("infer", "fwd"), _build_fwd)
            hits.append(hit)
            p = bind_params(cfg, state["params"], torch.device("cpu"))
            tokens = np.frombuffer(api.read_call_input(), np.int32).reshape(1, -1)
            logits = fwd(p, torch.from_numpy(tokens.copy()))
            api.write_call_output(
                torch.argmax(logits[0, -1]).to(torch.int32).numpy().tobytes())
            return 0

        rt.upload(FunctionDef("infer", infer, init_fn=init))
        tokens = np.arange(8, dtype=np.int32)
        lat = []
        for _ in range(5):
            t0 = time.perf_counter()
            cid = rt.invoke("infer", tokens.tobytes())
            assert rt.wait(cid, timeout=60) == 0, rt.call(cid).error
            lat.append(time.perf_counter() - t0)
        stats = rt.cold_start_stats()
        assert stats["warm_hits"] >= 4
        assert inits == [1] and hits == [False] + [True] * 4
        # warm path much faster than the first (build-paying) call
        assert min(lat[1:]) < lat[0]
    finally:
        rt.shutdown()


def test_train_lm_loss_decreases():
    """A ~tiny LM trains through the real train-step path and the loss drops."""
    from repro_torch.configs import smoke_config, smoke_shape
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.models.weights import trainable
    from repro_torch.optim import SGD

    cfg = smoke_config("qwen1.5-0.5b")
    shape = smoke_shape("train")
    model = build_model(cfg, ExecConfig(loss_chunk=16))
    params = trainable(model.init(torch.Generator().manual_seed(0), "cpu"))
    opt = SGD(lr=0.3)
    state = opt.init(params)
    step = make_train_step(model, opt, shape)

    pc = PipelineConfig(seed=0)
    losses = []
    for i in range(30):
        batch = {k: torch.from_numpy(v) for k, v in
                 make_batch(cfg, shape, pc, 0).items()}   # fixed batch
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]
