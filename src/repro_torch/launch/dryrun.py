"""Multi-pod dry-run: trace every (arch × shape × mesh) cell, count each device.

Counterpart of ``python -m repro.launch.dryrun``, with its flags and its
record's keys.  The production meshes (16x16 single pod, 2x16x16
multi-pod) are built over torch's fake process group: 256 or 512 ranks
that exist only as a world size, this process being rank 0.  Every
assigned cell's step (``launch/steps.py::make_step_for_shape``) runs once
under ``FakeTensorMode`` on ``DTensor`` parameters and inputs placed by
``ShardingRules`` (shapes, no data, no allocation: the 1.03 T kimi-k2 is
traced at full width like the rest), inside
``distributed/cost_analysis.py::CostCounter``, which counts rank 0's
share:

  * FLOPs and bytes per device (hand-written kernels on their fake route,
    by their ``ops.cost`` formulas: ``backend="auto"``, the kernel route,
    is the default; ``--override backend=torch`` counts the plain route,
    the twin of the reference's ``backend="xla"``);
  * collective bytes and counts per device, by kind;
  * peak memory: the arguments' local bytes plus the step's live storages
    at their peak;

from which the three roofline terms are derived at the H100's constants.
The fake tensors are CPU tensors on a CPU mesh: a CPU-only torch cannot
run autograd over fake CUDA tensors, and on a CPU mesh ``DTensor``
performs an all-to-all as an all-gather and a chunk, so such moves count
under ``all-gather``.  What the reference reads off XLA (``lower_s``,
``compile_s``, ``hlo_bytes``, ``xla_cost_flops``, the bf16-emulation
corrections) has no counterpart; ``trace_s`` is the time of the traced
step.  Artifacts land in ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>
[__tag].json``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.distributed.collectives import LINK_BW
from repro_torch.distributed.cost_analysis import KINDS, CostCounter, local_bytes
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import make_mesh, production_shape
from repro_torch.launch.steps import dummy_args, make_step_for_shape
from repro_torch.models import ExecConfig, build_model
from repro_torch.optim import SGD

# ----------------------------------------------------------------- hardware --
# NVIDIA H100 SXM, per GPU (data sheet, dense).
PEAK_FLOPS = 989e12            # bf16 FLOP/s
HBM_BW = 3.35e12               # bytes/s
# Every production axis of 16 spans two 8-GPU nodes, so a collective over
# it is bound by the network, not NVLink: one 400 Gb/s NDR InfiniBand
# port per GPU in a DGX H100, 50e9 bytes/s.
ICI_BW = LINK_BW

MESHES = {False: "pod16x16", True: "pod2x16x16"}


@contextlib.contextmanager
def fake_world(world_size: int):
    """torch's fake process group of ``world_size`` ranks as the default
    group (this process rank 0), torn down on leaving.  Refuses to stack
    on a group already set up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already set up; the dry-run "
                           "sets up and tears down its own fake group")
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(shape, axes):
    """A CPU mesh over the fake group (see :func:`fake_world`)."""
    return make_mesh(shape, axes, device_type="cpu")


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference).

    N counts matmul-involved params: the embedding *lookup* is free, but the
    unembed matmul always costs V·d per token (for tied embeddings the table
    is counted once in active_param_count and used as the unembed matmul)."""
    n = cfg.active_param_count()
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n * shape.tokens_per_step


def exec_for(cfg: ModelConfig, shape: ShapeConfig,
             overrides: Optional[dict] = None) -> ExecConfig:
    """Per-cell execution plan: the reference's choices for the fields the
    port's ``ExecConfig`` has, on the kernel route (``backend="auto"``)."""
    kw: Dict = dict(backend="auto", remat="full")
    if shape.kind == "train":
        kw["loss_chunk"] = 512
        if cfg.name == "kimi-k2-1t-a32b":
            kw["microbatches"] = 1
            kw["moe_group_size"] = 256
            kw["accum_dtype"] = "bfloat16"
        elif cfg.n_experts:
            kw["moe_group_size"] = 256
    else:
        kw["loss_chunk"] = 0
        kw["moe_group_size"] = 128
        if shape.kind == "decode" and cfg.n_experts:
            kw["moe_decode_impl"] = "einsum"
            kw["moe_capacity_override"] = 4.0
            kw["moe_group_size"] = 8192
    if overrides:
        kw.update(overrides)
    return ExecConfig(**kw)


def count_step(model, rules, shape: ShapeConfig, optimizer=None):
    """Trace ``model``'s step for ``shape`` once on fake tensors (placed by
    ``rules``, or on one device when it is None) inside a
    :class:`CostCounter`.  Returns (costs, argument bytes, seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = make_step_for_shape(model, rules, shape,
                                         optimizer=optimizer)
        dargs = dummy_args(model, shape, args, optimizer, rules)
        arg_bytes = local_bytes(_leaves(dargs))
        t0 = time.perf_counter()
        with CostCounter() as counter:
            step(*dargs)
        return counter.costs, arg_bytes, time.perf_counter() - t0


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def run_cell(arch: str, shape_id: str, mesh, mesh_name: str,
             overrides: Optional[dict] = None, fsdp: bool = True,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None) -> dict:
    """One cell's record (``cfg`` and ``shape`` override the registry's,
    for cut-down cells)."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_id)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_id, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    n_dev = mesh.size()
    ec = exec_for(cfg, shape, overrides)
    model = build_model(cfg, ec)
    rules = ShardingRules(mesh, cfg, fsdp=fsdp)
    costs, arg_bytes, trace_s = count_step(model, rules, shape,
                                           optimizer=SGD(lr=0.01))
    flops, bytes_accessed = costs.flops, costs.bytes
    coll = {k: costs.collective.get(k, 0.0) for k in KINDS}
    coll["counts"] = {k: int(costs.collective_counts.get(k, 0))
                      for k in KINDS}
    coll_total = costs.collective_bytes

    # roofline terms, seconds (per-device counts => per-GPU terms)
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_accessed / HBM_BW
    t_coll = coll_total / ICI_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    useful_ratio = mf / (flops * n_dev) if flops else 0.0
    worst = max(terms.values())
    return {
        "arch": arch, "shape": shape_id, "mesh": mesh_name,
        "status": "ok", "n_devices": n_dev,
        "exec": {k: getattr(ec, k) for k in
                 ("backend", "remat", "moe_impl", "moe_group_size",
                  "microbatches", "loss_chunk")},
        "fsdp": fsdp,
        "trace_s": round(trace_s, 2),
        "memory": {"argument_bytes": arg_bytes,
                   "temp_bytes": int(costs.peak_bytes),
                   "peak_bytes": arg_bytes + int(costs.peak_bytes)},
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": coll_total,
        "collectives": coll,
        "kernel_calls": dict(costs.kernels),
        "analysis_warnings": sorted(set(costs.warnings)),
        "roofline": {
            "t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant,
            "model_flops": mf,
            "useful_flops_ratio": useful_ratio,
            "roofline_fraction": t_compute / worst if worst else 0.0,
        },
    }


def _overrides(text: str) -> dict:
    out = {}
    for kv in text.split(","):
        if "=" in kv:
            k, v = kv.split("=", 1)
            out[k.strip()] = (int(v) if v.strip().lstrip("-").isdigit()
                              else v.strip())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape id (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute existing")
    ap.add_argument("--tag", default="", help="artifact suffix (perf variants)")
    ap.add_argument("--override", default="",
                    help="ExecConfig overrides, e.g. 'backend=torch,remat=dots'")
    args = ap.parse_args(argv)
    overrides = _overrides(args.override)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = []
    for multi in meshes:
        mesh_name = MESHES[multi]
        out_dir = os.path.join(args.out, mesh_name)
        os.makedirs(out_dir, exist_ok=True)
        shape_, axes = production_shape(multi)
        with fake_world(math.prod(shape_)):
            mesh = fake_mesh(shape_, axes)
            for arch in archs:
                for shape_id in shapes:
                    tag = f"__{args.tag}" if args.tag else ""
                    path = os.path.join(out_dir, f"{arch}__{shape_id}{tag}.json")
                    if os.path.exists(path) and not args.force:
                        print(f"[skip-cached] {mesh_name} {arch} {shape_id}")
                        continue
                    try:
                        rec = run_cell(arch, shape_id, mesh, mesh_name,
                                       overrides=overrides or None,
                                       fsdp=not args.no_fsdp)
                    except Exception as e:
                        rec = {"arch": arch, "shape": shape_id,
                               "mesh": mesh_name, "status": "error",
                               "error": repr(e),
                               "traceback": traceback.format_exc()[-4000:]}
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    results.append(rec)
                    print(status_line(rec), flush=True)
    n_err = sum(1 for r in results if r["status"] == "error")
    print(f"done: {len(results)} cells, {n_err} errors")
    return 1 if n_err else 0


def status_line(rec: dict) -> str:
    """A record's one-line summary, as the reference prints it."""
    if rec["status"] == "skipped":
        return f"[skipped] {rec['mesh']} {rec['arch']} {rec['shape']}: " \
               f"{rec['reason']}"
    if rec["status"] != "ok":
        return f"[ERROR] {rec['mesh']} {rec['arch']} {rec['shape']}: " \
               f"{rec['error']}"
    r = rec["roofline"]
    return (f"[ok] {rec['mesh']} {rec['arch']:>18s} {rec['shape']:<12s} "
            f"trace={rec['trace_s']:7.1f}s "
            f"peak={rec['memory']['peak_bytes'] / 2**30:7.2f}GiB "
            f"Tc={r['t_compute_s'] * 1e3:9.3f}ms "
            f"Tm={r['t_memory_s'] * 1e3:9.3f}ms "
            f"Tx={r['t_collective_s'] * 1e3:9.3f}ms "
            f"dom={r['dominant']:<10s} "
            f"useful={r['useful_flops_ratio']:.3f}")


if __name__ == "__main__":
    raise SystemExit(main())
