"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [--smoke]``.

Counterpart of ``python -m repro.launch.train``, with its flags, its
schedule and optimizers, its checkpoints (the reference's layout: either
package resumes the other's) and its output lines.  Everything runs on
the CUDA card (``--device cuda``, the default) and raises when there is
none; the CPU runs only when asked for (``--device cpu``).  ``--smoke``
trains the reduced config of the architecture on ``smoke_shape`` on one
device.  Without it the full config trains at ``--shape``:

  * launched with a process group of 256 ranks (512 with
    ``--multi-pod``), as the reference's production run, on the
    production mesh (``launch/mesh.py``): parameters, optimizer state and
    batch placed by ``ShardingRules`` (``launch/steps.py``), one
    microbatch, as there;
  * with no process group, on one device, the batch split into
    microbatches of ``MICROBATCH_ROWS`` rows (``ExecConfig.microbatches``).

``--multi-pod`` in a world of another size raises and names the size it
needs.  Every family trains, the encoder/decoder and VLM batches carrying
the frames or patch embeddings ``make_batch`` draws, as device tensors
beside the tokens.  On one card the step is captured
(``launch/train_graphs.py``), as the reference jits it: the first step
runs eagerly as the warm-up, the second captures the step on the
parameters and state it is handed (after any ``--resume``) and every
step from then on is one copy of the batch into the graph's buffers and
one replay; a failed capture or replay raises.  The CPU and the sharded
step run eagerly.  Each step ends in a sync of the card, and its time
goes to the ``faasm_train_step_ms`` histogram and a ``train.step`` span.
The full width on one card at a cut batch is ``examples/train_lm_torch.py``.
"""
from __future__ import annotations

import argparse
import math
from typing import List, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_shape, smoke_config, smoke_shape
from repro_torch.data import PipelineConfig, make_batch
from repro_torch.kernels.common import resolve_device
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.launch import train_graphs
from repro_torch.launch.steps import make_train_step, place_params
from repro_torch.models import ExecConfig, build_model
from repro_torch.models.weights import trainable
from repro_torch.optim import SGD, AdamW, warmup_cosine
from repro_torch.telemetry import clock as tclock
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import spans as tspans

MICROBATCH_ROWS = 4     # rows of 4,096 tokens per microbatch: ~10 GB at d 1024


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, single device, tiny batch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--optimizer", choices=["sgd", "adamw"], default="sgd")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/train_ckpt_torch")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def to_device(batch, device) -> dict:
    """A numpy batch of ``make_batch`` as tensors on ``device``: the tokens,
    targets and mask, and the frames or patch embeddings (f32, cast by the
    model to its dtype on the device)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv: Optional[List[str]] = None) -> dict:
    """Trains; returns the losses of the steps it ran, the last step's
    parameters and optimizer state, and the step it ran (``step``: on
    one card a :class:`~repro_torch.launch.train_graphs.GraphedTrainStep`)."""
    args = parser().parse_args(argv)
    world, need = world_size(), math.prod(production_shape(args.multi_pod)[0])
    if args.multi_pod and world != need:
        raise ValueError(f"--multi-pod: the 2x16x16 mesh needs a process "
                         f"group of {need} ranks; this run has {world}")
    device = resolve_device(args.device)
    rules = None
    if args.smoke:
        cfg = smoke_config(args.arch)
        shape = smoke_shape("train")
        ec = ExecConfig(loss_chunk=16)
    else:
        cfg = get_config(args.arch)
        shape = get_shape(args.shape)
        if world == need:          # the production mesh, as the reference
            rules = ShardingRules(make_production_mesh(
                multi_pod=args.multi_pod, device_type=device.type), cfg)
            ec = ExecConfig(loss_chunk=512)
        else:
            ec = ExecConfig(loss_chunk=512, microbatches=max(
                1, shape.global_batch // MICROBATCH_ROWS))

    model = build_model(cfg, ec)
    sched = warmup_cosine(args.lr, warmup=max(1, args.steps // 10),
                          total=args.steps)
    opt = SGD(lr=sched) if args.optimizer == "sgd" else AdamW(lr=sched)
    ck = Checkpointer(args.ckpt_dir, keep=2)

    print(f"train {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{shape.name}, opt={args.optimizer}")

    step_fn = make_train_step(model, opt, shape, rules)
    if rules is None:              # one device: the captured step on the card
        step_fn = train_graphs.for_device(step_fn, device)
    params = trainable(model.init(
        torch.Generator(device=device).manual_seed(0), device))
    state = opt.init(params)
    start = 0
    if args.resume and ck.latest_step() is not None:
        (params, state), start, _ = ck.restore((params, state))
        print(f"resumed at step {start}")
    if rules is not None:          # each rank keeps its shards
        params = place_params(params, rules)
        state = type(state)(*(place_params(f, rules) if isinstance(
            f, torch.nn.Module) else f for f in state))

    pc = PipelineConfig(seed=0)
    # step timing flows through the telemetry registry; the printed log
    # reads the histogram back, so it and any scrape agree by construction
    hist = tmetrics.registry().histogram("faasm_train_step_ms")
    tel = tspans.tracer()
    losses = []
    for step in range(start, args.steps):
        s0 = tclock.now()
        batch = to_device(make_batch(cfg, shape, pc, step), device)
        params, state, metrics = step_fn(params, state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        s1 = tclock.now()
        hist.observe((s1 - s0) * 1e3)
        if tel is not None:
            tel.record("train.step", "train", s0, s1, step=step)
        losses.append(metrics["loss"])
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"({hist.sum / 1e3:6.1f}s, "
                  f"p50 {hist.percentile(0.5):5.0f}ms)")
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            ck.save(step, (params, state))
    ck.save(args.steps, (params, state), blocking=True)
    print("done")
    return {"losses": [float(x) for x in losses], "params": params,
            "state": state, "step": step_fn}


if __name__ == "__main__":
    main()
