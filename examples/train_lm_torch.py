"""End-to-end LM training driver on the PyTorch/CUDA port: data pipeline ->
train step -> checkpoint/restart, on any --arch of the port's registry.

Twin of ``examples/train_lm.py``, with its flags and output lines, plus
``--device``: the CUDA card by default (raises without one), the CPU
only when named.  On the card it is the full-width run: ``--arch
qwen1.5-0.5b --seq 4096 --batch 4`` trains the whole 0.46 B-parameter
model at train_4k's sequence length, its batch cut from 256 to 4
(``chip_smoke.py`` runs it so, and so ``--arch mamba2-130m`` and
``--arch zamba2-1.2b``, whose Mamba layers run the SSD scan kernel K8 in
the forward and the plain chunked scan in the backward, ``--arch
whisper-tiny``, ``internvl2-2b`` and ``qwen3-4b``: the encoder/decoder
batch carries 1,500 frames a row and the VLM's 256 patch embeddings
ahead of 3,840 text tokens, every attention call through K5; and
``--arch granite-3-8b`` and ``starcoder2-7b`` at their full 8.2 B and
7.4 B parameters, whose weights, gradients and activations fit one
80 GB card since the SGD update holds no f32 copy of the model).  On the
card the step is captured as a CUDA graph, as the reference jits it
(``repro_torch.launch.train_graphs``): step 0 runs eagerly as the
warm-up, the next step captures it (after any ``--resume``) and replays,
and every later step is one copy of the batch and one replay; a failed
capture or replay raises.  The CPU runs the step eagerly.  Each step
ends in a sync of the card; checkpoints are the reference's layout, so
either script resumes the other's.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --smoke --device cpu
      PYTHONPATH=src python examples/train_lm_torch.py --arch qwen1.5-0.5b \\
          --seq 4096 --batch 4 --steps 8
"""
import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import PipelineConfig, make_batch
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import train_graphs
from repro_torch.launch.train import to_device
from repro_torch.models import ExecConfig, build_model
from repro_torch.models.weights import trainable
from repro_torch.optim import SGD, warmup_cosine


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--ckpt-dir", default="artifacts/train_lm_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def make_step(model, opt):
    """The example's train step: step(params, state, batch) -> (params,
    state, loss), the parameters and the optimizer state updated in place
    (what ``train_graphs.for_device`` captures on the card)."""

    def train_step(params, state, batch):
        (loss, metrics) = model.loss(params, batch)
        ps = list(params.parameters())
        grads = torch.autograd.grad(loss, ps)
        names = [n for n, _ in params.named_parameters()]
        params, state = opt.update(dict(zip(names, grads)), state, params)
        return params, state, loss.detach()

    return train_step


def main(argv=None) -> dict:
    """Trains; returns the config, each step's loss (tensors on the device)
    and host seconds (ending in a sync of the card), the parameters and
    the optimizer state after the last step, and the step it ran
    (``step``: on the card a
    :class:`~repro_torch.launch.train_graphs.GraphedTrainStep`)."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        cfg = smoke_config(args.arch)
        args.steps = min(args.steps, 40)
        args.seq = min(args.seq, 64)
    else:
        cfg = get_config(args.arch)
        over = {}
        if args.d_model:
            over.update(d_model=args.d_model,
                        n_heads=max(4, args.d_model // 64),
                        n_kv_heads=max(2, args.d_model // 128),
                        head_dim=64, d_ff=args.d_model * 4)
        if args.layers:
            over["n_layers"] = args.layers
        if args.vocab:
            over["vocab_size"] = args.vocab
        if over:
            cfg = cfg.with_overrides(name=cfg.name + "-custom", **over)

    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")

    shape = ShapeConfig("train_custom", "train", args.seq, args.batch)
    model = build_model(cfg, ExecConfig(loss_chunk=min(args.seq, 128)))
    opt = SGD(lr=warmup_cosine(args.lr, warmup=args.steps // 10 + 1,
                               total=args.steps))
    ck = Checkpointer(args.ckpt_dir, keep=2)

    params = trainable(model.init(
        torch.Generator(device=device).manual_seed(0), device))
    state = opt.init(params)
    start_step = 0
    if args.resume and ck.latest_step() is not None:
        (params, state), start_step, _ = ck.restore((params, state))
        print(f"resumed from step {start_step}")

    step_fn = train_graphs.for_device(make_step(model, opt), device)
    pc = PipelineConfig(seed=0)
    t0 = time.perf_counter()
    tokens_done = 0
    losses, step_s = [], []
    for step in range(start_step, args.steps):
        s0 = time.perf_counter()
        batch = to_device(make_batch(cfg, shape, pc, step), device)
        params, state, loss = step_fn(params, state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - s0)
        losses.append(loss)
        tokens_done += shape.tokens_per_step
        if step % 10 == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {step:4d}  loss {float(loss):7.4f}  "
                  f"{tokens_done / max(dt, 1e-9):9.0f} tok/s")
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            ck.save(step, (params, state), extra={"loss": float(loss)})
    ck.save(args.steps, (params, state), blocking=True,
            extra={"loss": float(loss)})
    print(f"done in {time.perf_counter() - t0:.1f}s; "
          f"checkpoints at {args.ckpt_dir} (latest step {ck.latest_step()})")
    return {"cfg": cfg, "losses": losses, "step_s": step_s,
            "params": params, "state": state, "step": step_fn}


if __name__ == "__main__":
    main()
