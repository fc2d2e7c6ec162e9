"""Paper Fig. 7 on the PyTorch port: inference serving latency under
cold-start ratios.  Twin of ``benchmarks/bench_inference.py`` (the same
runs and quantities, named ``fig7_infer_torch/...``), on the card unless
``--device cpu``.

Run:  PYTHONPATH=src:. python benchmarks/bench_inference_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

from benchmarks.common import emit


def main(argv=None) -> None:
    from inference_serving_torch import serve
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.common import resolve_device
    from repro_torch.launch.serve import host_leaves
    from repro_torch.models import ExecConfig, build_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = smoke_config("qwen1.5-0.5b")
    model = build_model(cfg, ExecConfig(backend="auto"))
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    leaves = host_leaves(params)

    for mode in ("faaslet", "container"):
        for ratio in (0.0, 0.2):
            r = serve(mode, 16, ratio, model, leaves, device)
            emit(f"fig7_infer_torch/{mode}/cold{int(ratio * 100)}/p50",
                 r["p50_ms"] * 1e3, f"p99={r['p99_ms']:.1f}ms")
            emit(f"fig7_infer_torch/{mode}/cold{int(ratio * 100)}/init",
                 r["init_mean_ms"] * 1e3, "mean cold-start init")


if __name__ == "__main__":
    main()
