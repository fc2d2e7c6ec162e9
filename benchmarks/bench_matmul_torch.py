"""Paper Fig. 8 on the PyTorch port: chained divide-and-conquer matmul —
duration + transfer.  Twin of ``benchmarks/bench_matmul.py`` (the same
sizes and modes, rows named ``fig8_matmul_torch/...``); the block products
stay numpy, the runtime and its state tiers are the port's, on the card
unless ``--device cpu``.

Run:  PYTHONPATH=src:. python benchmarks/bench_matmul_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from benchmarks.common import emit
from repro_torch.core import FaasmRuntime, FunctionDef, chain, await_all
from repro_torch.kernels.common import resolve_device
from repro_torch.state.ddo import MatrixReadOnly


def run_matmul(n: int, splits: int, mode: str, device="cuda") -> dict:
    rng = np.random.default_rng(0)
    B = rng.standard_normal((n, n)).astype(np.float32)
    C = rng.standard_normal((n, n)).astype(np.float32)
    blk = n // splits
    rt = FaasmRuntime(n_hosts=2, capacity=4, isolation=mode, device=device)
    try:
        MatrixReadOnly.create(rt.global_tier, "B", B)
        MatrixReadOnly.create(rt.global_tier, "C", C)

        def multiply_block(api):
            i, j = np.frombuffer(api.read_call_input(), np.int32)
            c_cols = MatrixReadOnly(api, "C").columns(j * blk, (j + 1) * blk)
            b_full = np.frombuffer(bytes(api.get_state("B", writable=False)),
                                   np.float32).reshape(n, n, order="F")
            out = b_full[i * blk:(i + 1) * blk, :] @ c_cols
            api.runtime.global_tier.set(f"out/{int(i)}_{int(j)}", out.tobytes(),
                                        host=api.host.id)
            return 0

        def matmul_main(api):
            calls = [np.asarray([i, j], np.int32).tobytes()
                     for i in range(splits) for j in range(splits)]
            cids = chain(api, "multiply_block", calls)
            assert all(r == 0 for r in await_all(api, cids))
            return 0

        rt.upload(FunctionDef("multiply_block", multiply_block,
                              memory_limit=1 << 26))
        rt.upload(FunctionDef("matmul_main", matmul_main, memory_limit=1 << 26))
        rt.global_tier.reset_metrics()
        t0 = time.perf_counter()
        cid = rt.invoke("matmul_main")
        rc = rt.wait(cid, timeout=300)
        wall = time.perf_counter() - t0
        assert rc == 0, rt.call(cid).error
        return {"wall_s": wall, "transfer_mb": rt.transfer_bytes() / 1e6}
    finally:
        rt.shutdown()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    for n in (128, 256):
        for mode in ("faaslet", "container"):
            r = run_matmul(n, 2, mode, device=device)
            emit(f"fig8_matmul_torch/{mode}/n{n}/wall", r["wall_s"] * 1e6,
                 f"transfer={r['transfer_mb']:.2f}MB")


if __name__ == "__main__":
    main()
