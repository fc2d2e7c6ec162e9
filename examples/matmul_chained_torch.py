"""Distributed divide-and-conquer matmul with chained Faaslets (paper §6.4),
on the PyTorch port.

Twin of ``examples/matmul_chained.py``: A = B @ C split into an s×s grid of
block multiplications, each a chained serverless function reading its input
blocks from the global tier (only the chunks it needs) and writing its
output block back; a merge function assembles the result.  The block
products stay numpy, as in the reference; the runtime and its state tiers
are the port's, on the card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/matmul_chained_torch.py \
          [--n 256] [--splits 2] [--device cuda|cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core import FaasmRuntime, FunctionDef, chain, await_all
from repro_torch.kernels.common import resolve_device
from repro_torch.state.ddo import MatrixReadOnly


def main(argv=None) -> dict:
    """Runs the example; returns ``out`` (the merged n×n product),
    ``rel_err``, ``wall_s`` and ``transfer_bytes``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--splits", type=int, default=2)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n, s = args.n, args.splits
    blk = n // s
    rng = np.random.default_rng(0)
    B = rng.standard_normal((n, n)).astype(np.float32)
    C = rng.standard_normal((n, n)).astype(np.float32)

    rt = FaasmRuntime(n_hosts=args.hosts, capacity=4, device=device)
    try:
        MatrixReadOnly.create(rt.global_tier, "B", B)
        MatrixReadOnly.create(rt.global_tier, "C", C)

        def multiply_block(api):
            i, j = np.frombuffer(api.read_call_input(), np.int32)
            # column-major DDO: pull only the needed column stripes
            c_cols = MatrixReadOnly(api, "C").columns(j * blk, (j + 1) * blk)
            b_full = np.frombuffer(bytes(api.get_state("B", writable=False)),
                                   np.float32).reshape(n, n, order="F")
            out = b_full[i * blk:(i + 1) * blk, :] @ c_cols
            api.runtime.global_tier.set(f"out/{int(i)}_{int(j)}",
                                        out.tobytes(), host=api.host.id)
            return 0

        def matmul_main(api):
            calls = []
            for i in range(s):
                for j in range(s):
                    calls.append(np.asarray([i, j], np.int32).tobytes())
            cids = chain(api, "multiply_block", calls)
            rcs = await_all(api, cids)
            assert all(r == 0 for r in rcs)
            # merge
            out = np.zeros((n, n), np.float32)
            gt = api.runtime.global_tier
            for i in range(s):
                for j in range(s):
                    blk_ij = np.frombuffer(gt.get(f"out/{i}_{j}",
                                                  host=api.host.id),
                                           np.float32).reshape(blk, blk)
                    out[i * blk:(i + 1) * blk, j * blk:(j + 1) * blk] = blk_ij
            api.write_call_output(out.tobytes())
            return 0

        rt.upload(FunctionDef("multiply_block", multiply_block,
                              memory_limit=1 << 26))
        rt.upload(FunctionDef("matmul_main", matmul_main,
                              memory_limit=1 << 26))

        t0 = time.perf_counter()
        cid = rt.invoke("matmul_main")
        rc = rt.wait(cid, timeout=600)
        wall = time.perf_counter() - t0
        assert rc == 0, rt.call(cid).error
        got = np.frombuffer(rt.output(cid), np.float32).reshape(n, n)
        ref = B @ C
        err = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))
        transfer = rt.transfer_bytes()
        print(f"matmul {n}x{n} via {s * s} chained faaslets: "
              f"{wall:.2f}s  rel-err={err:.2e}  "
              f"transfer={transfer / 1e6:.1f}MB")
        assert err < 1e-5
        print("matmul_chained OK")
        return {"out": got, "rel_err": err, "wall_s": wall,
                "transfer_bytes": transfer}
    finally:
        rt.shutdown()


if __name__ == "__main__":
    main()
