"""Quickstart: a tour of the FAASM public API, on the PyTorch port.

Twin of ``examples/quickstart.py``: the same tour and the same printed
lines, through the port's runtime, whose state tiers live on the card
unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]
"""
import argparse

import numpy as np

from repro_torch.core import FaasmRuntime, FunctionDef, chain, await_all, outputs
from repro_torch.kernels.common import resolve_device
from repro_torch.state.ddo import Counter, VectorAsync


def main(argv=None) -> dict:
    """Runs the tour; returns ``rc``, ``output`` (the orchestrator's bytes),
    ``final`` (the accumulated vector) and ``transfer_bytes``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    # 1. A cluster of two runtime instances (hosts), Faaslet isolation.
    rt = FaasmRuntime(n_hosts=2, capacity=4, device=device)

    # 2. State lives in the two-tier store: authoritative in the global tier,
    #    zero-copy shared replicas in each host's local tier.
    VectorAsync.create(rt.global_tier, "acc", np.zeros(8, np.float32))

    # 3. Functions interact with the world only through the host interface.
    def worker(api):
        i = int.from_bytes(api.read_call_input(), "little")
        vec = VectorAsync(api, "acc")          # maps a shared memory region
        vec.pull(track_delta=True)
        vec.add([i % 8], [float(i)])           # HOGWILD-style direct write
        vec.push_delta()                       # accumulate into the global tier
        Counter(api, "done").increment()
        api.write_call_output(f"worker-{i} ok".encode())
        return 0

    def orchestrator(api):
        ids = chain(api, "worker", [i.to_bytes(2, "little") for i in range(8)])
        codes = await_all(api, ids)
        assert all(c == 0 for c in codes)
        api.write_call_output(b"; ".join(outputs(api, ids)))
        return 0

    # 4. Upload = validate + codegen + Proto-Faaslet snapshot (§3.4, §5.2).
    rt.upload(FunctionDef("worker", worker))
    rt.upload(FunctionDef("orchestrator", orchestrator))

    # 5. Invoke and chain.
    cid = rt.invoke("orchestrator")
    rc = rt.wait(cid, timeout=60)
    print("return code:", rc)
    output = rt.output(cid)
    print("output:", output.decode())

    final = np.frombuffer(rt.global_tier.get("acc", host="main"), np.float32)
    print("accumulated state:", final)
    print("cold-start stats:", rt.cold_start_stats())
    transfer = rt.transfer_bytes()
    print("transfer bytes:", transfer)
    print("billable GB-s:", f"{rt.billable_gb_seconds():.2e}")
    rt.shutdown()
    assert rc == 0 and final[1] == 1.0
    print("quickstart OK")
    return {"rc": rc, "output": output, "final": final,
            "transfer_bytes": transfer}


if __name__ == "__main__":
    main()
