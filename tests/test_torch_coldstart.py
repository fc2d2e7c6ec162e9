"""The Tab. 3 / Fig. 10 twin (``benchmarks/bench_coldstart_torch.py``)
against the reference's ``benchmarks/bench_coldstart.py`` on the CPU.

The copy and wire accounting run in both packages at the reference's
sizes (a 4 MB key), the port's tiers on ``device="cpu"``: the bytes the
zero-copy plane and its emulated predecessor copy, the bytes a push and a
refresh move per wire, the int8 wire's share and the residual's cap are
equal.  The broadcast row races the tier's fan-out pump against the
refresh right after each push (in both packages); it is held with the
frames to the subscriber dropped (``wire-frame-drop``), where every
refresh delta-pulls one int8 frame.  ``main`` writes its JSON files under
the directory it is given, and the root's ``BENCH_*.json`` stay as they
are.
"""
import hashlib
import importlib
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in the test process)
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import bench_coldstart as ref  # noqa: E402
from benchmarks import bench_coldstart_torch as twin  # noqa: E402
from torch_twin_planes import port_planes_disarmed  # noqa: E402,F401

INT8_FRAME = (1 << 20) + (1 << 20) // 128 * 4   # 1 Mi codes + a scale a row


def test_state_copies_equal_the_references():
    want, got = ref._bench_state_copies(), twin._bench_state_copies("cpu")
    for k in ("value_mb", "new_bytes_copied", "new_full_value_copies",
              "old_bytes_copied", "old_full_value_copies"):
        assert got[k] == want[k], k
    assert got["new_full_value_copies"] == 1.0


def test_push_wire_equals_the_references():
    want, got = ref._bench_push_wire(), twin._bench_push_wire("cpu")
    assert got["wire_ratio"] == want["wire_ratio"]
    for wire in ("exact", "int8"):
        for k in ("value_mb", "pushes", "bytes_moved_per_push",
                  "residual_max"):
            assert got[wire][k] == want[wire][k], (wire, k)
        assert got[wire]["launches"] == {"quantize_delta": 0,
                                         "apply_delta": 0}
    assert got["int8"]["bytes_moved_per_push"] == INT8_FRAME
    assert 0 < got["int8"]["residual_max"] < 1e-3


def _dropping_frames_to(pkg: str, host: str):
    faults = importlib.import_module(f"{pkg}.faults")
    return faults.armed(faults.FaultPlan().add(
        "wire-frame-drop", host=host, times=1 << 20))


def test_pull_wire_equals_the_references():
    with _dropping_frames_to("repro", "q"):
        want = ref._bench_pull_wire()
    with _dropping_frames_to("repro_torch", "q"):
        got = twin._bench_pull_wire("cpu")
    assert got["pull_ratio_int8_vs_full"] == want["pull_ratio_int8_vs_full"]
    for mode in ("full", "exact", "int8", "broadcast"):
        for k in ("value_mb", "rounds", "pull_bytes_per_refresh",
                  "broadcast_bytes", "replica_vs_global_maxerr"):
            assert got[mode][k] == want[mode][k], (mode, k)
    assert got["full"]["pull_bytes_per_refresh"] == 4 << 20
    assert got["int8"]["pull_bytes_per_refresh"] == INT8_FRAME
    # the reference's row, 1,081,344: each refresh pulls one int8 frame
    assert got["broadcast"]["pull_bytes_per_refresh"] == INT8_FRAME
    assert got["broadcast"]["broadcast_bytes"] == 10 * INT8_FRAME


def test_broadcast_refresh_moves_at_most_one_frame():
    """Unforced, the race gives each refresh zero bytes (the broadcast
    landed first) or one int8 frame, in either package."""
    for rows in (ref._bench_pull_wire(), twin._bench_pull_wire("cpu")):
        moved = rows["broadcast"]["pull_bytes_per_refresh"] * 10
        assert moved % INT8_FRAME == 0 and 0 <= moved <= 10 * INT8_FRAME


def _digests() -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(REPO.glob("BENCH_*.json"))}


def test_main_writes_only_under_its_directory(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.chdir(REPO)
    before = _digests()
    out = tmp_path / "bench"
    res = twin.main("cpu", out)
    rows = [line.split(",", 1)[0] for line in capsys.readouterr().out
            .splitlines() if not line.startswith("#")]
    assert _digests() == before and before
    assert sorted(p.name for p in out.iterdir()) == [
        "BENCH_faults.json", "BENCH_pull.json", "BENCH_push.json",
        "BENCH_state.json"]
    assert [p for p in tmp_path.iterdir()] == [out]
    tables = {r.split("/")[0] for r in rows}
    assert tables == {"tab3_init_torch", "tab3_mem_torch", "fig10_churn_torch",
                      "state_copy_torch", "state_push_torch",
                      "state_pull_torch", "faults_torch"}
    assert set(res) == {"cow_reset", "state_plane", "push", "pull", "faults"}
    assert res["state_plane"]["new_full_value_copies"] == 1.0


def test_trace_writes_the_codec_curve_under_its_directory(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    monkeypatch.chdir(REPO)
    before = _digests()
    tr = twin.run_trace("cpu", tmp_path)
    assert _digests() == before
    assert [p.name for p in tmp_path.iterdir()] == ["BENCH_codec.json"]
    assert tr["value_kb"] == [64, 256, 1024, 4096]
    assert any(line.startswith("codec_torch/encode_int8_")
               for line in capsys.readouterr().out.splitlines())
