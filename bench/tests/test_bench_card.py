"""A short run of every cell on the card: it prints one result line whose
``correct`` is true.  Marked ``cuda``: it skips without a card (decided
in the fixture) and runs there with ``pytest -m cuda bench/tests``."""
import json
import subprocess
import sys

import pytest

from bench.harness import BENCH, ROOT, load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell_is_correct_on_the_card(card, cell):
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        cell, "--seed", "2147483647", "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
