"""On the card: one short run of each cell prints a correct result line.
Run there with ``python -m pytest benchmark/tests -m gpu -q``."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import core


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in core.manifest()["workloads"]])
def test_short_run_on_the_card(card, cell):
    proc = subprocess.run([sys.executable, str(core.BENCH / "run.py"), "--workload", cell,
                           "--seed", "4242", "--seconds", "5", "--trace", "0"],
                          capture_output=True, text=True, cwd=core.ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
