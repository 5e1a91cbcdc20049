"""The benchmark's command on a CUDA card; skips without one. On a
machine with a card: ``python -m pytest benchmark/tests -q -m cuda``."""

import json
import subprocess
import sys

import pytest

from benchmark import manifest
from benchmark.manifest import ROOT

CELLS = [c["name"] for c in manifest.load()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell_name", CELLS)
def test_cell_runs_and_reads_correct(card, cell_name, trace):
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell_name,
         "--seed", str(2**31 + 11 + trace), "--seconds", "5", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
        assert "device_idle_pct" in line["metrics"]
