"""The command itself on a card: every cell of ``BENCHMARK.json`` for a
short window, its last line ``correct``.  Needs an NVIDIA GPU; skips
without one (``-m gpu`` selects it)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench.harness.spec import ROOT, Spec


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"]
                                  for w in Spec().bm["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload", cell,
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
