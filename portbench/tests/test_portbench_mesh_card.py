"""On four cards: the mesh cell's command, as the benchmark runs it, for a
short window, traced; its control fails. Skipped without four cards.

    python3 -m pytest portbench/tests/test_portbench_mesh_card.py -m cuda
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO

CELL = "learn2d-weak-mesh4"
MESH_METRICS = {"mesh.allreduce_ms.mesh4", "mesh.rank_skew_ms.mesh4",
                "mesh.wire_mb.mesh4", "device.idle_pct.mesh4"}


@pytest.fixture
def four_cards():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards")


def _cell(seed, control=0, trace=0):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELL,
         "--seed", str(seed), "--seconds", "10", "--trace", str(trace),
         "--control", str(control)],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.cuda
def test_mesh_cell_on_four_cards(four_cards):
    r, err = _cell(2 ** 31 + 201, trace=1)
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 4 and r["device"]["busy_s"] > 0
    assert MESH_METRICS <= set(r["metrics"])
    # rank 0's NCCL kernels, named on standard error
    assert "AllReduce" in err.split("rank 0 collective kernels")[1]


@pytest.mark.cuda
def test_mesh_control_on_four_cards(four_cards):
    r, _ = _cell(2 ** 31 + 203, control=1)
    assert not r["correct"], r["checks"]
