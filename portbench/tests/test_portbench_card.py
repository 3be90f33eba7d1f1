"""On the card: each cell's command, as the driver runs it, for a short
window; its control fails. Skipped without a card.

    python3 -m pytest portbench/tests -m cuda
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO, load

CELLS = [w["name"] for w in load("BENCHMARK.json")["workloads"]
         if w["chips"] == 1]


def _cell(name, seed, control=0, trace=0):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", str(seed), "--seconds", "5", "--trace", str(trace),
         "--control", str(control)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    r = _cell(name, 2 ** 31 + 101, trace=1)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name):
    r = _cell(name, 2 ** 31 + 103, control=1)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_learner_half_batch_fault_on_the_card(card, monkeypatch):
    """The learner's step with half of each block's images left out, at
    the cell's own size: ``correct`` comes out false."""
    import time

    from ccsc_code_iccv2017_torch.parallel import consensus
    from portbench import run

    real = consensus.learn_mod.outer_step

    def half(state, b_blocks, *a, **kw):
        kept = b_blocks.clone()
        kept[:, kept.shape[1] // 2:] = 0
        return real(state, kept, *a, **kw)

    monkeypatch.setattr(consensus.learn_mod, "outer_step", half)
    r = run.run_cell("learn2d-northstar", 2 ** 31 + 107, 10.0, False,
                     max_steps=4, t_start=time.perf_counter())
    assert not r["correct"], r["checks"]
