"""The learner's phase metrics (``learn.gram_ms``, ``learn.step_rest_ms``):
their readers on a hand-made record, silent where the program keeps no
such phase, and on the card the learner trace that they read. Run
``python3 -m pytest portbench/tests -m cuda`` on a card."""
from __future__ import annotations

import pytest

from conftest import REPO
from portbench import run
from portbench.record import RunRecord

PHASES = ("learn.gram_ms", "learn.step_rest_ms")


def _record(trace):
    return RunRecord(cell={}, config={}, traffic={}, setup_s=1.0,
                     window_s=10.0, steps=3, learn_trace=trace)


@pytest.mark.parametrize("metric,key", zip(PHASES, ("gram_ms",
                                                    "step_rest_ms")))
def test_phase_reader_is_the_median_over_steps(metric, key):
    read = run.reader(REPO, metric)
    assert read(_record({key: [120.0, 100.0, 160.0, 1.0]})) == 110.0
    # a program without the phase's marks: nothing to read, no raise
    assert read(_record({"d_pass_ms": [350.0]})) is None
    assert read(_record(None)) is None


@pytest.mark.cuda
def test_learner_trace_carries_the_phases_on_the_card(card):
    import numpy as np

    from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
    from ccsc_code_iccv2017_torch.parallel import consensus

    b = np.random.default_rng(0).random((2 * 3, 20, 20), np.float32)
    res = consensus.learn(
        b, ProblemGeom((11, 11), 16),
        LearnConfig(num_blocks=2, max_it=3, tol=0.0, verbose="none"),
        device=card)
    tr = res.trace
    steps = len(tr["tim_vals"]) - 1
    assert steps == 3
    for key in ("d_pass_ms", "z_pass_ms", "gram_ms", "step_rest_ms"):
        assert len(tr[key]) == steps and min(tr[key]) > 0, key
    assert all(g < d for g, d in zip(tr["gram_ms"], tr["d_pass_ms"]))
