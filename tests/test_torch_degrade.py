"""The out-of-memory downgrade ladder of the learner CLIs
(``apps/_common.py::dispatch_learn(auto_degrade=True)``), the port of
the JAX package's ``apps/_dispatch.py`` ladder, on the CPU: the port's
versions of ``tests/test_supervised.py``'s ladder tests, with
``torch.OutOfMemoryError`` standing in for ``RESOURCE_EXHAUSTED``.

The ladder steps donate, chunk (at runtime), streaming, as JAX's does
(the chunked driver runs since the knobs slice). The records
(``degrade`` with rung, stage and the estimate or the error;
``mem_oom_dump``) and ``trace['degrades']`` are JAX's."""
import dataclasses
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.apps import _dispatch as jdispatch
from ccsc_code_iccv2017_tpu.config import LearnConfig as JCfg
from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.utils import perfmodel as jperf
from ccsc_code_iccv2017_torch.apps import _common
from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.parallel import consensus
from ccsc_code_iccv2017_torch.utils import obs, perfmodel

GEOM = ((3, 3), 4)
KW = dict(max_it=2, max_it_d=2, max_it_z=2, num_blocks=2, rho_d=50.0,
          rho_z=2.0, tol=0.0, verbose="none", track_objective=True)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for v in ("CCSC_INMEM_HBM_GB", "CCSC_MEM_DUMP_DIR"):
        monkeypatch.delenv(v, raising=False)


def _data(seed=1, n=4, side=12):
    return np.random.default_rng(seed).standard_normal(
        (n, side, side)).astype(np.float32)


def _oom(msg="CUDA out of memory. Tried to allocate 2.00 GiB (simulated)"):
    return torch.OutOfMemoryError(msg)


def _dispatch(b, cfg, **kw):
    return _common.dispatch_learn(b, ProblemGeom(*GEOM), cfg, 0, "cpu",
                                  **kw)


def _degrade_records(mdir):
    return [e for e in obs.read_events(mdir) if e["type"] == "degrade"]


def test_runtime_ladder_steps_to_streaming(monkeypatch, tmp_path):
    """Every in-memory attempt raises torch.OutOfMemoryError: the
    ``dispatch`` downgrades donate, chunk and streaming, JAX's rungs,
    recorded in the stream and in trace['degrades']; the run is the
    streaming learner's."""
    seen = []

    def oom_learn(b, geom, cfg, **kw):
        seen.append(cfg)
        raise _oom()

    monkeypatch.setattr(consensus, "learn", oom_learn)
    mdir = str(tmp_path / "m")
    res = _dispatch(_data(), LearnConfig(**KW, metrics_dir=mdir,
                                         outer_chunk=2),
                    auto_degrade=True)
    rungs = [("donate", "dispatch"), ("chunk", "dispatch"),
             ("streaming", "dispatch")]
    assert [(d["rung"], d["stage"]) for d in res.trace["degrades"]] == rungs
    assert "out of memory" in res.trace["degrades"][0]["error"]
    assert [(c.donate_state, c.outer_chunk) for c in seen] == [
        (False, 2), (True, 2), (True, 1)]
    assert res.trace["algorithm"] == "consensus_streaming"
    assert len(res.trace["obj_vals_z"]) == KW["max_it"] + 1
    recs = _degrade_records(mdir)
    assert [(e["rung"], e["stage"]) for e in recs] == rungs
    # JAX's ladder on the same OOM reaches streaming after its rungs
    jseen = []

    def joom(b, geom, cfg, **kw):
        jseen.append(cfg)
        raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory (simulated)")

    import ccsc_code_iccv2017_tpu.models.learn as jlearn

    monkeypatch.setattr(jlearn, "learn", joom)
    jres = jdispatch.dispatch_learn(
        _data(), JGeom(*GEOM), JCfg(**KW, outer_chunk=2),
        jax.random.PRNGKey(0), None, streaming=False, auto_degrade=True)
    assert [d["rung"] for d in jres.trace["degrades"]] == [
        r for r, _ in rungs]
    assert jres.trace["algorithm"] == res.trace["algorithm"]


def test_preflight_steps_to_streaming(monkeypatch, tmp_path):
    """A preflight estimate above CCSC_INMEM_HBM_GB steps down before any
    in-memory state exists; the record carries JAX's estimate and
    budget."""
    monkeypatch.setenv("CCSC_INMEM_HBM_GB", "1e-9")

    def never(*a, **kw):
        raise AssertionError("the in-memory learner ran")

    monkeypatch.setattr(consensus, "learn", never)
    mdir = str(tmp_path / "m")
    res = _dispatch(_data(), LearnConfig(**KW, metrics_dir=mdir),
                    auto_degrade=True)
    degs = res.trace["degrades"]
    assert [(d["rung"], d["stage"]) for d in degs] == [
        ("donate", "preflight"), ("streaming", "preflight")]
    jres = jdispatch.dispatch_learn(
        _data(), JGeom(*GEOM), JCfg(**KW), jax.random.PRNGKey(0), None,
        streaming=False, auto_degrade=True)
    # JAX's rungs, with the same estimates and budget
    assert [(d["rung"], d["est_gb"], d["budget_gb"]) for d in degs] == [
        (d["rung"], d["est_gb"], d["budget_gb"])
        for d in jres.trace["degrades"]]
    assert res.trace["algorithm"] == "consensus_streaming"
    assert [(e["rung"], e["est_gb"], e["budget_gb"])
            for e in _degrade_records(mdir)] == [
        (d["rung"], d["est_gb"], d["budget_gb"]) for d in degs]


def test_streaming_rung_refuses_a_foreign_checkpoint(monkeypatch, tmp_path):
    """An in-memory learner's checkpoint cannot be resumed by the
    streaming learner: the ladder stops and the original OOM surfaces."""
    b, ck = _data(), str(tmp_path / "ck")
    consensus.learn(b, ProblemGeom(*GEOM), LearnConfig(**dict(KW, max_it=1)),
                    device="cpu", checkpoint_dir=ck, checkpoint_every=1)

    def oom_learn(*a, **kw):
        raise _oom()

    monkeypatch.setattr(consensus, "learn", oom_learn)
    with pytest.raises(torch.OutOfMemoryError):
        _dispatch(b, LearnConfig(**KW), auto_degrade=True,
                  checkpoint_dir=ck, checkpoint_every=1)


@pytest.mark.parametrize("where", ["fits", "between"])
def test_preflight_stops_when_the_run_fits(monkeypatch, where):
    """A budget above the estimate keeps the in-memory run, with no
    record. Between the donated and plain estimates both packages stop
    at the donate rung, in memory."""
    b = _data()
    cfg = LearnConfig(**dict(KW, max_it=1))
    est, _ = perfmodel.inmem_learn_estimate(b.shape, ProblemGeom(*GEOM), cfg,
                                            device="cpu")
    jest_don, _ = jperf.inmem_learn_estimate(
        b.shape, JGeom(*GEOM), JCfg(**dict(KW, max_it=1), donate_state=True))
    assert jest_don < est == jperf.inmem_learn_estimate(
        b.shape, JGeom(*GEOM), JCfg(**dict(KW, max_it=1)))[0]
    budget = est + 1 if where == "fits" else jest_don + 1
    monkeypatch.setenv("CCSC_INMEM_HBM_GB", str(budget / 1e9))
    res = _dispatch(b, cfg, auto_degrade=True)
    jres = jdispatch.dispatch_learn(
        b, JGeom(*GEOM), JCfg(**dict(KW, max_it=1)), jax.random.PRNGKey(0),
        None, streaming=False, auto_degrade=True)
    if where == "fits":
        assert "degrades" not in res.trace and "degrades" not in jres.trace
        assert res.trace["algorithm"] == jres.trace["algorithm"] == \
            "consensus"
    else:
        assert [d["rung"] for d in jres.trace["degrades"]] == ["donate"]
        assert [d["rung"] for d in res.trace["degrades"]] == ["donate"]
        assert res.trace["algorithm"] == "consensus"


def test_a_custom_solver_takes_the_runtime_rung_only(monkeypatch):
    """The masked learner (a custom solver) gets no preflight and no
    streaming rung: after its donate rung an OOM it raises surfaces, as
    in JAX once donate is spent."""
    calls = []

    def flaky(b, geom, cfg, **kw):
        calls.append(cfg)
        raise _oom()

    monkeypatch.setenv("CCSC_INMEM_HBM_GB", "1e-9")  # no preflight anyway
    with pytest.raises(torch.OutOfMemoryError):
        _dispatch(_data(), LearnConfig(**KW), solver=flaky,
                  auto_degrade=True)
    assert [c.donate_state for c in calls] == [False, True]


def test_a_late_oom_with_progress_raises(tmp_path):
    """An OOM after iterations completed, with no checkpoint dir to
    resume from, surfaces instead of restarting the learn."""
    mdir = tmp_path / "m"

    def late(b, geom, cfg, **kw):
        w = obs.EventWriter(str(mdir / "events-p00000.jsonl"))
        w.write({"t": time.time(), "type": "step", "it": 5, "host": 0})
        w.close()
        raise _oom("CUDA out of memory. late fragmentation")

    with pytest.raises(torch.OutOfMemoryError, match="late"):
        _dispatch(_data(), LearnConfig(**KW, metrics_dir=str(mdir)),
                  solver=late, auto_degrade=True)
    assert jdispatch._retry_discards_progress(str(mdir), None, 0.0) is True
    assert _common._retry_discards_progress(str(mdir), None, 0.0) is True
    assert _common._retry_discards_progress(str(mdir), "ck", 0.0) is False


def test_with_the_ladder_off_the_error_is_raised(monkeypatch):
    def oom_learn(*a, **kw):
        raise _oom()

    monkeypatch.setattr(consensus, "learn", oom_learn)
    with pytest.raises(torch.OutOfMemoryError):
        _dispatch(_data(), LearnConfig(**KW))
    # and an error that is no OOM is never retried
    def boom(*a, **kw):
        raise ValueError("not a memory failure")

    monkeypatch.setattr(consensus, "learn", boom)
    with pytest.raises(ValueError):
        _dispatch(_data(), LearnConfig(**KW), auto_degrade=True)


def test_oom_forensic_dump_and_its_record(monkeypatch, tmp_path):
    """The OOM leaves utils.memwatch's forensic dump beside the stream
    and a ``mem_oom_dump`` record in the dispatch events file, whatever
    the ladder decides."""
    def oom_learn(*a, **kw):
        raise _oom()

    monkeypatch.setattr(consensus, "learn", oom_learn)
    mdir = str(tmp_path / "m")
    _dispatch(_data(), LearnConfig(**KW, metrics_dir=mdir),
              auto_degrade=True)
    assert os.path.exists(os.path.join(mdir, "events-p00000-dispatch.jsonl"))
    # one dump an OOM: the plain attempt's and the donate rung's
    dumps = [e for e in obs.read_events(mdir) if e["type"] == "mem_oom_dump"]
    assert len(dumps) == 2
    for rec in dumps:
        assert os.path.dirname(rec["path"]) == mdir
        with open(rec["path"]) as f:
            dump = json.load(f)
        assert dump["error"].startswith(
            "OutOfMemoryError: CUDA out of memory")
        assert "devices" in dump
    # the records are JAX's: every field JAX's schema requires
    from ccsc_code_iccv2017_tpu.analysis import obs_schema as jschema

    for e in obs.read_events(mdir):
        if e["type"] in ("degrade", "mem_oom_dump"):
            assert jschema.required_fields(e["type"]) <= set(e)


def test_rungs_the_port_refuses_are_passed_over():
    """No rung is passed over since the knobs slice: donate, chunk
    (runtime only), streaming, JAX's order."""
    cfg = LearnConfig(**KW, outer_chunk=2)
    new, streaming, name = _common._next_rung(cfg, False, None, None, None,
                                              {}, runtime=True)
    assert (new.donate_state, new.outer_chunk, streaming, name) == (
        True, 2, False, "donate")
    assert _common._next_rung(new, False, None, None, None, {}) [2] == \
        "streaming"  # the preflight never takes the chunk rung
    new, streaming, name = _common._next_rung(new, False, None, None, None,
                                              {}, runtime=True)
    assert (new.donate_state, new.outer_chunk, streaming, name) == (
        True, 1, False, "chunk")
    new, streaming, name = _common._next_rung(new, False, None, None, None,
                                              {}, runtime=True)
    assert (new.donate_state, streaming, name) == (False, True, "streaming")
    cfg = dataclasses.replace(cfg, donate_state=True, outer_chunk=1)
    assert _common._next_rung(cfg, True, None, None, None, {}) is None
    assert _common._next_rung(cfg, False, object(), None, None, {}) is None
    assert _common._next_rung(cfg, False, None, None, {"--x": 1}, {}) is None
    assert _common._next_rung(cfg, False, None, None, None,
                              {"init_d": np.zeros(3)}) is None
