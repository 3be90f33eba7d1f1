"""The port's telemetry streams against the JAX package's on the same
inputs, on the CPU: the consensus, masked and streaming learners, the
direct reconstruct and the serving engine, each with ``metrics_dir``.

The consensus learner starts from the JAX init (``convert.py``), so its
step records are held to JAX's at the learner parity tests' tolerances
(tests/test_torch_learn.py: objectives and rel changes rtol 1e-4), the
consensus disagreement at rel 1e-4 and the non-finite count exactly.
Telemetry adds no host read (the same number of ``mesh.agree`` calls,
the step's one read) and changes no bit of the trajectory. The engine's
requests reassemble into complete span trees, its ``stats()`` p99 sits
within one histogram bucket of the exact p99, a forced SLO breach takes
exactly one profiler capture, and the record types are the JAX engine's
on the same requests but for the quality plane (ROADMAP.md Queue 1 item
11) and the compile records (a CPU run of the port builds no kernel
library). The JAX package's own dashboard, ``scripts/obs_report.py``,
renders the port's streams.
"""
import importlib
import importlib.util
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.config import LearnConfig as JCfg
from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.config import ServeConfig as JServeCfg
from ccsc_code_iccv2017_tpu.config import SolveConfig as JSolveCfg
from ccsc_code_iccv2017_tpu.models import learn as jlearn
from ccsc_code_iccv2017_tpu.models import learn_masked as jlm
from ccsc_code_iccv2017_tpu.parallel import streaming as jstreaming
from ccsc_code_iccv2017_tpu.serve import CodecEngine as JEngine
from ccsc_code_iccv2017_tpu.utils import obs as jobs
from ccsc_code_iccv2017_torch import serve
from ccsc_code_iccv2017_torch.config import (
    LearnConfig, ProblemGeom, ServeConfig, SolveConfig,
)
from ccsc_code_iccv2017_torch.models import learn_masked as tlm
from ccsc_code_iccv2017_torch.models import reconstruct as tr
from ccsc_code_iccv2017_torch.parallel import consensus, streaming
from ccsc_code_iccv2017_torch.parallel import mesh as mesh_lib
from ccsc_code_iccv2017_torch.serve import slo
from ccsc_code_iccv2017_torch.utils import obs, trace

from test_torch_learn import (
    GEOM, GOLDEN_KW, _golden_data, _jax_init, _port_state,
)
from test_torch_obs import read_png

jrec = importlib.import_module("ccsc_code_iccv2017_tpu.models.reconstruct")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
# the records every learner run writes, compared by count
LEARN_TYPES = ("run_meta", "step", "roofline", "heartbeat", "summary")


def _by_type(events):
    by = {}
    for e in events:
        by.setdefault(e["type"], []).append(e)
    return by


def _port_learn(b, kw, **extra):
    return consensus.learn(
        b, ProblemGeom(*GEOM), LearnConfig(**kw), device="cpu",
        initial_state=_port_state(_jax_init(b)), **extra,
    )


def test_learner_stream_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("CCSC_OBS_HEARTBEAT_S", "0")
    b = _golden_data()
    kw = dict(GOLDEN_KW, max_it=3)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jlearn.learn(jnp.asarray(b), JGeom(*GEOM), JCfg(**kw, metrics_dir=jd),
                 key=jax.random.PRNGKey(42))
    _port_learn(b, dict(kw, metrics_dir=td))
    jby, tby = _by_type(jobs.read_events(jd)), _by_type(obs.read_events(td))
    for t in LEARN_TYPES:
        assert len(tby[t]) == len(jby[t]), t
    assert tby["run_meta"][0]["algorithm"] == "consensus"
    assert tby["run_meta"][0]["config"]["metrics_dir"] == td
    assert tby["run_meta"][0]["fingerprint"] == \
        jby["run_meta"][0]["fingerprint"]
    assert [s["it"] for s in tby["step"]] == [s["it"] for s in jby["step"]] \
        == [1, 2, 3]
    for ts, js in zip(tby["step"], jby["step"]):
        for k in ("obj_d", "obj_z", "d_diff", "z_diff", "obj_fid", "obj_l1",
                  "consensus_dis"):
            np.testing.assert_allclose(ts[k], js[k], rtol=RTOL, err_msg=k)
        assert ts["nonfinite_z"] == js["nonfinite_z"] == 0
        np.testing.assert_allclose(ts["obj_fid"] + ts["obj_l1"], ts["obj_z"],
                                   rtol=1e-6)
    for roof in tby["roofline"]:
        assert roof["chip"] == "cpu" and roof["bound_it_per_sec"] > 0
        assert {"mfu", "hbm_frac", "roofline_frac"} <= set(roof)
    summ = tby["summary"][-1]
    assert summ["status"] == "ok" and summ["iterations"] == 3
    assert summ["iterations"] == jby["summary"][-1]["iterations"]


def test_telemetry_adds_no_read_and_changes_no_bit(tmp_path, monkeypatch):
    """The step's one host read (``mesh.agree``) carries the telemetry
    scalars: as many calls with ``metrics_dir`` as without, and the
    trajectory is the same bit for bit."""
    calls = []
    real = mesh_lib.agree

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(mesh_lib, "agree", counting)
    b = _golden_data()
    kw = dict(GOLDEN_KW, max_it=3, fused_z=True)
    plain = _port_learn(b, kw)
    n_plain = len(calls)
    traced = _port_learn(b, dict(kw, metrics_dir=str(tmp_path / "m")))
    assert len(calls) - n_plain == n_plain == kw["max_it"]
    for f in ("d", "z", "Dz"):
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f
    for k in ("obj_vals_d", "obj_vals_z", "d_diff", "z_diff"):
        assert plain.trace[k] == traced.trace[k], k


def test_masked_and_streaming_streams_match_jax(tmp_path):
    """The masked and the streaming learners' runs: JAX's algorithm
    names, one step record a step, the summary's iterations (JAX
    tests/test_obs.py:535-583)."""
    r = np.random.default_rng(0)
    out = {}
    b2 = r.normal(size=(2, 12, 12)).astype(np.float32)
    mkw = dict(max_it=3, max_it_d=1, max_it_z=1, verbose="none",
               track_objective=True, tol=0.0)
    jlm.learn_masked(jnp.asarray(b2), JGeom((3, 3), 3),
                     JCfg(**mkw, metrics_dir=str(tmp_path / "jm")),
                     key=jax.random.PRNGKey(0))
    tlm.learn_masked(b2, ProblemGeom((3, 3), 3),
                     LearnConfig(**mkw, metrics_dir=str(tmp_path / "tm")),
                     device="cpu")
    out["masked"] = ("jm", "tm", "masked_admm", 3)
    b4 = r.normal(size=(4, 12, 12)).astype(np.float32)
    skw = dict(max_it=4, max_it_d=1, max_it_z=1, num_blocks=2, rho_d=50.0,
               rho_z=2.0, verbose="none", track_objective=True, tol=0.0)
    jstreaming.learn_streaming(b4, JGeom((3, 3), 3),
                               JCfg(**skw, metrics_dir=str(tmp_path / "js")),
                               key=jax.random.PRNGKey(0))
    streaming.learn_streaming(
        b4, ProblemGeom((3, 3), 3),
        LearnConfig(**skw, metrics_dir=str(tmp_path / "ts")), device="cpu")
    out["streaming"] = ("js", "ts", "consensus_streaming", 4)
    for name, (jd, td, algorithm, steps) in out.items():
        jby = _by_type(jobs.read_events(str(tmp_path / jd)))
        tby = _by_type(obs.read_events(str(tmp_path / td)))
        for by in (jby, tby):
            assert by["run_meta"][0]["algorithm"] == algorithm, name
            assert len(by["step"]) == steps, name
            assert by["summary"][-1]["status"] == "ok"
            assert by["summary"][-1]["iterations"] == steps
        assert len(tby["roofline"]) == steps
        # the masked learner has no cost model (it/s only); the streamed
        # math is the consensus step's
        assert ("mfu" in tby["roofline"][0]) == (name == "streaming")


def test_reconstruct_stream_matches_jax(tmp_path):
    geom = (3, 3), 2
    r = np.random.default_rng(0)
    b = r.normal(size=(1, 10, 10)).astype(np.float32)
    filt = r.normal(size=(2, 3, 3)).astype(np.float32)
    kw = dict(max_it=4, verbose="none")
    jres = jrec.reconstruct(
        jnp.asarray(b), jnp.asarray(filt),
        jrec.ReconstructionProblem(JGeom(*geom)),
        JSolveCfg(**kw, metrics_dir=str(tmp_path / "j")))
    tres = tr.reconstruct(
        b, filt, tr.ReconstructionProblem(ProblemGeom(*geom)),
        SolveConfig(**kw, metrics_dir=str(tmp_path / "t")), device="cpu")
    plain = tr.reconstruct(
        b, filt, tr.ReconstructionProblem(ProblemGeom(*geom)),
        SolveConfig(**kw), device="cpu")
    assert torch.equal(tres.recon, plain.recon)
    jby = _by_type(jobs.read_events(str(tmp_path / "j")))
    tby = _by_type(obs.read_events(str(tmp_path / "t")))
    n_it = int(tres.trace.num_iters)
    assert n_it == int(jres.trace.num_iters)
    assert tby["run_meta"][0]["algorithm"] == "reconstruct"
    assert [s["it"] for s in tby["step"]] == [s["it"] for s in jby["step"]] \
        == list(range(1, n_it + 1))
    for ts, js in zip(tby["step"], jby["step"]):
        np.testing.assert_allclose(ts["obj"], js["obj"], rtol=RTOL)
    for by in (tby, jby):
        assert by["summary"][-1]["iterations"] == n_it
    np.testing.assert_allclose(tby["summary"][-1]["final_obj"],
                               jby["summary"][-1]["final_obj"], rtol=RTOL)


# ------------------------------------------------------------------
# the serving engine
# ------------------------------------------------------------------

def _bank(k=4, s=5, seed=0):
    r = np.random.default_rng(seed)
    d = r.normal(size=(k, s, s)).astype(np.float32)
    return d / np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))


def _reqs(n, size=12):
    r = np.random.default_rng(5)
    out = []
    for _ in range(n):
        x = r.random((size, size)).astype(np.float32)
        m = (r.random((size, size)) < 0.5).astype(np.float32)
        out.append((x, m))
    return out


SOLVE_KW = dict(max_it=6, tol=1e-4, verbose="none")


def _port_engine(d, **kw):
    geom = ProblemGeom(d.shape[1:], d.shape[0])
    return serve.CodecEngine(
        d, tr.ReconstructionProblem(geom), SolveConfig(**SOLVE_KW),
        ServeConfig(verbose="none", **kw), device="cpu")


@pytest.mark.parametrize("mesh", [None, (2,)])
def test_engine_stream_traces_and_histograms(tmp_path, mesh):
    """A one-device engine and a (2,) mesh engine (two positions on the
    CPU): the dispatching thread writes every span and record."""
    d = _bank()
    m = str(tmp_path / "m")
    eng = _port_engine(d, buckets=((2, (12, 12)),), max_wait_ms=2.0,
                       metrics_dir=m,
                       **({} if mesh is None else {"mesh_shape": mesh}))
    try:
        served = [f.result(timeout=120) for f in
                  [eng.submit(x * k, mask=k) for x, k in _reqs(5)]]
        st = eng.stats()
    finally:
        eng.close()
    assert st["n_requests"] == 5
    ev = obs.read_events(m)
    by = _by_type(ev)
    meta = by["run_meta"][0]
    assert meta["algorithm"] == "serve"
    assert meta["serve_mesh"] == (None if mesh is None else list(mesh))
    assert meta.get("mesh_shape") == (None if mesh is None
                                      else {"batch": 2})
    assert {e["replica_id"] for e in by["serve_request"]} == {None}
    assert len(by["serve_request"]) == 5
    assert all(e["trace_id"] for e in by["serve_request"])
    assert sum(e["n"] for e in by["serve_dispatch"]) == 5
    for e in by["serve_dispatch"]:
        assert e["bound_requests_per_sec"] >= e["requests_per_sec"] > 0
    traces = trace.assemble(ev)
    assert len(traces) == 5
    for t in traces.values():
        assert t.complete
        assert {s.name for s in t.spans.values()} == {
            "request", "engine_queue", "solve"}
    phases = {h["phase"] for h in by["slo_histogram"]}
    assert phases >= {"total", "queue", "solve"}
    last = [h for h in by["slo_histogram"] if h["phase"] == "total"][-1]
    back = slo.from_snapshot(last)
    assert back.n == 5
    # the snapshot's max_ms rounds to 1e-3 ms
    assert back.percentile(0.99) / 1e3 == pytest.approx(
        st["p99_latency_s"], abs=1e-5)
    # within one bucket width of the exact p99 of the served latencies
    lat_ms = [1e3 * s.latency_s for s in served]
    exact = obs.percentile(lat_ms, 0.99)
    assert abs(1e3 * st["p99_latency_s"] - exact) <= \
        back.bucket_width_ms(exact)
    summ = by["summary"][-1]
    assert summ["status"] == "ok" and summ["n_requests"] == 5


def test_engine_stats_percentiles_below_the_max():
    """With a few hundred latencies the p50 and p99 fall below the
    largest one, so the histogram answers from its bucket edges, not its
    clamp to the max: ``stats()`` holds each within one bucket width of
    the exact nearest-rank value, and equals JAX's ``stats()`` source
    (its SloMonitor's percentile over 1e3) exactly. The latencies are
    fed to the engine's monitor as the dispatch loop feeds it."""
    from ccsc_code_iccv2017_tpu.serve import slo as jslo

    lat_ms = np.random.default_rng(3).lognormal(np.log(80.0), 0.6, 300)
    eng = _port_engine(_bank(), buckets=((1, (12, 12)),))
    jmon = jslo.SloMonitor()
    try:
        for v in lat_ms:
            eng._slo.observe("total", float(v))
            jmon.observe("total", float(v))
        st = eng.stats()
    finally:
        eng.close()
    assert st["n_requests"] == len(lat_ms)
    hist = slo.Histogram()
    for v in lat_ms:
        hist.observe(float(v))
    for key, q in (("p50_latency_s", 0.50), ("p99_latency_s", 0.99)):
        exact = obs.percentile(list(lat_ms), q)
        assert exact < lat_ms.max()
        got_ms = 1e3 * st[key]
        assert got_ms < lat_ms.max()
        assert abs(got_ms - exact) <= hist.bucket_width_ms(exact), key
        assert st[key] == jmon.percentile("total", q) / 1e3, key


def test_engine_slo_breach_takes_one_profile(tmp_path):
    """A 1 µs p99 target breaches at the first check: exactly one capture
    of the next dispatch, recorded as ``slo_profile``, its trace file on
    disk (JAX tests/test_trace.py:398-464)."""
    d = _bank()
    prof = tmp_path / "prof"
    eng = _port_engine(
        d, buckets=((1, (12, 12)),), max_wait_ms=0.0,
        metrics_dir=str(tmp_path / "m"), slo_p99_ms=0.001,
        slo_check_s=0.001, slo_profile_dir=str(prof))
    try:
        for x, k in _reqs(3):
            eng.reconstruct(x * k, mask=k, timeout=120)
            time.sleep(0.01)  # let the check cadence elapse
    finally:
        eng.close()
    by = _by_type(obs.read_events(str(tmp_path / "m")))
    assert by["slo_breach"]
    assert by["slo_breach"][0]["observed_ms"] > by["slo_breach"][0][
        "target_ms"]
    assert [p["trace_dir"] for p in by["slo_profile"]] == [str(prof)]
    names = os.listdir(prof)
    assert len(names) == 1 and names[0].endswith(".pt.trace.json")


def test_engine_record_types_match_the_jax_engine(tmp_path):
    d = _bank()
    reqs = _reqs(3)
    kw = dict(buckets=((2, (12, 12)),), max_wait_ms=2.0, verbose="none")
    jm, tm = str(tmp_path / "j"), str(tmp_path / "t")
    geom = JGeom(d.shape[1:], d.shape[0])
    jeng = JEngine(jnp.asarray(d), jrec.ReconstructionProblem(geom),
                   JSolveCfg(**SOLVE_KW), JServeCfg(metrics_dir=jm, **kw))
    try:
        [f.result(timeout=120) for f in
         [jeng.submit(x * k, mask=k) for x, k in reqs]]
    finally:
        jeng.close()
    teng = _port_engine(d, buckets=kw["buckets"], max_wait_ms=2.0,
                        metrics_dir=tm)
    try:
        [f.result(timeout=120) for f in
         [teng.submit(x * k, mask=k) for x, k in reqs]]
    finally:
        teng.close()
    # the quality plane's records included since the fleet slice
    jtypes = {e["type"] for e in jobs.read_events(jm)
              if e["type"] != "compile"}
    ttypes = {e["type"] for e in obs.read_events(tm)}
    assert ttypes == jtypes
    for path in (jm, tm):
        assert len(trace.assemble(obs.read_events(path))) == 3


def test_jax_obs_report_renders_port_streams(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("CCSC_OBS_HEARTBEAT_S", "0")
    ld, sd = str(tmp_path / "learn"), str(tmp_path / "serve")
    _port_learn(_golden_data(), dict(GOLDEN_KW, max_it=2, metrics_dir=ld))
    eng = _port_engine(_bank(), buckets=((2, (12, 12)),), max_wait_ms=2.0,
                       metrics_dir=sd)
    try:
        [f.result(timeout=120) for f in
         [eng.submit(x * k, mask=k) for x, k in _reqs(3)]]
    finally:
        eng.close()
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(REPO, "scripts", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main([ld])
    out = capsys.readouterr().out
    for section in ("RUN", "PHASES", "STEPS", "ROOFLINE", "HOSTS",
                    "SUMMARY"):
        assert section in out, section
    assert "consensus" in out and "it/s" in out
    mod.main([sd])
    out = capsys.readouterr().out
    for section in ("SERVING", "SLO", "TRACES", "SUMMARY"):
        assert section in out, section


# ------------------------------------------------------------------
# the profiler and the figures of a learner run
# ------------------------------------------------------------------

def test_profile_dir_captures_the_step_spans(tmp_path):
    p = tmp_path / "prof"
    _port_learn(_golden_data(), dict(GOLDEN_KW, max_it=2),
                profile_dir=str(p))
    (name,) = os.listdir(p)
    with open(p / name) as f:
        text = f.read()
    assert "ccsc_outer_0" in text and "ccsc_outer_1" in text


def test_verbose_all_writes_the_figures(tmp_path, capsys):
    fig = tmp_path / "fig"
    res = _port_learn(_golden_data(), dict(GOLDEN_KW, max_it=2,
                                            verbose="all"),
                      figures_dir=str(fig))
    assert sorted(os.listdir(fig)) == [
        "filters_001.png", "filters_002.png", "iterates_001.png",
        "iterates_002.png"]
    img, text = read_png(str(fig / "filters_001.png"))
    assert text == {"Title": "iter 1"}
    k, s1, s2 = res.d.shape
    grid = int(np.ceil(np.sqrt(k)))
    assert img.shape == (grid * (s1 + 1) + 1, grid * (s2 + 1) + 1)
    img, _ = read_png(str(fig / "iterates_002.png"))
    assert img.shape[1] == 2 * (16 + 2) + 2  # original | iterate
    assert "Iter 2" in capsys.readouterr().out
