"""Workload capture (``serve/capture.py``, a copy of the JAX package's
``serve.capture``) and its hook in the port's standalone ``CodecEngine``,
on the CPU: the recorder's round trip, dedup, rotation and sampling, the
capture format read across packages both ways, and an engine's capture
whose outcome digests are its results' and whose replay under the
captured solve params gives the same bits."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from ccsc_code_iccv2017_tpu import config as jcfg
from ccsc_code_iccv2017_tpu.serve import CodecEngine as JEngine
from ccsc_code_iccv2017_tpu.serve import capture as jcap
from ccsc_code_iccv2017_torch import serve
from ccsc_code_iccv2017_torch.config import ServeConfig, SolveConfig
from ccsc_code_iccv2017_torch.serve import capture as tcap
from ccsc_code_iccv2017_torch.utils import obs

import importlib

import test_torch_serve as tss

jr = importlib.import_module("ccsc_code_iccv2017_tpu.models.reconstruct")
FIELDS = ("b", "mask", "smooth_init", "x_orig")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for v in ("CCSC_CAPTURE_DIR", "CCSC_CAPTURE_SAMPLE",
              "CCSC_CAPTURE_ROTATE_MB"):
        monkeypatch.delenv(v, raising=False)


def _arrays(seed, side=6):
    r = np.random.default_rng(seed)
    return {f: r.random((side, side)).astype(np.float32) for f in FIELDS}


def _record(mod, path, n=3, **kw):
    events = []
    rec = mod.WorkloadRecorder(path, emit=lambda t, **f: events.append(
        (t, f)), meta={"source": "test"}, **kw)
    for i in range(n):
        a = _arrays(i)
        rec.record_submit(f"k-{i}", f"t-{i}", a["b"], mask=a["mask"],
                          smooth_init=a["smooth_init"], x_orig=a["x_orig"],
                          bucket="2@8x8", bank_id=None, tenant=None)
        rec.record_outcome(f"k-{i}", a["b"] * 2, 30.0 + i, 12.5, "2@8x8",
                           iters=7)
    rec.close()
    return rec, events


def test_recorder_round_trip(tmp_path):
    path = str(tmp_path / "cap")
    rec, events = _record(tcap, path)
    wl = tcap.read_workload(path)
    assert [w["key"] for w in wl] == ["k-0", "k-1", "k-2"]
    for i, w in enumerate(wl):
        a = _arrays(i)
        for f in FIELDS:
            assert w[f] == tcap.payload_sha(a[f])
            np.testing.assert_array_equal(tcap.load_payload(path, w[f]), a[f])
        out = w["outcome"]
        assert out["digest"] == tcap.payload_sha(a["b"] * 2)
        assert (out["psnr"], out["latency_ms"], out["iters"]) == (
            30.0 + i, 12.5, 7)
    meta = tcap.read_meta(path)
    assert (meta["status"], meta["n_requests"], meta["n_outcomes"]) == (
        "closed", 3, 3)
    assert meta["source"] == "test"
    assert [t for t, _ in events] == ["capture_start", "capture_summary"]
    summ = events[-1][1]
    assert summ["n_requests"] == 3 and summ["overhead_s"] >= 0
    assert set(tcap.read_payload_index(path)) == {
        w[f] for w in wl for f in FIELDS}
    # a closed recorder records nothing and never raises
    rec.record_submit("late", None, np.zeros(3, np.float32))
    assert len(tcap.read_workload(path)) == 3


def test_dedup_and_sha_equal_jax(tmp_path):
    path = str(tmp_path / "cap")
    rec = tcap.WorkloadRecorder(path)
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    for key in ("a", "b"):
        rec.record_submit(key, None, a, mask=a.copy())
    rec.close()
    assert rec.n_payloads == 1 and rec.n_dedup_hits == 3
    assert len(os.listdir(os.path.join(path, "payloads"))) == 1
    # the content address is JAX's: dtype and shape are part of it
    for arr in (a, a.reshape(4, 3), a.astype(np.float64), a[:, ::2]):
        assert tcap.payload_sha(arr) == jcap.payload_sha(arr)
    assert tcap.payload_sha(a) != tcap.payload_sha(a.reshape(4, 3))


def test_rotation_merges_segments(tmp_path):
    path = str(tmp_path / "cap")
    rec, events = _record(tcap, path, n=4, rotate_mb=1e-4)  # ~100 bytes
    segs = sorted(n for n in os.listdir(path) if n.startswith("requests-"))
    assert len(segs) > 2
    assert [t for t, _ in events].count("capture_rotate") == len(segs) - 1
    wl = tcap.read_workload(path)
    assert [w["key"] for w in wl] == ["k-0", "k-1", "k-2", "k-3"]
    assert all(w["outcome"] is not None for w in wl)
    assert [w["key"] for w in jcap.read_workload(path)] == [
        w["key"] for w in wl]


@pytest.mark.parametrize("sample", [0.0, 0.3, 0.5, 1.0])
def test_sampling_is_deterministic_per_key_as_jax(tmp_path, sample):
    keys = [f"req-{i:08d}" for i in range(200)]
    verdicts = [tcap._sample_admits(k, sample) for k in keys]
    assert verdicts == [jcap._sample_admits(k, sample) for k in keys]
    path = str(tmp_path / "cap")
    rec = tcap.WorkloadRecorder(path, sample=sample)
    x = np.ones(2, np.float32)
    for k in keys[:20]:
        rec.record_submit(k, None, x)
        rec.record_outcome(k, x, None, 1.0, "b")
    rec.close()
    kept = [k for k, v in zip(keys[:20], verdicts[:20]) if v]
    wl = tcap.read_workload(path)
    assert [w["key"] for w in wl] == kept
    assert all(w["outcome"] is not None for w in wl)  # paired
    assert rec.n_sampled_out == 20 - len(kept)


def test_resolve_capture_dir_as_jax(monkeypatch):
    for env in (None, "/env/cap"):
        if env is None:
            monkeypatch.delenv("CCSC_CAPTURE_DIR", raising=False)
        else:
            monkeypatch.setenv("CCSC_CAPTURE_DIR", env)
        for explicit in (None, "", "/explicit"):
            assert tcap.resolve_capture_dir(explicit) == \
                jcap.resolve_capture_dir(explicit)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_capture(tmp_path, writer):
    path = str(tmp_path / "cap")
    w, r = (tcap, jcap) if writer == "port" else (jcap, tcap)
    _record(w, path)
    got, ref = r.read_workload(path), w.read_workload(path)
    assert got == ref
    assert r.read_payload_index(path) == w.read_payload_index(path)
    assert r.read_meta(path)["session"] == w.read_meta(path)["session"]
    for x in got:
        np.testing.assert_array_equal(r.load_payload(path, x["b"]),
                                      w.load_payload(path, x["b"]))


def _requests(n, side=20):
    out = []
    for i in range(n):
        x, m = tss._req(side, seed=i + 1)
        out.append({"b": x * m, "mask": m, "x_orig": x,
                    "smooth_init": None})
    return out


def test_standalone_engine_capture_and_replay(tmp_path, monkeypatch):
    """A standalone engine records every request under the solve params
    it serves with; the payloads and the request records' SHAs are what
    JAX's engine records for the same requests; replaying the captured
    payloads through a fresh engine gives each recorded digest."""
    d = tss._bank()
    cfg_kw = tss._cfg_kw(max_it=6)
    buckets = ((2, (20, 20)),)
    reqs = _requests(5)
    cap = str(tmp_path / "cap")
    m = str(tmp_path / "m")
    with tss._engine(d, cfg_kw, buckets, capture_dir=cap,
                     metrics_dir=m) as eng:
        served = [f.result(timeout=60) for f in [
            eng.submit(q["b"], mask=q["mask"], x_orig=q["x_orig"])
            for q in reqs]]
    wl = sorted(tcap.read_workload(cap), key=lambda w: w["key"])
    meta = tcap.read_meta(cap)
    assert len(wl) == 5 and meta["source"] == "serve_engine"
    assert meta["solve"] == {k: cfg_kw[k] for k in (
        "max_it", "tol", "lambda_residual", "lambda_prior")}
    assert meta["buckets"] == [{"slots": 2, "spatial": [20, 20]}]
    for w, q, s in zip(wl, reqs, served):
        assert w["b"] == tcap.payload_sha(np.asarray(q["b"], np.float32))
        assert w["smooth_init"] is None and w["bucket"] == "2@20x20"
        assert w["outcome"]["digest"] == tcap.payload_sha(s.recon)
        assert w["outcome"]["psnr"] == round(s.psnr, 6)
        assert w["outcome"]["iters"] == int(s.trace.num_iters)
    kinds = [e["type"] for e in obs.read_events(m)]
    assert kinds.count("capture_start") == kinds.count("capture_summary") == 1
    # JAX's engine on the same requests records the same payloads
    jcap_dir = str(tmp_path / "jcap")
    geom = jcfg.ProblemGeom(d.shape[1:], d.shape[0])
    with JEngine(jnp.asarray(d), jr.ReconstructionProblem(geom),
                 jcfg.SolveConfig(**cfg_kw),
                 jcfg.ServeConfig(buckets=buckets, max_wait_ms=10.0,
                                  verbose="none", capture_dir=jcap_dir)) as je:
        for f in [je.submit(q["b"], mask=q["mask"], x_orig=q["x_orig"])
                  for q in reqs]:
            f.result(timeout=60)
    jwl = sorted(jcap.read_workload(jcap_dir), key=lambda w: w["key"])
    assert [(w["b"], w["mask"], w["x_orig"]) for w in jwl] == [
        (w["b"], w["mask"], w["x_orig"]) for w in wl]
    assert set(jwl[0]) == set(wl[0])
    assert set(jwl[0]["outcome"]) == set(wl[0]["outcome"])
    # replay: the captured payloads and solve params, capture off
    monkeypatch.setenv("CCSC_CAPTURE_DIR", str(tmp_path / "never"))
    with tss._engine(d, dict(cfg_kw, **meta["solve"]), buckets,
                     capture_dir="") as reng:
        futs = [reng.submit(**{f: None if w[f] is None else
                               tcap.load_payload(cap, w[f])
                               for f in FIELDS}) for w in wl]
        again = [f.result(timeout=60) for f in futs]
    assert not os.path.exists(str(tmp_path / "never"))
    assert [tcap.payload_sha(s.recon) for s in again] == [
        w["outcome"]["digest"] for w in wl]


def test_env_arms_capture_and_no_capture_without_it(tmp_path, monkeypatch):
    d = tss._bank()
    buckets = ((2, (20, 20)),)
    q = _requests(1)[0]
    with tss._engine(d, tss._cfg_kw(max_it=3), buckets) as eng:
        eng.submit(q["b"], mask=q["mask"]).result(timeout=60)
        assert eng._capture is None
    cap = str(tmp_path / "envcap")
    monkeypatch.setenv("CCSC_CAPTURE_DIR", cap)
    with tss._engine(d, tss._cfg_kw(max_it=3), buckets) as eng:
        eng.submit(q["b"], mask=q["mask"]).result(timeout=60)
    assert len(tcap.read_workload(cap)) == 1
    assert serve.WorkloadRecorder is tcap.WorkloadRecorder
