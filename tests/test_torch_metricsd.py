"""The port's metrics endpoint (``ccsc_code_iccv2017_torch.serve.metricsd``)
against the JAX package's: ``render_prometheus`` gives JAX's text for
the same metrics, ``StreamMetrics`` reads a stream to JAX's counters,
and a live HTTP scrape on 127.0.0.1:0 of the port fleet's endpoint
counts its served requests exactly (tests/test_trace.py's metricsd
cases, at the fleet tests' tiny problem: k=4 3x3 bank, a 2-slot 12x12
bucket, max_it 3). Every wait has its own limit.
"""
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from ccsc_code_iccv2017_tpu.serve import metricsd as jmetricsd
from ccsc_code_iccv2017_tpu.serve import slo as jslo
from ccsc_code_iccv2017_torch.config import (
    FleetConfig,
    ProblemGeom,
    ServeConfig,
    SolveConfig,
)
from ccsc_code_iccv2017_torch.models.reconstruct import (
    ReconstructionProblem,
)
from ccsc_code_iccv2017_torch.serve import CodecEngine, ServeFleet
from ccsc_code_iccv2017_torch.serve import metricsd, slo
from ccsc_code_iccv2017_torch.utils import obs


def _bank(seed=0):
    r = np.random.default_rng(seed)
    d = r.normal(size=(4, 3, 3)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    return d


def _cfg(**kw):
    return SolveConfig(**dict(dict(
        lambda_residual=5.0, lambda_prior=0.3, max_it=3, tol=0.0,
        verbose="none", track_objective=True), **kw))


def _reqs(n, seed=1):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = r.random((12, 12)).astype(np.float32)
        m = (r.random((12, 12)) < 0.5).astype(np.float32)
        out.append((x, m))
    return out


def _metrics(hist_mod, lat, db):
    h = hist_mod.Histogram.of(lat)
    q = hist_mod.Histogram(bounds=tuple(0.5 * i for i in range(1, 161)))
    for v in db:
        q.observe(v)
    return {
        "counters": {"requests_total": 7, "rejected_total": 0,
                     "hedges_total": 2},
        "gauges": {"queue_depth": 1, "queue_ceiling": 64,
                   "mean_occupancy": 0.75, "ctrl_breaker_open": 0},
        "labeled_counters": [
            ("tenant_requests_total", {"tenant": "a"}, 3),
            ("tenant_requests_total", {"tenant": "b"}, 4),
            ("tenant_rejected_total", {"tenant": "b"}, 1),
        ],
        "histograms": [
            ("latency_ms", {"phase": "total"}, h.snapshot()),
            ("latency_ms", {"phase": "total", "tenant": "a"}, h.snapshot()),
            ("psnr_db", {"bank_id": None, "tenant": "a",
                         "bucket": "2@12x12"}, q.snapshot()),
        ],
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_prometheus_gives_jax_text(seed):
    r = np.random.default_rng(seed)
    lat = [float(v) for v in r.lognormal(3.0, 1.2, size=50)]
    db = [float(v) for v in r.normal(28.0, 3.0, size=20)]
    got = metricsd.render_prometheus(_metrics(slo, lat, db))
    want = jmetricsd.render_prometheus(_metrics(jslo, lat, db))
    assert got == want
    assert "ccsc_requests_total 7" in got
    assert 'ccsc_tenant_requests_total{tenant="b"} 4' in got
    assert got.count("# TYPE ccsc_latency_ms histogram") == 1
    for prefix in ("ccsc", "other"):
        assert metricsd.render_prometheus({"counters": {"x": 1}},
                                          prefix=prefix) == \
            jmetricsd.render_prometheus({"counters": {"x": 1}},
                                        prefix=prefix)


def test_stream_metrics_reads_a_stream_like_jax(tmp_path):
    p = tmp_path / "events-p00000.jsonl"
    recs = [
        {"t": 1.0, "type": "fleet_request", "replica_id": 0,
         "trace_id": "t", "key": "k1", "latency_ms": 5.0,
         "tenant": "a"},
        {"t": 2.0, "type": "fleet_request", "replica_id": 1,
         "trace_id": "t", "key": "k2", "latency_ms": 6.0},
        {"t": 3.0, "type": "fleet_admission_reject", "replica_id": None,
         "queue_depth": 4, "ceiling": 4, "rung": "reject",
         "retry_after_s": 1.0},
        {"t": 4.0, "type": "tenant_reject", "replica_id": None,
         "tenant": "a", "queue_depth": 2, "quota": 2,
         "retry_after_s": 0.5},
        {"t": 5.0, "type": "fleet_requeue", "replica_id": 0, "key": "k3"},
    ]
    p.write_text("".join(json.dumps(r) + "\n" for r in recs))
    got = metricsd.StreamMetrics(str(tmp_path))()
    want = jmetricsd.StreamMetrics(str(tmp_path))()
    assert got["counters"] == want["counters"]
    assert got["counters"]["requests_total"] == 2
    assert metricsd.render_prometheus(got).splitlines()[:12] == \
        jmetricsd.render_prometheus(want).splitlines()[:12]


def test_resolve_endpoint_and_stamp_like_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("CCSC_METRICSD_PORT", raising=False)
    monkeypatch.delenv("CCSC_METRICSD_SNAPSHOT", raising=False)
    for args in ((None, None, None), (0, None, str(tmp_path)),
                 (None, "/s.prom", None), (9, "/z.prom", "/m")):
        assert metricsd.resolve_endpoint(*args) == \
            jmetricsd.resolve_endpoint(*args)
    monkeypatch.setenv("CCSC_METRICSD_PORT", "9104")
    assert metricsd.resolve_endpoint(None, None, None) == \
        jmetricsd.resolve_endpoint(None, None, None) == (9104, None)
    snap = str(tmp_path / "m.prom")
    md = metricsd.MetricsD(lambda: {"counters": {"requests_total": 1}},
                           port=None, snapshot_path=snap,
                           run_id="fleet-x").start()
    md.stop()
    got = metricsd.parse_snapshot_stamp(snap)
    assert got["run_id"] == "fleet-x"
    assert jmetricsd.parse_snapshot_stamp(snap)["run_id"] == "fleet-x"


def test_metricsd_http_scrape_on_an_ephemeral_port(tmp_path):
    snap = tmp_path / "metrics.prom"
    md = metricsd.MetricsD(
        lambda: {"counters": {"requests_total": 7}, "gauges": {},
                 "histograms": []},
        port=0, snapshot_path=str(snap), interval_s=0.05,
    ).start()
    try:
        assert md.port and md.port > 0
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{md.port}/metrics", timeout=10
        ).read().decode()
        assert "ccsc_requests_total 7" in body
        assert "ccsc_requests_total 7" in snap.read_text()
    finally:
        md.stop()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and any(
        t.name.startswith("ccsc-metricsd") and t.is_alive()
        for t in threading.enumerate()
    ):
        time.sleep(0.05)
    assert not any(t.name.startswith("ccsc-metricsd") and t.is_alive()
                   for t in threading.enumerate())


def test_fleet_metricsd_scrape_counts_exactly(tmp_path):
    """The port fleet's live endpoint: the scraped request counter
    equals the served requests exactly and agrees with ``stats()``,
    and the closing snapshot holds the final exposition."""
    d = _bank()
    fleet = ServeFleet(
        d, ReconstructionProblem(ProblemGeom((3, 3), 4)), _cfg(),
        ServeConfig(buckets=((2, (12, 12)),), max_wait_ms=2.0,
                    verbose="none"),
        FleetConfig(replicas=2, min_queue_depth=64, verbose="none",
                    metrics_dir=str(tmp_path), metricsd_port=0,
                    heartbeat_s=0.2, health_interval_s=0.05),
        device="cpu",
    )
    n = 6
    try:
        assert fleet._metricsd is not None and fleet._metricsd.port
        futs = [fleet.submit(x * m, mask=m, key=f"m{i}")
                for i, (x, m) in enumerate(_reqs(n, seed=3))]
        [f.result(timeout=180) for f in futs]
        url = f"http://127.0.0.1:{fleet._metricsd.port}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        st = fleet.stats()
    finally:
        fleet.close()
    assert f"ccsc_requests_total {n}" in body
    assert f"ccsc_requests_total {st['n_requests']}" in body
    assert f"ccsc_requeued_total {st['n_requeued']}" in body
    assert "ccsc_live_replicas 2" in body
    assert 'ccsc_latency_ms_bucket{le="+Inf",phase="total"}' in body
    events = obs.read_events(str(tmp_path), recursive=True)
    md = [e for e in events if e["type"] == "fleet_metricsd"]
    assert md and md[0]["port"] == fleet._metricsd.port
    with open(os.path.join(str(tmp_path), "metrics.prom")) as f:
        assert f"ccsc_requests_total {n}" in f.read()


def test_engine_metrics_carry_the_quality_histograms():
    """A standalone engine's ``metrics()`` (the app's endpoint source)
    holds its latency and dB histograms in the renderable shape."""
    d = _bank()
    eng = CodecEngine(
        d, ReconstructionProblem(ProblemGeom((3, 3), 4)),
        _cfg(track_psnr=True),
        ServeConfig(buckets=((2, (12, 12)),), max_wait_ms=2.0,
                    verbose="none"), device="cpu")
    try:
        for x, m in _reqs(3):
            eng.reconstruct(x * m, mask=m, x_orig=x, timeout=120)
        met = eng.metrics()
    finally:
        eng.close()
    assert met["counters"]["requests_total"] == 3
    names = {h[0] for h in met["histograms"]}
    assert names == {"latency_ms", "psnr_db"}
    psnr = [h for h in met["histograms"] if h[0] == "psnr_db"]
    assert psnr[0][2]["n"] == 3 and psnr[0][1]["bucket"] == "2@12x12"
    text = metricsd.render_prometheus(met)
    assert text == jmetricsd.render_prometheus(met)
    assert "ccsc_psnr_db_bucket" in text
