"""Pipelined dispatch in the port's engine (``ServeConfig.pipeline_depth``,
``CCSC_SERVE_PIPELINE``; serve/engine.py ``_launch`` / ``_complete``),
mirroring the JAX package's tests/test_serve_pipeline.py on the CPU:

- a depth-2 engine's results on a heterogeneous stream are BITWISE a
  depth-1 engine's, and within REC_TOL of the JAX depth-2 engine's;
- only a non-default depth keys the knob dict; the config wins over the
  env knob; an invalid depth is refused;
- a mesh engine at depth 2 is bitwise depth 1;
- a fleet replica killed with a launched batch loses nothing;
- the bench's pipelined arm is its own ledger configuration.

On the CPU ``_launch`` fills numpy canvases (the copy stream exists on the
card only, where chip_smoke.py phase 22 (d) holds it to phase 10)."""
import numpy as np
import pytest

from ccsc_code_iccv2017_tpu.config import ServeConfig as JServeConfig
from ccsc_code_iccv2017_tpu.config import SolveConfig as JSolveConfig
from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.models.reconstruct import (
    ReconstructionProblem as JProb)
from ccsc_code_iccv2017_tpu.serve import CodecEngine as JEngine
from ccsc_code_iccv2017_torch.config import (FleetConfig, ProblemGeom,
                                             ServeConfig, SolveConfig)
from ccsc_code_iccv2017_torch.models.reconstruct import ReconstructionProblem
from ccsc_code_iccv2017_torch.serve import CodecEngine, ServeFleet
from ccsc_code_iccv2017_torch.utils import faults, obs

REC_TOL = 1e-4


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    for v in ("CCSC_SERVE_PIPELINE", "CCSC_SERVE_MESH",
              "CCSC_FAULT_ENGINE_KILL_REQ", "CCSC_FAULT_ENGINE_KILL_REPLICA",
              "CCSC_WATCHDOG_MIN_S", "CCSC_WATCHDOG_COMPILE_S",
              "CCSC_PERF_LEDGER", "CCSC_CAPTURE_DIR"):
        monkeypatch.delenv(v, raising=False)
    faults.reset()
    yield
    faults.reset()


def _bank(k=6, s=5, seed=0):
    r = np.random.default_rng(seed)
    d = r.normal(size=(k, s, s)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    return d


_CFG = dict(lambda_residual=5.0, lambda_prior=0.3, max_it=6, tol=1e-4,
            verbose="none", track_objective=True, track_psnr=True)


def _req(size, seed=1, keep=0.5):
    r = np.random.default_rng(seed)
    x = r.random((size, size)).astype(np.float32)
    m = (r.random((size, size)) < keep).astype(np.float32)
    return x, m


def _engine(d, buckets, tmp_path=None, cfg=None, **kw):
    scfg = ServeConfig(
        buckets=buckets, max_wait_ms=kw.pop("max_wait_ms", 5.0),
        metrics_dir=str(tmp_path) if tmp_path is not None else None,
        verbose="none", mesh_shape=kw.pop("mesh_shape", ()), **kw)
    geom = ProblemGeom(d.shape[1:], d.shape[0])
    return CodecEngine(d, ReconstructionProblem(geom),
                       SolveConfig(**(cfg or _CFG)), scfg, device="cpu")


def _serve_all(eng, reqs):
    futs = [eng.submit(x * m, mask=m, x_orig=x) for x, m in reqs]
    return [f.result(timeout=300) for f in futs]


BUCKETS = ((2, (16, 16)), (2, (24, 24)))
SIZES = [16, 24, 12, 24, 16, 20, 24, 16, 12, 20, 24, 16]


def _assert_bitwise(ref, out):
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a.recon, b.recon)
        np.testing.assert_array_equal(np.asarray(a.trace.obj_vals),
                                      np.asarray(b.trace.obj_vals))
        np.testing.assert_array_equal(np.asarray(a.trace.psnr_vals),
                                      np.asarray(b.trace.psnr_vals))
        assert int(a.trace.num_iters) == int(b.trace.num_iters)


def test_depth2_bit_identical_to_depth1_hetero_stream():
    """Two buckets, off-bucket (padded) sizes mixed in, enough requests
    that the depth-2 worker holds a second batch launched; and within
    REC_TOL of the JAX package's depth-2 engine on the same stream."""
    d = _bank()
    reqs = [_req(sz, seed=300 + i) for i, sz in enumerate(SIZES)]
    with _engine(d, BUCKETS, pipeline_depth=1) as eng:
        ref = _serve_all(eng, reqs)
    with _engine(d, BUCKETS, pipeline_depth=2) as eng:
        out = _serve_all(eng, reqs)
        assert eng._pipeline_depth == 2
    _assert_bitwise(ref, out)
    jeng = JEngine(d, JProb(JGeom(d.shape[1:], d.shape[0])),
                   JSolveConfig(**_CFG),
                   JServeConfig(buckets=BUCKETS, max_wait_ms=5.0,
                                verbose="none", mesh_shape=(),
                                pipeline_depth=2))
    try:
        jout = _serve_all(jeng, reqs)
    finally:
        jeng.close()
    for a, b in zip(out, jout):
        scale = max(1.0, float(np.abs(b.recon).max()))
        assert float(np.abs(a.recon - b.recon).max()) <= REC_TOL * scale


def _ready_knobs(tmp_path, **kw):
    d = _bank(k=4, s=3)
    eng = _engine(d, ((2, (12, 12)),), tmp_path,
                  cfg=dict(_CFG, max_it=2, tol=0.0, track_psnr=False), **kw)
    eng.close()
    ready = [e for e in obs.read_events(str(tmp_path))
             if e.get("type") == "serve_ready"]
    assert ready
    return ready[-1]["knobs"]


def test_depth1_keeps_historical_knob_digest(tmp_path):
    assert "pipeline" not in _ready_knobs(tmp_path, pipeline_depth=1)


def test_nondefault_depth_keys_knob_dict(tmp_path):
    assert _ready_knobs(tmp_path, pipeline_depth=3)["pipeline"] == 3


def test_env_fallback_and_config_priority(tmp_path, monkeypatch):
    monkeypatch.setenv("CCSC_SERVE_PIPELINE", "2")
    assert _ready_knobs(tmp_path / "env", pipeline_depth=None)[
        "pipeline"] == 2
    assert "pipeline" not in _ready_knobs(tmp_path / "cfg", pipeline_depth=1)


def test_invalid_depth_refused():
    with pytest.raises(ValueError, match="pipeline_depth"):
        ServeConfig(buckets=((2, (12, 12)),), pipeline_depth=0)


def test_mesh_engine_depth2_bitwise_depth1():
    """A mesh engine takes the same worker (its positions upload their
    own shards inside the solve): depth 2 returns depth 1's results."""
    d = _bank(k=4, s=3)
    reqs = [_req(12, seed=500 + i) for i in range(7)]
    cfg = dict(_CFG, max_it=4)
    with _engine(d, ((2, (12, 12)),), cfg=cfg, mesh_shape=(2,),
                 pipeline_depth=1) as eng:
        ref = _serve_all(eng, reqs)
    with _engine(d, ((2, (12, 12)),), cfg=cfg, mesh_shape=(2,),
                 pipeline_depth=2) as eng:
        out = _serve_all(eng, reqs)
        assert eng.mesh_shape == (2,)
    _assert_bitwise(ref, out)


def test_dispatch_order_and_digest_release_match_depth1():
    """The pipelined worker dispatches the same batches in the same
    order, and releases every batch's digest: a bank published and
    retired after the stream is gone."""
    d = _bank()
    reqs = [_req(16, seed=600 + i) for i in range(6)]
    logs = []
    for depth in (1, 2):
        with _engine(d, ((2, (16, 16)),), pipeline_depth=depth,
                     max_wait_ms=50.0) as eng:
            _serve_all(eng, reqs)
            logs.append([(e["requests"], e["iters"])
                         for e in eng.dispatch_log])
            assert eng._dispatching == []
            digest = eng.add_bank(_bank(seed=1))
            assert eng.retire_bank(digest)
    assert logs[0] == logs[1]


def test_fleet_kill_with_prefetched_batch_zero_lost(tmp_path, monkeypatch):
    """A pipelined replica killed on its first request: the launched lane
    is redelivered once, bitwise an unfaulted depth-1 engine."""
    monkeypatch.setenv("CCSC_SERVE_PIPELINE", "2")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_KILL_REQ", "1")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_KILL_REPLICA", "0")
    monkeypatch.setenv("CCSC_WATCHDOG_MIN_S", "5")
    monkeypatch.setenv("CCSC_WATCHDOG_COMPILE_S", "5")
    faults.reset()
    d = _bank(k=4, s=3)
    cfg = dict(_CFG, max_it=4, tol=0.0, track_psnr=False)
    buckets = ((4, (12, 12)),)
    reqs = [_req(12, seed=400 + i) for i in range(10)]
    with _engine(d, buckets, cfg=cfg, pipeline_depth=1,
                 max_wait_ms=2.0) as eng:
        ref = [eng.submit(x * m, mask=m).result(timeout=180)
               for x, m in reqs]
    geom = ProblemGeom(d.shape[1:], d.shape[0])
    fleet = ServeFleet(
        d, ReconstructionProblem(geom), SolveConfig(**cfg),
        ServeConfig(buckets=buckets, max_wait_ms=2.0, verbose="none"),
        FleetConfig(replicas=2, min_queue_depth=64, restart_backoff_s=0.05,
                    heartbeat_s=0.2, health_interval_s=0.05,
                    verbose="none", metrics_dir=str(tmp_path)),
        device="cpu")
    try:
        futs = [fleet.submit(x * m, mask=m, key=f"p{i}")
                for i, (x, m) in enumerate(reqs)]
        res = [f.result(timeout=300) for f in futs]
        for i in range(10):
            np.testing.assert_array_equal(res[i].recon, ref[i].recon)
    finally:
        fleet.close()
    events = obs.read_events(str(tmp_path), recursive=True)
    assert any(e["type"] == "fleet_replica_dead" and e["replica_id"] == 0
               for e in events)
    served = [e["key"] for e in events if e["type"] == "fleet_request"]
    assert sorted(served) == sorted(f"p{i}" for i in range(10))


def test_bench_pipelined_arm_is_its_own_ledger_configuration(
        tmp_path, monkeypatch):
    """serve.bench's run_serve_workload records the pipelined arm with
    JAX's fields and a measured bitwise verdict; the ledger keys it
    apart from the default engine's row."""
    from ccsc_code_iccv2017_torch.analysis import ledger
    from ccsc_code_iccv2017_torch.serve import bench

    d = _bank(k=4, s=3)
    prob = ReconstructionProblem(ProblemGeom((3, 3), 4))
    cfg = SolveConfig(max_it=3, tol=0.0, verbose="none")
    reqs = [dict(b=x * m, mask=m, smooth_init=np.zeros_like(x), x_orig=x)
            for x, m in (_req(12, seed=700 + i) for i in range(5))]
    bucket = (2, (12, 12))
    with _engine(d, (bucket,), cfg=dict(verbose="none", max_it=3, tol=0.0),
                 pipeline_depth=1) as eng:
        base, base_s, _ = bench.run_engine(eng, reqs)
    looped = [(s.recon, int(s.trace.num_iters)) for s in base]
    out = bench.run_serve_workload(d, prob, cfg, reqs, bucket, "cpu", looped,
                                   base, len(base) / base_s, pipe_depth=2)
    assert out["pipeline_bit_identical"] is True
    assert out["pipeline_depth"] == 2
    assert out["pipeline_knobs"]["pipeline"] == 2
    assert out["speedup_pipeline_vs_default"] > 0
    path = str(tmp_path / "ledger.jsonl")
    monkeypatch.setenv("CCSC_PERF_LEDGER", path)
    rec = dict(out, chip="cpu", shape_key="solve2d:k4:s3x3:sz16x16",
               knobs={"requests": 5, "slots": 2},
               engine_requests_per_sec=len(base) / base_s)
    assert ledger.append_serve_record(rec) is not None
    rows = ledger.Ledger(path).read()
    assert len(rows) == 2
    assert len({ledger.record_key(r) for r in rows}) == 2
