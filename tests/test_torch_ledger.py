"""The perf ledger (``analysis/ledger.py``, a copy of the JAX package's
``analysis.ledger`` without its seeders) and its hooks in the port on
the CPU: the same records, keys, digests, bands and gate verdicts as
JAX's on the same inputs; torn-line tolerance; the live anomaly watch; a
learner run's close-time append (also with telemetry off); the engine's
warmup record and the serve bench's row; and each package reading the
other's ledger lines."""
import json
import os
import time

import numpy as np
import pytest

from ccsc_code_iccv2017_tpu.analysis import ledger as jled
from ccsc_code_iccv2017_tpu.config import LearnConfig as JCfg
from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.tune import store as jstore
from ccsc_code_iccv2017_tpu.utils import obs as jobs
from ccsc_code_iccv2017_torch.analysis import ledger as tled
from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.parallel import consensus
from ccsc_code_iccv2017_torch.tune import store as tstore
from ccsc_code_iccv2017_torch.utils import obs

import test_torch_serve as tss


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for v in ("CCSC_PERF_LEDGER", "CCSC_COMPILE_CACHE", "CCSC_PERF_GATE_MAD",
              "CCSC_PERF_GATE_FRAC", "CCSC_PERF_GATE_MIN_HISTORY",
              "CCSC_ANOMALY_WINDOW"):
        monkeypatch.delenv(v, raising=False)


def _rec(mod, value, chip="h100", kind="learn", knobs=None, t=None, **kw):
    return mod.normalize_record(
        chip=chip, kind=kind, workload=kw.pop("workload", "consensus2d"),
        shape_key=kw.pop("shape_key",
                         "consensus2d:k100:s11x11:n1024:sz128x128:b8"),
        knobs={"storage_dtype": "float32"} if knobs is None else knobs,
        value=value, unit=kw.pop("unit", "outer_iters/sec"), t=t, **kw)


def test_records_keys_and_digests_equal_jax():
    for knobs in (None, {}, {"a": 1, "b": [1, 2]}, {"b": 2, "a": 1},
                  {"fused_z": True, "num_blocks": 8, "x": None}):
        assert tled.knob_digest(knobs) == jled.knob_digest(knobs)
    kw = dict(t=5.0, roofline_frac=0.6337, peak_hbm_bytes=123,
              mfu=0.1, hbm_frac=0.2, degraded=True, source="s", git_sha="g")
    a, b = _rec(tled, 1.5, **kw), _rec(jled, 1.5, **kw)
    assert a == b and tled.record_key(a) == jled.record_key(b)
    # an unknown card keys by the card itself
    assert tled.normalize_record(chip="A100->h100", kind="learn", value=1,
                                 unit="u", t=0)["chip"] == "A100"
    ext = {"chip": "h100", "kind": "bench", "value": 1.2, "unit": "u",
           "metric": "dropped", "t": 1.0}
    assert tled.coerce_record(ext) == jled.coerce_record(ext)
    for bad in ({"chip": "h100", "value": 1.0}, "not a dict"):
        with pytest.raises(ValueError):
            tled.coerce_record(bad)


def test_shape_keys_equal_jax():
    geoms = [((11, 11), 100, ()), ((3, 3), 4, (2,)), ((5, 5, 5), 8, ())]
    for args in geoms:
        tg, jg = ProblemGeom(*args), JGeom(*args)
        for algo in ("consensus", "masked", "streaming"):
            assert tstore.learn_workload(tg, algo) == \
                jstore.learn_workload(jg, algo)
        assert tstore.solve_workload(tg) == jstore.solve_workload(jg)
    for kw in (dict(k=100, support=(11, 11), n=800, size=(100, 100),
                    blocks=8),
               dict(k=4, support=5, n=3, size=17, blocks=1)):
        assert tstore.learn_shape_key("consensus2d", **kw) == \
            jstore.learn_shape_key("consensus2d", **kw)
    for kw in (dict(k=100, support=(11, 11), spatial=(256, 256)),
               dict(k=6, support=5, spatial=(20, 24), mesh=(2, 2))):
        assert tstore.solve_shape_key("solve2d", **kw) == \
            jstore.solve_shape_key("solve2d", **kw)
    for m in ("2D consensus ADMM outer iters/sec (k=100 11x11 filters, "
              "n=128x100^2, 8 blocks, 1 chip)", "unparsable"):
        assert tstore._parse_learn_metric(m) == jstore._parse_learn_metric(m)


def test_append_read_filter(tmp_path):
    led = tled.Ledger(str(tmp_path / "led.jsonl"))
    led.append(_rec(tled, 2.0, t=1.0))
    led.append(_rec(tled, 2.1, t=2.0))
    led.append(_rec(tled, 17.0, chip="cpu", kind="serve",
                    unit="requests/sec", t=3.0))
    led.append(_rec(tled, 1.0, knobs={"storage_dtype": "bfloat16"}, t=4.0))
    assert len(led.read()) == 4
    assert len(led.records(chip="h100")) == 3
    assert len(led.records(kind="serve")) == 1
    assert len(led.records(knob_digest_=tled.knob_digest(
        {"storage_dtype": "bfloat16"}))) == 1
    groups = led.by_key()
    assert len(groups) == 3  # the knob digest keys configurations apart
    assert groups == jled.Ledger(led.path).by_key()
    assert not led.empty and tled.Ledger(str(tmp_path / "no.jsonl")).empty


def test_torn_and_corrupt_lines(tmp_path):
    path = tmp_path / "led.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps(_rec(tled, 2.0, t=1.0)) + "\n")
        f.write("{not json\n")
        f.write(json.dumps(_rec(tled, 2.2, t=2.0)) + "\n")
        f.write('{"torn": ')  # a killed writer
    led = tled.Ledger(str(path))
    assert [r["value"] for r in led.read()] == [2.0, 2.2]
    led.append(_rec(tled, 2.4, t=3.0))  # terminates the torn tail first
    assert [r["value"] for r in led.read()] == [2.0, 2.2, 2.4]
    assert [r["value"] for r in jled.Ledger(str(path)).read()] == [
        2.0, 2.2, 2.4]


@pytest.mark.parametrize("values", [
    [1.0, 2.0, 3.0, 4.0, 100.0], [2.0, 2.0, 2.0], [], [5.0],
    [1.95, 2.02, 2.0, 1.98, 2.05, 2.01]])
@pytest.mark.parametrize("knobs", [{}, {"mad_k": 2.0, "frac": 0.1},
                                   {"abs_floor": 0.5, "frac": 0.0}])
def test_robust_band_equals_jax(values, knobs):
    assert tled.robust_band(values, **knobs) == \
        jled.robust_band(values, **knobs)


@pytest.mark.parametrize("history, newest", [
    ([1.95, 2.02, 2.0, 1.98, 2.05, 2.01], 2.0),  # inside the band
    ([1.95, 2.02, 2.0, 1.98, 2.05, 2.01], 1.0),  # 0.5x: a regression
    ([2.0], 1.0),  # a young key passes
])
def test_gate_verdicts_equal_jax(tmp_path, history, newest):
    path = str(tmp_path / "led.jsonl")
    led = tled.Ledger(path)
    for i, v in enumerate(history):
        led.append(_rec(tled, v, t=100.0 + i))
    led.append(_rec(tled, newest, t=200.0))
    got = tled.gate(led, min_history=3)
    assert got == jled.gate(jled.Ledger(path), min_history=3)
    (v,) = got
    assert v["ok"] == (newest >= 1.5 or len(history) < 3)
    # record mode judges one external record against the full history
    ext = _rec(tled, 0.9, t=300.0)
    assert tled.gate(led, record=ext, min_history=3) == \
        jled.gate(jled.Ledger(path), record=ext, min_history=3)
    assert len(led.read()) == len(history) + 1  # nothing appended


def _band():
    return tled.robust_band([0.5, 0.52, 0.49, 0.51, 0.5, 0.48])


def test_anomaly_watch_equals_jax():
    seq = [0.5] * 4 + [0.1] * 6 + [0.5] * 3 + [0.05] * 3 + [float("nan")]
    tw = tled.AnomalyWatch(_band(), window=3, key="k")
    jw = jled.AnomalyWatch(_band(), window=3, key="k")
    got = [tw.observe(f) for f in seq]
    assert got == [jw.observe(f) for f in seq]
    assert tw.n_fired == 2 and sum(g is not None for g in got) == 2


def test_watch_for_and_the_run_records_perf_anomaly(tmp_path, monkeypatch):
    """A ledger with history for this configuration arms the run's
    anomaly watch at start_run; a run whose rolling roofline fraction
    falls below the band records one ``perf_anomaly``."""
    path = str(tmp_path / "led.jsonl")
    cfg = LearnConfig(max_it=4, num_blocks=2, verbose="none")
    knobs = {k: getattr(cfg, k) for k in obs._LEDGER_KNOB_KEYS}
    assert obs._LEDGER_KNOB_KEYS == jobs._LEDGER_KNOB_KEYS
    led = tled.Ledger(path)
    for i in range(4):
        led.append(_rec(tled, 2.0, chip="cpu", knobs=knobs,
                        roofline_frac=0.9, t=100.0 + i))
    monkeypatch.setenv("CCSC_PERF_LEDGER", path)
    w = tled.watch_for("cpu", "learn", "consensus2d", knobs=knobs)
    jw = jled.watch_for("cpu", "learn", "consensus2d", knobs=knobs)
    assert w.band == jw.band and w.key == jw.key
    assert tled.watch_for("cpu", "learn", knobs={"x": 1}) is None
    m = str(tmp_path / "m")
    run = obs.start_run(m, algorithm="consensus", verbose="none",
                        geom=ProblemGeom((5, 5), 4), cfg=cfg,
                        data_shape=[8, 16, 16], device="cpu")
    assert run.anomaly is not None and run.anomaly.band["n"] == 4
    cost = {"flops": 5e10, "bytes": 5e9}  # the cpu row's bound: 10 it/s
    for i in range(5):
        run.chunk(i, 1, 1, 1.0, cost=cost)  # frac 0.1, far below 0.9
    run.close(status="ok")
    anoms = [e for e in obs.read_events(m) if e["type"] == "perf_anomaly"]
    assert len(anoms) == 1 and anoms[0]["rolling_frac"] == pytest.approx(0.1)


@pytest.mark.parametrize("telemetry", [True, False])
def test_a_learner_run_appends_its_record_at_close(tmp_path, monkeypatch,
                                                   telemetry):
    """With CCSC_PERF_LEDGER set, the consensus learner's close appends
    one record keyed as JAX keys the same problem (chip, kind, workload,
    shape key, knob digest), with telemetry on (and a ledger_append
    record) or off."""
    path = str(tmp_path / "led.jsonl")
    monkeypatch.setenv("CCSC_PERF_LEDGER", path)
    b = np.random.default_rng(0).standard_normal((8, 16, 16)).astype(
        np.float32)
    kw = dict(max_it=2, num_blocks=2, verbose="none", tol=0.0,
              watchdog=True)
    m = str(tmp_path / "m") if telemetry else None
    consensus.learn(b, ProblemGeom((5, 5), 4), LearnConfig(**kw,
                    metrics_dir=m), device="cpu")
    (rec,) = tled.Ledger(path).read()
    assert (rec["chip"], rec["kind"], rec["unit"], rec["source"]) == (
        "cpu", "learn", "outer_iters/sec", "run:consensus")
    assert rec["roofline_frac"] > 0 and rec["value"] > 0
    # JAX's run of the same problem keys the same way
    jrun = jobs.start_run(None, algorithm="consensus", verbose="none",
                          geom=JGeom((5, 5), 4), cfg=JCfg(**kw),
                          data_shape=[8, 16, 16])
    jrun.chunk(0, 1, 1, 1.0, cost={"flops": 1.0, "bytes": 1.0})
    jrun.close(status="ok")
    recs = tled.Ledger(path).read()
    assert len(recs) == 2 and tled.record_key(recs[0]) == \
        jled.record_key(recs[1])
    if telemetry:
        (ev,) = [e for e in obs.read_events(m)
                 if e["type"] == "ledger_append"]
        assert ev["key"] == tled.record_key(rec) and ev["path"] == path
    # an error close appends nothing
    run = obs.start_run(None, algorithm="consensus", verbose="none",
                        geom=ProblemGeom((5, 5), 4), cfg=LearnConfig(**kw),
                        data_shape=[8, 16, 16], device="cpu")
    run.chunk(0, 1, 1, 1.0, cost={"flops": 1.0, "bytes": 1.0})
    run.close(status="error")
    assert len(tled.Ledger(path).read()) == 2


def test_no_record_without_the_knob(tmp_path):
    b = np.zeros((4, 12, 12), np.float32) + 1.0
    consensus.learn(b, ProblemGeom((3, 3), 2), LearnConfig(
        max_it=1, num_blocks=2, verbose="none"), device="cpu")
    assert not tled.enabled()
    assert tled.maybe_append(chip="cpu", kind="learn", value=1.0,
                             unit="u") is None


def test_the_engine_appends_its_warmup_record(tmp_path, monkeypatch):
    path = str(tmp_path / "led.jsonl")
    monkeypatch.setenv("CCSC_PERF_LEDGER", path)
    d = tss._bank()
    buckets = ((2, (20, 20)), (4, (24, 24)))
    with tss._engine(d, tss._cfg_kw(max_it=2), buckets):
        pass
    (rec,) = tled.Ledger(path).read()
    assert (rec["kind"], rec["workload"], rec["unit"], rec["chip"]) == (
        "warmup", "serve_warmup", "warm_starts/sec", "cpu")
    assert rec["shape_key"] == jled.warmup_shape_key(buckets) == \
        "2@20x20,4@24x24"
    assert rec["knobs"]["staged"] is False and rec["n_compiles"] == 2
    assert rec["value"] > 0
    # a lazy engine appends nothing
    with tss._engine(d, tss._cfg_kw(max_it=2), buckets, aot_warmup=False):
        pass
    assert len(tled.Ledger(path).read()) == 1


def test_the_serve_bench_appends_its_rows(tmp_path, monkeypatch):
    from ccsc_code_iccv2017_torch.serve import bench

    path = str(tmp_path / "led.jsonl")
    out = bench.main(["--device", "cpu", "--side", "24", "--pad-side", "20",
                      "--max-it", "2", "--requests", "3", "--padded", "1",
                      "--slots", "2"])
    assert not os.path.exists(path)  # unset: no ledger
    monkeypatch.setenv("CCSC_PERF_LEDGER", path)
    tled.append_serve_record(out, source="test")
    jled.append_serve_record(out, source="test")
    a, b = tled.Ledger(path).read()
    assert tled.record_key(a) == tled.record_key(b)
    assert (a["kind"], a["workload"], a["unit"]) == ("serve", "serve2d",
                                                     "requests/sec")
    assert a["value"] == out["engine_requests_per_sec"]
    assert a["shape_key"] == jstore.solve_shape_key(
        "solve2d", k=100, support=(11, 11), spatial=(24, 24))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_lines(tmp_path, writer):
    path = str(tmp_path / "led.jsonl")
    w, r = (tled, jled) if writer == "port" else (jled, tled)
    for i, v in enumerate([2.0, 2.1, 1.9, 1.0]):
        w.Ledger(path).append(_rec(w, v, t=10.0 + i, roofline_frac=0.5))
    w.append_warmup_record(chip="h100", buckets=((4, (256, 256)),),
                           join_s=0.5)  # disarmed: a no-op
    assert r.Ledger(path).read() == w.Ledger(path).read()
    assert r.gate(r.Ledger(path), min_history=3) == \
        w.gate(w.Ledger(path), min_history=3)
    assert [v["ok"] for v in r.gate(r.Ledger(path), min_history=3)] == [
        False]
