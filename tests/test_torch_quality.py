"""The port's quality observatory (``ccsc_code_iccv2017_torch.serve.quality``)
on the CPU, against the JAX package on the same inputs, at
tests/test_quality.py's tiny problem (k=4 3x3 bank, a 2-slot 8x8
bucket, max_it 3).

Contracts under test, as in the JAX package:
- ONE shared valid-region PSNR: the engine's delivered ``res.psnr``,
  the capture outcome record and every scorer quote the same
  :func:`quality.valid_region_psnr` value;
- ``QualityMonitor``: the records (histograms, floor breaches, drift
  fires, solve diagnostics) equal the JAX monitor's for the same PSNR
  stream;
- solve diagnostics ride the existing dispatch: equal dispatch counts
  and bit-identical recons with ``track_diagnostics`` off/on;
- golden probes: ``synth_probe`` equals JAX's, references self-seal
  and are then judged exact, and the bank-rot guard holds;
- shadow scoring: ``score_bank`` appends ``kind=quality`` records
  keyed like JAX's, within 1e-3 dB of JAX's score of the same capture
  (PSNR of recons within REC_TOL); ``judge_candidate`` /
  ``gate_publish`` and the gate CLI's exit codes and verdict lines
  equal JAX's on the same ledger;
- the fleet schedules probes through idle capacity and its capture
  never records probe traffic.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from ccsc_code_iccv2017_tpu.serve import quality as jquality
from ccsc_code_iccv2017_torch.analysis import ledger as ledger_mod
from ccsc_code_iccv2017_torch.config import (
    FleetConfig,
    ProblemGeom,
    ServeConfig,
    SolveConfig,
    TenantSpec,
)
from ccsc_code_iccv2017_torch.models.reconstruct import (
    ReconstructionProblem,
)
from ccsc_code_iccv2017_torch.serve import (
    CodecEngine,
    ServeFleet,
    capture as capture_mod,
    quality,
    registry as registry_mod,
)
from ccsc_code_iccv2017_torch.utils import obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bank(k=4, s=3, seed=0):
    r = np.random.default_rng(seed)
    d = r.normal(size=(k, s, s)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    return d


def _geom():
    return ProblemGeom(spatial_support=(3, 3), num_filters=4)


def _cfg(**kw):
    base = dict(
        lambda_residual=5.0, lambda_prior=0.3, max_it=3, tol=0.0,
        verbose="none",
    )
    base.update(kw)
    return SolveConfig(**base)


def _scfg(**kw):
    base = dict(
        buckets=((2, (8, 8)),), max_wait_ms=2.0, verbose="none",
    )
    base.update(kw)
    return ServeConfig(**base)


def _engine(d=None, cfg=None, scfg=None):
    return CodecEngine(
        d if d is not None else _bank(),
        ReconstructionProblem(_geom()),
        cfg or _cfg(),
        scfg or _scfg(),
        device="cpu",
    )


def _req(seed, side=8):
    r = np.random.default_rng(seed)
    x = r.random((side, side)).astype(np.float32)
    return x


# ---------------------------------------------------------------------
# the shared valid-region PSNR
# ---------------------------------------------------------------------


def test_valid_region_psnr_matches_manual_crop():
    r = np.random.default_rng(0)
    rec = r.random((8, 8)).astype(np.float32)
    ref = r.random((8, 8)).astype(np.float32)
    got = quality.valid_region_psnr(rec, ref, (1, 1))
    mse = float(np.mean((rec[1:-1, 1:-1] - ref[1:-1, 1:-1]) ** 2))
    assert got == pytest.approx(10 * np.log10(1.0 / mse))
    # perfect reconstruction is finite (mse floor), not inf
    assert np.isfinite(quality.valid_region_psnr(ref, ref, (1, 1)))


def test_capture_recorded_psnr_is_bit_equal_to_shared_fn(tmp_path):
    """The satellite pin: the dB the capture outcome records IS
    round(valid_region_psnr(recon, x_orig, psf_radius), 6) — replay
    and the shadow scorer recompute with the same function, so the
    two can never drift."""
    cdir = str(tmp_path / "cap")
    geom = _geom()
    eng = _engine(
        cfg=_cfg(track_psnr=True),
        scfg=_scfg(capture_dir=cdir),
    )
    try:
        xs = [_req(i) for i in range(3)]
        results = [
            eng.reconstruct(x, x_orig=x, timeout=180) for x in xs
        ]
    finally:
        eng.close()
    for x, res in zip(xs, results):
        want = quality.valid_region_psnr(
            np.asarray(res.recon), x, geom.psf_radius
        )
        assert res.psnr == pytest.approx(want, abs=0)
    entries = capture_mod.read_workload(cdir)
    assert len(entries) == 3
    by_sha = {
        e["x_orig"]: e["outcome"] for e in entries if e.get("x_orig")
    }
    assert len(by_sha) == 3
    for x, res in zip(xs, results):
        out = by_sha[capture_mod.payload_sha(x)]
        assert out is not None
        recon = np.ascontiguousarray(
            np.asarray(res.recon, np.float32)
        )
        assert out["digest"] == capture_mod.payload_sha(recon)
        # bit-equality, not approx: both sides are the one shared
        # function rounded the one shared way
        assert out["psnr"] == round(
            quality.valid_region_psnr(recon, x, geom.psf_radius), 6
        )


# ---------------------------------------------------------------------
# dB histograms + tenant floors
# ---------------------------------------------------------------------


def test_db_bounds_table_shape():
    b = quality.DB_BOUNDS
    assert b[0] == 0.5 and b[-1] == 80.0
    steps = {round(hi - lo, 6) for lo, hi in zip(b, b[1:])}
    assert steps == {0.5}


def test_monitor_db_bucketing_and_snapshots():
    m = quality.QualityMonitor(check_s=0.0)
    for db in (20.2, 20.2, 35.0):
        assert m.observe(
            db, bank_id="bk", tenant="t", bucket="8x8"
        ) == []
    # untracked / nonfinite observations are no-ops
    m.observe(None, bank_id="bk", tenant="t", bucket="8x8")
    m.observe(float("nan"), bank_id="bk", tenant="t", bucket="8x8")
    snaps = m.raw_snapshots()
    assert len(snaps) == 1
    sn = snaps[0]
    assert (sn["bank_id"], sn["tenant"], sn["bucket"]) == (
        "bk", "t", "8x8",
    )
    assert sn["unit"] == "db" and sn["n"] == 3
    # median rank bucket is (20.0, 20.5]: upper edge, dB semantics
    assert sn["p50_ms"] == 20.5


def test_floor_breach_upper_edge_refire_dedup_and_recovery():
    spec = TenantSpec(tenant="t", min_psnr_db=30.0)
    m = quality.QualityMonitor(specs=[spec], check_s=0.0)
    # floor INSIDE the median bucket (29.5, 30.0] must not breach:
    # upper edge 30.0 is not provably below 30.0
    for db in (29.6, 29.8, 30.4):
        m.observe(db, tenant="t", bucket="8x8")
    br, snaps, _ = m.tick()
    assert br == [] and len(snaps) == 1 and m.n_breached == 0
    # provably below: every observation under (28.5, 29.0]
    for db in (28.9, 28.9, 28.9):
        m.observe(db, tenant="t", bucket="8x8")
    br, _, _ = m.tick()
    assert len(br) == 1
    assert br[0]["tenant"] == "t"
    assert br[0]["min_psnr_db"] == 30.0
    assert br[0]["observed_db"] < 30.0
    assert m.n_breached == 1
    # re-fire dedup: no new observations -> no second fire
    br, _, _ = m.tick()
    assert br == []
    assert m.n_breached == 1
    # one more low observation re-arms the judgment
    m.observe(28.9, tenant="t", bucket="8x8")
    br, _, _ = m.tick()
    assert len(br) == 1
    # recovery: pull the median well above the floor
    for _ in range(20):
        m.observe(36.2, tenant="t", bucket="8x8")
    br, _, _ = m.tick()
    assert br == [] and m.n_breached == 0


def test_monitor_tick_cadence_and_final_flush():
    m = quality.QualityMonitor(check_s=3600.0)
    m.observe(25.0, bank_id=None, tenant=None, bucket="8x8")
    assert m.tick() != ([], [], [])  # first tick always flushes
    m.observe(26.0, bank_id=None, tenant=None, bucket="8x8")
    assert m.tick() == ([], [], [])  # inside the cadence window
    _, snaps, _ = m.final()  # close flush is unconditional
    assert len(snaps) == 1 and snaps[0]["n"] == 2


def test_drift_watch_fires_once_per_excursion_and_caches_band():
    calls = []
    band = quality.quality_band([30.0] * 5, db=1.0)
    assert band is not None and band["lo"] == pytest.approx(29.0)

    def band_for(bank_id, digest):
        calls.append((bank_id, digest))
        return band if digest == "dg" else None

    m = quality.QualityMonitor(
        check_s=0.0, drift_band_for=band_for, drift_window=3
    )
    fires = []
    for _ in range(4):
        fires += m.observe(
            28.0, bank_id="bk", digest="dg", bucket="8x8"
        )
    # window fills at 3, fires once, stays silent while low
    assert len(fires) == 1
    f = fires[0]
    assert f["bank_id"] == "bk" and f["digest"] == "dg"
    assert f["rolling_db"] < f["band_lo"] == pytest.approx(29.0)
    assert f["window"] == 3
    # recovery re-arms, a second excursion fires again
    for _ in range(3):
        assert m.observe(31.0, bank_id="bk", digest="dg") == []
    fires2 = []
    for _ in range(3):
        fires2 += m.observe(28.0, bank_id="bk", digest="dg")
    assert len(fires2) == 1
    # one band lookup per (bank, digest) — cached, not per request
    assert calls.count(("bk", "dg")) == 1
    # the no-history negative is cached too
    for _ in range(3):
        m.observe(28.0, bank_id="bk", digest="other")
    assert calls.count(("bk", "other")) == 1
    # no digest -> no drift machinery at all
    assert m.observe(20.0, bank_id="bk") == []


def test_quality_band_absolute_db_floor():
    # tight history: the MAD term is tiny, the dB floor binds
    band = quality.quality_band([30.0, 30.05, 29.95], db=1.0)
    assert band["lo"] == pytest.approx(29.0)
    # wide history: the MAD term binds past the floor
    wide = quality.quality_band(
        [25.0, 30.0, 35.0, 20.0, 40.0], db=1.0
    )
    assert wide["lo"] < wide["median"] - 1.0
    assert quality.quality_band([]) is None


# ---------------------------------------------------------------------
# solve diagnostics ride the existing fence
# ---------------------------------------------------------------------


def test_solve_diag_fence_parity_and_obj_split():
    """The fence-parity assertion: turning diagnostics on adds ZERO
    dispatches (the extras subtree rides the result pytree of the
    dispatch already paid for) and changes no served bit."""
    xs = [_req(i) for i in range(4)]
    outs = {}
    stats = {}
    diags = {}
    for flag in (False, True):
        eng = _engine(cfg=_cfg(track_diagnostics=flag))
        try:
            outs[flag] = [
                np.asarray(
                    eng.reconstruct(x, timeout=180).recon
                )
                for x in xs
            ]
            stats[flag] = eng.stats()["n_dispatches"]
        finally:
            diags[flag] = eng._quality.final()[2]
            eng.close()
    assert stats[True] == stats[False]
    for a, b in zip(outs[False], outs[True]):
        assert np.array_equal(a, b)
    # iteration accounting is always on; the objective split only
    # exists when the solve actually tracked it on device
    for flag in (False, True):
        assert len(diags[flag]) == 1
        assert diags[flag][0]["n"] == len(xs)
    assert "obj_fid_mean" not in diags[False][0]
    assert "obj_fid_mean" in diags[True][0]
    assert "obj_l1_mean" in diags[True][0]
    assert diags[True][0]["nonfinite"] == 0
    d = diags[True][0]
    assert d["tol_stop_frac"] + d["maxit_stop_frac"] == pytest.approx(
        1.0
    )


# ---------------------------------------------------------------------
# golden probes
# ---------------------------------------------------------------------


def test_synth_probe_deterministic_and_unit_peak():
    d = np.asarray(_bank(), np.float32)
    a = quality.synth_probe(d, (8, 8), seed=7)
    b = quality.synth_probe(d, (8, 8), seed=7)
    assert np.array_equal(a, b)
    assert a.dtype == np.float32 and a.shape == (8, 8)
    assert np.abs(a).max() == pytest.approx(1.0, abs=1e-5)
    c = quality.synth_probe(d, (8, 8), seed=8)
    assert not np.array_equal(a, c)


def test_probe_generate_idempotent_and_persistent(tmp_path):
    pdir = str(tmp_path / "probes")
    d = np.asarray(_bank(), np.float32)
    ps = quality.ProbeSet.generate(
        pdir, _geom(), ((2, (8, 8)),), n_per_bucket=2, d=d
    )
    assert len(ps) == 2
    names = [p["name"] for p in ps.probes()]
    manifest = open(os.path.join(pdir, ps.MANIFEST)).read()
    # regenerate: nothing re-recorded, probes identical
    ps2 = quality.ProbeSet.generate(
        pdir, _geom(), ((2, (8, 8)),), n_per_bucket=2, d=d
    )
    assert [p["name"] for p in ps2.probes()] == names
    assert open(os.path.join(pdir, ps.MANIFEST)).read() == manifest
    for p in ps2.probes():
        x = ps2.load(p["x_orig"])
        assert np.array_equal(
            x, ps2.load(p["b"])
        )  # synth probes serve unmasked
        assert p["psf_radius"] == [1, 1]


def test_probe_reference_seals_then_judges_exact(tmp_path):
    pdir = str(tmp_path / "probes")
    d = _bank()
    eng = _engine(d=d)
    try:
        ps = quality.ProbeSet.generate(
            pdir, _geom(), ((2, (8, 8)),),
            d=np.asarray(d, np.float32),
        )
        first = ps.run(eng, timeout=180)
        assert [v["status"] for v in first] == ["reference"]
        dg = first[0]["digest"]
        assert dg == eng.bank_digest()
        assert ps.reference(first[0]["probe"], dg) is not None
        # the same digest re-served is bit-exact against its sealed
        # reference — and a RELOADED set judges identically
        again = ps.run(eng, timeout=180)
        assert [v["status"] for v in again] == ["exact"]
        reloaded = quality.ProbeSet(pdir)
        assert [
            v["status"] for v in reloaded.run(eng, timeout=180)
        ] == ["exact"]
    finally:
        eng.close()


class _FakeTarget:
    """A reconstruct/bank_digest shim: ProbeSet.run needs nothing
    else, which keeps the rot-guard truth table exact and fast."""

    def __init__(self, digest, degrade=0.0, seed=3):
        self._digest = digest
        self._degrade = float(degrade)
        self._rng = np.random.default_rng(seed)

    def bank_digest(self, bank_id=None):
        return self._digest

    def reconstruct(
        self, b, mask=None, x_orig=None, bank_id=None, timeout=None
    ):
        noise = np.random.default_rng(0).standard_normal(
            b.shape
        ).astype(np.float32)
        recon = b + (0.001 + self._degrade) * noise

        class _R:
            pass

        r = _R()
        r.recon = recon.astype(np.float32)
        return r


def test_probe_bank_rot_guard_and_standing_reference_link(tmp_path):
    """The guard truth table: a digest the bank never served may
    self-seal only when it does NOT regress the bank's standing
    reference — including when that reference was first sealed under
    a different bank id sharing the digest (the link rule)."""
    pdir = str(tmp_path / "probes")
    ps = quality.ProbeSet.generate(
        pdir, _geom(), ((1, (8, 8)),), seed=5,
        d=np.asarray(_bank(), np.float32),
    )
    name = ps.probes()[0]["name"]
    good = _FakeTarget("dg-good", degrade=0.0)
    rot = _FakeTarget("dg-rot", degrade=0.3)  # several dB worse
    peer = _FakeTarget("dg-peer", degrade=0.0)

    # 1. the DEFAULT bank seals the good digest's reference
    assert ps.run(good)[0]["status"] == "reference"
    # 2. bank id "bk" serves the SAME digest: judged exact, and the
    #    reference is linked as bk's standing baseline
    v = ps.run(good, bank_id="bk")
    assert v[0]["status"] == "exact"
    # 3. a never-seen digest that regresses bk's standing reference
    #    is judged regressed — NOT blessed as its own baseline
    v = ps.run(rot, bank_id="bk")
    assert v[0]["status"] == "regressed"
    assert v[0]["ref_db"] is not None
    assert v[0]["db"] < float(v[0]["ref_db"]) - v[0]["db_tol"]
    assert ps.reference(name, "dg-rot") is None
    # ... and the verdict survives a reload (the link was persisted)
    assert (
        quality.ProbeSet(pdir).run(rot, bank_id="bk")[0]["status"]
        == "regressed"
    )
    # 4. swapping back to the referenced digest re-judges bit-exact
    assert ps.run(good, bank_id="bk")[0]["status"] == "exact"
    # 5. a never-seen digest that does NOT regress may seal its own
    assert (
        ps.run(peer, bank_id="bk")[0]["status"] == "reference"
    )
    assert ps.reference(name, "dg-peer") is not None


def test_resolve_probe_dir_chain(monkeypatch):
    monkeypatch.delenv("CCSC_PROBE_DIR", raising=False)
    assert quality.resolve_probe_dir(None) is None
    assert quality.resolve_probe_dir("/x") == "/x"
    monkeypatch.setenv("CCSC_PROBE_DIR", "/envd")
    assert quality.resolve_probe_dir(None) == "/envd"
    assert quality.resolve_probe_dir("/x") == "/x"
    # explicit empty string is OFF regardless of the env
    assert quality.resolve_probe_dir("") is None


# ---------------------------------------------------------------------
# fleet integration: probe scheduling + capture probe-skip
# ---------------------------------------------------------------------


def test_fleet_probe_schedule_events_and_capture_skip(tmp_path):
    mdir = str(tmp_path / "metrics")
    pdir = str(tmp_path / "probes")
    cdir = str(tmp_path / "cap")
    interval = 0.25
    fleet = ServeFleet(
        _bank(),
        ReconstructionProblem(_geom()),
        _cfg(),
        _scfg(),
        FleetConfig(
            replicas=1, metrics_dir=mdir, min_queue_depth=64,
            restart_backoff_s=0.05, verbose="none",
            capture_dir=cdir,
            probe_dir=pdir, probe_interval_s=interval,
        ),
        device="cpu",
    )
    try:
        x = _req(1)
        fleet.submit(x, x_orig=x, key="real-0").result(timeout=180)
        # idle fleet: the probe thread must sweep on its own clock
        deadline = time.time() + 40 * interval
        probed = []
        while time.time() < deadline:
            probed = [
                e
                for e in obs.read_events(mdir, recursive=True)
                if e.get("type") == "quality_probe"
            ]
            if len(probed) >= 2:
                break
            time.sleep(interval / 2)
    finally:
        fleet.close()
    assert len(probed) >= 2
    # first sweep seals, later sweeps are bit-exact on an unchanged
    # bank — never a breach
    statuses = [e["status"] for e in probed]
    assert statuses[0] == "reference"
    assert set(statuses) <= {"reference", "exact", "db_ok"}
    assert fleet.metrics()["counters"]["probe_failures_total"] == 0
    assert fleet.quality_advice() == []
    ps = quality.ProbeSet(pdir)
    assert len(ps) >= 1
    # probe traffic is NOT captured workload: replaying the capture
    # must reproduce the real request stream only
    keys = [e["key"] for e in capture_mod.read_workload(cdir)]
    assert keys == ["real-0"]
    assert not any(
        k.startswith(quality.PROBE_KEY_PREFIX) for k in keys
    )


# ---------------------------------------------------------------------
# shadow scoring + the gate
# ---------------------------------------------------------------------


def _seed_quality_ledger(path, live_digest, values, bank="default"):
    led = ledger_mod.Ledger(path)
    for v in values:
        rec = ledger_mod.normalize_record(
            chip="testchip", kind="quality", value=float(v),
            unit="db", workload="w", shape_key="sk",
            knobs={"bank": bank}, source="test",
        )
        rec.update(digest=live_digest)
        led.append(rec)
    return led


def test_score_bank_ledger_keying_by_digest(tmp_path):
    cdir = str(tmp_path / "cap")
    lpath = str(tmp_path / "led.jsonl")
    d_live = _bank(seed=0)
    d_cand = _bank(seed=9)
    eng = _engine(
        d=d_live,
        cfg=_cfg(track_psnr=True),
        scfg=_scfg(capture_dir=cdir),
    )
    try:
        for i in range(3):
            x = _req(10 + i)
            eng.reconstruct(x, x_orig=x, timeout=180)
    finally:
        eng.close()
    rec_live = quality.score_bank(
        cdir, d_live, ledger_path=lpath, timeout=180, device="cpu"
    )
    rec_cand = quality.score_bank(
        cdir, d_cand, ledger_path=lpath, timeout=180, device="cpu"
    )
    assert rec_live["kind"] == rec_cand["kind"] == "quality"
    assert rec_live["unit"] == "db"
    assert rec_live["digest"] == registry_mod.bank_digest(d_live)
    assert rec_cand["digest"] == registry_mod.bank_digest(d_cand)
    assert rec_live["digest"] != rec_cand["digest"]
    assert rec_live["knobs"] == {"bank": "default"}
    assert rec_live["n_scored"] == 3
    assert rec_live["min_db"] <= rec_live["p10_db"]
    # both banks land under ONE ledger key: the digest is a record
    # field the gate partitions by, never part of the key
    led = ledger_mod.Ledger(lpath)
    keys = {
        k
        for k, rows in led.by_key().items()
        if any(r.get("kind") == "quality" for r in rows)
    }
    assert len(keys) == 1


def test_judge_candidate_and_gate_publish(tmp_path):
    lpath = str(tmp_path / "led.jsonl")
    led = _seed_quality_ledger(
        lpath, "dg-live", [30.0, 30.1, 29.9]
    )
    for dg, val in (("dg-ok", 29.8), ("dg-bad", 25.0)):
        rec = ledger_mod.normalize_record(
            chip="testchip", kind="quality", value=val, unit="db",
            workload="w", shape_key="sk",
            knobs={"bank": "default"}, source="test",
        )
        rec.update(digest=dg)
        led.append(rec)
    led = ledger_mod.Ledger(lpath)
    ok = quality.judge_candidate(led, "dg-ok", db=1.0)
    assert len(ok) == 1 and ok[0]["ok"] and not ok[0]["skipped"]
    # live history = every record under another digest (3 seeded
    # live records + the other candidate's score)
    assert ok[0]["n_history"] == 4
    bad = quality.judge_candidate(led, "dg-bad", db=1.0)
    assert len(bad) == 1 and not bad[0]["ok"]
    assert bad[0]["value"] == 25.0 and bad[0]["lo"] > 25.0
    # unknown digest: nothing to judge
    assert quality.judge_candidate(led, "dg-nope") == []
    # thin live history is a trivial pass, reported as skipped
    thin = quality.judge_candidate(
        led, "dg-bad", db=1.0, min_history=10
    )
    assert thin[0]["skipped"] and thin[0]["ok"]
    # the publish guard raises on the regression verdict only
    assert quality.gate_publish("dg-ok", ledger_path=lpath)
    with pytest.raises(quality.QualityGateError) as ei:
        quality.gate_publish("dg-bad", ledger_path=lpath)
    assert ei.value.verdicts and not ei.value.verdicts[0]["ok"]


def test_quality_gate_cli_exit_codes_match_jax(tmp_path):
    """``python -m ccsc_code_iccv2017_torch.serve.quality_gate`` gives
    the JAX ``scripts/quality_gate.py``'s exit code and output on the
    same ledger: 0 clean, 1 regression, 2 usage (unknown candidate)."""
    lpath = str(tmp_path / "led.jsonl")
    led = _seed_quality_ledger(
        lpath, "dg-live", [30.0, 30.1, 29.9]
    )
    for dg, val in (("dg-ok", 29.8), ("dg-bad", 25.0)):
        rec = ledger_mod.normalize_record(
            chip="testchip", kind="quality", value=val, unit="db",
            workload="w", shape_key="sk",
            knobs={"bank": "default"}, source="test",
        )
        rec.update(digest=dg)
        led.append(rec)

    import contextlib
    import importlib.util
    import io

    from ccsc_code_iccv2017_torch.serve import quality_gate

    spec = importlib.util.spec_from_file_location(
        "jax_quality_gate", os.path.join(REPO, "scripts", "quality_gate.py"))
    jgate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jgate)

    def gate(main, *args):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = main(["--ledger", lpath, *args])
        return rc, out.getvalue(), err.getvalue()

    cases = [
        (("--candidate", "dg-ok", "--db", "1.0"), 0),
        (("--candidate", "dg-bad", "--db", "1.0"), 1),
        (("--candidate", "dg-bad", "--db", "1.0", "--json"), 1),
        (("--candidate", "dg-absent"), 2),
        ((), 2),
        (("--list",), 0),
    ]
    for args, rc in cases:
        got, want = gate(quality_gate.main, *args), gate(jgate.main, *args)
        assert got == want, args
        assert got[0] == rc, args
    assert "0 regression(s)" in gate(quality_gate.main, "--candidate",
                                     "dg-ok", "--db", "1.0")[1]
    # the module entry point a CI job runs, with its exit status
    r = subprocess.run(
        [sys.executable, "-m", "ccsc_code_iccv2017_torch.serve.quality_gate",
         "--ledger", lpath, "--candidate", "dg-bad", "--db", "1.0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 1, r.stdout + r.stderr
    assert "REGRESSION" in r.stdout


# ---------------------------------------------------------------------
# against the JAX package on the same inputs
# ---------------------------------------------------------------------


def _db_stream(n=400, seed=4):
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        v = float(r.normal(30.0 if i < n // 2 else 26.0, 1.5))
        out.append((v, ("bk", "bk2", None)[i % 3],
                    ("t", "u", None)[i % 3 if i % 5 else 0],
                    ("8x8", "16x16")[i % 2], ("dg", "dg2")[i % 2]))
    return out


def test_quality_monitor_records_match_jax():
    """Both monitors, fed the same PSNR stream and solve diagnostics,
    return the same breach, histogram, drift and diagnostic records
    (time stamps aside)."""
    band = quality.quality_band([30.0] * 5, db=1.0)
    assert band == jquality.quality_band([30.0] * 5, db=1.0)

    def make(mod, spec_cls):
        specs = (spec_cls(tenant="t", min_psnr_db=29.0),
                 spec_cls(tenant="u", min_psnr_db=20.0))
        return mod.QualityMonitor(
            specs=specs, check_s=0.0, drift_window=4,
            drift_band_for=lambda b, dg: band if dg == "dg" else None)

    from ccsc_code_iccv2017_tpu import config as jcfg

    pm, jm = make(quality, TenantSpec), make(jquality, jcfg.TenantSpec)

    def strip(recs):
        return [{k: v for k, v in r.items() if k not in ("t", "ts")}
                for r in recs]

    r = np.random.default_rng(9)
    for i, (db, bank, tenant, bucket, dg) in enumerate(_db_stream()):
        got = pm.observe(db, bank_id=bank, tenant=tenant, bucket=bucket,
                         digest=dg)
        want = jm.observe(db, bank_id=bank, tenant=tenant, bucket=bucket,
                          digest=dg)
        assert strip(got) == strip(want), i
        if i % 7 == 0:
            iters = r.integers(1, 4, size=2)
            kw = dict(obj_fid=r.random(2).astype(np.float32),
                      obj_l1=r.random(2).astype(np.float32),
                      nonfinite=np.zeros(2, np.int32))
            pm.observe_solve(bucket, iters, 3, **kw)
            jm.observe_solve(bucket, iters, 3, **kw)
        if i % 50 == 0:
            assert [strip(x) for x in pm.tick()] == [
                strip(x) for x in jm.tick()]
            assert pm.n_breached == jm.n_breached
    got, want = pm.final(), jm.final()
    assert [strip(x) for x in got] == [strip(x) for x in want]
    assert got[0] and got[1] and got[2]  # breaches, histograms, diags
    assert strip(pm.raw_snapshots()) == strip(jm.raw_snapshots())


@pytest.mark.parametrize("spatial,seed", [((8, 8), 7), ((12, 9), 0),
                                          ((32, 32), 123)])
def test_synth_probe_matches_jax(spatial, seed):
    d = _bank(k=5, s=3, seed=2)
    got = quality.synth_probe(d, spatial, seed)
    want = jquality.synth_probe(d, spatial, seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_score_bank_and_gate_match_jax(tmp_path):
    """The same capture scored by both packages: the port's record has
    JAX's key fields (chip aside: the port names its device), the same
    digest and count, and a median within 1e-3 dB; both packages' gate
    gives the same verdict on the port's ledger."""
    from ccsc_code_iccv2017_tpu.analysis import ledger as jledger

    cdir = str(tmp_path / "cap")
    d_live = _bank(seed=0)
    eng = _engine(d=d_live, cfg=_cfg(track_psnr=True),
                  scfg=_scfg(capture_dir=cdir))
    try:
        for i in range(3):
            x = _req(10 + i)
            eng.reconstruct(x, x_orig=x, timeout=180)
    finally:
        eng.close()
    lp, lj = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    got = quality.score_bank(cdir, d_live, ledger_path=lp, timeout=180,
                             device="cpu")
    want = jquality.score_bank(cdir, d_live, ledger_path=lj, timeout=180)
    for k in ("kind", "unit", "workload", "shape_key", "knobs", "digest",
              "n_scored", "source"):
        assert got[k] == want[k], k
    assert got["chip"] == "cpu"
    for k in ("value", "p10_db", "min_db"):
        assert abs(got[k] - want[k]) <= 1e-3, k
    for dg in (got["digest"], "dg-none"):
        assert quality.judge_candidate(ledger_mod.Ledger(lp), dg) == \
            jquality.judge_candidate(jledger.Ledger(lp), dg)
    assert quality.gate_publish(got["digest"], ledger_path=lp) == \
        jquality.gate_publish(got["digest"], ledger_path=lp)
