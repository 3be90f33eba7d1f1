"""The port's serving fleet (``ccsc_code_iccv2017_torch.serve.ServeFleet``)
on the CPU, against its own single engine and against the JAX
``ServeFleet``, at the JAX fleet tests' tiny problem (k=4 3x3 bank, a
2-slot 12x12 bucket, max_it 3-4; tests/test_fleet.py).

Contracts under test, as in the JAX package:
- CHAOS PARITY: with replicas and injected kill + hang faults
  mid-stream, every request completes with a result bit-identical to a
  single unfaulted engine's serve of the same request, zero requests
  are lost or served twice, and the restarted casualty rejoins and
  serves — all asserted from the obs stream;
- requeue idempotency: a request handed off mid-dispatch is served
  exactly once; a recovered straggler's late result is suppressed
  (at-most-once delivery);
- admission control: beyond the queue ceiling submit raises an
  explicit ``Overloaded`` with a retry-after hint, and the overload
  ladder walks shed-batching -> reject -> degrade and back;
- the JAX package's stream readers (``obs.read_events(recursive=True)``,
  ``watchdog.check_replicas``, ``scripts/obs_report.py`` FLEET) read
  the port fleet's stream.

Tolerances: the port fleet vs its own single engine, bit for bit; vs
the JAX fleet, recon within REC_TOL = 1e-4 of max|ref| and the
objective traces rtol TRACE_RTOL = 1e-4 (tests/test_torch_serve.py:
float32 ADMM iterates whose FFTs and sums run in another order).
Every wait has its own limit, so a hang fails a test, not the suite.
"""
import importlib
import os
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest

from ccsc_code_iccv2017_tpu import config as jcfg
from ccsc_code_iccv2017_tpu import serve as jserve
from ccsc_code_iccv2017_tpu.utils import faults as jfaults
from ccsc_code_iccv2017_tpu.utils import obs as jobs
from ccsc_code_iccv2017_torch.config import (
    FleetConfig,
    ProblemGeom,
    ServeConfig,
    SolveConfig,
)
from ccsc_code_iccv2017_torch.models.reconstruct import (
    ReconstructionProblem,
)
from ccsc_code_iccv2017_torch.serve import (
    CodecEngine,
    Overloaded,
    ServeFleet,
)
from ccsc_code_iccv2017_torch.serve.fleet import _FleetRequest
from ccsc_code_iccv2017_torch.utils import faults, obs
from ccsc_code_iccv2017_torch.utils.validate import CCSCInputError

REC_TOL = 1e-4
TRACE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _fault_isolation(monkeypatch):
    for v in (
        "CCSC_FAULT_ENGINE_KILL_REQ",
        "CCSC_FAULT_ENGINE_KILL_REPLICA",
        "CCSC_FAULT_ENGINE_HANG_REQ",
        "CCSC_FAULT_ENGINE_HANG_REPLICA",
        "CCSC_FAULT_ENGINE_HANG_S",
        "CCSC_FAULT_ENGINE_SLOW_REQ",
        "CCSC_FAULT_ENGINE_SLOW_REPLICA",
        "CCSC_FAULT_ENGINE_SLOW_S",
        "CCSC_REQ_DEADLINE_MS",
        "CCSC_HEDGE_AFTER_MS",
        "CCSC_FAULT_STATE_DIR",
        "CCSC_WATCHDOG_ACTION",
        "CCSC_WATCHDOG_MIN_S",
        "CCSC_WATCHDOG_COMPILE_S",
    ):
        monkeypatch.delenv(v, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _bank(k=4, s=3, seed=0):
    r = np.random.default_rng(seed)
    d = r.normal(size=(k, s, s)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    return d


def _cfg(**kw):
    base = dict(
        lambda_residual=5.0, lambda_prior=0.3, max_it=4, tol=0.0,
        verbose="none", track_objective=True,
    )
    base.update(kw)
    return SolveConfig(**base)


def _reqs(n, side=12, seed=1):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = r.random((side, side)).astype(np.float32)
        m = (r.random((side, side)) < 0.5).astype(np.float32)
        out.append((x, m))
    return out


def _fleet(d, cfg, tmp_path=None, *, buckets=((2, (12, 12)),),
           serve_kw=None, **kw):
    scfg = ServeConfig(
        buckets=buckets, max_wait_ms=kw.pop("max_wait_ms", 2.0),
        verbose="none", **(serve_kw or {}),
    )
    fkw = dict(
        min_queue_depth=64, restart_backoff_s=0.05,
        heartbeat_s=0.2, health_interval_s=0.05, verbose="none",
        metrics_dir=str(tmp_path) if tmp_path is not None else None,
    )
    fkw.update(kw)
    geom = ProblemGeom(d.shape[1:], d.shape[0])
    return ServeFleet(
        d, ReconstructionProblem(geom), cfg, scfg, FleetConfig(**fkw),
        device="cpu",
    )


def _single_engine_results(d, cfg, reqs, buckets=((2, (12, 12)),)):
    """The parity reference: one unfaulted CodecEngine, same pinned
    (bank, problem, SolveConfig, buckets)."""
    scfg = ServeConfig(buckets=buckets, max_wait_ms=2.0, verbose="none")
    geom = ProblemGeom(d.shape[1:], d.shape[0])
    eng = CodecEngine(d, ReconstructionProblem(geom), cfg, scfg,
                      device="cpu")
    try:
        futs = [eng.submit(x * m, mask=m) for x, m in reqs]
        return [f.result(timeout=180) for f in futs]
    finally:
        eng.close()


# ------------------------------------------------------------- basics


def test_fleet_single_replica_bit_identical_no_faults():
    d = _bank()
    cfg = _cfg()
    reqs = _reqs(4)
    ref = _single_engine_results(d, cfg, reqs)
    fleet = _fleet(d, cfg, replicas=1)
    try:
        futs = [fleet.submit(x * m, mask=m) for x, m in reqs]
        res = [f.result(timeout=180) for f in futs]
    finally:
        fleet.close()
    for i in range(len(reqs)):
        np.testing.assert_array_equal(res[i].recon, ref[i].recon)
        assert int(res[i].trace.num_iters) == int(
            ref[i].trace.num_iters
        )


def test_idempotency_key_api():
    d = _bank()
    fleet = _fleet(d, _cfg(), replicas=1, max_wait_ms=500.0)
    try:
        x, m = _reqs(1)[0]
        f1 = fleet.submit(x * m, mask=m, key="dup")
        f2 = fleet.submit(x * m, mask=m, key="dup")
        assert f1 is f2  # still in flight: the SAME future
        res = f1.result(timeout=120)
        assert res.recon.shape == (12, 12)
        # wait until delivery bookkeeping has settled
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                fleet.submit(x * m, mask=m, key="dup")
            except CCSCInputError as e:
                assert "already served" in str(e)
                break
            time.sleep(0.02)
        else:
            pytest.fail("resubmitting a served key was not refused")
    finally:
        fleet.close()


def test_fleet_close_reentrant_and_submit_after_close():
    d = _bank()
    fleet = _fleet(d, _cfg(), replicas=1)
    x, m = _reqs(1)[0]
    fleet.reconstruct(x * m, mask=m)
    assert not fleet.closed
    fleet.close()
    assert fleet.closed
    fleet.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        fleet.submit(x * m, mask=m)


def test_requeue_max_attempts_exhausted_errors():
    """The exactly-once-OR-ERROR half of the delivery contract: a
    request whose ownership budget is spent gets an explicit error on
    requeue, never a silent retry-forever."""
    d = _bank()
    fleet = _fleet(d, _cfg(), replicas=1, max_attempts=2)
    try:
        rep = fleet._replicas[0]
        req = _FleetRequest(
            key="doomed", b=np.zeros((12, 12), np.float32), mask=None,
            smooth_init=None, x_orig=None, future=Future(),
            t_submit=time.perf_counter(), attempts=2,
        )
        with fleet._cv:
            fleet._index["doomed"] = req
            rep.assigned.append(req)
        fleet._requeue_from(rep, reason="test")
        with pytest.raises(RuntimeError, match="delivery attempts"):
            req.future.result(timeout=5)
        assert fleet.stats()["n_failed"] == 1
    finally:
        fleet.close()


def test_failed_key_is_spent_and_late_result_suppressed():
    """Exactly-once-OR-error means OR: once a key's future carries the
    max_attempts error, a recovered straggler's late result for it is
    suppressed (not recorded as a served request) and resubmitting the
    key is refused — the client can never see both an error and a
    result for one key."""
    d = _bank()
    fleet = _fleet(d, _cfg(), replicas=1, max_attempts=1)
    try:
        x, m = _reqs(1)[0]
        res = fleet.reconstruct(x * m, mask=m, timeout=120)
        rep = fleet._replicas[0]
        req = _FleetRequest(
            key="doomed", b=x * m, mask=m, smooth_init=None,
            x_orig=None, future=Future(),
            t_submit=time.perf_counter(), attempts=1,
        )
        with fleet._cv:
            fleet._index["doomed"] = req
            rep.assigned.append(req)
        fleet._requeue_from(rep, reason="test")
        with pytest.raises(RuntimeError, match="delivery attempts"):
            req.future.result(timeout=5)
        n_before = fleet.stats()["n_requests"]
        served_before = rep.served
        # the straggler wakes with a late result for the failed key
        fleet._deliver(rep, req, res)
        st = fleet.stats()
        assert st["n_requests"] == n_before  # not recorded as served
        assert rep.served == served_before
        assert st["n_duplicates_suppressed"] == 1
        with pytest.raises(RuntimeError, match="delivery attempts"):
            req.future.result(timeout=0)  # error stands, no result
        with pytest.raises(CCSCInputError, match="already failed"):
            fleet.submit(x * m, mask=m, key="doomed")
    finally:
        fleet.close()


def test_take_drops_requeued_copy_of_resolved_key():
    """A requeued copy of a key a straggler already delivered must be
    dropped inside _take — running the full solve only to have the
    delivery suppressed would waste a dispatch."""
    d = _bank()
    fleet = _fleet(d, _cfg(), replicas=1, max_wait_ms=2.0)
    try:
        x, m = _reqs(1)[0]
        fleet.reconstruct(x * m, mask=m, key="k1", timeout=120)
        ghost = _FleetRequest(
            key="k1", b=x * m, mask=m, smooth_init=None, x_orig=None,
            future=Future(), t_submit=time.perf_counter(), attempts=1,
        )
        with fleet._cv:
            fleet._index["k1"] = ghost
            fleet._queue.append(ghost)
            fleet._cv.notify_all()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with fleet._cv:
                if not fleet._queue and "k1" not in fleet._index:
                    break
            time.sleep(0.02)
        else:
            pytest.fail("requeued copy of a delivered key not dropped")
        st = fleet.stats()
        assert st["n_requests"] == 1  # the real delivery only
        # dropped BEFORE the solve: nothing reached _deliver to be
        # suppressed there
        assert st["n_duplicates_suppressed"] == 0
        assert not ghost.future.done()
    finally:
        fleet.close()


def test_transient_all_retired_does_not_fail_queue():
    """Replica 0 is abandoned (budget exhausted) while replica 1 sits
    in restart backoff: the queue must survive — only when EVERY
    replica is abandoned do pending futures get the no-capacity
    error."""
    d = _bank()
    fleet = _fleet(d, _cfg(), replicas=2)
    try:
        req = _FleetRequest(
            key="pending", b=np.zeros((12, 12), np.float32), mask=None,
            smooth_init=None, x_orig=None, future=Future(),
            t_submit=time.perf_counter(),
        )
        with fleet._cv:
            for rep in fleet._replicas:
                rep.retired = True  # both transiently down
            fleet._abandoned.add(0)  # only replica 0 is terminal
            fleet._index["pending"] = req
            fleet._queue.append(req)
            fleet._fail_if_no_capacity()
            assert len(fleet._queue) == 1  # replica 1 is coming back
            assert not req.future.done()
            fleet._abandoned.add(1)  # now nobody is coming back
            fleet._fail_if_no_capacity()
            assert not fleet._queue
        with pytest.raises(RuntimeError, match="no live replicas"):
            req.future.result(timeout=5)
        # and the door is closed: a fresh submit is refused up front
        # instead of returning a future no worker will ever take
        x, m = _reqs(1)[0]
        with pytest.raises(RuntimeError, match="no live replicas"):
            fleet.submit(x * m, mask=m)
    finally:
        with fleet._cv:  # let close() retire them cleanly
            for rep in fleet._replicas:
                rep.retired = False
        fleet.close()


def test_replica_death_drains_engine_queue():
    """The crash path hands the casualty's engine-queued work back via
    drain_pending (the documented handoff hook) before closing it, so
    close() never spends a dispatch on results nobody will read."""
    d = _bank()
    fleet = _fleet(d, _cfg(), replicas=1)
    try:
        rep = fleet._replicas[0]
        calls = []
        orig = rep.engine.drain_pending
        rep.engine.drain_pending = lambda: calls.append(1) or orig()
        fleet._on_replica_death(rep, RuntimeError("injected"))
        assert calls, "death path did not drain the engine queue"
        # the replacement rejoins and serves
        x, m = _reqs(1)[0]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with fleet._cv:
                live = not fleet._replicas[0].retired
            if live:
                break
            time.sleep(0.05)
        res = fleet.reconstruct(x * m, mask=m, timeout=120)
        assert res.recon.shape == (12, 12)
    finally:
        fleet.close()


def test_delivery_bookkeeping_is_bounded():
    """A long-lived fleet must not grow per-request state forever: the
    served/failed key stores are capped at FleetConfig.key_window
    (newest win) and the latency sample at latency_window, while the
    delivered COUNT keeps counting — the admission control that
    prevents queue OOM must not be undermined by the bookkeeping."""
    d = _bank()
    fleet = _fleet(
        d, _cfg(), replicas=1, key_window=4, latency_window=3,
    )
    try:
        for i, (x, m) in enumerate(_reqs(8, seed=11)):
            fleet.reconstruct(x * m, mask=m, key=f"b{i}", timeout=120)
        st = fleet.stats()
        assert st["n_requests"] == 8  # the count never truncates
        assert len(fleet._delivered) == 4  # the keys do
        assert len(fleet._latencies) == 3
        # the newest keys are the ones remembered
        assert list(fleet._delivered) == [f"b{i}" for i in range(4, 8)]
        # inside the window the idempotency refusal still holds
        x, m = _reqs(1)[0]
        with pytest.raises(CCSCInputError, match="already served"):
            fleet.submit(x * m, mask=m, key="b7")
    finally:
        fleet.close()


def test_derived_ceiling_credits_degraded_budget():
    """Rung 3 recycles replicas onto max_it x degrade_max_it_factor,
    which raises real request throughput — serving_bound must be
    computed with the EFFECTIVE budget, or the admission ceiling and
    retry-after undersell exactly the capacity the degrade bought."""
    from ccsc_code_iccv2017_torch.utils import perfmodel

    d = _bank()
    fleet = _fleet(
        d, _cfg(max_it=8), replicas=1, max_queue_depth=10,
        degrade_max_it_factor=0.5,
        health_interval_s=30.0,  # keep the monitor out of the way
    )
    try:
        rep = fleet._replicas[0]
        rep.engine._last_it_rate = 100.0  # a measured dispatch rate
        fleet._update_ceiling(perfmodel, [rep])
        rps_full = fleet._bound_rps
        assert rps_full > 0
        fleet._degraded = True
        fleet._update_ceiling(perfmodel, [rep])
        assert fleet._bound_rps == pytest.approx(2.0 * rps_full)
    finally:
        fleet._degraded = False
        fleet.close()


def test_constructor_failure_stops_spawned_watchdogs(monkeypatch):
    """ServeFleet.__init__'s failure path must release EVERYTHING the
    replicas it did manage to spawn acquired — not just their engines.
    A supervisor that retries fleet construction in a loop would
    otherwise accumulate one ccsc-watchdog poll thread per spawned
    replica per failed attempt for the life of the process."""
    import threading

    from ccsc_code_iccv2017_torch.serve import fleet as fleet_mod

    def _dogs():
        return sum(
            t.name == "ccsc-watchdog" and t.is_alive()
            for t in threading.enumerate()
        )

    before = _dogs()
    real_engine = fleet_mod.CodecEngine
    calls = {"n": 0}

    def flaky_engine(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("boom: replica 1 failed to build")
        return real_engine(*a, **kw)

    monkeypatch.setattr(fleet_mod, "CodecEngine", flaky_engine)
    with pytest.raises(RuntimeError, match="replica 1 failed"):
        _fleet(_bank(), _cfg(), replicas=2)
    assert calls["n"] == 2
    # watchdog.stop() joins (2s); poll briefly for the quiet exit
    deadline = time.monotonic() + 5.0
    while _dogs() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _dogs() == before


def test_recycle_thread_is_joined_by_close():
    """The rung-3 recycle walker is a TRACKED thread (lint:
    thread-safety): close() joins it, so an interpreter exit can never
    catch it alive mid-work."""
    import threading

    d = _bank()
    fleet = _fleet(d, _cfg(), replicas=1)
    try:
        fleet._start_recycle()
        assert fleet._recycle_thread is not None
    finally:
        fleet.close()
    assert not fleet._recycle_thread.is_alive()
    assert not any(
        t.name == "ccsc-fleet-recycle" and t.is_alive()
        for t in threading.enumerate()
    )


def test_malformed_hang_env_never_crashes(monkeypatch):
    """The chaos knobs keep the module's never-crash stance: a typo'd
    CCSC_FAULT_ENGINE_HANG_S must not raise from inside the replica
    worker (where it would be booked as a replica crash and burn
    restart budget on every restarted generation)."""
    monkeypatch.setenv("CCSC_FAULT_ENGINE_HANG_REQ", "1")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_HANG_S", "10s")
    faults.reset()
    dur = faults.engine_hang_request(0, 1)
    assert dur == 3600.0  # the wedged-forever default, not a raise


def _recycling_with_inflight(fleet, key="inflight"):
    """Put replica 0 in the state the rung-3 recycle loop leaves it in
    — retired, state='recycling', handoff NOT yet performed — with one
    request still in flight on it."""
    x, m = _reqs(1)[0]
    rep = fleet._replicas[0]
    req = _FleetRequest(
        key=key, b=x * m, mask=m, smooth_init=None, x_orig=None,
        future=Future(), t_submit=time.perf_counter(), attempts=1,
    )
    with fleet._cv:
        rep.retired = True
        rep.state = "recycling"
        fleet._index[key] = req
        rep.assigned.append(req)
    return rep, req


def test_recycling_replica_crash_still_hands_off():
    """A replica retired for a rung-3 recycle that CRASHES mid-dispatch
    (before its clean recycle exit) still owes its casualty handoff:
    its in-flight requests must be requeued onto the replacement and
    the slot respawned. Regression — the death handler used to treat
    any ``retired`` replica as already drained, leaving the requests'
    futures hanging forever and the slot a dead husk (``reaped``, not
    ``retired``, gates the handoff)."""
    d = _bank()
    fleet = _fleet(d, _cfg(), replicas=1)
    try:
        rep, req = _recycling_with_inflight(fleet)
        # the worker crashes before the clean recycle exit could run
        fleet._on_replica_death(rep, RuntimeError("injected"))
        assert rep.reaped
        # the request was requeued, the replacement spawns and serves
        # it — the future resolves instead of hanging until close
        res = req.future.result(timeout=180)
        assert res.recon.shape == (12, 12)
        cur = fleet._replicas[0]
        assert cur.generation == rep.generation + 1
        assert fleet.stats()["n_requeued"] == 1
    finally:
        fleet.close()


def test_recycling_replica_stall_still_hands_off():
    """Same hole via the stall path: a wedged recycling worker fires
    the watchdog — the stall handler must not early-return on
    ``retired`` but drain and respawn like any other casualty."""
    d = _bank()
    fleet = _fleet(d, _cfg(), replicas=1)
    try:
        rep, req = _recycling_with_inflight(fleet, key="stalled")
        fleet._on_replica_stall(rep, "replica0-dispatch")
        assert rep.reaped
        res = req.future.result(timeout=180)
        assert res.recon.shape == (12, 12)
        assert fleet._replicas[0].generation == rep.generation + 1
    finally:
        fleet.close()


# ------------------------------------------------------- chaos parity


def test_chaos_kill_hang_zero_lost_bit_identical(tmp_path, monkeypatch):
    """The acceptance chaos test: 3 replicas, replica 0 killed
    and replica 1 hung mid-stream. Every request completes exactly
    once, bit-identical to a single unfaulted engine; the hung
    straggler's late deliveries are suppressed; both casualties
    restart, rejoin, and serve — all read back from the obs stream."""
    monkeypatch.setenv("CCSC_FAULT_ENGINE_KILL_REQ", "2")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_KILL_REPLICA", "0")
    # replica 1 hangs on its FIRST take: that fence's deadline is
    # MIN_S a request + COMPILE_S (4.5 s for a 2-slot batch) whatever
    # the host's pace, where a later one calibrates on measured fences
    # that a loaded CPU makes arbitrarily slow
    monkeypatch.setenv("CCSC_FAULT_ENGINE_HANG_REQ", "1")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_HANG_REPLICA", "1")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_HANG_S", "8.0")
    monkeypatch.setenv("CCSC_WATCHDOG_MIN_S", "1.5")
    monkeypatch.setenv("CCSC_WATCHDOG_COMPILE_S", "1.5")
    faults.reset()
    d = _bank()
    cfg = _cfg()
    reqs = _reqs(12)
    ref = _single_engine_results(d, cfg, reqs)

    fleet = _fleet(d, cfg, tmp_path, replicas=3)
    try:
        futs = [
            fleet.submit(x * m, mask=m, key=f"k{i}")
            for i, (x, m) in enumerate(reqs)
        ]
        res = [f.result(timeout=300) for f in futs]

        # zero lost: every future resolved with a real result,
        # bit-identical to the unfaulted single-engine serve
        assert len(res) == 12
        for i in range(12):
            np.testing.assert_array_equal(res[i].recon, ref[i].recon)
            assert int(res[i].trace.num_iters) == int(
                ref[i].trace.num_iters
            )

        # the casualties rejoin: wait for 3 live replicas again
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = fleet.stats()
            live = [
                r for r in st["replicas"]
                if r is not None and r["state"] == "live"
            ]
            if len(live) == 3:
                break
            time.sleep(0.05)
        assert len(live) == 3, st["replicas"]
        restarted = {
            r["replica"] for r in st["replicas"]
            if r is not None and r["generation"] > 0
        }
        assert restarted == {0, 1}

        # ... and SERVE: keep offering fresh work until a restarted
        # replica delivers (replicas race for the queue, so one wave
        # may be won entirely by the incumbent)
        served_by_restarted = False
        for wave in range(10):
            wf = [
                fleet.submit(x * m, mask=m, key=f"w{wave}-{i}")
                for i, (x, m) in enumerate(_reqs(6, seed=50 + wave))
            ]
            [f.result(timeout=120) for f in wf]
            ev = obs.read_events(str(tmp_path))
            ready_t = {
                e["replica_id"]: e["t"]
                for e in ev if e["type"] == "fleet_replica_ready"
            }
            if any(
                e["type"] == "fleet_request"
                and e["replica_id"] in restarted
                and e["t"] > ready_t.get(e["replica_id"], np.inf)
                for e in ev
            ):
                served_by_restarted = True
                break
        assert served_by_restarted

        # the hung straggler wakes 8 s after its take and delivers
        # late — wait for the suppression to land BEFORE closing (an
        # abandoned worker is deliberately not joined by close())
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            ev = obs.read_events(str(tmp_path))
            if any(
                e["type"] == "fleet_duplicate_suppressed" for e in ev
            ):
                break
            time.sleep(0.1)
    finally:
        fleet.close()
    # the exact host-measured latency sample (seconds), for the
    # histogram-accuracy acceptance below
    host_latencies = list(fleet._latencies)

    events = obs.read_events(str(tmp_path), recursive=True)
    # every serve_*/fleet_*/span_* record names its replica (None
    # allowed only for fleet-scope records) — the runtime half of
    # the lint
    for e in events:
        t = e.get("type", "")
        if (
            t.startswith("serve_") or t.startswith("fleet_")
            or t.startswith("span_")
        ):
            assert "replica_id" in e, e

    dead = [e for e in events if e["type"] == "fleet_replica_dead"]
    reasons = {e["replica_id"]: e["reason"] for e in dead}
    assert reasons[0] == "crash" and reasons[1] == "stall"
    stalls = [e for e in events if e["type"] == "stall"]
    assert any(e.get("replica_id") == 1 for e in stalls)
    assert [e for e in events if e["type"] == "fleet_requeue"]
    # exactly-once delivery of the original 12 keys
    first_wave = [
        e for e in events
        if e["type"] == "fleet_request" and e["key"].startswith("k")
    ]
    keys = [e["key"] for e in first_wave]
    assert sorted(keys) == sorted(f"k{i}" for i in range(12))
    assert len(keys) == len(set(keys)), "a request was served twice"
    # some were handed off (attempts > 1)
    assert any(e["attempts"] > 1 for e in first_wave)
    # the hung straggler woke after 8 s and its late results for
    # already-delivered keys were suppressed (at-most-once)
    assert [
        e for e in events if e["type"] == "fleet_duplicate_suppressed"
    ]
    # the fleet closed with nothing lost
    summary = [
        e for e in events
        if e["type"] == "summary" and e.get("n_requeued") is not None
    ][-1]
    assert summary["n_failed"] == 0

    # from the event streams ALONE, every
    # submitted trace_id reassembles into a complete, gap-free span
    # tree — including the requests requeued across the replica kill
    # and the hang (their story shows both ownerships)
    from ccsc_code_iccv2017_torch.utils import trace as trace_util

    traces = trace_util.assemble(events)
    tid_by_key = {
        e["key"]: e["trace_id"]
        for e in events
        if e["type"] == "fleet_request"
    }
    for i in range(12):
        tid = tid_by_key[f"k{i}"]
        tr = traces[tid]
        assert tr.complete, (
            f"k{i}",
            [
                (s.name, s.status, s.closed)
                for s in tr.spans.values()
            ],
        )
    orphans = sum(
        len(t.orphans) + len(t.unparented) for t in traces.values()
    )
    assert orphans == 0, "span trees must reassemble gap-free"
    requeued_keys = [
        e["key"] for e in first_wave if e["attempts"] > 1
    ]
    tr = traces[tid_by_key[requeued_keys[0]]]
    attempts = tr.by_name("attempt")
    assert len(attempts) >= 2, "the handoff must be visible as spans"
    assert any(s.status == "requeued" for s in attempts)
    assert any(s.status == "ok" for s in attempts)
    # the fleet queue span was re-opened for the second ownership
    assert len(tr.by_name("queue")) >= 2

    # fleet-wide percentiles recomputed from
    # the LAST slo_histogram event match the host-measured exact
    # sample within one bucket width
    from ccsc_code_iccv2017_torch.serve import slo as slo_mod

    fleet_hists = [
        e for e in events
        if e["type"] == "slo_histogram"
        and e.get("replica_id") is None
        and e.get("phase") == "total"
    ]
    assert fleet_hists, "the fleet must flush its histogram at close"
    hist = slo_mod.from_snapshot(fleet_hists[-1])
    exact_ms = sorted(v * 1e3 for v in host_latencies)
    assert hist.n == len(exact_ms)
    for q in (0.50, 0.95, 0.99):
        ex = obs.percentile(exact_ms, q)
        got = hist.percentile(q)
        assert abs(got - ex) <= hist.bucket_width_ms(ex) + 1e-6, (
            q, got, ex,
        )


# -------------------------------------------------- admission control


def test_overload_explicit_ceiling_rejects_and_bounds_queue(tmp_path):
    d = _bank()
    fleet = _fleet(
        d, _cfg(max_it=30), tmp_path, replicas=1,
        buckets=((1, (12, 12)),), max_wait_ms=0.0,
        max_queue_depth=4,
    )
    admitted, rejected = [], 0
    retry_hints = []
    try:
        for i, (x, m) in enumerate(_reqs(16)):
            try:
                admitted.append(fleet.submit(x * m, mask=m, key=f"o{i}"))
            except Overloaded as e:
                rejected += 1
                retry_hints.append(e.retry_after_s)
        results = [f.result(timeout=300) for f in admitted]
        st = fleet.stats()
    finally:
        fleet.close()
    # explicit rejections, not silent queue growth
    assert rejected >= 1
    assert all(h > 0 for h in retry_hints)
    assert st["n_rejected"] == rejected
    # every ADMITTED request completed, with a real latency summary
    assert len(results) == len(admitted)
    assert st["p99_latency_s"] is not None
    events = obs.read_events(str(tmp_path))
    rej = [e for e in events if e["type"] == "fleet_admission_reject"]
    assert len(rej) == rejected
    # the queue never grew past its ceiling
    assert all(e["queue_depth"] <= 4 for e in rej)


def test_overload_derived_ceiling_from_serving_bound(tmp_path):
    """The acceptance overload test against the DERIVED ceiling: after
    a dispatch has measured an iteration rate, the ceiling comes from
    perfmodel.serving_bound x live replicas x max_queue_s; submitting
    4x that yields explicit Overloaded rejections, bounded p99 for
    admitted requests, and no silent queue growth."""
    d = _bank()
    fleet = _fleet(
        d, _cfg(max_it=40), tmp_path, replicas=1,
        buckets=((1, (12, 12)),), max_wait_ms=0.0,
        max_queue_depth=None, min_queue_depth=2, max_queue_s=0.05,
    )
    try:
        # one served request measures the iteration rate; the monitor
        # then derives the ceiling from serving_bound
        x0, m0 = _reqs(1)[0]
        fleet.reconstruct(x0 * m0, mask=m0)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            ev = obs.read_events(str(tmp_path))
            if any(e["type"] == "fleet_ceiling" for e in ev):
                break
            time.sleep(0.02)
        ceil_ev = [e for e in ev if e["type"] == "fleet_ceiling"]
        assert ceil_ev, "ceiling was never derived from serving_bound"
        assert ceil_ev[-1]["source"] == "serving_bound"
        ceiling = fleet.queue_ceiling
        assert ceiling >= 2

        admitted, rejected = [], 0
        for i, (x, m) in enumerate(_reqs(4 * ceiling, seed=7)):
            try:
                admitted.append(
                    fleet.submit(x * m, mask=m, key=f"d{i}")
                )
            except Overloaded as e:
                rejected += 1
                assert e.retry_after_s > 0
        results = [f.result(timeout=300) for f in admitted]
        st = fleet.stats()
    finally:
        fleet.close()
    assert rejected >= 1, "4x the derived ceiling must overflow it"
    assert len(results) == len(admitted)
    assert st["p99_latency_s"] is not None and st["p99_latency_s"] < 120
    events = obs.read_events(str(tmp_path))
    rej = [e for e in events if e["type"] == "fleet_admission_reject"]
    max_ceil = max(
        e["ceiling"] for e in events if e["type"] == "fleet_ceiling"
    )
    assert all(
        e["queue_depth"] <= max(max_ceil, 64) for e in rej
    )  # bounded, never silent growth


def test_overload_ladder_rungs_and_degrade_recycle(tmp_path):
    """White-box walk of the three-rung ladder: shed micro-batch
    waiting -> reject -> (sustained) degrade-recycle onto a reduced
    max_it, then restore on pressure release — each transition an obs
    event, the degrade rungs rebuilding replicas one at a time."""
    d = _bank()
    fleet = _fleet(
        d, _cfg(max_it=8), tmp_path, replicas=1,
        max_wait_ms=50.0,
        max_queue_depth=10, degrade_after_s=0.2,
        degrade_max_it_factor=0.5,
        health_interval_s=30.0,  # the monitor must not fight the test
    )
    try:
        rep0 = fleet._replicas[0]
        assert fleet.overload_rung == "normal"
        fleet._eval_rungs(6, time.monotonic())  # 0.6 of ceiling
        assert fleet.overload_rung == "shed_batching"
        assert rep0.engine._max_wait_s == 0.0  # rung 1 sheds waits
        fleet._eval_rungs(10, time.monotonic())
        assert fleet.overload_rung == "reject"
        time.sleep(0.3)  # sustain rejection past degrade_after_s
        fleet._eval_rungs(10, time.monotonic())
        assert fleet.overload_rung == "degrade"
        # the recycle rebuilds the replica on the degraded budget
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            cur = fleet._replicas[0]
            if cur.generation == 1 and cur.state == "live":
                break
            time.sleep(0.05)
        assert fleet._replicas[0].generation == 1
        assert fleet._replicas[0].engine.cfg.max_it == 4  # 8 x 0.5
        # a request served under rung 3 uses the degraded budget
        x, m = _reqs(1)[0]
        res = fleet.reconstruct(x * m, mask=m, timeout=120)
        assert int(res.trace.num_iters) <= 4
        # pressure released: back to normal, full budget restored
        fleet._eval_rungs(0, time.monotonic())
        assert fleet.overload_rung == "normal"
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            cur = fleet._replicas[0]
            if cur.generation == 2 and cur.state == "live":
                break
            time.sleep(0.05)
        assert fleet._replicas[0].engine.cfg.max_it == 8
        # recycles are maintenance, not failures: the crash-restart
        # budget must be untouched by the two rebuild cycles
        assert fleet._restarts.get(0, 0) == 0
    finally:
        fleet.close()
    events = obs.read_events(str(tmp_path))
    trans = [
        (e["rung_from"], e["rung_to"])
        for e in events if e["type"] == "fleet_overload"
    ]
    assert trans == [
        ("normal", "shed_batching"),
        ("shed_batching", "reject"),
        ("reject", "degrade"),
        ("degrade", "normal"),
    ]
    degrades = [e for e in events if e["type"] == "degrade"]
    assert [e["rung"] for e in degrades] == [
        "serve_max_it", "serve_restore"
    ]
    assert all(e["replica_id"] is None for e in degrades)


# ------------------------------------------------------------- report


def test_jax_readers_read_the_port_fleet_stream(tmp_path):
    """The JAX package's stream readers read the port fleet's stream:
    ``obs.read_events(recursive=True)`` merges the fleet stream and the
    replica-NN/ engine streams, ``watchdog.check_replicas`` judges the
    replicas from its heartbeats, and ``scripts/obs_report.py`` renders
    its FLEET section."""
    from ccsc_code_iccv2017_tpu.utils import watchdog as jwatchdog

    d = _bank()
    fleet = _fleet(d, _cfg(), tmp_path, replicas=2)
    try:
        for i, (x, m) in enumerate(_reqs(4)):
            fleet.submit(x * m, mask=m, key=f"r{i}")
        # drain through close
    finally:
        fleet.close()
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "obs_report",
        os.path.join(
            os.path.dirname(__file__), "..", "scripts", "obs_report.py"
        ),
    )
    obs_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(obs_report)
    events = jobs.read_events(str(tmp_path), recursive=True)
    assert events == obs.read_events(str(tmp_path), recursive=True)
    assert {e["replica_id"] for e in events
            if e["type"] == "serve_request"} <= {0, 1}
    out = obs_report.render(events)
    assert "FLEET" in out
    assert "replica 0:" in out and "replica 1:" in out
    assert "delivered     4 request(s)" in out
    assert "serve_fleet" in out
    rows = jwatchdog.check_replicas(str(tmp_path), stale_s=120.0)
    assert [r["replica"] for r in rows] == [0, 1]
    assert not any(r["stale"] for r in rows)
    assert sum(r["served"] for r in rows) == 4


def test_check_replicas_staleness_rule(tmp_path):
    """A replica whose newest heartbeat lags the stream is stale by
    the same rule as check_peers; judged from parsed events too."""
    from ccsc_code_iccv2017_torch.utils import watchdog

    t0 = 1000.0
    events = [
        {"t": t0, "type": "fleet_heartbeat", "replica_id": 0,
         "state": "live", "served": 3, "restarts": 0},
        {"t": t0 + 300.0, "type": "fleet_heartbeat", "replica_id": 1,
         "state": "live", "served": 5, "restarts": 1},
        {"t": t0 + 301.0, "type": "fleet_request", "replica_id": 1,
         "key": "x"},
    ]
    rows = watchdog.check_replicas(events=events, stale_s=120.0)
    assert [r["replica"] for r in rows] == [0, 1]
    assert rows[0]["stale"] is True
    assert rows[1]["stale"] is False
    assert rows[1]["served"] == 5 and rows[1]["restarts"] == 1


def test_set_replica_count_grow_shrink(tmp_path):
    """The elasticity actuator end to end: grow
    1 -> 2 spawns a second replica onto the next free slice
    synchronously, shrink 2 -> 1 drain-then-retires (never a kill —
    the retired replica's in-flight work completes or requeues), and
    a re-grow resurrects the retired slot on a fresh generation.
    Requests keep being served across every transition, zero lost."""
    d = _bank()
    fleet = _fleet(d, _cfg(), tmp_path, replicas=1)
    try:
        for i, (x, m) in enumerate(_reqs(4, seed=3)):
            assert fleet.submit(
                x * m, mask=m, key=f"g0-{i}"
            ).result(timeout=120) is not None

        r = fleet.set_replica_count(2, reason="test_grow")
        assert r == {"from_n": 1, "to_n": 2}
        snap = fleet.control_snapshot()
        assert snap["live_replicas"] == 2
        assert fleet.replica_target == 2
        for i, (x, m) in enumerate(_reqs(4, seed=4)):
            assert fleet.submit(
                x * m, mask=m, key=f"g1-{i}"
            ).result(timeout=120) is not None

        r = fleet.set_replica_count(1, reason="test_shrink")
        assert r == {"from_n": 2, "to_n": 1}
        assert fleet.replica_target == 1
        # drain-then-retire completes asynchronously
        deadline = time.monotonic() + 60
        retired = []
        while time.monotonic() < deadline and not retired:
            retired = [
                e for e in obs.read_events(str(tmp_path))
                if e["type"] == "fleet_replica_retired"
            ]
            time.sleep(0.02)
        assert retired, "shrink never retired a replica"
        assert "scale_down" in retired[-1]["reason"]
        for i, (x, m) in enumerate(_reqs(4, seed=5)):
            assert fleet.submit(
                x * m, mask=m, key=f"s0-{i}"
            ).result(timeout=120) is not None
        assert fleet.control_snapshot()["live_replicas"] == 1

        # resurrect the retired slot: same id, next generation
        fleet.set_replica_count(2, reason="test_regrow")
        assert fleet.control_snapshot()["live_replicas"] == 2
        for i, (x, m) in enumerate(_reqs(4, seed=6)):
            assert fleet.submit(
                x * m, mask=m, key=f"g2-{i}"
            ).result(timeout=120) is not None
        st = fleet.stats()
    finally:
        fleet.close()
    assert st["n_requests"] == 16 and st["n_failed"] == 0
    events = obs.read_events(str(tmp_path))
    scales = [e for e in events if e["type"] == "fleet_scale"]
    assert [(e["from_n"], e["to_n"]) for e in scales] == [
        (1, 2), (2, 1), (1, 2)
    ]
    gens = [
        e.get("generation")
        for e in events
        if e["type"] == "fleet_replica_ready"
    ]
    assert max(g for g in gens if g is not None) >= 1  # resurrection


def test_restarted_replica_with_compile_cache_reports_warm(tmp_path,
                                                           monkeypatch):
    """A replica killed at its first request restarts in a process whose
    libraries live in the compile cache: its ``fleet_replica_ready``
    reads ``warm=True`` (without a cache it read False), and the
    requeued request is served."""
    from ccsc_code_iccv2017_torch.data import native
    from ccsc_code_iccv2017_torch.ops import kernels
    from ccsc_code_iccv2017_torch.serve import engine as tengine

    monkeypatch.setattr(tengine, "_compile_cache_path", None)
    monkeypatch.setattr(kernels, "_BUILD_DIR", None)
    monkeypatch.setattr(native, "_BUILD_DIR", None)
    monkeypatch.setenv("CCSC_FAULT_ENGINE_KILL_REQ", "1")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_KILL_REPLICA", "0")
    faults.reset()
    cache = str(tmp_path / "cc")
    mdir = str(tmp_path / "m")
    d = _bank()
    fleet = _fleet(d, _cfg(), mdir, replicas=1,
                   serve_kw=dict(compile_cache=cache))
    try:
        (x, m), = _reqs(1, seed=7)
        res = fleet.submit(x * m, mask=m, key="k0").result(timeout=120)
        assert np.isfinite(res.recon).all()
    finally:
        fleet.close()
    ready = [e for e in obs.read_events(mdir, recursive=True)
             if e["type"] == "fleet_replica_ready"]
    assert ready and all(e["warm"] is True for e in ready), ready
    assert max(e["generation"] for e in ready) >= 1
    assert kernels.build_dir() == cache


def test_ceiling_recomputed_on_replica_death(tmp_path, monkeypatch):
    """The derived admission ceiling must be
    recomputed on EVERY replica lifecycle transition. Kill one of two
    replicas (no restart budget -> abandoned): the abandon transition
    itself must re-derive and emit ``fleet_ceiling`` with
    live_replicas=1 and a LOWER ceiling — a fleet that keeps admitting
    at 2-replica capacity into 1 replica melts down."""
    monkeypatch.setenv("CCSC_FAULT_ENGINE_KILL_REQ", "4")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_KILL_REPLICA", "0")
    faults.reset()
    # every replica's measured iteration rate pinned: the transition's
    # arithmetic is under test, not the pace of a loaded CPU, which
    # moves a derived ceiling by 10x between two waves
    monkeypatch.setattr(CodecEngine, "last_it_rate",
                        property(lambda self: 100.0))
    d = _bank()
    fleet = _fleet(
        d, _cfg(max_it=40), tmp_path, replicas=2, max_restarts=0,
        max_queue_depth=None, min_queue_depth=4, max_queue_s=2.0,
    )
    try:
        # a small first wave measures rates WITHOUT reaching replica
        # 0's 4th take, so the 2-replica ceiling is derived first
        for i, (x, m) in enumerate(_reqs(3, seed=11)):
            fleet.submit(x * m, mask=m, key=f"w0-{i}").result(
                timeout=300
            )
        deadline = time.monotonic() + 30
        pre = []
        while time.monotonic() < deadline and not pre:
            pre = [
                e for e in obs.read_events(str(tmp_path))
                if e["type"] == "fleet_ceiling"
                and e["live_replicas"] == 2
            ]
            time.sleep(0.02)
        assert pre, "2-replica ceiling never derived"

        # now push replica 0 over its kill threshold; requeue hands
        # its stranded work to the survivor, so nothing is lost
        dead = False
        for wave in range(12):
            for i, (x, m) in enumerate(_reqs(4, seed=20 + wave)):
                fleet.submit(
                    x * m, mask=m, key=f"w{wave + 1}-{i}"
                ).result(timeout=300)
            dead = any(
                e["type"] == "fleet_replica_abandoned"
                for e in obs.read_events(str(tmp_path))
            )
            if dead:
                break
        assert dead, "the kill fault never abandoned replica 0"

        deadline = time.monotonic() + 30
        post = []
        while time.monotonic() < deadline and not post:
            post = [
                e for e in obs.read_events(str(tmp_path))
                if e["type"] == "fleet_ceiling"
                and e["live_replicas"] == 1
            ]
            time.sleep(0.02)
    finally:
        fleet.close()
    assert post, "no ceiling recompute on the abandon transition"
    pre_ceiling = max(e["ceiling"] for e in pre)
    assert post[-1]["ceiling"] < pre_ceiling, (
        f"ceiling must drop with the lost replica: "
        f"{post[-1]['ceiling']} !< {pre_ceiling}"
    )
    assert post[-1]["source"] == "serving_bound"


# ------------------------------------------- request lifecycle


def test_deadline_refused_at_admission(tmp_path):
    """A request whose budget is already spent at submit is refused
    with ``DeadlineExceeded(where='admission')`` BEFORE any admission
    work — asserted from the exception, the live counter, and the
    event stream (the refusal never becomes a served request)."""
    from ccsc_code_iccv2017_torch.serve import DeadlineExceeded

    d = _bank()
    fleet = _fleet(d, _cfg(), tmp_path, replicas=1)
    try:
        x, m = _reqs(1)[0]
        with pytest.raises(DeadlineExceeded) as ei:
            fleet.submit(x * m, mask=m, key="doa", deadline_ms=0.0)
        assert ei.value.where == "admission"
        assert (
            fleet.metrics()["counters"]["deadline_exceeded_total"]
            == 1
        )
    finally:
        fleet.close()
    events = obs.read_events(str(tmp_path), recursive=True)
    refusals = [
        e for e in events if e["type"] == "deadline_exceeded"
    ]
    assert len(refusals) == 1
    assert refusals[0]["where"] == "admission"
    assert not any(e["type"] == "fleet_request" for e in events)


def test_deadline_expires_in_queue_never_occupies_slot(
    tmp_path, monkeypatch
):
    """Deadline honesty at the queue: while the only replica is held
    by a slow request, a queued request whose budget expires is
    dropped at the next take (``where='queue'``) — its future fails
    with DeadlineExceeded, it NEVER occupies a solve slot (no
    fleet_request, no attempt span), and its root span closes
    ``deadline``."""
    from concurrent.futures import TimeoutError as FutTimeout

    from ccsc_code_iccv2017_torch.serve import DeadlineExceeded

    monkeypatch.setenv("CCSC_FAULT_ENGINE_SLOW_REQ", "1")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_SLOW_S", "1.0")
    faults.reset()
    d = _bank()
    # slots=1: the slow request and the doomed one can never share a
    # batch, so the expiry deterministically happens at the queue
    fleet = _fleet(
        d, _cfg(), tmp_path, replicas=1, buckets=((1, (12, 12)),)
    )
    try:
        (x0, m0), (x1, m1) = _reqs(2)
        f0 = fleet.submit(x0 * m0, mask=m0, key="slowed")
        f1 = fleet.submit(
            x1 * m1, mask=m1, key="doomed", deadline_ms=100.0
        )
        assert f0.result(timeout=120) is not None
        with pytest.raises(DeadlineExceeded) as ei:
            f1.result(timeout=120)
        assert ei.value.where == "queue"
    except FutTimeout:  # pragma: no cover - diagnosis aid
        pytest.fail("expired request never resolved")
    finally:
        fleet.close()
    events = obs.read_events(str(tmp_path), recursive=True)
    exp = [
        e for e in events
        if e["type"] == "deadline_exceeded"
        and e.get("key") == "doomed"
    ]
    assert len(exp) == 1 and exp[0]["where"] == "queue"
    assert not any(
        e["type"] == "fleet_request" and e["key"] == "doomed"
        for e in events
    )
    roots = [
        e for e in events
        if e["type"] == "span_end" and e.get("span") == "request"
        and e.get("status") == "deadline"
    ]
    assert len(roots) == 1


def test_cancel_withdraws_queued_request(tmp_path, monkeypatch):
    """Cooperative cancellation: cancelling a future while its
    request still waits in the fleet queue withdraws it pre-dispatch
    — counted, span-closed ``cancelled``, never served."""
    from concurrent.futures import CancelledError

    monkeypatch.setenv("CCSC_FAULT_ENGINE_SLOW_REQ", "1")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_SLOW_S", "1.0")
    faults.reset()
    d = _bank()
    fleet = _fleet(
        d, _cfg(), tmp_path, replicas=1, buckets=((1, (12, 12)),)
    )
    try:
        (x0, m0), (x1, m1) = _reqs(2)
        f0 = fleet.submit(x0 * m0, mask=m0, key="busy")
        f1 = fleet.submit(x1 * m1, mask=m1, key="bail")
        assert f1.cancel()  # still queued: withdrawal must succeed
        assert f0.result(timeout=120) is not None
        with pytest.raises(CancelledError):
            f1.result(timeout=120)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if fleet.control_snapshot()["cancelled"] == 1:
                break
            time.sleep(0.02)
        assert fleet.control_snapshot()["cancelled"] == 1
        assert fleet.metrics()["counters"]["cancelled_total"] == 1
    finally:
        fleet.close()
    events = obs.read_events(str(tmp_path), recursive=True)
    cans = [
        e for e in events if e["type"] == "request_cancelled"
    ]
    assert len(cans) == 1 and cans[0]["key"] == "bail"
    assert cans[0]["where"] == "queue"
    assert not any(
        e["type"] == "fleet_request" and e["key"] == "bail"
        for e in events
    )
    roots = [
        e for e in events
        if e["type"] == "span_end" and e.get("span") == "request"
        and e.get("status") == "cancelled"
    ]
    assert len(roots) == 1


def test_hedge_routes_around_slow_replica_and_suppresses_loser(
    tmp_path, monkeypatch
):
    """Hedged attempts, in-process: with replica 0 slow (not hung),
    stuck attempts get a duplicate on replica 1; the first result
    wins, every key is delivered exactly once and bit-identical to a
    single unfaulted engine, the loser is suppressed-and-counted
    (``hedge_lost`` event + attempt span), and the hedge volume
    respects the hedge_max_frac denominator."""
    monkeypatch.setenv("CCSC_FAULT_ENGINE_SLOW_REQ", "1")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_SLOW_S", "1.0")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_SLOW_REPLICA", "0")
    faults.reset()
    d = _bank()
    cfg = _cfg()
    reqs = _reqs(6)
    ref = _single_engine_results(d, cfg, reqs)
    fleet = _fleet(
        # 500 ms: far past a healthy attempt on a loaded CPU, far under
        # the slow replica's 1 s a request
        d, cfg, tmp_path, replicas=2, hedge_after_ms=500.0,
        hedge_max_frac=1.0, health_interval_s=0.02,
    )
    try:
        futs = [
            fleet.submit(x * m, mask=m, key=f"h{i}")
            for i, (x, m) in enumerate(reqs)
        ]
        res = [f.result(timeout=120) for f in futs]
        snap = fleet.control_snapshot()
        assert snap["hedges"] >= 1
        assert snap["hedges"] <= 1.0 * len(reqs)  # the frac cap
        assert snap["hedge_wins"] >= 1
    finally:
        fleet.close()  # joins workers: straggler losers settle
    for i in range(len(reqs)):
        np.testing.assert_array_equal(res[i].recon, ref[i].recon)
    events = obs.read_events(str(tmp_path), recursive=True)
    served = [e for e in events if e["type"] == "fleet_request"]
    keys = [e["key"] for e in served]
    assert sorted(keys) == sorted(f"h{i}" for i in range(6))
    assert len(keys) == len(set(keys))  # exactly once each
    spawns = {
        e["key"] for e in events if e["type"] == "hedge_spawn"
    }
    wins = {e["key"] for e in events if e["type"] == "hedge_win"}
    losses = {e["key"] for e in events if e["type"] == "hedge_lost"}
    assert spawns
    assert wins <= spawns and losses <= spawns
    assert wins == losses  # every decided pair: winner + loser
    lost_spans = [
        e for e in events
        if e["type"] == "span_end" and e.get("span") == "attempt"
        and e.get("status") == "hedge_lost"
    ]
    assert len(lost_spans) == len(losses)


def test_tenant_deadline_default_stamped_on_trace(tmp_path):
    """``TenantSpec.deadline_ms`` is the tenant's default budget: the
    resolved ABSOLUTE deadline is stamped on the request's root span
    at admission (deadline honesty starts at the trace), and a
    comfortable budget serves normally."""
    from ccsc_code_iccv2017_torch.config import TenantSpec

    d = _bank()
    fleet = _fleet(
        d, _cfg(), tmp_path, replicas=1,
        tenants=(
            TenantSpec(tenant="mobile", deadline_ms=60_000.0),
        ),
    )
    try:
        x, m = _reqs(1)[0]
        res = fleet.submit(
            x * m, mask=m, key="t0", tenant="mobile"
        ).result(timeout=120)
        assert res is not None
    finally:
        fleet.close()
    events = obs.read_events(str(tmp_path), recursive=True)
    roots = [
        e for e in events
        if e["type"] == "span_start" and e.get("span") == "request"
    ]
    assert len(roots) == 1
    dl = roots[0].get("deadline")
    assert dl is not None and dl > time.time() - 120


# ---------------------------------------------- against the JAX fleet


def _jax_fleet(d, cfg_kw, buckets=((2, (12, 12)),), **kw):
    jrec = importlib.import_module(
        "ccsc_code_iccv2017_tpu.models.reconstruct")
    geom = jcfg.ProblemGeom(d.shape[1:], d.shape[0])
    fkw = dict(min_queue_depth=64, restart_backoff_s=0.05,
               heartbeat_s=0.2, health_interval_s=0.05, verbose="none")
    fkw.update(kw)
    return jserve.ServeFleet(
        jnp.asarray(d), jrec.ReconstructionProblem(geom),
        jcfg.SolveConfig(**cfg_kw),
        jcfg.ServeConfig(buckets=buckets, max_wait_ms=2.0, verbose="none"),
        jcfg.FleetConfig(**fkw),
    )


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-9)


def test_fleet_matches_the_jax_fleet_on_the_same_requests():
    """Two replicas each side, the same keyed requests: every port
    result within REC_TOL of the JAX fleet's, the objective traces
    within TRACE_RTOL, the same iteration counts and the same
    delivered/requeued counters."""
    d = _bank()
    cfg_kw = dict(lambda_residual=5.0, lambda_prior=0.3, max_it=4,
                  tol=0.0, verbose="none", track_objective=True)
    reqs = _reqs(6)
    jf = _jax_fleet(d, cfg_kw, replicas=2)
    try:
        jres = [f.result(timeout=180) for f in [
            jf.submit(x * m, mask=m, key=f"j{i}")
            for i, (x, m) in enumerate(reqs)]]
        jst = jf.stats()
    finally:
        jf.close()
    tf = _fleet(d, SolveConfig(**cfg_kw), replicas=2)
    try:
        tres = [f.result(timeout=180) for f in [
            tf.submit(x * m, mask=m, key=f"j{i}")
            for i, (x, m) in enumerate(reqs)]]
        tst = tf.stats()
    finally:
        tf.close()
    for a, b in zip(tres, jres):
        assert _rel(a.recon, b.recon) <= REC_TOL
        np.testing.assert_allclose(a.trace.obj_vals, b.trace.obj_vals,
                                   rtol=TRACE_RTOL)
        assert int(a.trace.num_iters) == int(b.trace.num_iters)
        assert a.recon.shape == b.recon.shape == (12, 12)
    for k in ("n_requests", "n_requeued", "n_rejected", "n_failed",
              "n_duplicates_suppressed", "overload_rung"):
        assert tst[k] == jst[k], k
    assert len(tst["replicas"]) == len(jst["replicas"]) == 2


@pytest.mark.parametrize("slots", [2, 4])
def test_results_are_bitwise_in_any_slot_order(slots):
    """A request served in another slot, beside other batch-mates and
    other filler slots (the position a requeue lands it in), gives the
    same bits: the 2-replica fleet serves the stream reversed and
    rotated, and every result equals the single engine's in-order
    serve."""
    d = _bank()
    cfg = _cfg()
    buckets = ((slots, (12, 12)),)
    reqs = _reqs(7, seed=21)
    ref = _single_engine_results(d, cfg, reqs, buckets=buckets)
    n = len(reqs)
    for order in (list(range(n))[::-1], [(i + 3) % n for i in range(n)]):
        fleet = _fleet(d, cfg, replicas=2, buckets=buckets)
        try:
            futs = {i: fleet.submit(reqs[i][0] * reqs[i][1],
                                    mask=reqs[i][1], key=f"p{i}")
                    for i in order}
            res = {i: f.result(timeout=180) for i, f in futs.items()}
        finally:
            fleet.close()
        for i in range(n):
            np.testing.assert_array_equal(res[i].recon, ref[i].recon)
            np.testing.assert_array_equal(res[i].trace.obj_vals,
                                          ref[i].trace.obj_vals)
