"""The port's cross-process federated serving
(``ccsc_code_iccv2017_torch.serve.federation`` over the port's
``serve.dqueue``) held to the port's plain fleet and to the JAX
package's federation, on the CPU:

- two port ``FederatedHost``s (in-process threads, k=4 3x3 bank, one
  2-slot 24x24 bucket) serve a frontend's stream BIT-IDENTICAL to the
  port's plain ``ServeFleet`` and within REC_TOL of max|ref| of the JAX
  package's federation on the same inputs; every trace reassembles
  complete across the frontend's and the hosts' streams;
- host death: a host stops heartbeating and draining while it holds
  leases, without ``leave()``; its leases expire, the survivor reaps
  them and serves everything with zero lost and bitwise results, and
  the dead host's late completes are fenced (the real SIGKILL of a
  host process is ``chip_smoke.py`` phase 20 (b));
- the frontend contract, the concurrent same-key single item, the
  failed request with a complete trace, the durable cancel marker, the
  cross-host deadline and hedge-duplicate suppression.
"""
import os
import threading
import time

import numpy as np
import pytest

from ccsc_code_iccv2017_torch.config import FleetConfig
from ccsc_code_iccv2017_torch.models.reconstruct import ReconstructionProblem
from ccsc_code_iccv2017_torch.serve import capture as cap
from ccsc_code_iccv2017_torch.serve.dqueue import DurableQueue
from ccsc_code_iccv2017_torch.serve.federation import (
    FederatedFrontend,
    FederatedHost,
)
from ccsc_code_iccv2017_torch.utils import faults, obs
from ccsc_code_iccv2017_torch.utils import trace as trace_util

REC_TOL = 1e-4
SIDE = 24


def _bank(k=4, sup=3, seed=0):
    r = np.random.default_rng(seed)
    d = r.normal(size=(k, sup, sup)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    return d


def _cfgs(pkg_config):
    geom = pkg_config.ProblemGeom((3, 3), 4)
    cfg = pkg_config.SolveConfig(
        lambda_residual=5.0, lambda_prior=0.3, max_it=3, tol=0.0,
        verbose="none", track_psnr=True, track_objective=True,
    )
    scfg = pkg_config.ServeConfig(
        buckets=((2, (SIDE, SIDE)),), max_wait_ms=2.0, verbose="none"
    )
    return geom, cfg, scfg


def _requests(n, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = r.random((SIDE, SIDE)).astype(np.float32)
        m = (r.random((SIDE, SIDE)) < 0.5).astype(np.float32)
        out.append((x * m, m, x))
    return out


def _port_cfgs():
    from ccsc_code_iccv2017_torch import config

    return _cfgs(config)


def _host(tmp, d, host_id, metrics_sub, replicas=1, **kw):
    geom, cfg, scfg = _port_cfgs()
    fleet_kw = kw.pop("fleet_kw", {})
    return FederatedHost(
        os.path.join(tmp, "q"), d, ReconstructionProblem(geom), cfg, scfg,
        FleetConfig(replicas=replicas, min_queue_depth=64,
                    restart_backoff_s=0.05, verbose="none", **fleet_kw),
        host=host_id, metrics_dir=os.path.join(tmp, metrics_sub),
        heartbeat_s=0.2, ttl_s=1.0, skew_s=0.2, verbose="none",
        device="cpu", **kw,
    )


def _frontend(tmp, **kw):
    return FederatedFrontend(
        os.path.join(tmp, "q"), client="fe0",
        metrics_dir=os.path.join(tmp, "m-fe"), verbose="none",
        poll_s=0.02, **kw,
    )


def _plain_fleet_results(d, reqs):
    from ccsc_code_iccv2017_torch.serve import ServeFleet

    geom, cfg, scfg = _port_cfgs()
    fleet = ServeFleet(
        d, ReconstructionProblem(geom), cfg, scfg,
        FleetConfig(replicas=1, min_queue_depth=64, verbose="none"),
        device="cpu",
    )
    try:
        return [fleet.reconstruct(b, mask=m, x_orig=x, timeout=180)
                for b, m, x in reqs]
    finally:
        fleet.close()


def _jax_federation_results(tmp, d, reqs):
    from ccsc_code_iccv2017_tpu import config as jconfig
    from ccsc_code_iccv2017_tpu.models.reconstruct import (
        ReconstructionProblem as JProblem,
    )
    from ccsc_code_iccv2017_tpu.serve.federation import (
        FederatedFrontend as JFrontend,
        FederatedHost as JHost,
    )

    geom, cfg, scfg = _cfgs(jconfig)
    qdir = os.path.join(tmp, "jq")
    host = JHost(
        qdir, d, JProblem(geom), cfg, scfg,
        jconfig.FleetConfig(replicas=1, min_queue_depth=64,
                            verbose="none"),
        host="jhost", heartbeat_s=0.2, ttl_s=5.0, skew_s=0.2,
        verbose="none",
    )
    fe = JFrontend(qdir, client="jfe", verbose="none", poll_s=0.02)
    try:
        futs = [fe.submit(b, mask=m, x_orig=x) for b, m, x in reqs]
        out = [f.result(timeout=180) for f in futs]
        fe.seal()
        assert host.serve_until_sealed(timeout=120)
    finally:
        host.close()
        fe.close()
    return out


def test_federated_serve_bit_identical_to_plain_fleet(tmp_path):
    tmp = str(tmp_path)
    d = _bank()
    reqs = _requests(6)
    ref = _plain_fleet_results(d, reqs)
    hosts = [_host(tmp, d, f"host{i}", f"m-host{i}") for i in range(2)]
    fe = _frontend(tmp)
    try:
        futs = [fe.submit(b, mask=m, x_orig=x) for b, m, x in reqs]
        res = [f.result(timeout=180) for f in futs]
        fe.seal()
        for h in hosts:
            assert h.serve_until_sealed(timeout=120)
    finally:
        for h in hosts:
            h.close()
        fe.close()
    for got, want in zip(res, ref):
        # the durable queue and the content-addressed result store
        # moved the bytes and changed NOTHING
        assert np.array_equal(got.recon, want.recon)
        assert got.digest == cap.payload_sha(
            np.ascontiguousarray(np.asarray(want.recon)))
        assert got.host in ("host0", "host1") and got.attempts == 1
    assert sum(h.served for h in hosts) == len(reqs)
    # the JAX package's federation on the same inputs
    jres = _jax_federation_results(tmp, d, reqs)
    for got, want in zip(res, jres):
        scale = float(np.abs(want.recon).max())
        assert np.abs(got.recon - want.recon).max() <= REC_TOL * scale
    evs = obs.read_events(tmp, recursive=True)
    kinds = {e["type"] for e in evs}
    assert {"fed_join", "fed_leave", "fed_heartbeat", "dqueue_submit",
            "dqueue_claim", "dqueue_complete"} <= kinds
    traces = trace_util.assemble(evs)
    for r in res:
        assert traces[r.trace_id].complete


def test_host_death_lease_expiry_zero_lost_bit_parity(tmp_path,
                                                      monkeypatch):
    """A host that stops heartbeating and draining while it holds
    leases (no ``leave()``) loses nothing: its leases expire, the
    survivor reaps and serves every request bitwise the plain fleet's,
    each trace shows both ownerships, and the dead host's late
    completes are fenced."""
    tmp = str(tmp_path)
    d = _bank()
    reqs = _requests(8, seed=1)
    ref = _plain_fleet_results(d, reqs)
    # the doomed host's replica is slow, so it holds leases mid-solve
    monkeypatch.setenv("CCSC_FAULT_ENGINE_SLOW_REQ", "1")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_SLOW_S", "0.5")
    faults.reset()
    dead = _host(tmp, d, "host0", "m-host0")
    fe = _frontend(tmp)
    survivor = None
    try:
        futs = [fe.submit(b, mask=m, x_orig=x, key=f"k{i}")
                for i, (b, m, x) in enumerate(reqs)]
        t_end = time.monotonic() + 60
        while fe.queue.stats()["leased"] < 2:
            assert time.monotonic() < t_end, "host0 never held 2 leases"
            time.sleep(0.01)
        # host death: the drain and the heartbeat stop, nothing leaves
        dead._stop.set()
        dead._stop_beat.set()
        dead._drain_thread.join(timeout=30)
        dead._beat_thread.join(timeout=30)
        held = fe.queue.stats()["leased"]
        assert held >= 2
        monkeypatch.delenv("CCSC_FAULT_ENGINE_SLOW_REQ")
        faults.reset()
        survivor = _host(tmp, d, "host1", "m-host1")
        fe.seal()
        res = [f.result(timeout=120) for f in futs]
        assert survivor.serve_until_sealed(timeout=60)
    finally:
        if survivor is not None:
            survivor.close()
        dead.close()  # the straggler's completes are fenced now
        fe.close()
    assert len(res) == len(reqs)
    for got, want in zip(res, ref):
        assert np.array_equal(got.recon, want.recon)
    handed = [r for r in res if r.attempts > 1]
    assert len(handed) >= 2 and all(r.host == "host1" for r in handed)
    assert dead.served < len(reqs)
    probe = DurableQueue(os.path.join(tmp, "q"), host="probe")
    for i, r in enumerate(res):
        rec = probe.result(f"k{i}")
        assert rec["status"] == "ok" and rec["host"] == r.host
    events = obs.read_events(tmp, recursive=True)
    cross = [e for e in events if e["type"] == "dqueue_requeue"
             and e.get("from_host") == "host0"
             and e.get("by_host") == "host1"]
    assert len(cross) >= 2
    # the dead host woke at close() and tried to deliver: fenced
    assert [e for e in events if e["type"] == "dqueue_suppressed"
            and e.get("host") == "host0"]
    traces = trace_util.assemble(events)
    for r in res:
        tr = traces[r.trace_id]
        assert tr.complete, (r.key, tr.orphans, tr.unparented)
        # every ownership is visible: the reaper's retrospective span
        # of the dead one, the survivor's delivery, and the dead
        # host's fenced late delivery
        attempts = [s for s in tr.by_name("attempt")
                    if s.status != "suppressed"]
        assert len(attempts) == r.attempts
        if r.attempts > 1:
            assert {s.status for s in attempts} == {"requeued", "ok"}


def test_frontend_contract(tmp_path):
    tmp = str(tmp_path)
    host = _host(tmp, _bank(), "hostA", "m-host")
    fe = FederatedFrontend(os.path.join(tmp, "q"), client="fe0",
                           verbose="none")
    try:
        b, m, x = _requests(1)[0]
        f1 = fe.submit(b, mask=m, x_orig=x, key="pin")
        assert fe.submit(b, mask=m, key="pin") is f1
        assert f1.result(timeout=180).key == "pin"
        with pytest.raises(ValueError):
            fe.submit(b, mask=m, key="pin")  # spent across the pool
        host.close()
        f2 = fe.submit(b, mask=m, key="orphaned")
        fe.close()
        with pytest.raises(RuntimeError):
            f2.result(timeout=5)
        with pytest.raises(RuntimeError):
            fe.submit(b, mask=m)  # closed frontend refuses
    finally:
        host.close()
        fe.close()


def test_frontend_concurrent_same_key_single_item(tmp_path):
    fe = FederatedFrontend(os.path.join(str(tmp_path), "q"), client="fe0",
                           verbose="none")
    try:
        b, m, _x = _requests(1)[0]
        got = []
        barrier = threading.Barrier(2)

        def go():
            barrier.wait()
            got.append(fe.submit(b, mask=m, key="dup"))

        ts = [threading.Thread(target=go) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert len(got) == 2 and got[0] is got[1]
        qdir = os.path.join(str(tmp_path), "q", "queue")
        assert len([n for n in os.listdir(qdir) if n.endswith(".json")]) == 1
    finally:
        fe.close()


def test_failed_request_resolves_error_with_complete_trace(tmp_path):
    qdir = os.path.join(str(tmp_path), "q")
    fe = _frontend(str(tmp_path))
    fe.queue.max_attempts = 1  # item-record budget: one ownership
    ev = []

    def emit(t, **f):
        ev.append(dict(f, type=t, t=time.time()))

    ghost = DurableQueue(qdir, host="ghost", emit=emit, ttl_s=0.15,
                         skew_s=0.0)
    reaper = DurableQueue(qdir, host="reaper", emit=emit, ttl_s=0.15,
                          skew_s=0.0)
    try:
        b, m, _x = _requests(1)[0]
        fut = fe.submit(b, mask=m, key="doomed")
        ghost.join()
        assert ghost.claim()  # then the "host" dies silently
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            time.sleep(0.1)
            reaper.heartbeat()
            reaper.reap()
            if fut.done():
                break
        with pytest.raises(RuntimeError, match="ownership"):
            fut.result(timeout=1)
    finally:
        fe.close()
    traces = trace_util.assemble(
        obs.read_events(str(tmp_path), recursive=True) + ev)
    (tr,) = traces.values()
    assert tr.complete and tr.root.status == "error"
    attempts = tr.by_name("attempt")
    assert len(attempts) == 1 and attempts[0].status == "error"


def test_frontend_cancel_writes_durable_marker(tmp_path):
    fe = _frontend(str(tmp_path))
    try:
        b, m, x = _requests(1)[0]
        f = fe.submit(b, mask=m, x_orig=x, key="bail")
        assert f.cancel()
        t_end = time.time() + 10.0
        while fe.n_cancelled < 1 and time.time() < t_end:
            time.sleep(0.01)
        assert fe.n_cancelled == 1
        probe = DurableQueue(os.path.join(str(tmp_path), "q"), host="probe")
        rec = probe.result("bail")
        assert rec is not None and rec["status"] == "cancelled"
        assert probe.spent("bail")
        probe.join()
        assert probe.claim(limit=4) == []
    finally:
        fe.close()
    evs = obs.read_events(str(tmp_path), recursive=True)
    cc = [e for e in evs if e["type"] == "request_cancelled"]
    assert cc and cc[0].get("where") == "dqueue"
    root_ends = [e for e in evs if e["type"] == "span_end"
                 and e.get("span") == trace_util.ROOT_SPAN
                 and e.get("key") == "bail"]
    assert [e.get("status") for e in root_ends] == ["cancelled"]


def test_cross_host_deadline_writes_durable_result(tmp_path):
    from ccsc_code_iccv2017_torch.serve import DeadlineExceeded

    fe = _frontend(str(tmp_path))
    try:
        b, m, x = _requests(1)[0]
        f = fe.submit(b, mask=m, x_orig=x, key="late", deadline_ms=50.0)
        time.sleep(0.15)  # budget lapses before any host exists
        ev = []
        host_q = DurableQueue(
            os.path.join(str(tmp_path), "q"), host="H0",
            emit=lambda t, **fi: ev.append(dict(fi, type=t)))
        host_q.join()
        assert host_q.claim(limit=4) == []  # resolved, not leased
        rec = host_q.result("late")
        assert rec is not None and rec["status"] == "deadline"
        assert host_q.spent("late")
        with pytest.raises(DeadlineExceeded) as ei:
            f.result(timeout=30)
        assert ei.value.where == "claim"
        assert fe.n_failed == 1
        assert ("deadline_exceeded", "claim") in [
            (e["type"], e.get("where")) for e in ev
            if e["type"] == "deadline_exceeded"]
    finally:
        fe.close()
    evs = obs.read_events(str(tmp_path), recursive=True)
    root_ends = [e for e in evs if e["type"] == "span_end"
                 and e.get("span") == trace_util.ROOT_SPAN
                 and e.get("key") == "late"]
    assert [e.get("status") for e in root_ends] == ["deadline"]


def test_cross_host_hedge_duplicates_suppressed(tmp_path, monkeypatch):
    tmp = str(tmp_path)
    d = _bank()
    reqs = _requests(6, seed=2)
    ref = _plain_fleet_results(d, reqs)  # before the fault env lands
    monkeypatch.setenv("CCSC_FAULT_ENGINE_SLOW_REQ", "1")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_SLOW_S", "0.8")
    monkeypatch.setenv("CCSC_FAULT_ENGINE_SLOW_REPLICA", "0")
    faults.reset()
    host = _host(tmp, d, "hostA", "m-host", replicas=2, fleet_kw=dict(
        hedge_after_ms=120.0, hedge_max_frac=1.0, health_interval_s=0.02))
    fe = _frontend(tmp)
    try:
        futs = [fe.submit(b, mask=m, x_orig=x, key=f"k{i}")
                for i, (b, m, x) in enumerate(reqs)]
        res = [f.result(timeout=180) for f in futs]
        fe.seal()
        assert host.serve_until_sealed(timeout=120)
    finally:
        host.close()
        fe.close()
    for i, (got, want) in enumerate(zip(res, ref)):
        assert np.array_equal(got.recon, want.recon), f"k{i}"
    probe = DurableQueue(os.path.join(tmp, "q"), host="probe")
    assert len(probe.result_names()) == len(reqs)
    for i in range(len(reqs)):
        assert probe.result(f"k{i}")["status"] == "ok"
    by = {}
    for e in obs.read_events(tmp, recursive=True):
        by.setdefault(e["type"], []).append(e)
    spawns = by.get("hedge_spawn", [])
    assert spawns, "the slow replica never provoked a hedge"
    assert len(by.get("hedge_win", [])) == len(by.get("hedge_lost", []))
    assert len(spawns) <= len(reqs)
    assert not by.get("stall", []) and not by.get("fleet_replica_dead", [])
    traces = trace_util.assemble(
        [e for es in by.values() for e in es])
    for r in res:
        assert traces[r.trace_id].complete
