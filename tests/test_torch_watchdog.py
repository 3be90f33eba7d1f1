"""The dispatch-fence watchdog (``utils/watchdog.py``) against the JAX
package's ``utils.watchdog`` on the CPU: the same deadlines from the same
budget, the same ``stall`` / ``peer_stale`` records and liveness
verdicts, and abort mode's exit 87; armed in the port's learners, it
changes no result and fires under a hang fault."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.analysis import obs_schema as jschema
from ccsc_code_iccv2017_tpu.utils import obs as jobs
from ccsc_code_iccv2017_tpu.utils import watchdog as jwd
from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.models import learn_masked as tlm
from ccsc_code_iccv2017_torch.parallel import consensus, streaming
from ccsc_code_iccv2017_torch.utils import faults, obs, perfmodel
from ccsc_code_iccv2017_torch.utils import watchdog as twd

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for v in ("CCSC_WATCHDOG_ACTION", "CCSC_WATCHDOG_MIN_S",
              "CCSC_WATCHDOG_COMPILE_S", "CCSC_WATCHDOG_PEER_STALE_S",
              "CCSC_FAULT_HANG_IT", "CCSC_FAULT_HANG_S",
              "CCSC_FAULT_STATE_DIR"):
        monkeypatch.delenv(v, raising=False)
    faults.reset()
    yield
    faults.reset()


def test_constants_and_defaults_equal_jax():
    assert twd.EXIT_STALL == jwd.EXIT_STALL == 87
    for name in ("DEFAULT_MIN_S", "DEFAULT_COMPILE_S",
                 "DEFAULT_PEER_STALE_S"):
        assert getattr(twd, name) == getattr(jwd, name)


@pytest.mark.parametrize("per_iter", [0.0, 0.5, 4.0, 40.0])
@pytest.mark.parametrize("env", [{}, {"CCSC_WATCHDOG_MIN_S": "10",
                                      "CCSC_WATCHDOG_COMPILE_S": "100"},
                                 {"CCSC_WATCHDOG_MIN_S": "abc"}])
def test_deadline_derivation_equals_jax(monkeypatch, per_iter, env):
    """The same per-iteration budget gives the same deadline for every
    fence: the first (with the build allowance), later ones floored at
    MIN_S and scaled by the iterations covered, a driver-signalled
    rebuild, and after self-calibration."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = {}
    for name, mod in (("port", twd), ("jax", jwd)):
        wd = mod.DispatchWatchdog(per_iter, action="event")
        try:
            got = [wd.timeout_for(1), wd.timeout_for(4)]
            wd.arm(1, "f0")
            wd.disarm()
            got += [wd.timeout_for(n, may_compile=c) for n in (1, 3, 16)
                    for c in (False, True)]
            wd._obs_per_iter = 2.5  # a calibrated slow pace
            got += [wd.timeout_for(1), wd.timeout_for(8)]
            out[name] = (got, wd.action, wd.min_s, wd.compile_s,
                         wd.peer_stale_s)
        finally:
            wd.stop()
    assert out["port"] == out["jax"]


def test_maybe_start_derives_the_budget_from_the_roofline_bound():
    cost = {"flops": 1e12, "bytes": 1e10}
    cfg = LearnConfig(watchdog=True, watchdog_slack=5.0)
    wd = twd.maybe_start(cfg, cost=cost, device="cpu")
    try:
        bound = perfmodel.bound_iters_per_sec(cost, chip="cpu")
        assert wd.per_iter_s == pytest.approx(5.0 / bound)
    finally:
        wd.stop()
    # the card's deadline is the H100 row's: JAX's formula on that bound
    h100 = perfmodel.bound_iters_per_sec(cost, chip="h100")
    assert 5.0 / h100 == pytest.approx(
        5.0 * max(1e12 / 66.9e12, 1e10 / 3.35e12))
    assert twd.maybe_start(LearnConfig()) is None  # off by default
    wd0 = twd.maybe_start(cfg, algorithm="masked_admm")  # no cost model
    try:
        assert wd0.per_iter_s == 0.0 and wd0.algorithm == "masked_admm"
    finally:
        wd0.stop()


def test_stall_record_fires_and_matches_jax(monkeypatch, tmp_path):
    """An armed fence that never disarms writes one ``stall`` record per
    fence, with JAX's fields."""
    monkeypatch.setenv("CCSC_WATCHDOG_MIN_S", "0.3")
    monkeypatch.setenv("CCSC_WATCHDOG_COMPILE_S", "0")
    recs = {}
    for name, (o, mod) in (("port", (obs, twd)), ("jax", (jobs, jwd))):
        d = str(tmp_path / name)
        if name == "port":
            run = o.start_run(d, algorithm="test", verbose="none",
                              device="cpu")
        else:
            run = o.start_run(d, algorithm="test", verbose="none")
        wd = mod.DispatchWatchdog(0.0, action="event", algorithm="test")
        try:
            wd.arm(1, "test_fence")
            deadline = time.monotonic() + 10
            while wd.stalls == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(0.6)  # fire-once per armed fence
            wd.disarm()
        finally:
            wd.stop()
            run.close()
        assert wd.stalls == 1
        (st,) = [e for e in o.read_events(d) if e["type"] == "stall"]
        recs[name] = {k: v for k, v in st.items() if k != "t"}
    assert recs["port"] == recs["jax"]
    assert jschema.required_fields("stall") <= set(recs["port"]) | {"t"}


def _learn(kind, b, cfg, **kw):
    geom = ProblemGeom((3, 3), 4)
    if kind == "consensus":
        return consensus.learn(b, geom, cfg, device="cpu", **kw)
    if kind == "masked":
        return tlm.learn_masked(b, geom, cfg, device="cpu", **kw)
    return streaming.learn_streaming(b, geom, cfg, device="cpu",
                                     stream_mode="paged", **kw)


@pytest.mark.parametrize("kind", ["consensus", "masked", "streaming"])
def test_hang_fault_fires_one_stall_and_the_run_completes(monkeypatch,
                                                         tmp_path, kind):
    """``CCSC_FAULT_HANG_IT`` sleeps inside the armed fence: the
    watchdog (event mode) records exactly one stall for it, and the run
    completes bitwise the unarmed, unfaulted one."""
    b = np.random.default_rng(3).standard_normal((4, 10, 10)).astype(
        np.float32)
    kw = dict(max_it=3, max_it_d=2, max_it_z=2, num_blocks=2, tol=0.0,
              verbose="none", rho_d=50.0, rho_z=2.0)
    if kind == "masked":
        kw.pop("num_blocks")
    ref = _learn(kind, b, LearnConfig(**kw))
    monkeypatch.setenv("CCSC_FAULT_HANG_IT", "2")
    monkeypatch.setenv("CCSC_FAULT_HANG_S", "4.5")
    monkeypatch.setenv("CCSC_FAULT_STATE_DIR", str(tmp_path / "state"))
    monkeypatch.setenv("CCSC_WATCHDOG_ACTION", "event")
    # a floor far above a step of this size, even on a loaded host
    monkeypatch.setenv("CCSC_WATCHDOG_MIN_S", "3")
    monkeypatch.setenv("CCSC_WATCHDOG_COMPILE_S", "60")
    m = str(tmp_path / "m")
    res = _learn(kind, b, LearnConfig(**kw, watchdog=True, metrics_dir=m))
    events = obs.read_events(m)
    stalls = [e for e in events if e["type"] == "stall"]
    prefix = {"consensus": "ccsc_outer_", "masked": "masked_outer_",
              "streaming": "stream_outer_"}[kind]
    assert [s["label"] for s in stalls] == [f"{prefix}1"]
    assert [e["fault"] for e in events if e["type"] == "fault_fired"] == [
        "hang"]
    assert torch.equal(res.d, ref.d)
    assert res.trace["obj_vals_z"] == ref.trace["obj_vals_z"]


def _write(path, records):
    w = obs.EventWriter(path)
    for r in records:
        w.write(r)
    w.close()


def test_check_peers_and_replicas_equal_jax(tmp_path):
    now = time.time()
    _write(str(tmp_path / "events-p00000.jsonl"),
           [{"t": t, "type": "heartbeat", "host": 0, "step": 1}
            for t in (now - 500, now - 300, now - 10)]
           + [{"t": now - 5, "type": "fleet_heartbeat", "replica_id": 0,
               "state": "live", "served": 4, "restarts": 0},
              {"t": now - 400, "type": "fleet_heartbeat", "replica_id": 1,
               "state": "live", "served": 1, "restarts": 1}])
    # host 1 went quiet 400 s before the stream's newest record
    _write(str(tmp_path / "events-p00001.jsonl"),
           [{"t": now - 400, "type": "heartbeat", "host": 1, "step": 1}])
    d = str(tmp_path)
    stale = twd.check_peers(d, stale_s=120)
    assert stale == jwd.check_peers(d, stale_s=120)
    assert [p["host"] for p in stale] == [1]
    assert stale[0]["behind_s"] == pytest.approx(390, abs=5)
    assert twd.check_peers(d, stale_s=1000) == []
    assert twd.check_replicas(d, stale_s=120) == \
        jwd.check_replicas(d, stale_s=120)
    assert [r["stale"] for r in twd.check_replicas(d, stale_s=120)] == [
        False, True]


def test_the_live_peer_check_flags_a_stale_rank(monkeypatch, tmp_path):
    """In a process group of two, the watchdog thread tails the shared
    metrics dir and records ``peer_stale`` once for a rank whose
    heartbeat lags the stream."""
    now = time.time()
    m = str(tmp_path)
    _write(os.path.join(m, "events-p00001.jsonl"),
           [{"t": now - 300, "type": "heartbeat", "host": 1, "step": 1}])
    monkeypatch.setattr(obs, "_process_group", lambda: (0, 2))
    monkeypatch.setenv("CCSC_WATCHDOG_PEER_STALE_S", "4")
    run = obs.start_run(m, algorithm="consensus", verbose="none",
                        device="cpu")
    wd = twd.DispatchWatchdog(0.0, action="event", metrics_dir=m)
    try:
        run.heartbeat(1, 0.1)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not any(
                e["type"] == "peer_stale" for e in obs.read_events(m)):
            time.sleep(0.1)
        time.sleep(1.2)  # a second check flags nothing new
    finally:
        wd.stop()
        run.close()
    peers = [e for e in obs.read_events(m) if e["type"] == "peer_stale"]
    assert [p["host"] for p in peers] == [1]


def test_abort_mode_exits_87(tmp_path):
    """``CCSC_WATCHDOG_ACTION=abort`` (the default): an expired fence
    syncs the stream and hard-exits the process with EXIT_STALL while
    the driver thread is still blocked."""
    m = str(tmp_path / "m")
    code = (
        "import time\n"
        "from ccsc_code_iccv2017_torch.utils import obs, watchdog\n"
        f"run = obs.start_run({m!r}, algorithm='test', verbose='none', "
        "device='cpu')\n"
        "wd = watchdog.DispatchWatchdog(0.0, algorithm='test')\n"
        "wd.arm(1, 'hung_fence')\n"
        "time.sleep(60)\n"
        "print('not reached')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, CCSC_WATCHDOG_MIN_S="0.5",
               CCSC_WATCHDOG_COMPILE_S="0")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == twd.EXIT_STALL, proc.stderr
    assert time.monotonic() - t0 < 50
    assert "not reached" not in proc.stdout
    stalls = [e for e in obs.read_events(m) if e["type"] == "stall"]
    assert [(s["label"], s["action"]) for s in stalls] == [
        ("hung_fence", "abort")]


def _mesh_rank(rank, b, mdir):
    """A rank of the consensus learner on block_mesh(2), each rank with
    its own watchdog (event mode) over the shared metrics dir."""
    os.environ["CCSC_WATCHDOG_ACTION"] = "event"
    from ccsc_code_iccv2017_torch.parallel.mesh import block_mesh

    cfg = LearnConfig(max_it=2, max_it_d=2, max_it_z=2, num_blocks=2,
                      tol=0.0, verbose="none", watchdog=True,
                      metrics_dir=mdir)
    return consensus.learn(b, ProblemGeom((3, 3), 4), cfg, device="cpu",
                           mesh=block_mesh(2)).d


def test_every_rank_of_a_mesh_arms_its_own(tmp_path):
    from ccsc_code_iccv2017_torch.parallel import distributed

    b = np.random.default_rng(5).standard_normal((4, 10, 10)).astype(
        np.float32)
    m = str(tmp_path / "m")
    d0, d1 = distributed.launch(_mesh_rank, 2, args=(b, m), device="cpu",
                                timeout=60)
    ref = consensus.learn(b, ProblemGeom((3, 3), 4), LearnConfig(
        max_it=2, max_it_d=2, max_it_z=2, num_blocks=2, tol=0.0,
        verbose="none"), device="cpu").d
    assert torch.equal(d0, d1)
    assert float((d0 - ref).abs().max()) <= 2e-5
    events = obs.read_events(m)
    assert sorted(e["host"] for e in events if e["type"] == "run_meta") == [
        0, 1]
    assert not [e for e in events if e["type"] in ("stall", "peer_stale")]
    assert sorted(os.listdir(m)) == ["events-p00000.jsonl",
                                     "events-p00001.jsonl"]
