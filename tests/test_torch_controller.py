"""The port's SLO-feedback capacity controller
(``ccsc_code_iccv2017_torch.serve.controller``) held to the JAX
package's ``serve.controller``:

- the fail-safety contracts of the JAX package's controller tests,
  against the port's controller over a FakeFleet (the controller is
  strictly advisory, so its whole contract shows in the actuator calls
  it makes and the ``ctrl_*`` events it emits): sustained pressure and
  SLO breaches scale up, scale-down needs everything green, cooldowns,
  the flap guard, bounds holdoffs and reconciliation, sensor blackout
  and stale or failing snapshots hold and never scale down, a hung
  actuator opens the breaker and a reset half-opens it, a crash
  mid-scale leaves the fleet as configured, close is advisory,
  brownout hysteresis, the device-memory veto and host-pool scaling;
- the same snapshot sequence fed to JAX's and the port's
  ``CapacityController.step()`` makes the same actuator calls and the
  same ``ctrl_*`` event sequence (type, action, reason);
- the port controller over a real port ``ServeFleet`` on the CPU grows
  it 1 -> 2 under a burst and shrinks it back once idle, with zero
  lost requests;
- ``apps.serve.ResubmitBackoff`` and the refusal trio.
"""
import time

import numpy as np
import pytest

from ccsc_code_iccv2017_torch.apps.serve import ResubmitBackoff
from ccsc_code_iccv2017_torch.config import ControllerConfig
from ccsc_code_iccv2017_torch.serve.controller import CapacityController
from ccsc_code_iccv2017_torch.serve.engine import BucketCold
from ccsc_code_iccv2017_torch.serve.fleet import Overloaded
from ccsc_code_iccv2017_torch.utils import faults, obs

_FAULT_VARS = (
    "CCSC_FAULT_CTRL_SENSOR_BLACKOUT",
    "CCSC_FAULT_CTRL_BLACKOUT_S",
    "CCSC_FAULT_CTRL_ACT_HANG",
    "CCSC_FAULT_CTRL_ACT_HANG_S",
    "CCSC_FAULT_CTRL_CRASH_SCALE",
    "CCSC_FAULT_STATE_DIR",
)


@pytest.fixture(autouse=True)
def _ctrl_isolation(monkeypatch):
    for v in _FAULT_VARS:
        monkeypatch.delenv(v, raising=False)
    faults.reset()
    yield
    faults.reset()


class FakeFleet:
    """The controller's entire world: one sensor (control_snapshot)
    and three actuators, each call recorded. Emits through a REAL obs
    run so the ctrl_* event contract is exercised end to end."""

    def __init__(self, run, target=1):
        self._run = run
        self._target = target
        self._brownout = False
        self.scale_calls = []
        self.brownout_calls = []
        self.gauges = {}
        self.fail_snapshot = False
        self.stale_age_s = 0.0
        self.snap = dict(
            queue_depth=0, ceiling=10, rung=0, live_replicas=target,
            abandoned=0, bound_rps=5.0, warm_replicas=target,
            warmup_eta_s=0.0, p99_ms=None, slo_p99_target_ms=None,
        )

    @property
    def replica_target(self):
        return self._target

    def control_snapshot(self):
        if self.fail_snapshot:
            raise RuntimeError("sensors down")
        s = dict(self.snap)
        s["t"] = time.time() - self.stale_age_s
        s["replica_target"] = self._target
        s["brownout"] = self._brownout
        return s

    def set_replica_count(self, n, reason="manual"):
        old = self._target
        self._target = n
        self.scale_calls.append((old, n, reason))
        return {"from_n": old, "to_n": n}

    def set_brownout(self, on, reason="controller"):
        self.brownout_calls.append((on, reason))
        changed = on != self._brownout
        self._brownout = on
        return changed

    def set_ctrl_gauge(self, name, value):
        self.gauges[name] = value


def _cfg(cls=ControllerConfig, **kw):
    base = dict(
        min_replicas=1, max_replicas=3, interval_s=0.01, high_frac=0.8,
        low_frac=0.2, sustain=2, cooldown_s=0.05, stale_s=5.0,
        act_timeout_s=0.25, act_retries=0, act_backoff_s=0.01,
        breaker_after=2, breaker_reset_s=0.5,
        # out of the way unless a test targets brownout
        brownout_frac=1.4, brownout_exit_frac=0.05, hbm_limit_mb=0.0,
    )
    base.update(kw)
    return cls(**base)


@pytest.fixture
def run(tmp_path):
    r = obs.start_run(str(tmp_path), algorithm="ctrl_test", verbose="none",
                      compile_monitor=False, device="cpu")
    yield r
    if not r.closed:
        r.close(status="ok")


def _events(tmp_path, type_=None):
    ev = obs.read_events(str(tmp_path))
    return [e for e in ev if type_ is None or e["type"] == type_]


# -- the happy control loop ----------------------------------------------


def test_scale_up_on_sustained_pressure(run, tmp_path):
    fleet = FakeFleet(run, target=1)
    ctrl = CapacityController(fleet, _cfg())
    fleet.snap["queue_depth"] = 9  # frac 0.9 >= high_frac
    ctrl.step()
    assert fleet.scale_calls == []  # one tick is not sustained
    ctrl.step()
    assert fleet.scale_calls == [(1, 2, "controller:queue_pressure")]
    decs = _events(tmp_path, "ctrl_decision")
    assert decs and decs[-1]["action"] == "scale_up"
    assert decs[-1]["snapshot"]["queue_depth"] == 9
    scales = _events(tmp_path, "ctrl_scale")
    assert scales[-1]["direction"] == "up" and scales[-1]["ok"] is True
    assert (scales[-1]["from_n"], scales[-1]["to_n"]) == (1, 2)


def test_scale_up_on_slo_breach(run, tmp_path):
    fleet = FakeFleet(run, target=1)
    ctrl = CapacityController(fleet, _cfg())
    fleet.snap.update(queue_depth=1, p99_ms=250.0, slo_p99_target_ms=100.0)
    ctrl.step()
    ctrl.step()
    assert fleet.scale_calls == [(1, 2, "controller:slo_breach")]


def test_scale_down_needs_green_everything(run, tmp_path):
    fleet = FakeFleet(run, target=2)
    ctrl = CapacityController(fleet, _cfg())
    fleet.snap.update(queue_depth=0, rung=1)
    for _ in range(5):
        ctrl.step()
    assert fleet.scale_calls == []
    fleet.snap["rung"] = 0
    ctrl.step()
    ctrl.step()
    assert fleet.scale_calls == [(2, 1, "controller:idle_capacity")]


def test_cooldown_suppresses_back_to_back_scaling(run, tmp_path):
    fleet = FakeFleet(run, target=1)
    ctrl = CapacityController(fleet, _cfg(cooldown_s=30.0))
    fleet.snap["queue_depth"] = 9
    for _ in range(6):
        ctrl.step()
    assert fleet.scale_calls == [(1, 2, "controller:queue_pressure")]
    holds = _events(tmp_path, "ctrl_holdoff")
    assert any(h["reason"] == "cooldown:scale_up" for h in holds)


def test_flap_guard_oscillating_load(run, tmp_path):
    fleet = FakeFleet(run, target=2)
    ctrl = CapacityController(fleet, _cfg(sustain=3))
    for i in range(18):
        fleet.snap["queue_depth"] = 9 if i % 2 == 0 else 0
        ctrl.step()
    assert fleet.scale_calls == [] and fleet.brownout_calls == []
    assert _events(tmp_path, "ctrl_scale") == []


def test_bounds_holdoffs_and_reconcile(run, tmp_path):
    fleet = FakeFleet(run, target=3)
    ctrl = CapacityController(fleet, _cfg())
    fleet.snap["queue_depth"] = 10
    for _ in range(3):
        ctrl.step()
    assert fleet.scale_calls == []
    holds = _events(tmp_path, "ctrl_holdoff")
    assert any(h["reason"] == "at_max_replicas" for h in holds)
    fleet2 = FakeFleet(run, target=1)
    ctrl2 = CapacityController(fleet2, _cfg(min_replicas=2))
    fleet2.snap["queue_depth"] = 5
    ctrl2.step()
    assert fleet2.scale_calls == [(1, 2, "controller:reconcile_bounds")]


# -- fail-safe sensors ---------------------------------------------------


def test_sensor_blackout_holds_and_never_scales_down(run, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("CCSC_FAULT_CTRL_SENSOR_BLACKOUT", "1")
    monkeypatch.setenv("CCSC_FAULT_CTRL_BLACKOUT_S", "60")
    faults.reset()
    fleet = FakeFleet(run, target=2)
    ctrl = CapacityController(fleet, _cfg(sustain=1))
    fleet.snap["queue_depth"] = 0
    for _ in range(6):
        ctrl.step()
    assert fleet.scale_calls == [] and fleet.brownout_calls == []
    holds = _events(tmp_path, "ctrl_holdoff")
    assert holds and all(h["reason"] == "sensor_stale" for h in holds)
    assert any(e["fault"] == "ctrl_blackout"
               for e in _events(tmp_path, "fault_fired"))


def test_stale_snapshot_fails_safe(run, tmp_path):
    fleet = FakeFleet(run, target=2)
    ctrl = CapacityController(fleet, _cfg(sustain=2, stale_s=1.0))
    fleet.snap["queue_depth"] = 0
    fleet.stale_age_s = 30.0
    for _ in range(4):
        ctrl.step()
    assert fleet.scale_calls == []
    assert any(h["reason"] == "sensor_stale"
               for h in _events(tmp_path, "ctrl_holdoff"))
    fleet.stale_age_s = 0.0
    ctrl.step()
    assert fleet.scale_calls == []  # streaks were reset
    ctrl.step()
    assert fleet.scale_calls == [(2, 1, "controller:idle_capacity")]


def test_snapshot_exception_fails_safe(run, tmp_path):
    fleet = FakeFleet(run, target=2)
    ctrl = CapacityController(fleet, _cfg(sustain=1))
    fleet.snap["queue_depth"] = 0
    fleet.fail_snapshot = True
    for _ in range(3):
        ctrl.step()
    assert fleet.scale_calls == []
    assert any(h["reason"] == "sensor_stale"
               for h in _events(tmp_path, "ctrl_holdoff"))


# -- stuck actuators -----------------------------------------------------


def test_actuator_hang_opens_breaker(run, tmp_path, monkeypatch):
    monkeypatch.setenv("CCSC_FAULT_CTRL_ACT_HANG", "10")
    monkeypatch.setenv("CCSC_FAULT_CTRL_ACT_HANG_S", "3600")
    faults.reset()
    fleet = FakeFleet(run, target=1)
    ctrl = CapacityController(
        fleet, _cfg(sustain=1, act_timeout_s=0.1, cooldown_s=0.0001))
    fleet.snap["queue_depth"] = 9
    ctrl.step()  # invocation 1: hangs -> timeout -> failed
    ctrl.step()  # invocation 2: hangs -> breaker opens
    ctrl.step()  # refused at the breaker, no invocation
    assert fleet.scale_calls == []
    assert fleet.gauges.get("ctrl_breaker_open") == 1.0
    scales = _events(tmp_path, "ctrl_scale")
    assert scales and all(s["ok"] is False for s in scales)
    assert any(h["reason"] == "breaker_open:scale_up"
               for h in _events(tmp_path, "ctrl_holdoff"))
    assert any(e["fault"] == "ctrl_act_hang"
               for e in _events(tmp_path, "fault_fired"))


def test_breaker_half_opens_after_reset(run, tmp_path, monkeypatch):
    monkeypatch.setenv("CCSC_FAULT_CTRL_ACT_HANG", "2")
    faults.reset()
    fleet = FakeFleet(run, target=1)
    ctrl = CapacityController(
        fleet, _cfg(sustain=1, act_timeout_s=0.1, cooldown_s=0.0001,
                    breaker_reset_s=0.2))
    fleet.snap["queue_depth"] = 9
    ctrl.step()
    ctrl.step()  # breaker open now, both hang charges spent
    assert fleet.gauges.get("ctrl_breaker_open") == 1.0
    time.sleep(0.25)  # past breaker_reset_s: half-open probe allowed
    ctrl.step()
    assert fleet.scale_calls == [(1, 2, "controller:queue_pressure")]
    assert fleet.gauges.get("ctrl_breaker_open") == 0.0


# -- controller death ----------------------------------------------------


def test_crash_mid_scale_leaves_fleet_as_configured(run, tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("CCSC_FAULT_CTRL_CRASH_SCALE", "1")
    faults.reset()
    fleet = FakeFleet(run, target=1)
    ctrl = CapacityController(fleet, _cfg(sustain=1)).start()
    fleet.snap["queue_depth"] = 9
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not ctrl.died:
        time.sleep(0.01)
    assert ctrl.died and not ctrl.alive
    assert fleet.scale_calls == [] and fleet.replica_target == 1
    assert _events(tmp_path, "ctrl_decision")
    ctrl.close()
    ctrl2 = CapacityController(fleet, _cfg(sustain=1))
    ctrl2.step()
    assert fleet.scale_calls == [(1, 2, "controller:queue_pressure")]
    assert fleet.replica_target == 2
    ctrl2.close()


def test_close_is_advisory(run, tmp_path):
    fleet = FakeFleet(run, target=2)
    fleet.snap["queue_depth"] = 5
    ctrl = CapacityController(fleet, _cfg()).start()
    assert ctrl.alive
    ctrl.close()
    assert not ctrl.alive
    assert fleet.scale_calls == [] and fleet.replica_target == 2


# -- brownout ------------------------------------------------------------


def test_brownout_hysteresis(run, tmp_path):
    fleet = FakeFleet(run, target=1)
    ctrl = CapacityController(
        fleet, _cfg(brownout_frac=0.9, brownout_exit_frac=0.3,
                    cooldown_s=0.01, high_frac=1.45, sustain=50))
    fleet.snap["queue_depth"] = 9
    ctrl.step()
    assert fleet.brownout_calls == [(True, "controller")]
    assert _events(tmp_path, "ctrl_brownout")[-1]["on"] is True
    fleet.snap["queue_depth"] = 5
    time.sleep(0.02)
    ctrl.step()
    assert len(fleet.brownout_calls) == 1
    fleet.snap["queue_depth"] = 2
    time.sleep(0.02)
    ctrl.step()
    assert fleet.brownout_calls[-1] == (False, "controller")
    assert _events(tmp_path, "ctrl_brownout")[-1]["on"] is False


# -- scale-up vetoes and the host axis -----------------------------------


class FakeMemWatch:
    def __init__(self, peak_mb):
        self._peak = int(peak_mb * 2**20)

    def sample(self):
        return self._peak

    @property
    def peak_bytes(self):
        return self._peak


def test_hbm_watermark_vetoes_scale_up(run, tmp_path):
    fleet = FakeFleet(run, target=1)
    ctrl = CapacityController(fleet, _cfg(sustain=1, hbm_limit_mb=100.0),
                              memwatch=FakeMemWatch(peak_mb=200.0))
    fleet.snap["queue_depth"] = 9
    for _ in range(3):
        ctrl.step()
    assert fleet.scale_calls == []
    assert any(h["reason"] == "hbm_watermark"
               for h in _events(tmp_path, "ctrl_holdoff"))


class FakePool:
    def __init__(self, n=1):
        self.n_hosts = n
        self.calls = []

    def grow(self):
        self.n_hosts += 1
        self.calls.append("grow")
        return f"host-{self.n_hosts}"

    def shrink(self):
        self.n_hosts -= 1
        self.calls.append("shrink")
        return f"host-{self.n_hosts + 1}"


def test_host_pool_scales_when_replicas_pinned(run, tmp_path):
    pool = FakePool(n=1)
    fleet = FakeFleet(run, target=2)
    ctrl = CapacityController(
        fleet, _cfg(min_replicas=2, max_replicas=2, sustain=1,
                    min_hosts=1, max_hosts=2, cooldown_s=0.0001),
        host_pool=pool)
    fleet.snap["queue_depth"] = 9
    ctrl.step()
    assert pool.calls == ["grow"]
    scales = _events(tmp_path, "ctrl_scale")
    assert scales[-1]["direction"] == "host_up"
    assert (scales[-1]["from_n"], scales[-1]["to_n"]) == (1, 2)
    fleet.snap["queue_depth"] = 0
    time.sleep(0.01)
    ctrl.step()
    assert pool.calls == ["grow", "shrink"] and pool.n_hosts == 1


# -- the port and JAX decide alike ---------------------------------------

# (queue_depth, rung, p99_ms, slo_target) per tick: pressure builds and
# scales up, cools down, brownout engages and releases, the fleet drains
# back to its floor and holds there, a breach scales up again
_SEQUENCE = (
    [(9, 0, None, None)] * 3 + [(10, 1, None, None)] * 2
    + [(5, 0, None, None)] * 2 + [(2, 0, None, None)]
    + [(0, 0, None, None)] * 6 + [(1, 0, 250.0, 100.0)] * 3
)


def _drive(ctrl_cls, cfg_cls, run, sleep_s):
    fleet = FakeFleet(run, target=1)
    ctrl = ctrl_cls(fleet, _cfg(
        cfg_cls, min_replicas=1, max_replicas=2, sustain=2,
        cooldown_s=0.0001, brownout_frac=0.95, brownout_exit_frac=0.3))
    for depth, rung, p99, slo in _SEQUENCE:
        fleet.snap.update(queue_depth=depth, rung=rung, p99_ms=p99,
                          slo_p99_target_ms=slo)
        ctrl.step()
        time.sleep(sleep_s)
    return fleet


def _ctrl_trace(events):
    keep = ("ctrl_decision", "ctrl_scale", "ctrl_brownout", "ctrl_holdoff")
    return [(e["type"], e.get("action"), e.get("reason"),
             e.get("direction"), e.get("on"), e.get("ok"))
            for e in events if e["type"] in keep]


def test_same_snapshots_same_decisions_as_jax(tmp_path):
    from ccsc_code_iccv2017_tpu.config import ControllerConfig as JCfg
    from ccsc_code_iccv2017_tpu.serve.controller import (
        CapacityController as JCtrl,
    )
    from ccsc_code_iccv2017_tpu.utils import obs as jobs

    # no compile monitor: a JAX monitor opened here would outlive the
    # run in this process and count later tests' XLA compiles
    jrun = jobs.start_run(str(tmp_path / "j"), algorithm="ctrl_test",
                          verbose="none", compile_monitor=False)
    try:
        jfleet = _drive(JCtrl, JCfg, jrun, 0.002)
    finally:
        jrun.close(status="ok")
    trun = obs.start_run(str(tmp_path / "t"), algorithm="ctrl_test",
                         verbose="none", compile_monitor=False,
                         device="cpu")
    try:
        tfleet = _drive(CapacityController, ControllerConfig, trun, 0.002)
    finally:
        trun.close(status="ok")
    assert tfleet.scale_calls == jfleet.scale_calls
    assert tfleet.brownout_calls == jfleet.brownout_calls
    assert [c[:2] for c in tfleet.scale_calls] == [(1, 2), (2, 1), (1, 2)]
    jt = _ctrl_trace(jobs.read_events(str(tmp_path / "j")))
    tt = _ctrl_trace(obs.read_events(str(tmp_path / "t")))
    assert tt == jt
    assert {t[0] for t in tt} == {"ctrl_decision", "ctrl_scale",
                                  "ctrl_brownout", "ctrl_holdoff"}


# -- the port controller over a real port fleet --------------------------


def test_controller_grows_and_shrinks_a_real_fleet(tmp_path):
    from ccsc_code_iccv2017_torch.config import (
        FleetConfig, ProblemGeom, ServeConfig, SolveConfig,
    )
    from ccsc_code_iccv2017_torch.models.reconstruct import (
        ReconstructionProblem,
    )
    from ccsc_code_iccv2017_torch.serve import ServeFleet

    r = np.random.default_rng(0)
    d = r.normal(size=(4, 3, 3)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    fleet = ServeFleet(
        d, ReconstructionProblem(ProblemGeom((3, 3), 4)),
        SolveConfig(lambda_residual=5.0, lambda_prior=0.3, max_it=3,
                    tol=0.0, verbose="none", track_psnr=True),
        ServeConfig(buckets=((2, (12, 12)),), max_wait_ms=2.0,
                    verbose="none"),
        FleetConfig(replicas=1, max_queue_depth=64, restart_backoff_s=0.05,
                    metrics_dir=str(tmp_path / "m"), verbose="none"),
        device="cpu",
    )
    ctrl = CapacityController(fleet, _cfg(
        min_replicas=1, max_replicas=2, sustain=1, high_frac=0.3,
        low_frac=0.05, cooldown_s=0.0001, act_timeout_s=60.0))
    try:
        futs = []
        for i in range(40):
            x = r.random((12, 12)).astype(np.float32)
            m = (r.random((12, 12)) < 0.5).astype(np.float32)
            futs.append(fleet.submit(x * m, mask=m, x_orig=x, key=f"k{i}"))
        ctrl.step()  # burst: 40 queued of a 64 ceiling -> grow
        assert fleet.replica_target == 2
        res = [f.result(timeout=120) for f in futs]
        assert len(res) == 40 and all(np.isfinite(x.recon).all()
                                      for x in res)
        t_end = time.monotonic() + 60
        while fleet.replica_target > 1 and time.monotonic() < t_end:
            ctrl.step()  # idle: drain-then-retire back to the floor
            time.sleep(0.05)
        assert fleet.replica_target == 1
        st = fleet.stats()
        assert st["n_requests"] == 40
    finally:
        ctrl.close()
        fleet.close()
    scales = [e for e in obs.read_events(str(tmp_path / "m"),
                                         recursive=True)
              if e["type"] == "ctrl_scale"]
    assert [(e["direction"], e["ok"]) for e in scales] == [
        ("up", True), ("down", True)]


# -- the resubmit backoff split (apps.serve) -----------------------------


def test_resubmit_backoff_tracks_classes_separately():
    bo = ResubmitBackoff()
    cold = BucketCold("64x64", 1.0)
    over = Overloaded("queue full", 1.0)
    assert bo.delay_for(over) == 1.0
    assert bo.delay_for(cold) == 1.0  # NOT 2.0: its own counter
    assert bo.delay_for(over) == 2.0
    assert bo.delay_for(cold) == 2.0
    assert bo.delay_for(over) == 4.0
    assert bo.delay_for(cold) == 4.0
    assert bo.consec("Overloaded") == 3 and bo.consec("BucketCold") == 3
    bo.reset()
    assert bo.delay_for(over) == 1.0 and bo.delay_for(cold) == 1.0


def test_resubmit_backoff_caps():
    bo = ResubmitBackoff()
    over = Overloaded("queue full", 3.0)
    delays = [bo.delay_for(over) for _ in range(10)]
    assert delays[0] == 3.0
    assert max(delays) == ResubmitBackoff.CAP_S == delays[-1]
    assert bo.delay_for(BucketCold("64x64", 0.25)) == 0.25


def test_refusal_trio_deadline_is_terminal():
    from ccsc_code_iccv2017_torch.serve.engine import DeadlineExceeded

    dead = DeadlineExceeded("admission", 123.0)
    assert not isinstance(dead, (Overloaded, BucketCold))
    assert not hasattr(dead, "retry_after_s")
    assert dead.where == "admission" and dead.deadline == 123.0
    bo = ResubmitBackoff()
    with pytest.raises(AttributeError):
        bo.delay_for(dead)
    assert bo.consec("Overloaded") == 0 and bo.consec("BucketCold") == 0
