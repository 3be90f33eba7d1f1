"""SLO-feedback capacity controller — the strictly-advisory control
plane over a :class:`~.fleet.ServeFleet` (a copy of
``ccsc_code_iccv2017_tpu.serve.controller``: the same loop, bands,
streaks, cooldowns, fail-safes and events, so both packages make the
same decision on the same snapshot sequence).

One daemon thread closes the loop the fleet left open: every tick it
takes ONE consistent sensor snapshot (``ServeFleet.control_snapshot``
— queue depth vs the derived admission ceiling, live/warm replicas vs
target, SLO p99 vs the declared target, warmup ETAs, plus an optional
measured device-memory watermark from
:class:`~..utils.memwatch.MemWatch`, ``torch.cuda.memory_stats``'
peak) and drives the fleet's actuators inside configured bounds:

- ``set_replica_count`` — fine-grain grow/shrink. Grow spawns a
  replica engine in the same process (the kernel library is already
  loaded, so a grown replica builds plans and nothing else); the new
  replica is admitted into the ceiling only once warm. Shrink is
  drain-then-retire with requeue-to-front, never a kill.
- ``set_brownout`` — the degrade rung driven directly: trade solve
  quality for throughput BEFORE any shed.
- an optional :class:`~.federation.FederatedHostPool` — coarse-grain
  host spin-up/down against the durable queue, engaged only when the
  replica axis is already pinned at its bound.

Control-theory hygiene, because a flapping controller is worse than
none: hysteresis bands (``high_frac``/``low_frac`` and the brownout
pair) with ``sustain``-tick streaks, per-actuator cooldowns, sensor
staleness detection that FAILS SAFE (stale or missing telemetry →
hold state, emit ``ctrl_holdoff``, and never scale *down*), actuator
invocations under timeout/retry/exponential-backoff with a
stuck-actuator circuit breaker, and — the hard invariant the
``CCSC_FAULT_CTRL_*`` chaos points prove — the controller holds NO
durable state: every tick re-reads ``fleet.replica_target``, so a
controller that dies mid-scale leaves the fleet serving exactly as
configured and a restarted one reconciles from live state.

Every decision is an event (``ctrl_decision`` / ``ctrl_scale`` /
``ctrl_brownout`` / ``ctrl_holdoff``, analysis.obs_schema) carrying
the sensor snapshot that justified it, so a reader of the fleet's
stream can replay why capacity moved.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..config import ControllerConfig
from ..utils import env as _env
from ..utils import faults

__all__ = ["CapacityController", "ActuatorStuck", "BreakerOpen"]


class ActuatorStuck(RuntimeError):
    """An actuator invocation exhausted its timeout/retry budget."""


class BreakerOpen(RuntimeError):
    """The actuator's circuit breaker is open — invocation refused."""


def _resolve(value, knob: str):
    return value if value is not None else _env.env_float(knob)


class CapacityController:
    """The control loop. Construct over a running fleet and
    :meth:`start` it; :meth:`close` stops the loop without touching
    the data plane. ``host_pool`` (a
    :class:`~.federation.FederatedHostPool`) and ``memwatch`` (a
    :class:`~..utils.memwatch.MemWatch`) are optional sensors/
    actuators — absent, the controller simply never uses them."""

    #: actuator registry keys (cooldowns + breakers are per-actuator)
    _ACTUATORS = ("scale_up", "scale_down", "brownout", "hosts")

    def __init__(
        self,
        fleet,
        cfg: Optional[ControllerConfig] = None,
        *,
        host_pool=None,
        memwatch=None,
    ):
        cfg = cfg or ControllerConfig()
        self._fleet = fleet
        self._cfg = cfg
        self._pool = host_pool
        self._mem = memwatch
        # every None field resolves from its CCSC_CTRL_* knob once,
        # here — the loop never consults the environment again
        self.interval_s = float(
            _resolve(cfg.interval_s, "CCSC_CTRL_INTERVAL_S")
        )
        self.high_frac = float(
            _resolve(cfg.high_frac, "CCSC_CTRL_HIGH_FRAC")
        )
        self.low_frac = float(
            _resolve(cfg.low_frac, "CCSC_CTRL_LOW_FRAC")
        )
        self.sustain = int(
            cfg.sustain if cfg.sustain is not None
            else _env.env_int("CCSC_CTRL_SUSTAIN")
        )
        self.cooldown_s = float(
            _resolve(cfg.cooldown_s, "CCSC_CTRL_COOLDOWN_S")
        )
        self.stale_s = float(
            _resolve(cfg.stale_s, "CCSC_CTRL_STALE_S")
        )
        self.act_timeout_s = float(
            _resolve(cfg.act_timeout_s, "CCSC_CTRL_ACT_TIMEOUT_S")
        )
        self.act_retries = int(
            cfg.act_retries if cfg.act_retries is not None
            else _env.env_int("CCSC_CTRL_ACT_RETRIES")
        )
        self.act_backoff_s = float(
            _resolve(cfg.act_backoff_s, "CCSC_CTRL_ACT_BACKOFF_S")
        )
        self.breaker_after = int(
            cfg.breaker_after if cfg.breaker_after is not None
            else _env.env_int("CCSC_CTRL_BREAKER_AFTER")
        )
        self.breaker_reset_s = float(
            _resolve(cfg.breaker_reset_s, "CCSC_CTRL_BREAKER_RESET_S")
        )
        self.brownout_frac = float(
            _resolve(cfg.brownout_frac, "CCSC_CTRL_BROWNOUT_FRAC")
        )
        self.brownout_exit_frac = float(
            _resolve(
                cfg.brownout_exit_frac, "CCSC_CTRL_BROWNOUT_EXIT_FRAC"
            )
        )
        self.hbm_limit_mb = float(
            _resolve(cfg.hbm_limit_mb, "CCSC_CTRL_HBM_LIMIT_MB")
        )
        # loop state — streaks and bookkeeping only; NEVER the
        # capacity itself (that lives in fleet.replica_target)
        self._tick = 0
        self._up_streak = 0
        self._down_streak = 0
        self._stale_since: Optional[float] = None
        self._cool_until: Dict[str, float] = {}
        self._breaker_fails: Dict[str, int] = {}
        self._breaker_open_until: Dict[str, float] = {}
        self._last_holdoff: Optional[tuple] = None  # (reason, t_mono)
        self.died = False  # the loop thread crashed (chaos asserts)
        self.n_decisions = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- plumbing ------------------------------------------------------
    def _emit(self, type_: str, *, replica_id, **fields) -> None:
        """Controller records ride the fleet's obs stream (one
        merged timeline); ``replica_id`` is always
        None — decisions are fleet-scope."""
        self._fleet._run.event(type_, replica_id=replica_id, **fields)

    def _console(self, msg: str) -> None:
        try:
            self._fleet._run.console(f"ctrl: {msg}", tier="brief")
        except Exception:
            pass

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "CapacityController":
        if self._thread is not None:
            raise RuntimeError("controller already started")
        self._thread = threading.Thread(
            target=self._loop, name="ccsc-capacity-ctrl", daemon=True
        )
        self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def close(self) -> None:
        """Stop the control loop. Strictly advisory to the end: the
        fleet keeps serving at whatever capacity was last
        configured."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, 2 * self.interval_s))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except faults.InjectedFault:
                # chaos: the controller crashed mid-decision. The
                # invariant under test is that NOTHING else changes —
                # no cleanup, no last-gasp actuation.
                self.died = True
                return
            except Exception as e:  # noqa: BLE001 — advisory plane
                # a control-plane bug must never wedge the loop (and
                # can never touch the data plane)
                self._console(f"tick error ({type(e).__name__}: {e})")

    # -- sensors -------------------------------------------------------
    def _read_sensors(self) -> Optional[Dict[str, object]]:
        """One consistent snapshot, or None when telemetry is absent/
        stale — the caller must then FAIL SAFE (hold state, never
        scale down)."""
        if faults.ctrl_sensor_blackout(self._tick):
            return None
        try:
            snap = self._fleet.control_snapshot()
        except Exception:
            return None
        age = time.time() - float(snap.get("t", 0.0))
        if age > self.stale_s:
            return None
        if self._mem is not None:
            try:
                self._mem.sample()
                peak = self._mem.peak_bytes
                snap["hbm_peak_mb"] = (
                    None if peak is None
                    else round(peak / 2**20, 1)
                )
            except Exception:
                snap["hbm_peak_mb"] = None
        return snap

    # -- actuation ladder ---------------------------------------------
    def _breaker_is_open(self, name: str) -> bool:
        until = self._breaker_open_until.get(name)
        if until is None:
            return False
        if time.monotonic() >= until:
            # half-open: allow one probe invocation through
            del self._breaker_open_until[name]
            self._publish_breaker_gauge()
            return False
        return True

    def _publish_breaker_gauge(self) -> None:
        now = time.monotonic()
        n_open = sum(
            1 for u in self._breaker_open_until.values() if u > now
        )
        try:
            self._fleet.set_ctrl_gauge(
                "ctrl_breaker_open", float(n_open)
            )
        except Exception:
            pass

    def _actuate(self, name: str, fn: Callable[[], object]):
        """Run one actuator under the full robustness ladder:
        circuit-breaker gate, per-invocation timeout (the fn runs on
        a scratch thread — a wedged actuator can strand that thread
        but never this loop), retries with exponential backoff, and
        breaker accounting on exhaustion. The chaos hang fault lives
        INSIDE the guarded invocation, so the ladder itself is what
        gets exercised."""
        if self._breaker_is_open(name):
            raise BreakerOpen(name)
        last_err: Optional[BaseException] = None
        for attempt in range(1 + self.act_retries):
            box: Dict[str, object] = {}

            def _work():
                try:
                    dur = faults.ctrl_actuator_hang()
                    if dur > 0:
                        time.sleep(dur)
                    box["value"] = fn()
                except BaseException as e:  # noqa: BLE001
                    box["error"] = e

            t = threading.Thread(
                target=_work,
                name=f"ccsc-ctrl-act-{name}",
                daemon=True,
            )
            t.start()
            t.join(self.act_timeout_s)
            if not t.is_alive() and "value" in box:
                self._breaker_fails[name] = 0
                self._cool_until[name] = (
                    time.monotonic() + self.cooldown_s
                )
                return box["value"]
            last_err = box.get("error") or TimeoutError(
                f"actuator {name} exceeded {self.act_timeout_s}s"
            )
            if attempt < self.act_retries:
                time.sleep(self.act_backoff_s * (2 ** attempt))
        fails = self._breaker_fails.get(name, 0) + 1
        self._breaker_fails[name] = fails
        if fails >= self.breaker_after:
            self._breaker_open_until[name] = (
                time.monotonic() + self.breaker_reset_s
            )
            self._publish_breaker_gauge()
            self._console(
                f"breaker OPEN for {name} ({fails} consecutive "
                f"failures, reset in {self.breaker_reset_s}s)"
            )
        raise ActuatorStuck(f"{name}: {last_err!r}")

    def _holdoff(self, reason: str, snap=None) -> None:
        """Emit a wanted-but-suppressed decision — deduplicated (same
        reason re-emits at cooldown cadence at most) so a saturated
        suppression doesn't flood the stream."""
        now = time.monotonic()
        if self._last_holdoff is not None:
            last_reason, last_t = self._last_holdoff
            if (
                last_reason == reason
                and now - last_t < self.cooldown_s
            ):
                return
        self._last_holdoff = (reason, now)
        self._emit(
            "ctrl_holdoff", replica_id=None, reason=reason,
            tick=self._tick, snapshot=snap,
        )

    def _cooling(self, name: str) -> bool:
        return time.monotonic() < self._cool_until.get(name, 0.0)

    # -- one control tick ----------------------------------------------
    def step(self) -> None:
        """A single tick, callable directly by tests: sense, judge,
        actuate. All capacity state is re-read from the fleet — a
        restarted controller starts correct by construction."""
        self._tick += 1
        snap = self._read_sensors()
        if snap is None:
            # FAIL SAFE: no/stale telemetry. Hold everything, reset
            # streaks (resumed sensors must re-sustain pressure), and
            # say so — but never scale down blind.
            if self._stale_since is None:
                self._stale_since = time.monotonic()
                self._console(
                    "sensors stale/absent — holding state (no "
                    "scale-down on blind telemetry)"
                )
            self._up_streak = self._down_streak = 0
            self._holdoff("sensor_stale")
            return
        if self._stale_since is not None:
            self._stale_since = None
            self._last_holdoff = None
        target = int(self._fleet.replica_target)
        ceiling = snap.get("ceiling") or 0
        depth = int(snap.get("queue_depth") or 0)
        frac = depth / max(1, int(ceiling))
        p99 = snap.get("p99_ms")
        slo = snap.get("slo_p99_target_ms")
        breach = (
            p99 is not None and slo is not None and p99 > float(slo)
        )
        snap = dict(snap, frac=round(frac, 4), breach=breach)

        self._judge_brownout(snap, frac, breach)

        # pressure streaks (the flap guard): scale-down additionally
        # requires SLO green, ladder at rung 0, and no brownout —
        # shedding capacity while ANY overload signal is live would
        # fight the ladder
        up = frac >= self.high_frac or breach
        down = (
            frac <= self.low_frac
            and not breach
            and int(snap.get("rung") or 0) == 0
            and not bool(snap.get("brownout"))
        )
        if up:
            self._up_streak += 1
            self._down_streak = 0
        elif down:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0

        cfg = self._cfg
        if self._up_streak >= self.sustain:
            if target < cfg.max_replicas:
                self._scale(target, target + 1, "queue_pressure"
                            if frac >= self.high_frac
                            else "slo_breach", snap)
            elif not self._grow_hosts(snap):
                self._holdoff("at_max_replicas", snap)
        elif self._down_streak >= self.sustain:
            if target > cfg.min_replicas:
                self._scale(target, target - 1, "idle_capacity", snap)
            elif not self._shrink_hosts(snap):
                self._holdoff("at_min_replicas", snap)
        elif target < cfg.min_replicas:
            # reconciliation: live state below the configured floor
            # (operator shrink, a previous controller's last act) is
            # corrected without waiting out a streak
            self._scale(target, target + 1, "reconcile_bounds", snap)
        elif target > cfg.max_replicas:
            self._scale(target, target - 1, "reconcile_bounds", snap)

    # -- judged actions ------------------------------------------------
    def _judge_brownout(self, snap, frac: float, breach: bool) -> None:
        on = bool(snap.get("brownout"))
        want_on = not on and frac >= self.brownout_frac
        want_off = (
            on and frac <= self.brownout_exit_frac and not breach
        )
        if not (want_on or want_off):
            return
        if self._cooling("brownout"):
            self._holdoff("cooldown:brownout", snap)
            return
        to = bool(want_on)
        reason = "queue_saturation" if to else "pressure_cleared"
        self.n_decisions += 1
        self._emit(
            "ctrl_decision", replica_id=None,
            action="brownout_on" if to else "brownout_off",
            reason=reason, tick=self._tick, snapshot=snap,
        )
        try:
            self._actuate(
                "brownout", lambda: self._fleet.set_brownout(
                    to, reason="controller"
                )
            )
        except BreakerOpen:
            self._holdoff("breaker_open:brownout", snap)
            return
        except ActuatorStuck:
            self._emit(
                "ctrl_brownout", replica_id=None, on=to,
                reason=reason, ok=False,
            )
            return
        self._emit(
            "ctrl_brownout", replica_id=None, on=to, reason=reason,
            ok=True,
        )

    def _scale(self, from_n: int, to_n: int, reason: str, snap) -> None:
        direction = "up" if to_n > from_n else "down"
        name = f"scale_{direction}"
        if self._cooling(name):
            self._holdoff(f"cooldown:{name}", snap)
            return
        if self._breaker_is_open(name):
            self._holdoff(f"breaker_open:{name}", snap)
            return
        if direction == "up" and self._hbm_veto(snap):
            self._holdoff("hbm_watermark", snap)
            return
        self.n_decisions += 1
        self._emit(
            "ctrl_decision", replica_id=None, action=name,
            reason=reason, tick=self._tick, snapshot=snap,
        )
        if faults.ctrl_crash_mid_scale():
            # chaos: die between commitment and actuation — the fleet
            # must keep serving exactly as configured
            raise faults.InjectedFault(
                "controller crash mid-scale (chaos)"
            )
        try:
            self._actuate(
                name,
                lambda: self._fleet.set_replica_count(
                    to_n, reason=f"controller:{reason}"
                ),
            )
        except BreakerOpen:
            self._holdoff(f"breaker_open:{name}", snap)
            return
        except ActuatorStuck:
            self._emit(
                "ctrl_scale", replica_id=None, direction=direction,
                from_n=from_n, to_n=to_n, ok=False,
            )
            return
        self._up_streak = self._down_streak = 0
        self._emit(
            "ctrl_scale", replica_id=None, direction=direction,
            from_n=from_n, to_n=to_n, ok=True,
        )
        self._console(
            f"scaled {direction} {from_n} -> {to_n} ({reason})"
        )

    def _hbm_veto(self, snap) -> bool:
        if self.hbm_limit_mb <= 0:
            return False
        peak = snap.get("hbm_peak_mb")
        return peak is not None and float(peak) >= self.hbm_limit_mb

    # -- coarse-grain host scaling -------------------------------------
    def _grow_hosts(self, snap) -> bool:
        cfg = self._cfg
        if self._pool is None or cfg.max_hosts is None:
            return False
        if self._pool.n_hosts >= cfg.max_hosts:
            return False
        if self._cooling("hosts"):
            self._holdoff("cooldown:hosts", snap)
            return True
        n = self._pool.n_hosts
        self.n_decisions += 1
        self._emit(
            "ctrl_decision", replica_id=None, action="host_up",
            reason="replicas_at_max", tick=self._tick, snapshot=snap,
        )
        try:
            self._actuate("hosts", self._pool.grow)
        except (BreakerOpen, ActuatorStuck):
            self._holdoff("breaker_open:hosts", snap)
            return True
        self._emit(
            "ctrl_scale", replica_id=None, direction="host_up",
            from_n=n, to_n=n + 1, ok=True,
        )
        return True

    def _shrink_hosts(self, snap) -> bool:
        cfg = self._cfg
        if self._pool is None or cfg.min_hosts is None:
            return False
        if self._pool.n_hosts <= cfg.min_hosts:
            return False
        if self._cooling("hosts"):
            self._holdoff("cooldown:hosts", snap)
            return True
        n = self._pool.n_hosts
        self.n_decisions += 1
        self._emit(
            "ctrl_decision", replica_id=None, action="host_down",
            reason="replicas_at_min", tick=self._tick, snapshot=snap,
        )
        try:
            self._actuate("hosts", self._pool.shrink)
        except (BreakerOpen, ActuatorStuck):
            self._holdoff("breaker_open:hosts", snap)
            return True
        self._emit(
            "ctrl_scale", replica_id=None, direction="host_down",
            from_n=n, to_n=n - 1, ok=True,
        )
        return True
