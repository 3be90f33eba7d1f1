"""Deterministic fault injection for chaos-testing the learners (a copy
of ``ccsc_code_iccv2017_tpu.utils.faults``: the same env knobs, fire
decisions, markers and records).

Failure handling is only trustworthy when every recovery path is
exercised end-to-end — on CPU, in CI, every run (the MPAX-style
"solver-level safeguard" discipline, PAPERS.md arXiv:2412.09734).
This module is the single switchboard of injectable faults; the
learner drivers and ``utils.checkpoint`` query it at well-defined
points, so a test (or ``chip_smoke.py`` phase 18 on the card) can
prove:

- divergence recovery: ``CCSC_FAULT_NAN_IT=k`` poisons the code
  iterate on the device INSIDE the step that computes outer iteration
  ``k`` (1-based) — the non-finite metrics guard then fires exactly as
  it would on a real blow-up;
- checkpoint atomicity: ``CCSC_FAULT_CKPT_SAVE=1`` raises
  ``InjectedFault`` inside ``checkpoint.save`` after the payload is
  written but BEFORE the atomic commit — the on-disk snapshot must
  remain the previous valid one;
- preemption: ``CCSC_FAULT_SIGTERM_IT=k`` raises SIGTERM in the
  driver thread at the boundary after outer iteration ``k``
  completes — the graceful-shutdown path must checkpoint and exit
  cleanly;
- hangs: ``CCSC_FAULT_HANG_IT=k`` sleeps ``CCSC_FAULT_HANG_S``
  seconds (default 3600) inside the host-side fence at the boundary
  after iteration ``k`` — indistinguishable from a wedged dispatch,
  so the watchdog (utils.watchdog) and the external supervisor
  (the ``supervise`` module) are provable on CPU;
- serving-replica faults: ``CCSC_FAULT_ENGINE_KILL_REQ=k`` /
  ``CCSC_FAULT_ENGINE_HANG_REQ=k`` kill (raise ``InjectedFault`` in
  the replica worker) or hang (sleep ``CCSC_FAULT_ENGINE_HANG_S``,
  default 3600) a serving-fleet replica (serve.ServeFleet) while it
  processes its k-th taken request (1-based, counted PER replica) —
  the fleet's requeue-with-idempotency-keys and health-driven drain
  paths are provable on CPU. ``CCSC_FAULT_ENGINE_KILL_REPLICA`` /
  ``CCSC_FAULT_ENGINE_HANG_REPLICA`` (comma lists of replica ids)
  restrict which replicas are armed, so a chaos schedule can kill
  replica 0 and hang replica 1 in the same run; unset = any replica.
  These fire at most once PER REPLICA (marker
  ``fault-fired-engine_kill-r<id>.json``), so a restarted casualty
  rejoins clean instead of re-dying forever.
  ``CCSC_FAULT_ENGINE_SLOW_REQ=k`` is the GRAY-failure variant: from
  the k-th taken request onward an armed replica
  (``CCSC_FAULT_ENGINE_SLOW_REPLICA``) sleeps
  ``CCSC_FAULT_ENGINE_SLOW_S`` (default 2.0 — far under the watchdog
  floor, so the stall detector must NOT fire) on EVERY request:
  slow-but-alive, the pathology hedged attempts exist for. Sustained,
  not fire-once; the marker records only the first slowed request.
- control-plane faults (the fleet controller, not ported yet):
  ``CCSC_FAULT_CTRL_SENSOR_BLACKOUT=k`` blanks the controller's
  sensor read from its k-th tick for ``CCSC_FAULT_CTRL_BLACKOUT_S``
  seconds (fail-safe holdoff provable), ``CCSC_FAULT_CTRL_ACT_HANG=n``
  wedges the first n actuator invocations for
  ``CCSC_FAULT_CTRL_ACT_HANG_S`` seconds each (timeout/retry/circuit-
  breaker ladder provable), and ``CCSC_FAULT_CTRL_CRASH_SCALE=1``
  kills the control loop between a scale decision and its actuation
  (the fleet-serves-exactly-as-configured invariant provable).

Every fault fires AT MOST ONCE per run. Within a process that is a
set in memory; ACROSS supervisor restarts the consumption must
survive the process — otherwise a restarted run re-trips the same
injected fault forever and the supervisor can never make progress.
So firing also (a) drops a ``fault-fired-<name>.json`` marker into
the fault state dir — ``CCSC_FAULT_STATE_DIR`` if set, else the
active obs run's metrics dir — and (b) records a ``fault_fired``
event in the obs stream, so every restart sees WHAT fired and WHEN in
the same telemetry that carries the restarts themselves. With neither
a state dir nor an active stream the fire-once contract is
process-local, as before. ``reset()`` re-arms the in-process state
for the next test (on-disk markers belong to the test's tmp dir).
Reads go through the environment on every query so tests can
arm/disarm with monkeypatch.setenv.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Optional

from . import env as _env

__all__ = [
    "InjectedFault",
    "nan_iteration",
    "consume_nan",
    "ckpt_save_hook",
    "sigterm_tick",
    "hang_tick",
    "engine_kill_request",
    "engine_hang_request",
    "engine_slow_request",
    "ctrl_sensor_blackout",
    "ctrl_actuator_hang",
    "ctrl_crash_mid_scale",
    "reset",
]


class InjectedFault(RuntimeError):
    """Raised by an armed fault point (never by production paths)."""


# fault points that already fired in this process (the fire-once
# contract keeps a recovered or resumed run from re-failing on the
# same injection)
_fired: set = set()


def _state_dir() -> Optional[str]:
    """Where cross-restart fire-once markers live: the explicit
    CCSC_FAULT_STATE_DIR (the ``supervise`` module sets it to the metrics
    dir), else the active obs run's stream directory."""
    d = _env.env_str("CCSC_FAULT_STATE_DIR")
    if d:
        return d
    try:
        from . import obs

        run = obs.current_run()
        if run is not None and run.writer is not None:
            return os.path.dirname(run.writer.path)
    except Exception:  # pragma: no cover - obs import cycle guard
        pass
    return None


def _marker_path(name: str) -> Optional[str]:
    d = _state_dir()
    if d is None:
        return None
    return os.path.join(d, f"fault-fired-{name}.json")


def _fired_before(name: str) -> bool:
    if name in _fired:
        return True
    p = _marker_path(name)
    if p is not None and os.path.exists(p):
        # a previous attempt of this supervised run already delivered
        # the fault — cache so the marker is stat'ed once per process
        _fired.add(name)
        return True
    return False


def _mark_fired(name: str, **info) -> None:
    _fired.add(name)
    p = _marker_path(name)
    if p is not None:
        try:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "w", encoding="utf-8") as f:
                json.dump(
                    {"fault": name, "t": time.time(), **info}, f
                )
        except OSError:  # pragma: no cover - marker is best-effort
            pass
    try:
        from . import obs

        obs.record("fault_fired", fault=name, **info)
    except Exception:  # pragma: no cover - never fail the driver
        pass


def _env_int(name: str) -> Optional[int]:
    # the shared never-crash helper (utils.env): a typo'd fault env
    # disarms the fault, loudly, instead of raising from inside the
    # learner loop
    return _env.env_int(name, None)


def nan_iteration() -> Optional[int]:
    """1-based outer iteration whose step should poison the iterate
    with NaN, or None. Stays armed until ``consume_nan()`` — the
    driver consumes it when the poisoned step has actually run, so a
    rho-backoff retry of the same iteration runs clean.

    (Every fault point checks its env var FIRST: an unarmed production
    run must pay one dict lookup per query, not a marker-file stat.)"""
    k = _env_int("CCSC_FAULT_NAN_IT")
    if k is None or _fired_before("nan"):
        return None
    return k


def consume_nan() -> None:
    """Mark the NaN injection as delivered (the poisoned step ran)."""
    _mark_fired("nan")


def ckpt_save_hook() -> None:
    """Called by ``utils.checkpoint.save`` between writing the payload
    and the atomic commit; raises ``InjectedFault`` once when armed
    (CCSC_FAULT_CKPT_SAVE truthy) — simulating a crash mid-save."""
    if not _env.env_flag("CCSC_FAULT_CKPT_SAVE"):
        return
    if _fired_before("ckpt"):
        return
    _mark_fired("ckpt")
    raise InjectedFault("injected checkpoint-save crash")


def sigterm_tick(completed_it: int) -> None:
    """Called by the drivers at the boundary after outer iteration
    ``completed_it`` (1-based); raises SIGTERM in the calling thread
    once when armed (CCSC_FAULT_SIGTERM_IT <= completed_it).

    ``signal.raise_signal`` (not ``os.kill``) so delivery is
    synchronous in the driver thread — the graceful-shutdown flag is
    deterministically set before the driver's next boundary check."""
    k = _env_int("CCSC_FAULT_SIGTERM_IT")
    if k is None or completed_it < k or _fired_before("sigterm"):
        return
    # marked (and persisted) BEFORE delivery: the process may not
    # get another chance, and a supervisor restart must see it
    _mark_fired("sigterm", iteration=int(completed_it))
    signal.raise_signal(signal.SIGTERM)


def hang_tick(completed_it: int) -> None:
    """Called by the drivers INSIDE the armed watchdog fence, right
    after the readback of the chunk that completed outer iteration
    ``completed_it``; sleeps CCSC_FAULT_HANG_S seconds (default 3600)
    once when armed (CCSC_FAULT_HANG_IT <= completed_it) — to the
    watchdog and the supervisor this is exactly a hung dispatch.

    Marked (and persisted) BEFORE the sleep: a watchdog abort or a
    supervisor kill never returns control here, and the restarted
    process must not re-hang."""
    k = _env_int("CCSC_FAULT_HANG_IT")
    if k is None or completed_it < k or _fired_before("hang"):
        return
    dur = _env.env_float("CCSC_FAULT_HANG_S")
    _mark_fired("hang", iteration=int(completed_it), sleep_s=dur)
    time.sleep(dur)


def _replica_armed(env_name: str, replica_id: int) -> bool:
    """Whether a per-replica fault env restricts to (or includes) this
    replica: unset/empty = every replica is armed; else a comma list
    of replica ids. A malformed list disarms (same never-crash stance
    as ``_env_int``)."""
    ids = _env.env_int_list(env_name, None)
    if ids is None:
        return True
    # a malformed list parses to () — the fault disarms (never-crash)
    return int(replica_id) in ids


def engine_kill_request(replica_id: int, req_seq: int) -> bool:
    """Serving-fleet kill fault (serve.ServeFleet): True exactly once
    per armed replica when the replica is processing its
    ``CCSC_FAULT_ENGINE_KILL_REQ``-th taken request (1-based, counted
    per replica) — the caller then raises ``InjectedFault`` in the
    replica worker, simulating an engine crash with requests assigned.
    ``CCSC_FAULT_ENGINE_KILL_REPLICA`` restricts which replicas are
    armed (comma list; unset = all)."""
    k = _env_int("CCSC_FAULT_ENGINE_KILL_REQ")
    if k is None or req_seq < k:
        return False
    if not _replica_armed("CCSC_FAULT_ENGINE_KILL_REPLICA", replica_id):
        return False
    name = f"engine_kill-r{int(replica_id)}"
    if _fired_before(name):
        return False
    _mark_fired(
        name, replica_id=int(replica_id), request_seq=int(req_seq)
    )
    return True


def engine_hang_request(replica_id: int, req_seq: int) -> float:
    """Serving-fleet hang fault: the seconds the replica worker should
    sleep INSIDE its armed health fence (``CCSC_FAULT_ENGINE_HANG_S``,
    default 3600) when it is processing its
    ``CCSC_FAULT_ENGINE_HANG_REQ``-th taken request, else 0.0 — to the
    fleet's per-replica watchdog this is exactly a wedged dispatch.
    Fire-once per armed replica (``CCSC_FAULT_ENGINE_HANG_REPLICA``
    restricts), marked BEFORE the sleep: a drained-and-restarted
    replica must not re-hang."""
    k = _env_int("CCSC_FAULT_ENGINE_HANG_REQ")
    if k is None or req_seq < k:
        return 0.0
    if not _replica_armed("CCSC_FAULT_ENGINE_HANG_REPLICA", replica_id):
        return 0.0
    name = f"engine_hang-r{int(replica_id)}"
    if _fired_before(name):
        return 0.0
    # never-crash: a malformed knob must not become a "replica crash"
    # that burns restart budget on every generation — utils.env falls
    # back to the wedged-forever default
    dur = _env.env_float("CCSC_FAULT_ENGINE_HANG_S")
    _mark_fired(
        name,
        replica_id=int(replica_id),
        request_seq=int(req_seq),
        sleep_s=dur,
    )
    return dur


def engine_slow_request(replica_id: int, req_seq: int) -> float:
    """Serving-fleet GRAY-failure fault: the extra seconds the replica
    worker should sleep (``CCSC_FAULT_ENGINE_SLOW_S``, default 2.0 —
    deliberately far under ``CCSC_WATCHDOG_MIN_S`` so the stall
    detector stays silent) on EVERY request from its
    ``CCSC_FAULT_ENGINE_SLOW_REQ``-th taken request onward, else 0.0.
    Unlike kill/hang this is SUSTAINED, not fire-once: a gray replica
    is slow-but-alive indefinitely — that is the pathology hedged
    attempts (serve.fleet) exist to route around. The fire-once
    marker is dropped on the FIRST slowed request only, so the obs
    stream records that the fault armed without one record per
    request. ``CCSC_FAULT_ENGINE_SLOW_REPLICA`` restricts which
    replicas are armed (comma list; unset = all)."""
    k = _env_int("CCSC_FAULT_ENGINE_SLOW_REQ")
    if k is None or req_seq < k:
        return 0.0
    if not _replica_armed("CCSC_FAULT_ENGINE_SLOW_REPLICA", replica_id):
        return 0.0
    dur = _env.env_float("CCSC_FAULT_ENGINE_SLOW_S")
    name = f"engine_slow-r{int(replica_id)}"
    if not _fired_before(name):
        _mark_fired(
            name,
            replica_id=int(replica_id),
            request_seq=int(req_seq),
            sleep_s=dur,
        )
    return dur


# -- control-plane fault points (the fleet controller) ---------------
# in-process episode state: the blackout's wall-clock window and the
# remaining armed actuator hangs (reset() clears both)
_blackout_until: Optional[float] = None
_act_hangs_left: Optional[int] = None


def ctrl_sensor_blackout(tick: int) -> bool:
    """Controller sensor-blackout fault: True while the control
    plane's sensor read must come back empty. Armed by
    ``CCSC_FAULT_CTRL_SENSOR_BLACKOUT=k`` (1-based controller tick):
    from tick ``k`` the blackout holds for
    ``CCSC_FAULT_CTRL_BLACKOUT_S`` wall seconds (default 3), then
    clears and never re-fires. The controller under test must fail
    SAFE — hold state, emit ``ctrl_holdoff``, and never scale
    *down* on missing telemetry."""
    global _blackout_until
    k = _env_int("CCSC_FAULT_CTRL_SENSOR_BLACKOUT")
    if k is None:
        return False
    if _blackout_until is not None:
        return time.monotonic() < _blackout_until
    if tick < k or _fired_before("ctrl_blackout"):
        return False
    dur = _env.env_float("CCSC_FAULT_CTRL_BLACKOUT_S")
    _blackout_until = time.monotonic() + dur
    _mark_fired("ctrl_blackout", tick=int(tick), duration_s=dur)
    return True


def ctrl_actuator_hang() -> float:
    """Seconds an actuator invocation should wedge — queried INSIDE
    the controller's timeout-guarded actuator worker, never on a
    data-plane thread, so the hang exercises the timeout/retry/
    circuit-breaker ladder without touching serving.
    ``CCSC_FAULT_CTRL_ACT_HANG=n`` arms the first ``n`` invocations
    to sleep ``CCSC_FAULT_CTRL_ACT_HANG_S`` seconds each (default
    3600): n spanning the retry budget is how a chaos schedule
    proves the breaker OPENS instead of the first retry healing."""
    global _act_hangs_left
    n = _env_int("CCSC_FAULT_CTRL_ACT_HANG")
    if n is None:
        return 0.0
    if _act_hangs_left is None:
        if _fired_before("ctrl_act_hang"):
            return 0.0
        _act_hangs_left = int(n)
    if _act_hangs_left <= 0:
        return 0.0
    dur = _env.env_float("CCSC_FAULT_CTRL_ACT_HANG_S")
    if _act_hangs_left == int(n):
        # marked on the FIRST armed invocation (the controller's
        # actuator thread may never return from the sleep)
        _mark_fired("ctrl_act_hang", n=int(n), sleep_s=dur)
    _act_hangs_left -= 1
    return dur


def ctrl_crash_mid_scale() -> bool:
    """True exactly once when armed (``CCSC_FAULT_CTRL_CRASH_SCALE``
    truthy): the controller raises ``InjectedFault`` after COMMITTING
    to a scale decision but before invoking the actuator — the
    control loop dies mid-scale. The hard invariant under test: the
    data plane keeps serving exactly as configured, and a restarted
    controller reconciles from ``ServeFleet.replica_target`` (live
    state, not controller memory)."""
    if not _env.env_flag("CCSC_FAULT_CTRL_CRASH_SCALE"):
        return False
    if _fired_before("ctrl_crash_scale"):
        return False
    _mark_fired("ctrl_crash_scale")
    return True


def reset() -> None:
    """Re-arm all in-process fault points (test isolation). On-disk
    fire-once markers are per fault state dir and belong to the test's
    tmp directory lifecycle."""
    global _blackout_until, _act_hangs_left
    _fired.clear()
    _blackout_until = None
    _act_hangs_left = None
