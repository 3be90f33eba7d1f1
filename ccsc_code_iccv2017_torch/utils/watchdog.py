"""Dispatch-fence watchdog: a hung step must not hang the run (the
torch port of ``ccsc_code_iccv2017_tpu.utils.watchdog``: the same
records, knobs, deadlines and exit code).

A wedged card, a deadlocked collective, or a runaway kernel all
present the same way: the driver blocks forever inside a step's one
host read (its fence), the event stream goes quiet, and nothing
in-process will ever notice — the failure modes the in-process
recovery cannot see by construction. The watchdog is a host-side
thread armed around every fenced step in the three learner drivers;
the deadline is derived from the analytic roofline bound
(``utils.perfmodel.bound_iters_per_sec``, the H100 row on the card)
times a configurable slack, so it scales with the problem instead of
being one more magic timeout.

On expiry it emits a ``stall`` record into the obs stream (utils.obs)
and, in ``abort`` mode, syncs the stream and hard-exits with
``EXIT_STALL`` — the driver thread is wedged inside the runtime, so a
soft unwind is not available; the last on-disk checkpoint is the
resume point and the ``supervise`` module restarts from it. In
``event`` mode it only records the stall (monitoring without
authority).

In a multi-host run the same thread watches the shared metrics dir for
peer-host heartbeat staleness (``check_peers``): a host whose newest
heartbeat lags the stream by more than the stale threshold is flagged
with a ``peer_stale`` record — the post-mortem "which host died"
signal, live (a host is a rank of the process group). The JAX
package's ``scripts/obs_report.py`` renders the same staleness rule as
a per-host liveness column.

Enabled per run via ``LearnConfig.watchdog`` (CLI ``--watchdog``);
knobs:

==============================  =====================================
CCSC_WATCHDOG_ACTION            'abort' (default) | 'event'
CCSC_WATCHDOG_MIN_S             deadline floor per fence (default 30)
CCSC_WATCHDOG_COMPILE_S         extra allowance on the FIRST fence,
                                which includes the kernels' nvcc
                                build (default 300)
CCSC_WATCHDOG_PEER_STALE_S      peer heartbeat staleness threshold
                                (default 120)
==============================  =====================================
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from . import env as _env

__all__ = [
    "DispatchWatchdog",
    "maybe_start",
    "check_peers",
    "check_replicas",
    "EXIT_STALL",
    "DEFAULT_PEER_STALE_S",
]

# distinctive exit code for a stall abort, recognized by the
# ``supervise`` module (a crash, but one whose diagnosis is already in
# the event stream)
EXIT_STALL = 87

# re-exported views of the registry defaults (utils.env is the single
# source of truth — editing these here would change nothing)
DEFAULT_MIN_S = _env.REGISTRY["CCSC_WATCHDOG_MIN_S"].default
DEFAULT_COMPILE_S = _env.REGISTRY["CCSC_WATCHDOG_COMPILE_S"].default
DEFAULT_PEER_STALE_S = _env.REGISTRY[
    "CCSC_WATCHDOG_PEER_STALE_S"
].default


class DispatchWatchdog:
    """Deadline monitor for the drivers' fenced dispatches.

    The driver arms a deadline before each step + its host read
    (``arm``) and disarms it when the fence returns
    (``disarm``); the daemon thread fires when an armed deadline
    expires. One watchdog per run; ``stop()`` in the driver's finally.
    All methods are cheap and thread-safe — the armed window is two
    lock-protected float writes per fence.
    """

    def __init__(
        self,
        per_iter_s: float,
        *,
        action: Optional[str] = None,
        metrics_dir: Optional[str] = None,
        algorithm: str = "",
        replica_id: Optional[int] = None,
        on_stall=None,
        run=None,
    ):
        # ``replica_id`` + ``on_stall``: the serving fleet
        # (serve.ServeFleet) runs one watchdog per replica in 'event'
        # mode — the stall record then names the replica, and the
        # callback is the fleet's authority hook (drain + requeue +
        # restart the casualty) since an in-process replica has no
        # process to hard-exit. ``run`` pins the obs Run the stall
        # record is written to; without it the record goes to the
        # process-global current run, which in a fleet (one run per
        # replica engine plus the fleet stream, all open at once) is
        # whichever was opened most recently — the wrong stream for
        # every replica but the newest.
        self.per_iter_s = float(per_iter_s)
        self.replica_id = replica_id
        self.run = run
        self.on_stall = on_stall
        self.min_s = _env.env_float("CCSC_WATCHDOG_MIN_S")
        self.compile_s = _env.env_float("CCSC_WATCHDOG_COMPILE_S")
        self.action = action or _env.env_str("CCSC_WATCHDOG_ACTION")
        if self.action not in ("abort", "event"):
            self.action = "abort"
        self.peer_stale_s = _env.env_float(
            "CCSC_WATCHDOG_PEER_STALE_S"
        )
        self.metrics_dir = metrics_dir
        self.algorithm = algorithm
        self.stalls = 0
        self._deadline: Optional[float] = None
        self._label = ""
        self._fences = 0
        self._fired_this_fence = False
        self._armed_at: Optional[float] = None
        self._armed_iters = 1
        self._armed_compile = False
        self._obs_per_iter = 0.0
        self._stale_flagged: set = set()
        self._peer_checked = 0.0
        self._tail: Optional["_HeartbeatTail"] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="ccsc-watchdog", daemon=True
        )
        self._thread.start()

    # -- driver API ----------------------------------------------------
    def timeout_for(
        self, expected_iters: int, may_compile: bool = False
    ) -> float:
        """Deadline budget for a fence covering ``expected_iters``
        outer iterations: the roofline-derived expectation times the
        slack (already folded into per_iter_s), floored at MIN_S, plus
        the compile allowance when a kernel build may land inside this
        fence — always true for the first fence (the nvcc build of
        K1/K2 and the cuFFT plans), and signaled by the driver
        (``may_compile``) for a step it treats as fresh (a
        post-recovery rho rebuild, a one-off poisoned step).

        Without a cost model (per_iter_s == 0: the masked and
        streaming learners) the MIN_S floor scales with the number of
        iterations the fence covers — a 16-iteration chunk legitimately
        takes 16x longer than a single step.

        The deadline is additionally SELF-CALIBRATING: every clean
        fence (no compile, no stall) updates the slowest observed
        per-iteration time, and later deadlines are at least 4x that —
        so a run whose real pace the static model under-predicts (the
        streaming learner's host paging, a shared card) teaches the
        watchdog its own baseline instead of being aborted for it."""
        n = max(1, expected_iters)
        per = self.per_iter_s if self.per_iter_s > 0 else self.min_s
        t = max(self.min_s, per * n, 4.0 * self._obs_per_iter * n)
        if self._fences == 0 or may_compile:
            t += self.compile_s
        return t

    def arm(
        self,
        expected_iters: int = 1,
        label: str = "",
        may_compile: bool = False,
    ) -> None:
        t = self.timeout_for(expected_iters, may_compile=may_compile)
        with self._lock:
            self._deadline = time.monotonic() + t
            self._label = label
            self._fired_this_fence = False
            self._armed_at = time.monotonic()
            self._armed_iters = max(1, expected_iters)
            self._armed_compile = may_compile or self._fences == 0

    def disarm(self) -> None:
        with self._lock:
            # calibrate on clean fences only (a compile-bearing or
            # stalled fence is not representative of steady state)
            if (
                self._armed_at is not None
                and not self._armed_compile
                and not self._fired_this_fence
            ):
                per = (
                    time.monotonic() - self._armed_at
                ) / self._armed_iters
                self._obs_per_iter = max(self._obs_per_iter, per)
            self._armed_at = None
            self._deadline = None
            self._fences += 1

    def stop(self) -> None:
        self._stop.set()
        # the thread is daemon; join briefly so tests see a quiet exit
        self._thread.join(timeout=2.0)

    # -- the monitor thread --------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(0.25):
            now = time.monotonic()
            with self._lock:
                expired = (
                    self._deadline is not None
                    and not self._fired_this_fence
                    and now > self._deadline
                )
                if expired:
                    # fire once per armed fence; the driver may still
                    # return late (a slow fence, not a hang) and the
                    # next arm() re-enables firing
                    self._fired_this_fence = True
                label = self._label
            if expired:
                self._on_stall(label)
            self._maybe_check_peers()

    def _on_stall(self, label: str) -> None:
        from . import obs

        self.stalls += 1
        extra = (
            {} if self.replica_id is None
            else {"replica_id": self.replica_id}
        )
        fields = dict(
            label=label,
            algorithm=self.algorithm,
            per_iter_budget_s=round(self.per_iter_s, 4),
            action=self.action,
            **extra,
        )
        if self.run is not None and not self.run.closed:
            self.run.event("stall", **fields)
        else:
            obs.record("stall", **fields)
        obs.console(
            f"WATCHDOG: dispatch fence '{label}' exceeded its deadline "
            f"— the device/runtime looks hung ({self.action} mode)",
            tier="always",
        )
        if self.on_stall is not None:
            try:
                self.on_stall(label)
            except Exception:  # pragma: no cover - observer must not
                pass  # kill the monitor thread
        if self.action == "abort":
            run = obs.current_run()
            if run is not None and run.writer is not None:
                try:
                    run.writer.sync()
                except Exception:  # pragma: no cover - dying anyway
                    pass
            # the driver thread is wedged waiting on the card: no soft
            # unwind exists. Hard-exit with the stall code; the last
            # on-disk checkpoint is the resume point and the supervise
            # module restarts from it.
            os._exit(EXIT_STALL)

    def _maybe_check_peers(self) -> None:
        if self.metrics_dir is None or self.peer_stale_s <= 0:
            return
        now = time.monotonic()
        if now - self._peer_checked < max(1.0, self.peer_stale_s / 4):
            return
        self._peer_checked = now
        from . import obs

        try:
            me, world = obs._process_group()
        except Exception:
            return
        if world < 2:
            return

        if self._tail is None:
            self._tail = _HeartbeatTail(self.metrics_dir)
        for peer in self._tail.stale_peers(self.peer_stale_s):
            if peer["host"] == me or peer["host"] in self._stale_flagged:
                continue
            self._stale_flagged.add(peer["host"])
            obs.record("peer_stale", **peer)
            obs.console(
                f"WATCHDOG: host {peer['host']} heartbeat is "
                f"{peer['behind_s']:.0f}s behind the stream — peer "
                "looks dead",
                tier="always",
            )


class _HeartbeatTail:
    """Incremental heartbeat view over the shared metrics dir for the
    watchdog's periodic peer check: rides ``utils.obs.EventTail`` (the
    shared offset-tracking reader that also feeds the live metrics
    endpoint and the supervisor's preemption judgment), so the
    per-check cost is O(new records) instead of re-parsing the whole
    stream (which grows to hundreds of MB over a long run) every
    interval. The one-shot ``check_peers`` below stays a full read —
    obs_report and tests call it once, not every 30 s."""

    def __init__(self, metrics_dir: str):
        from . import obs

        self.dir = metrics_dir
        self._tail = obs.EventTail(metrics_dir)
        self.last_hb: Dict[int, Dict] = {}
        self.newest_t = 0.0

    def poll(self) -> None:
        for rec in self._tail.poll():
            t = rec.get("t", 0.0)
            if isinstance(t, (int, float)):
                self.newest_t = max(self.newest_t, t)
            if rec.get("type") != "heartbeat":
                continue
            h = rec.get("host", 0)
            if h not in self.last_hb or t > self.last_hb[h]["t"]:
                self.last_hb[h] = rec

    def stale_peers(self, stale_s: float) -> List[Dict]:
        self.poll()
        out = []
        for h, e in sorted(self.last_hb.items()):
            behind = self.newest_t - e.get("t", 0.0)
            if behind > stale_s:
                out.append(
                    {
                        "host": h,
                        "last_t": e.get("t"),
                        "last_step": e.get("step"),
                        "behind_s": round(behind, 1),
                    }
                )
        return out


def check_peers(
    metrics_dir: str,
    stale_s: Optional[float] = None,
    now: Optional[float] = None,
) -> List[Dict]:
    """Hosts whose newest heartbeat lags the stream.

    ``now`` defaults to the newest record timestamp ANYWHERE in the
    stream — staleness is judged against the run's own clock line, so
    a finished run's report is stable (a host is stale because OTHERS
    kept going after it stopped, not because the run ended). Returns
    one dict per stale host: {host, last_t, last_step, behind_s}.
    """
    from . import obs

    stale_s = (
        _env.env_float("CCSC_WATCHDOG_PEER_STALE_S")
        if stale_s is None
        else stale_s
    )
    events = obs.read_events(metrics_dir)
    if not events:
        return []
    if now is None:
        now = max(e.get("t", 0.0) for e in events)
    last: Dict[int, Dict] = {}
    for e in events:
        if e.get("type") != "heartbeat":
            continue
        h = e.get("host", 0)
        if h not in last or e.get("t", 0.0) > last[h]["t"]:
            last[h] = e
    out = []
    for h, e in sorted(last.items()):
        behind = now - e.get("t", 0.0)
        if behind > stale_s:
            out.append(
                {
                    "host": h,
                    "last_t": e.get("t"),
                    "last_step": e.get("step"),
                    "behind_s": round(behind, 1),
                }
            )
    return out


def check_replicas(
    metrics_dir: Optional[str] = None,
    stale_s: Optional[float] = None,
    now: Optional[float] = None,
    events: Optional[List[Dict]] = None,
) -> List[Dict]:
    """Per-replica liveness of a serving fleet, judged from its obs
    stream by the SAME staleness rule as ``check_peers``: a replica
    whose newest ``fleet_heartbeat`` lags the stream's newest record
    by more than ``stale_s`` is stale. Returns one dict per KNOWN
    replica — ``{replica, state, last_t, behind_s, stale, served,
    restarts}`` — so a report can render a full
    liveness column, not just the casualties. ``now`` defaults to the
    newest record timestamp anywhere in the stream (a finished run's
    report is stable). Pass ``events`` to judge an already-parsed
    record list (obs_report) instead of reading ``metrics_dir``."""
    from . import obs

    stale_s = (
        _env.env_float("CCSC_WATCHDOG_PEER_STALE_S")
        if stale_s is None
        else stale_s
    )
    if events is None:
        if metrics_dir is None:
            raise ValueError("need metrics_dir or events")
        events = obs.read_events(metrics_dir)
    if not events:
        return []
    if now is None:
        now = max(e.get("t", 0.0) for e in events)
    last: Dict[int, Dict] = {}
    for e in events:
        if e.get("type") != "fleet_heartbeat":
            continue
        r = e.get("replica_id")
        if r is None:
            continue
        if r not in last or e.get("t", 0.0) > last[r]["t"]:
            last[r] = e
    out = []
    for r, e in sorted(last.items()):
        behind = now - e.get("t", 0.0)
        out.append(
            {
                "replica": r,
                "state": e.get("state"),
                "last_t": e.get("t"),
                "behind_s": round(behind, 1),
                "stale": behind > stale_s,
                "served": e.get("served"),
                "restarts": e.get("restarts"),
            }
        )
    return out


def maybe_start(
    cfg, cost=None, algorithm: str = "", device=None
) -> Optional[DispatchWatchdog]:
    """Build and start the run's watchdog when ``cfg.watchdog`` is on,
    else None (the drivers guard every arm/disarm on that).

    With an analytic per-step ``cost`` (utils.perfmodel) the per-
    iteration budget is ``watchdog_slack / bound_iters_per_sec`` — the
    roofline-derived fastest possible iteration times the slack, on the
    roofline row of the learner's ``device`` (the H100 row on the card).
    With no cost model (the masked learner) the MIN_S floor alone
    governs.
    """
    if not getattr(cfg, "watchdog", False):
        return None
    per_iter = 0.0
    if cost is not None:
        from . import perfmodel

        bound = perfmodel.bound_iters_per_sec(
            cost, chip=perfmodel.detect_chip(device))
        if bound > 0 and bound != float("inf"):
            per_iter = cfg.watchdog_slack / bound
    return DispatchWatchdog(
        per_iter,
        metrics_dir=getattr(cfg, "metrics_dir", None),
        algorithm=algorithm,
    )
