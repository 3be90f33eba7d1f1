"""Run resilience: divergence recovery, graceful preemption, run identity
(a copy of ``ccsc_code_iccv2017_tpu.utils.resilience``; its messages
go through the current telemetry run's console, utils.obs).

- ``RecoveryManager`` — rho-backoff divergence recovery: when the
  driver's non-finite guard fires it keeps the last good state,
  multiplies the ADMM penalties by ``cfg.rho_backoff`` and retries, up
  to ``cfg.max_recoveries`` times; each event is recorded in the trace
  (``trace['recoveries']``) so a resumed run re-applies the backoff.
- ``GracefulShutdown`` — SIGTERM/SIGINT request checkpoint-and-clean-
  exit at the next iteration boundary. A second signal forces the
  previous behaviour.
- ``console`` — the learners' run messages, silenced by
  ``verbose='none'`` unless ``always``; each printed line is also a
  ``log`` record of the current run (utils.obs).
- ``config_fingerprint`` — a stable identity hash of the problem, the
  same fields and the same hex digest as the JAX package, so a JAX
  checkpoint resumes in the port and vice versa (utils.checkpoint).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import signal
import threading
from typing import Optional

__all__ = [
    "console",
    "RecoveryManager",
    "GracefulShutdown",
    "config_fingerprint",
]


def console(cfg, msg: str, always: bool = False) -> None:
    """Print a learner's run message unless ``cfg.verbose == 'none'``
    (``always`` prints regardless), through the current run's console
    when one is open, so the line is also a ``log`` record."""
    from . import obs

    run = obs.current_run()
    if run is not None:
        run.console(msg, tier="always" if always else "brief")
    elif always or cfg.verbose != "none":
        print(msg, flush=True)


def config_fingerprint(geom, cfg, algorithm: str) -> str:
    """sha256 hex identity of (problem geometry, problem-defining config
    fields, producing algorithm). Run-length and execution-strategy
    knobs and the rho values are excluded: a checkpoint may resume with
    another max_it, tol, fused_z or (post-backoff) rho. The data is not
    part of the identity; the driver's shape check rejects gross
    mismatches."""
    ident = {
        "algorithm": algorithm,
        "spatial_support": list(geom.spatial_support),
        "num_filters": geom.num_filters,
        "reduce_shape": list(geom.reduce_shape),
        "lambda_residual": cfg.lambda_residual,
        "lambda_prior": cfg.lambda_prior,
        "num_blocks": cfg.num_blocks,
        "max_it_d": cfg.max_it_d,
        "max_it_z": cfg.max_it_z,
        "storage_dtype": cfg.storage_dtype,
        "d_storage_dtype": cfg.d_storage_dtype,
        "fft_pad": cfg.fft_pad,
        "compat_coding": cfg.compat_coding,
    }
    blob = json.dumps(ident, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


class RecoveryManager:
    """Budgeted rho-backoff for the non-finite divergence guard.

    Holds the BASE config and the cumulative backoff scale
    (``rho_backoff ** recoveries_used``); ``cfg`` is the working config
    with scaled ``rho_d``/``rho_z``. ``trace``: when resuming, recovery
    events recorded in ``trace['recoveries']`` are re-applied."""

    def __init__(self, base_cfg, trace: Optional[dict] = None):
        self._base = base_cfg
        self.used = len((trace or {}).get("recoveries", []))

    @property
    def enabled(self) -> bool:
        return self._base.max_recoveries > 0

    @property
    def scale(self) -> float:
        return float(self._base.rho_backoff ** self.used)

    @property
    def cfg(self):
        """The working config (the base object itself when no recovery
        fired)."""
        if self.used == 0:
            return self._base
        return dataclasses.replace(
            self._base,
            rho_d=self._base.rho_d * self.scale,
            rho_z=self._base.rho_z * self.scale,
        )

    def on_divergence(self, failed_it: int) -> Optional[dict]:
        """The guard fired at outer iteration ``failed_it`` (1-based).
        Returns the recovery event to record, or None when recovery is
        disabled or the budget is spent (the caller then stops and
        keeps the last good state)."""
        if not self.enabled or self.used >= self._base.max_recoveries:
            return None
        self.used += 1
        ev = {
            "iteration": int(failed_it),
            "recovery": self.used,
            "rho_scale": self.scale,
            "rho_d": float(self._base.rho_d * self.scale),
            "rho_z": float(self._base.rho_z * self.scale),
        }
        from . import obs

        obs.console(
            f"Iter {failed_it}: divergence recovery {self.used}/"
            f"{self._base.max_recoveries} — restoring last good state, "
            f"backing off rho to scale {self.scale:g} "
            f"(rho_d={ev['rho_d']:g}, rho_z={ev['rho_z']:g})",
            tier="always",
        )
        return ev


class GracefulShutdown:
    """Context manager turning SIGTERM/SIGINT into a checkpoint request
    at the next iteration boundary. First signal: sets ``requested``.
    Second signal: restores the previous handlers and re-raises through
    them. A no-op outside the main thread."""

    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.requested = False
        self.signum: Optional[int] = None
        self._prev = {}
        self._active = False

    def _handler(self, signum, frame):
        if self.requested:
            # second signal: stop being graceful
            self._restore()
            if signum == signal.SIGINT:
                raise KeyboardInterrupt
            signal.raise_signal(signum)
            return
        self.requested = True
        self.signum = signum
        from . import obs

        obs.console(
            f"received signal {signum}: will checkpoint and exit at the "
            "next iteration boundary (signal again to force)",
            tier="always",
        )

    def _restore(self):
        if not self._active:
            return
        for s, h in self._prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._prev = {}
        self._active = False

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            try:
                for s in self._SIGNALS:
                    self._prev[s] = signal.signal(s, self._handler)
                self._active = True
            except ValueError:  # pragma: no cover - race on thread id
                self._restore()
        return self

    def __exit__(self, *exc):
        self._restore()
        return False
