"""Deterministic traffic replay: re-serve a captured workload as the
fleet's measuring instrument (the torch port of
``ccsc_code_iccv2017_tpu.serve.replay``, with the JAX package's
``scripts/replay.py`` as this module's :func:`main`:
``python -m ccsc_code_iccv2017_torch.serve.replay CAPTURE_DIR``).

A capture (:mod:`serve.capture`) records what the fleet served and
what it answered; :class:`ReplayDriver` re-submits that stream
against a FRESH fleet (or standalone engine) and judges the answers:

- **open-loop** — requests are submitted at their recorded arrival
  times scaled by a speed factor (the recorded diurnal curve, slowed
  or accelerated), or at max speed (``speed=0``: back-to-back, the
  saturation probe — admission refusals back off for the fleet's
  retry-after hint and resubmit, so "zero lost requests" is a real
  claim, not a dropped-on-overload one);
- **closed-loop** — each request is submitted when the previous one
  resolves (the latency-isolated mode: no queueing beyond one
  request).

Every replayed result is paired with its recorded original and
verified: a request replayed in the SAME bucket must be
BIT-IDENTICAL (sha256 of the reconstruction bytes equals the
recorded outcome digest — the determinism contract of pinned
(bank, problem, config) bucket solves, PAPERS.md arXiv:2412.09734);
a request that landed in a different bucket (a replay fleet with a
different bucket table) is held to valid-region-PSNR tolerance
instead (``CCSC_REPLAY_PSNR_TOL`` dB).

The session is itself observable and gated: ``replay_request`` /
``replay_summary`` events land in the replay's own obs stream (recorded
vs replayed p50/p99 side by side; the JAX package's
``scripts/obs_report.py`` renders them as its REPLAY section), and a
``kind=replay`` record is appended to the durable perf ledger
(``CCSC_PERF_LEDGER``) so ``python -m
ccsc_code_iccv2017_torch.analysis.perf_gate`` judges replay throughput
against its own history like any other workload.

:func:`generate_diurnal` writes a deterministic synthetic
diurnal-curve capture (sinusoidal arrival intensity, seeded
payloads, no outcomes) in the same format, for load-shape
experiments before any real traffic exists.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import env as _env
from . import capture as _capture
from . import quality as _quality
from . import slo as _slo

__all__ = ["ReplayDriver", "generate_diurnal"]

# verification verdicts, strongest to weakest. "deadline" is a
# replayed request whose per-request budget (recorded latency x
# CCSC_REPLAY_DEADLINE_SLACK) expired — an SLO verdict, distinct
# from "mismatch" (wrong bytes) and "lost" (no resolution at all)
STATUSES = (
    "match_exact", "match_psnr", "unverified", "mismatch",
    "deadline", "lost",
)

# a recorded latency shorter than this still gets a workable budget
# (warmup jitter on the replay side must not flag honest requests)
_DEADLINE_FLOOR_MS = 1000.0


def _percentiles(lat_ms) -> Tuple[Optional[float], Optional[float]]:
    h = _slo.Histogram.of(lat_ms)
    if not h.n:
        return None, None
    return h.percentile(0.50), h.percentile(0.99)


class ReplayDriver:
    """Re-serve one captured workload against a serving target.

    ``metrics_dir`` opens the replay's own telemetry run (algorithm
    ``serve_replay``); None replays silently (the returned report
    still carries everything). ``psnr_tol`` is the dB tolerance for
    cross-bucket verification (default ``CCSC_REPLAY_PSNR_TOL``).
    """

    def __init__(
        self,
        capture_dir: str,
        metrics_dir: Optional[str] = None,
        psnr_tol: Optional[float] = None,
        verbose: str = "brief",
    ):
        self.capture_dir = capture_dir
        self.metrics_dir = metrics_dir
        self.verbose = verbose
        self.psnr_tol = (
            float(psnr_tol)
            if psnr_tol is not None
            else float(_env.env_float("CCSC_REPLAY_PSNR_TOL"))
        )
        # deadline plumbing: when set, each replayed
        # request carries budget = max(recorded latency, floor) x
        # slack instead of the one-size-fits-all 600 s future wait;
        # None keeps replay deadline-free (the legacy contract)
        self.deadline_slack = _env.env_float(
            "CCSC_REPLAY_DEADLINE_SLACK"
        )
        self.meta = _capture.read_meta(capture_dir)
        self.requests = _capture.read_workload(capture_dir)
        self._payloads: Dict[str, np.ndarray] = {}

    # -- payload access (cached: dedup means one sha loads once) -------
    def _payload(self, sha: Optional[str]) -> Optional[np.ndarray]:
        if sha is None:
            return None
        arr = self._payloads.get(sha)
        if arr is None:
            arr = _capture.load_payload(self.capture_dir, sha)
            self._payloads[sha] = arr
        return arr

    def _arrays(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "b": self._payload(req.get("b")),
            "mask": self._payload(req.get("mask")),
            "smooth_init": self._payload(req.get("smooth_init")),
            "x_orig": self._payload(req.get("x_orig")),
        }

    # -- verification --------------------------------------------------
    def _verify(self, req: Dict[str, Any], res) -> str:
        out = req.get("outcome")
        if out is None:
            return "unverified"
        if res.bucket == out.get("bucket"):
            # same bucket program, same bytes in: determinism demands
            # the same bytes out
            digest = _capture.payload_sha(np.asarray(res.recon))
            return (
                "match_exact"
                if digest == out.get("digest")
                else "mismatch"
            )
        rec_psnr = out.get("psnr")
        got_db = res.psnr
        if got_db is None and rec_psnr is not None:
            # the served result carries no dB (the replay submit
            # dropped x_orig, or the target predates PSNR plumbing):
            # recompute with the SAME shared quality.valid_region_psnr
            # the recorder quoted, from the captured ground truth
            x_orig = self._payload(req.get("x_orig"))
            radius = self._psf_radius()
            if x_orig is not None and radius is not None:
                got_db = _quality.valid_region_psnr(
                    res.recon, x_orig, radius
                )
        if rec_psnr is not None and got_db is not None:
            return (
                "match_psnr"
                if abs(float(got_db) - float(rec_psnr))
                <= self.psnr_tol
                else "mismatch"
            )
        return "unverified"

    def _deadline_ms(self, req: Dict[str, Any]) -> Optional[float]:
        """The replayed request's end-to-end budget: the recorded
        latency (floored) scaled by ``CCSC_REPLAY_DEADLINE_SLACK``.
        None when the slack knob is unset (deadline-free replay) or
        the capture carries no recorded latency to scale."""
        if self.deadline_slack is None:
            return None
        out = req.get("outcome")
        lat = None if out is None else out.get("latency_ms")
        if lat is None:
            return None
        return max(float(lat), _DEADLINE_FLOOR_MS) * float(
            self.deadline_slack
        )

    def _psf_radius(self) -> Optional[Tuple[int, ...]]:
        # the capture meta's problem geometry (capture._write_meta)
        # gives the psf-radius border the recorder's dB crop used
        g = (self.meta or {}).get("geom") or {}
        sup = g.get("spatial_support")
        if not sup:
            return None
        return tuple(int(s) // 2 for s in sup)

    # -- the replay ----------------------------------------------------
    def replay(
        self,
        target,
        speed: float = 1.0,
        mode: str = "open",
        timeout_s: float = 600.0,
    ) -> Dict[str, Any]:
        """Replay the captured stream against ``target`` (a
        :class:`~.fleet.ServeFleet` or :class:`~.engine.CodecEngine`)
        and return the verification + latency report.

        ``speed`` scales the recorded inter-arrival gaps (2.0 = twice
        as fast); ``speed<=0`` is max-speed saturation. ``mode`` is
        ``'open'`` (recorded arrival clock) or ``'closed'`` (submit
        on completion)."""
        from ..utils import obs as _obs
        from .fleet import BucketCold, Overloaded

        import os as _os

        if mode not in ("open", "closed"):
            raise ValueError(
                f"mode must be 'open' | 'closed', got {mode!r}"
            )
        rec = getattr(target, "_capture", None)
        if rec is not None and _os.path.abspath(
            rec.path
        ) == _os.path.abspath(self.capture_dir):
            raise ValueError(
                "replay target is capturing into the very directory "
                "being replayed — it would append every replayed "
                "request as a duplicate-key record and corrupt the "
                "capture (build the replay fleet with "
                "capture_dir='' to force capture off)"
            )
        is_fleet = hasattr(target, "fleet_cfg")
        run = _obs.start_run(
            self.metrics_dir,
            algorithm="serve_replay",
            verbose=self.verbose,
            compile_monitor=False,
            capture_dir=self.capture_dir,
            mode=mode,
            speed=speed,
            n_recorded=len(self.requests),
        )
        try:
            return self._replay_inner(
                target, run, speed, mode, timeout_s, is_fleet,
                # both explicit-backpressure refusals retry the same
                # way: an overloaded queue and a still-staging bucket
                # each carry a retry_after_s hint
                (Overloaded, BucketCold),
            )
        finally:
            if not run.closed:
                run.close(status="ok")

    def _submit_one(
        self, target, rkey, arrays, is_fleet, overloaded_cls,
        bank_id=None, tenant=None, deadline_ms=None,
    ):
        """Submit with explicit-backpressure retries; returns
        (future, n_overload_backoffs, t_submit). Admission refusals
        are honored (sleep the retry-after hint) and retried until
        admitted — replay's zero-lost contract sheds nothing.
        ``rkey`` is a replay-unique key, NOT the recorded one: a
        multi-session capture legitimately repeats idempotency keys
        (auto-keys restart per fleet), and resubmitting a spent key
        would be refused. ``bank_id``/``tenant`` are the RECORDED
        routing identities: a mixed-tenant capture replays each
        request against its own bank (per-bank digest parity) under
        its own tenant accounting — the replay target must have the
        same banks published and tenants declared. ``t_submit`` is
        taken after the last refusal, so backoff sleeps never inflate
        the replayed latency — the recorded side only ever measures
        admitted submit->delivery, and the comparison must too."""
        n_over = 0
        route = {"bank_id": bank_id, "tenant": tenant}
        # the budget clock starts at the ADMITTED submit, same as
        # t_sub: backoff sleeps never eat into the request's deadline
        while True:
            t_sub = time.perf_counter()
            try:
                if is_fleet:
                    return (
                        target.submit(
                            arrays["b"],
                            mask=arrays["mask"],
                            smooth_init=arrays["smooth_init"],
                            x_orig=arrays["x_orig"],
                            key=rkey,
                            deadline_ms=deadline_ms,
                            **route,
                        ),
                        n_over,
                        t_sub,
                    )
                return (
                    target.submit(
                        arrays["b"],
                        mask=arrays["mask"],
                        smooth_init=arrays["smooth_init"],
                        x_orig=arrays["x_orig"],
                        deadline_ms=deadline_ms,
                        **route,
                    ),
                    n_over,
                    t_sub,
                )
            except overloaded_cls as e:
                n_over += 1
                time.sleep(min(e.retry_after_s, 5.0))

    def _replay_inner(
        self, target, run, speed, mode, timeout_s, is_fleet,
        overloaded_cls,
    ) -> Dict[str, Any]:
        reqs = self.requests
        t_start = time.perf_counter()
        inflight: List[Tuple[Dict, Any, float]] = []
        # verdicts, not results: each ServedResult is verified (and
        # its reconstruction dropped) the moment we collect it — a
        # thousands-of-requests replay must not hold every recon
        # array until the report
        verdicts: List[Tuple[Dict, str, float, Optional[str]]] = []
        n_overloaded = 0
        for i, req in enumerate(reqs):
            arrays = self._arrays(req)
            if mode == "open" and speed > 0:
                due = t_start + req.get("t_rel", 0.0) / speed
                lag = due - time.perf_counter()
                if lag > 0:
                    time.sleep(lag)
            dl_ms = self._deadline_ms(req)
            fut, n_over, t_sub = self._submit_one(
                target, f"replay-{i:06d}", arrays, is_fleet,
                overloaded_cls,
                bank_id=req.get("bank_id"),
                tenant=req.get("tenant"),
                deadline_ms=dl_ms,
            )
            n_overloaded += n_over
            if mode == "closed":
                verdicts.append(
                    self._settle(req, fut, t_sub, timeout_s, dl_ms)
                )
            else:
                inflight.append((req, fut, t_sub, dl_ms))
        # submitted payloads now live in the target's own queue; drop
        # the reader cache so delivered requests' arrays can be freed
        self._payloads.clear()
        while inflight:
            req, fut, t_sub, dl_ms = inflight.pop(0)
            verdicts.append(
                self._settle(req, fut, t_sub, timeout_s, dl_ms)
            )
        elapsed = time.perf_counter() - t_start
        return self._report(
            run, verdicts, elapsed, speed, mode, n_overloaded,
            target, is_fleet,
        )

    def _settle(
        self, req, fut, t_sub, timeout_s, deadline_ms=None
    ) -> Tuple[Dict, str, float, Optional[str]]:
        """Wait one future out and reduce it to its verdict
        (status, latency, served bucket) — the result arrays are
        released here, not carried to the report. With deadline
        plumbing active, the wait is the request's own remaining
        budget (plus slack for the expiry round trip) instead of the
        one-size-fits-all ``timeout_s``, and an expiry resolves as
        the distinct ``deadline`` verdict, never a mismatch."""
        from .fleet import DeadlineExceeded

        wait_s = timeout_s
        if deadline_ms is not None:
            left = deadline_ms / 1e3 - (
                time.perf_counter() - t_sub
            )
            # the serving side expires it; this wait only has to
            # outlive that expiry landing on the future
            wait_s = min(timeout_s, max(left, 0.0) + 5.0)
        try:
            res = fut.result(timeout=wait_s)
        except DeadlineExceeded:
            return req, "deadline", 0.0, None
        except Exception:
            return req, "lost", 0.0, None
        lat_ms = (time.perf_counter() - t_sub) * 1e3
        return req, self._verify(req, res), lat_ms, res.bucket

    def _report(
        self, run, verdicts, elapsed, speed, mode, n_overloaded,
        target, is_fleet,
    ) -> Dict[str, Any]:
        counts = {s: 0 for s in STATUSES}
        replayed_lat: List[float] = []
        recorded_lat: List[float] = []
        for req, status, lat_ms, bucket in verdicts:
            counts[status] += 1
            if status not in ("lost", "deadline"):
                replayed_lat.append(lat_ms)
            out = req.get("outcome")
            if out is not None and out.get("latency_ms") is not None:
                recorded_lat.append(out["latency_ms"])
            run.event(
                "replay_request",
                key=req["key"],
                status=status,
                tenant=req.get("tenant"),
                bank_id=req.get("bank_id"),
                latency_ms=round(lat_ms, 3),
                recorded_latency_ms=(
                    None if out is None else out.get("latency_ms")
                ),
                bucket=bucket,
            )
        rec_p50, rec_p99 = _percentiles(recorded_lat)
        rep_p50, rep_p99 = _percentiles(replayed_lat)
        n = len(verdicts)
        rps = n / elapsed if elapsed > 0 else 0.0
        report: Dict[str, Any] = {
            "mode": mode,
            "speed": speed,
            "n_recorded": len(self.requests),
            "n_replayed": n,
            "n_lost": counts["lost"],
            "n_mismatched": counts["mismatch"],
            "n_deadline": counts["deadline"],
            "n_exact": counts["match_exact"],
            "n_psnr": counts["match_psnr"],
            "n_unverified": counts["unverified"],
            "replay_overload_backoffs": n_overloaded,
            "recorded_rejected": self.meta.get("n_rejected"),
            "recorded_p50_ms": rec_p50,
            "recorded_p99_ms": rec_p99,
            "replayed_p50_ms": rep_p50,
            "replayed_p99_ms": rep_p99,
            "elapsed_s": round(elapsed, 4),
            "requests_per_sec": round(rps, 4),
            "ok": counts["lost"] == 0 and counts["mismatch"] == 0,
        }
        run.event(
            "replay_summary",
            mode=mode,
            speed=speed,
            n_recorded=report["n_recorded"],
            n_replayed=n,
            n_lost=report["n_lost"],
            n_mismatched=report["n_mismatched"],
            n_deadline=report["n_deadline"],
            n_exact=report["n_exact"],
            n_psnr=report["n_psnr"],
            n_unverified=report["n_unverified"],
            replay_overload_backoffs=n_overloaded,
            recorded_rejected=report["recorded_rejected"],
            recorded_p50_ms=rec_p50,
            recorded_p99_ms=rec_p99,
            replayed_p50_ms=rep_p50,
            replayed_p99_ms=rep_p99,
            elapsed_s=report["elapsed_s"],
            requests_per_sec=report["requests_per_sec"],
        )
        led = self._ledger_append(report, target, is_fleet)
        if led is not None:
            run.event(
                "ledger_append",
                key=led["key"],
                value=led["value"],
                unit=led["unit"],
                path=led["path"],
            )
            report["ledger_key"] = led["key"]
        run.console(
            f"replay: {n} request(s) at {mode}/"
            + ("max-speed" if speed <= 0 else f"{speed:g}x")
            + f", {report['n_exact']} bit-exact, "
            f"{report['n_psnr']} psnr-matched, "
            f"{report['n_mismatched']} mismatched, "
            f"{report['n_deadline']} deadline, "
            f"{report['n_lost']} lost",
            tier="brief",
        )
        return report

    def _ledger_append(
        self, report: Dict[str, Any], target, is_fleet
    ) -> Optional[Dict[str, Any]]:
        """Append this replay session to the durable perf ledger
        (kind=replay, requests/sec) so analysis.perf_gate gates
        replay throughput against its own per-configuration history.
        Never raises — the ledger must not fail a replay."""
        try:
            from ..analysis import ledger as _ledger
            from ..tune import store as tune_store
            from ..utils import obs as _obs
            from ..utils import perfmodel

            if not _ledger.enabled() or report["n_replayed"] <= 0:
                return None
            chip = perfmodel.detect_chip(
                getattr(target, "_device", None)
                or getattr(target, "device", None)
            )
            if not chip:
                return None
            geom = target.geom
            buckets = (
                target.buckets if is_fleet else target._buckets
            )
            spatial = max(
                (sp for _s, sp in buckets), key=lambda sp: tuple(sp)
            )
            workload = tune_store.solve_workload(geom)
            rec = _ledger.maybe_append(
                chip=chip,
                kind="replay",
                workload=workload,
                shape_key=tune_store.solve_shape_key(
                    workload,
                    k=geom.num_filters,
                    support=tuple(geom.spatial_support),
                    spatial=tuple(spatial),
                ),
                knobs={
                    "mode": report["mode"],
                    "speed": report["speed"],
                    "replicas": (
                        target.fleet_cfg.replicas if is_fleet else 1
                    ),
                },
                value=report["requests_per_sec"],
                unit="requests/sec",
                git_sha=_obs.git_sha(),
                source="serve.replay",
            )
            if rec is None:
                return None
            return {
                "key": _ledger.record_key(rec),
                "value": rec["value"],
                "unit": rec["unit"],
                "path": _ledger.default_ledger_path(),
            }
        except Exception:  # pragma: no cover - defensive
            return None


# ---------------------------------------------------------------------
# synthetic diurnal workload
# ---------------------------------------------------------------------


def generate_diurnal(
    path: str,
    n_requests: int = 64,
    duration_s: float = 60.0,
    spatial: Tuple[int, int] = (24, 24),
    keep: float = 0.5,
    amp: float = 0.8,
    seed: int = 0,
) -> str:
    """Write a deterministic synthetic diurnal-curve capture.

    Arrival times follow a sinusoidal intensity —
    ``rate(t) ∝ 1 + amp·sin(2π·t/T − π/2)`` (trough at t=0, peak at
    mid-stream, the compressed shape of a day's traffic) — placed by
    inverse-CDF of the cumulative intensity, so the same (n,
    duration, amp, seed) always yields byte-identical requests and
    the identical arrival clock. Payloads are seeded masked images
    with ground truth (``x_orig``) attached, so a replay of the
    synthetic stream still measures PSNR. No outcomes are recorded
    (there was no serve) — replay marks these ``unverified`` and the
    stream functions as a pure load shape."""
    rng = np.random.default_rng(seed)
    # inverse-CDF placement on a fine grid of the cumulative intensity
    grid = np.linspace(0.0, duration_s, 4096)
    rate = 1.0 + amp * np.sin(
        2.0 * math.pi * grid / max(duration_s, 1e-9) - math.pi / 2.0
    )
    cum = np.concatenate([[0.0], np.cumsum(rate[:-1] + rate[1:])])
    cum /= max(cum[-1], 1e-12)
    targets = (np.arange(n_requests) + 0.5) / n_requests
    arrivals = np.interp(targets, cum, grid)
    rec = _capture.WorkloadRecorder(path, sample=1.0)
    h, w = int(spatial[0]), int(spatial[1])
    for i, t_rel in enumerate(arrivals):
        x = rng.random((h, w), dtype=np.float64).astype(np.float32)
        m = (rng.random((h, w)) < keep).astype(np.float32)
        key = f"diurnal-{i:06d}"
        # curve time, not generation time: t_rel comes from the
        # intensity inversion so generation speed never leaks into
        # the workload
        rec.record_submit(
            key, None, x * m, mask=m, x_orig=x, t_rel=float(t_rel),
        )
    rec.close(
        synthetic="diurnal",
        duration_s=duration_s,
        amp=amp,
        seed=seed,
        keep=keep,
    )
    return path


# ---------------------------------------------------------------------
# the CLI (python -m ccsc_code_iccv2017_torch.serve.replay)
# ---------------------------------------------------------------------

_CLI_DOC = """Replay a captured serving workload against a fresh fleet
(serve.capture -> serve.replay) and verify the answers.

    python -m ccsc_code_iccv2017_torch.serve.replay CAPTURE_DIR
        [--replicas N] [--speed X | --max-speed] [--mode open|closed]
        [--filters BANK.mat] [--metrics-dir DIR] [--json]
        [--device cuda|cpu]

    python -m ccsc_code_iccv2017_torch.serve.replay --generate-diurnal
        OUT_DIR [--requests N --duration S --side PX --seed K]

    python -m ccsc_code_iccv2017_torch.serve.replay --demo
        [--demo-dir DIR] [--device cuda|cpu]

Default mode rebuilds a serving fleet pinned to the capture's own
geometry/solve parameters (recorded in the capture's meta.json; the
bank comes from --filters or, for synthetic-bank captures, the
deterministic --bank-seed bank) and re-submits the recorded stream:
open-loop on the recorded arrival clock x --speed (--max-speed =
back-to-back saturation, admission refusals honored + retried so
nothing is shed) or closed-loop. Every replayed result is paired with
its recorded outcome — same-bucket replays must be BIT-IDENTICAL
(sha256 of the reconstruction bytes), cross-bucket replays are held
to --psnr-tol dB. Exit 0 iff zero lost and zero mismatched.

The replay session appends a kind=replay record to the durable perf
ledger when CCSC_PERF_LEDGER is armed, so
``python -m ccsc_code_iccv2017_torch.analysis.perf_gate --list --kind
replay`` gates replay throughput against its own history.

--generate-diurnal writes a deterministic synthetic diurnal-curve
capture (sinusoidal arrival intensity) for load-shape experiments; it
needs no device.

--demo is the self-contained end-to-end proof: a 3-replica fleet
serves a stream UNDER INJECTED KILL/HANG FAULTS with capture on, the
captured stream is replayed at 1x and at max speed against fresh
fleets, and both replays must complete with zero lost requests and
full bit-parity.
"""


def _synth_bank(k: int, support, seed: int) -> np.ndarray:
    """The deterministic synthetic bank (serve.bench's construction):
    seeded normal filters, unit-normalized — the same (k, support,
    seed) always yields the same bytes, which is what lets a replay
    rebuild the exact capture-side operator without shipping it."""
    r = np.random.default_rng(seed)
    d = r.normal(size=(k, *support)).astype(np.float32)
    axes = tuple(range(1, d.ndim))
    d /= np.sqrt((d**2).sum(axis=axes, keepdims=True))
    return d


def _build_fleet(meta, args, metrics_dir, capture_requests):
    """A fresh fleet pinned to the capture's recorded configuration."""
    import sys

    from ..config import FleetConfig, ProblemGeom, ServeConfig, SolveConfig
    from ..models.reconstruct import ReconstructionProblem
    from .fleet import ServeFleet

    geom_meta = meta.get("geom") or {}
    if args.filters:
        from ..utils.io_mat import load_filters_2d

        d = load_filters_2d(args.filters)
        geom = ProblemGeom(d.shape[1:], d.shape[0])
    else:
        support = tuple(
            geom_meta.get("spatial_support") or (args.support,) * 2
        )
        k = int(geom_meta.get("num_filters") or args.k)
        d = _synth_bank(k, support, args.bank_seed)
        geom = ProblemGeom(support, k)
    solve = meta.get("solve") or {}
    cfg = SolveConfig(
        lambda_residual=float(solve.get("lambda_residual", 5.0)),
        lambda_prior=float(solve.get("lambda_prior", 0.3)),
        max_it=int(solve.get("max_it", 20)),
        tol=float(solve.get("tol", 0.0)),
        verbose="none",
        track_psnr=True,
        track_objective=True,
    )
    buckets = meta.get("buckets")
    if buckets:
        btab = tuple(
            (int(b["slots"]), tuple(int(s) for s in b["spatial"]))
            for b in buckets
        )
    else:
        # no recorded table (synthetic capture): one bucket over the
        # largest recorded request shape
        hi = max(
            (tuple(r.get("spatial") or ()) for r in capture_requests),
            default=(args.side,) * 2,
        )
        btab = ((args.slots, tuple(int(s) for s in hi)),)
    tune = str(meta.get("tune") or "off")
    if tune != "off":
        # stderr: --json consumers own stdout
        print(
            f"replay: capture was served with tune={tune!r} — the port "
            "replays untuned (tune='off'); bit parity needs the same "
            "arm",
            file=sys.stderr,
        )
    scfg = ServeConfig(
        buckets=btab, max_wait_ms=args.max_wait_ms, verbose="none",
    )
    fcfg = FleetConfig(
        replicas=args.replicas,
        metrics_dir=metrics_dir,
        # "" = capture explicitly OFF: a replay run in a shell that
        # still has CCSC_CAPTURE_DIR armed must never re-capture
        # itself into the capture it is replaying
        capture_dir="",
        min_queue_depth=max(64, 2 * len(capture_requests)),
        restart_backoff_s=0.05,
        verbose="none",
    )
    return ServeFleet(d, ReconstructionProblem(geom), cfg, scfg, fcfg,
                      device=args.device)


def _print_report(rep, as_json=False) -> None:
    import json

    if as_json:
        print(json.dumps(rep, indent=1))
        return

    def f(v):
        return "—" if v is None else f"{v:.1f}"

    speed = "max" if rep["speed"] <= 0 else f"{rep['speed']:g}x"
    print(
        f"replay[{rep['mode']}/{speed}]: {rep['n_replayed']}/"
        f"{rep['n_recorded']} replayed, {rep['n_exact']} bit-exact, "
        f"{rep['n_psnr']} psnr-matched, {rep['n_unverified']} "
        f"unverified, {rep['n_mismatched']} MISMATCHED, "
        f"{rep['n_lost']} LOST"
    )
    print(
        f"  latency p50 {f(rep['recorded_p50_ms'])} -> "
        f"{f(rep['replayed_p50_ms'])} ms, p99 "
        f"{f(rep['recorded_p99_ms'])} -> {f(rep['replayed_p99_ms'])} "
        f"ms (recorded -> replayed), "
        f"{rep['requests_per_sec']:.2f} req/s over "
        f"{rep['elapsed_s']:.2f}s"
    )
    if rep.get("replay_overload_backoffs"):
        print(
            f"  admission: {rep['replay_overload_backoffs']} overload "
            f"backoff(s) during replay vs {rep['recorded_rejected']} "
            "recorded rejection(s)"
        )


def _run_replay(args) -> int:
    import sys

    driver = ReplayDriver(
        args.capture_dir,
        metrics_dir=args.metrics_dir,
        psnr_tol=args.psnr_tol,
        # --json promises a machine-readable stdout: the driver's
        # console line must not precede the JSON document
        verbose="none" if args.json else "brief",
    )
    if not driver.requests:
        print(
            f"replay: no captured requests under {args.capture_dir}",
            file=sys.stderr,
        )
        return 2
    speed = args.speed
    if speed is None:
        speed = (
            0.0 if args.max_speed
            else float(_env.env_float("CCSC_REPLAY_SPEED"))
        )
    fleet = _build_fleet(
        driver.meta, args, args.metrics_dir, driver.requests
    )
    try:
        rep = driver.replay(fleet, speed=speed, mode=args.mode)
    finally:
        fleet.close()
    _print_report(rep, as_json=args.json)
    return 0 if rep["ok"] else 1


def _run_generate(args) -> int:
    generate_diurnal(
        args.generate_diurnal,
        n_requests=args.requests,
        duration_s=args.duration,
        spatial=(args.side, args.side),
        seed=args.seed,
    )
    print(
        f"generated {args.requests} diurnal request(s) over "
        f"{args.duration:g}s -> {args.generate_diurnal}"
    )
    return 0


def _fault_env(**env):
    """Arm fault knobs for a block: returns a context manager that sets
    ``env``, resets the fire-once fault state, and restores both on
    exit."""
    import contextlib
    import os

    from ..utils import faults

    @contextlib.contextmanager
    def _cm():
        old = {k: os.environ.get(k) for k in env}
        os.environ.update({k: str(v) for k, v in env.items()})
        faults.reset()
        try:
            yield
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            faults.reset()

    return _cm()


def _run_demo(args) -> int:
    """The end-to-end acceptance story, self-contained."""
    import os
    import tempfile

    from ..config import FleetConfig, ProblemGeom, ServeConfig, SolveConfig
    from ..models.reconstruct import ReconstructionProblem
    from .fleet import ServeFleet

    root = args.demo_dir or tempfile.mkdtemp(prefix="ccsc_replay_demo_")
    os.makedirs(root, exist_ok=True)
    cap_dir = os.path.join(root, "capture")
    k, support, seed = 4, (3, 3), 0
    d = _synth_bank(k, support, seed)
    geom = ProblemGeom(support, k)
    cfg = SolveConfig(
        lambda_residual=5.0, lambda_prior=0.3, max_it=3, tol=0.0,
        verbose="none", track_psnr=True, track_objective=True,
    )
    scfg = ServeConfig(
        buckets=((2, (12, 12)),), max_wait_ms=2.0, verbose="none"
    )
    r = np.random.default_rng(0)

    print("demo 1/3: 3-replica fleet, kill+hang faults, capture on")
    with _fault_env(
        CCSC_FAULT_ENGINE_KILL_REQ=2,
        CCSC_FAULT_ENGINE_KILL_REPLICA="0",
        CCSC_FAULT_ENGINE_HANG_REQ=2,
        CCSC_FAULT_ENGINE_HANG_REPLICA="1",
        CCSC_FAULT_ENGINE_HANG_S="3.0",
        CCSC_WATCHDOG_MIN_S="0.5",
    ):
        fleet = ServeFleet(
            d, ReconstructionProblem(geom), cfg, scfg,
            FleetConfig(
                replicas=3,
                metrics_dir=os.path.join(root, "serve-metrics"),
                capture_dir=cap_dir,
                min_queue_depth=64,
                restart_backoff_s=0.05,
                verbose="none",
            ),
            device=args.device,
        )
        futs = []
        for i in range(args.requests):
            x = r.random((12, 12)).astype(np.float32)
            m = (r.random((12, 12)) < 0.5).astype(np.float32)
            futs.append(
                fleet.submit(x * m, mask=m, x_orig=x, key=f"d{i}")
            )
        n_served = sum(1 for f in futs if f.result(timeout=300))
        fleet.close()
    print(f"  served {n_served}/{args.requests} under faults")

    rc = 0
    for label, speed in (("1x", 1.0), ("max-speed", 0.0)):
        print(f"demo {2 if speed else 3}/3: replay at {label}")
        fresh = ServeFleet(
            d, ReconstructionProblem(geom), cfg, scfg,
            FleetConfig(
                replicas=3,
                metrics_dir=os.path.join(root, f"replay-{label}"),
                capture_dir="",  # replay fleets never re-capture
                min_queue_depth=64,
                restart_backoff_s=0.05,
                verbose="none",
            ),
            device=args.device,
        )
        try:
            rep = ReplayDriver(
                cap_dir,
                metrics_dir=os.path.join(root, f"replay-{label}"),
            ).replay(fresh, speed=speed, mode="open")
        finally:
            fresh.close()
        _print_report(rep)
        if not rep["ok"] or rep["n_exact"] != rep["n_replayed"]:
            rc = 1
    print(
        ("demo PASSED" if rc == 0 else "demo FAILED")
        + f" — artifacts under {root}"
    )
    return rc


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(
        description=_CLI_DOC,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "capture_dir", nargs="?", default=None,
        help="capture directory to replay (serve.capture layout)",
    )
    ap.add_argument(
        "--filters", default=None,
        help=".mat/.npz bank the capture was served with (default: "
        "the deterministic synthetic bank from the capture's "
        "recorded geometry + --bank-seed)",
    )
    ap.add_argument("--bank-seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=4,
                    help="synthetic-bank filters when meta lacks geom")
    ap.add_argument("--support", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument(
        "--speed", type=float, default=None,
        help="arrival-clock speed factor (default CCSC_REPLAY_SPEED; "
        "0 = max-speed)",
    )
    ap.add_argument(
        "--max-speed", action="store_true",
        help="saturation mode: submit back-to-back, honoring "
        "admission backpressure",
    )
    ap.add_argument("--mode", choices=("open", "closed"),
                    default="open")
    ap.add_argument("--psnr-tol", type=float, default=None)
    ap.add_argument(
        "--metrics-dir", default=None,
        help="obs stream dir of the replay session",
    )
    ap.add_argument("--json", action="store_true")
    ap.add_argument(
        "--generate-diurnal", default=None, metavar="OUT_DIR",
        help="write a deterministic synthetic diurnal-curve capture "
        "and exit",
    )
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--side", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--demo", action="store_true",
        help="run the self-contained capture-under-faults -> "
        "replay-verify acceptance story",
    )
    ap.add_argument("--demo-dir", default=None)
    ap.add_argument(
        "--device", default="cuda",
        help="the replay fleet's device (default cuda; cpu for a run "
        "without a card)",
    )
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.generate_diurnal:
        return _run_generate(args)
    if args.demo:
        return _run_demo(args)
    if not args.capture_dir:
        ap.error(
            "a CAPTURE_DIR (or --generate-diurnal / --demo) is "
            "required"
        )
    return _run_replay(args)


if __name__ == "__main__":
    import sys

    sys.exit(main())
