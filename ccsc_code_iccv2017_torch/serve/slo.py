"""SLO layer: streaming log-bucketed latency histograms + declared
latency targets, checked continuously in-process (a copy of
``ccsc_code_iccv2017_tpu.serve.slo``; in the port the one-shot capture a
breach arms is a ``torch.profiler`` trace, utils.profiling.xla_trace).

The serving stack measured latency but never WATCHED it: percentiles
were computed from raw sample lists at ``stats()`` time (unbounded
memory on a long-lived engine, and nothing fired while p99 was
quietly blowing past its budget). This module replaces both:

- :class:`Histogram` — fixed-size log-bucketed latency histogram
  (Prometheus ``le`` semantics): O(1) memory forever, O(#buckets)
  percentile queries, mergeable, and serializable as an obs
  ``slo_histogram`` record so any stream reader can recompute
  fleet-wide percentiles. This is THE percentile implementation of
  the serving stack — engine ``stats()``, fleet ``stats()``,
  ``serve.bench`` and ``scripts/obs_report.py`` all quote it (the
  exact nearest-rank ``utils.obs.percentile`` remains for small
  one-shot samples).
- :class:`SloMonitor` — per-phase histograms (submit→result
  ``total``, queue wait, solve) plus declared targets
  (``ServeConfig.slo_p50_ms`` / ``slo_p99_ms``, env
  ``CCSC_SLO_P50_MS`` / ``CCSC_SLO_P99_MS``). ``tick()`` checks the
  targets every ``CCSC_SLO_CHECK_S`` seconds and returns breach
  records (emitted as ``slo_breach`` events) and periodic histogram
  snapshots (``slo_histogram`` events). A breach can additionally
  arm a ONE-SHOT ``utils.profiling.xla_trace`` capture around the
  engine's next dispatch (``ServeConfig.slo_profile_dir`` /
  ``CCSC_SLO_XPROF_DIR``) — the "why was p99 slow" answer becomes an
  xprof trace instead of a guess.

Thread-safe: ``observe`` is called from worker threads, ``tick`` from
the fleet monitor thread; all state mutations hold the internal lock,
and nothing is emitted under it (the caller emits the returned
records — the thread-safety lint forbids stream writes under a held
lock).
"""
from __future__ import annotations

import math
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils import env as _env

__all__ = [
    "Histogram",
    "SloMonitor",
    "TenantSlos",
    "DEFAULT_BOUNDS_MS",
    "default_bounds",
    "resolve_targets",
    "from_snapshot",
]


def default_bounds(
    lo_ms: float = 0.1, hi_ms: float = 600_000.0, growth: float = 1.6
) -> Tuple[float, ...]:
    """Log-spaced bucket upper edges from ``lo_ms`` to past ``hi_ms``
    (0.1 ms .. 10 min at the defaults — 34 buckets + overflow covers
    a CPU test engine and a TPU fleet with the same table, so
    histograms from any stream merge)."""
    out = [round(lo_ms * growth**i, 6) for i in
           range(1 + int(math.ceil(math.log(hi_ms / lo_ms, growth))))]
    return tuple(out)


DEFAULT_BOUNDS_MS = default_bounds()


class Histogram:
    """Streaming log-bucketed histogram (bucket i counts observations
    <= bounds[i]; one extra overflow bucket past the last bound)."""

    __slots__ = ("bounds", "counts", "n", "sum_ms", "max_ms")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS_MS):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.n = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    @classmethod
    def of(cls, values_ms, bounds: Sequence[float] = DEFAULT_BOUNDS_MS):
        h = cls(bounds)
        for v in values_ms:
            h.observe(v)
        return h

    def observe(self, ms: float) -> None:
        ms = float(ms)
        self.counts[bisect_left(self.bounds, ms)] += 1
        self.n += 1
        self.sum_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms

    def bucket_width_ms(self, ms: float) -> float:
        """Width of the bucket containing ``ms`` — the histogram's
        resolution at that latency (percentile answers are honest to
        within one width)."""
        i = bisect_left(self.bounds, float(ms))
        if i >= len(self.bounds):
            return max(self.max_ms - self.bounds[-1], 0.0)
        lo = self.bounds[i - 1] if i > 0 else 0.0
        return self.bounds[i] - lo

    def _rank_bucket(self, q: float) -> Optional[int]:
        if self.n == 0:
            return None
        rank = max(1, int(math.ceil(q * self.n)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return i
        return len(self.counts) - 1  # pragma: no cover - sums to n

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile, answered as the containing
        bucket's upper edge (clamped to the max observed value so the
        answer never exceeds reality). None when empty. Within one
        bucket width of the exact sample percentile by construction —
        the acceptance contract obs_report and the tests hold it to."""
        i = self._rank_bucket(q)
        if i is None:
            return None
        if i >= len(self.bounds):
            return self.max_ms
        return min(self.bounds[i], self.max_ms)

    def percentile_floor(self, q: float) -> Optional[float]:
        """LOWER edge of the rank bucket — the conservative bound the
        breach check compares against a target: every observation in
        the bucket is strictly above this edge (buckets hold
        ``(lower, upper]``), so ``floor >= target`` proves the true
        quantile exceeds the target, while the reported upper edge
        alone could overstate it by a bucket width and false-fire a
        breach (burning the one-shot xprof capture on a non-event)."""
        i = self._rank_bucket(q)
        if i is None:
            return None
        if i >= len(self.bounds):
            return self.bounds[-1]
        return self.bounds[i - 1] if i > 0 else 0.0

    def merge(self, other: "Histogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.sum_ms += other.sum_ms
        self.max_ms = max(self.max_ms, other.max_ms)

    def snapshot(self) -> Dict:
        """JSON-able state (the ``slo_histogram`` record body and the
        metricsd scrape source)."""
        return {
            "bounds_ms": list(self.bounds),
            "counts": list(self.counts),
            "n": self.n,
            "sum_ms": round(self.sum_ms, 3),
            "max_ms": round(self.max_ms, 3),
            "p50_ms": self.percentile(0.50),
            "p95_ms": self.percentile(0.95),
            "p99_ms": self.percentile(0.99),
        }


def from_snapshot(rec: Dict) -> Histogram:
    """Rebuild a histogram from an ``slo_histogram`` record (or a
    ``snapshot()`` dict) — how a stream reader recomputes fleet-wide
    percentiles offline."""
    h = Histogram(rec.get("bounds_ms") or DEFAULT_BOUNDS_MS)
    counts = rec.get("counts") or []
    for i, c in enumerate(counts[: len(h.counts)]):
        h.counts[i] = int(c)
    h.n = int(rec.get("n", sum(h.counts)))
    h.sum_ms = float(rec.get("sum_ms", 0.0))
    h.max_ms = float(rec.get("max_ms", 0.0))
    return h


def resolve_targets(
    p50_ms: Optional[float] = None, p99_ms: Optional[float] = None
) -> Dict[float, float]:
    """Quantile -> target-ms map from config values, falling back to
    the CCSC_SLO_* env knobs; empty when no SLO is declared."""
    if p50_ms is None:
        p50_ms = _env.env_float("CCSC_SLO_P50_MS")
    if p99_ms is None:
        p99_ms = _env.env_float("CCSC_SLO_P99_MS")
    out: Dict[float, float] = {}
    if p50_ms is not None and p50_ms > 0:
        out[0.50] = float(p50_ms)
    if p99_ms is not None and p99_ms > 0:
        out[0.99] = float(p99_ms)
    return out


class SloMonitor:
    """Per-phase latency histograms + continuous target checks.

    Phases are free-form labels; the serving stack uses ``total``
    (submit→result — the phase the targets apply to), ``queue`` and
    ``solve``. All methods are thread-safe; ``tick``/``final`` return
    records for the CALLER to emit (never emits under its own lock).
    """

    TARGET_PHASE = "total"

    def __init__(
        self,
        targets: Optional[Dict[float, float]] = None,
        check_s: Optional[float] = None,
        bounds: Sequence[float] = DEFAULT_BOUNDS_MS,
    ):
        self.targets = dict(targets or {})
        if check_s is None:
            check_s = _env.env_float("CCSC_SLO_CHECK_S")
        self.check_s = max(0.0, float(check_s))
        self._bounds = tuple(bounds)
        self._hists: Dict[str, Histogram] = {}
        self._last_check = 0.0
        self._last_n: Dict[float, int] = {}
        self._lock = threading.Lock()

    def observe(self, phase: str, ms: float) -> None:
        with self._lock:
            h = self._hists.get(phase)
            if h is None:
                h = self._hists[phase] = Histogram(self._bounds)
            h.observe(ms)

    def percentile(self, phase: str, q: float) -> Optional[float]:
        with self._lock:
            h = self._hists.get(phase)
            return h.percentile(q) if h is not None else None

    def n(self, phase: str) -> int:
        with self._lock:
            h = self._hists.get(phase)
            return h.n if h is not None else 0

    def _check_locked(self) -> List[Dict]:
        breaches: List[Dict] = []
        h = self._hists.get(self.TARGET_PHASE)
        if h is None or h.n == 0:
            return breaches
        for q, target in sorted(self.targets.items()):
            # only re-judge a quantile once new observations arrived —
            # a breached-and-idle engine must not re-fire every tick
            if self._last_n.get(q) == h.n:
                continue
            self._last_n[q] = h.n
            observed = h.percentile(q)
            floor = h.percentile_floor(q)
            # conservative: fire only when the rank bucket's LOWER
            # edge already meets the target — the true quantile is
            # then provably past it. Comparing the reported upper
            # edge would false-breach whenever the target merely
            # falls inside the rank bucket.
            if floor is not None and floor >= target:
                breaches.append(
                    {
                        "phase": self.TARGET_PHASE,
                        "quantile": q,
                        "target_ms": target,
                        "observed_ms": round(observed, 3),
                        "n": h.n,
                    }
                )
        return breaches

    def _snapshots_locked(self) -> List[Dict]:
        out = []
        for phase in sorted(self._hists):
            h = self._hists[phase]
            if h.n == 0:
                continue
            snap = {"phase": phase}
            snap.update(h.snapshot())
            out.append(snap)
        return out

    def tick(self, now: Optional[float] = None) -> Tuple[List[Dict], List[Dict]]:
        """(breach records, histogram snapshots) when the check
        cadence elapsed, else ([], []). The caller emits them
        (``slo_breach`` / ``slo_histogram``)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._last_check and now - self._last_check < self.check_s:
                return [], []
            self._last_check = now
            return self._check_locked(), self._snapshots_locked()

    def final(self) -> Tuple[List[Dict], List[Dict]]:
        """Unconditional closing flush (run summary path): the stream
        always ends with one complete histogram per phase, so a short
        run's percentiles are recomputable offline."""
        with self._lock:
            return self._check_locked(), self._snapshots_locked()

    def raw_snapshots(self) -> List[Dict]:
        """Current per-phase snapshots WITHOUT touching the breach
        bookkeeping — the metricsd scrape source (a scrape must never
        consume a pending breach trigger)."""
        with self._lock:
            return self._snapshots_locked()


class TenantSlos:
    """Per-TENANT latency SLO monitors (the multi-tenant face of
    :class:`SloMonitor`): one monitor per declared
    :class:`~..config.TenantSpec`, each judging its OWN declared
    p50/p99 targets against its own streaming histogram — one
    tenant's burst cannot move another tenant's quantiles, which is
    what makes "the other tenant's latency band held" a measurable
    claim rather than a fleet-average guess.

    Targets come from the spec ONLY (no CCSC_SLO_* env fallback here:
    a fleet-wide knob must not silently become every tenant's
    contract). Every record returned by ``tick``/``final``/
    ``raw_snapshots`` carries the ``tenant`` name, and snapshots also
    carry the declared targets (``target_p50_ms``/``target_p99_ms``)
    so a stream reader can judge "within band" offline without the
    fleet config in hand. Untenanted traffic (tenant None) and
    unknown tenants are ignored — the fleet-wide monitor owns them.
    Thread-safe via the per-monitor locks; same caller-emits
    discipline as :class:`SloMonitor`.
    """

    def __init__(self, specs=None, check_s: Optional[float] = None,
                 bounds: Sequence[float] = DEFAULT_BOUNDS_MS):
        self._mons: Dict[str, SloMonitor] = {}
        self.targets: Dict[str, Dict[float, float]] = {}
        for spec in specs or ():
            targets: Dict[float, float] = {}
            if spec.slo_p50_ms is not None and spec.slo_p50_ms > 0:
                targets[0.50] = float(spec.slo_p50_ms)
            if spec.slo_p99_ms is not None and spec.slo_p99_ms > 0:
                targets[0.99] = float(spec.slo_p99_ms)
            self.targets[spec.tenant] = targets
            self._mons[spec.tenant] = SloMonitor(
                targets, check_s=check_s, bounds=bounds
            )

    def __bool__(self) -> bool:
        return bool(self._mons)

    def observe(self, tenant: Optional[str], ms: float) -> None:
        mon = self._mons.get(tenant) if tenant is not None else None
        if mon is not None:
            mon.observe(SloMonitor.TARGET_PHASE, ms)

    def percentile(
        self, tenant: str, q: float
    ) -> Optional[float]:
        mon = self._mons.get(tenant)
        if mon is None:
            return None
        return mon.percentile(SloMonitor.TARGET_PHASE, q)

    def n(self, tenant: str) -> int:
        mon = self._mons.get(tenant)
        return mon.n(SloMonitor.TARGET_PHASE) if mon else 0

    def _stamp(self, tenant: str, recs: List[Dict]) -> List[Dict]:
        t = self.targets.get(tenant, {})
        for rec in recs:
            rec["tenant"] = tenant
            if "counts" in rec:  # histogram snapshots carry the
                # declared band so offline readers judge them alone
                rec["target_p50_ms"] = t.get(0.50)
                rec["target_p99_ms"] = t.get(0.99)
        return recs

    def tick(
        self, now: Optional[float] = None
    ) -> Tuple[List[Dict], List[Dict]]:
        breaches: List[Dict] = []
        snaps: List[Dict] = []
        for tenant in sorted(self._mons):
            br, sn = self._mons[tenant].tick(now)
            breaches.extend(self._stamp(tenant, br))
            snaps.extend(self._stamp(tenant, sn))
        return breaches, snaps

    def final(self) -> Tuple[List[Dict], List[Dict]]:
        breaches: List[Dict] = []
        snaps: List[Dict] = []
        for tenant in sorted(self._mons):
            br, sn = self._mons[tenant].final()
            breaches.extend(self._stamp(tenant, br))
            snaps.extend(self._stamp(tenant, sn))
        return breaches, snaps

    def raw_snapshots(self) -> List[Dict]:
        out: List[Dict] = []
        for tenant in sorted(self._mons):
            out.extend(
                self._stamp(
                    tenant, self._mons[tenant].raw_snapshots()
                )
            )
        return out
