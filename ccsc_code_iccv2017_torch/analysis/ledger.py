"""The durable perf ledger: the cross-run performance memory (a copy of
``ccsc_code_iccv2017_tpu.analysis.ledger``: the same record format,
keys, bands and verdicts, so either package reads the other's ledger
lines; its seeders from the JAX package's bench artifacts are not
ported, see ROADMAP.md).

This module gives the measured record a durable home and a read
path:

- **Append-only JSONL ledger** (one normalized record per line) with
  the tune-store durability stance: appends repair a torn trailing
  line first and fsync (a preempted run can never destroy history),
  reads drop corrupt/torn lines instead of failing the stream, and a
  missing/corrupt file reads as empty, never raises.
- **Primary key** = ``chip | kind | workload | shape_key |
  knob-digest`` — the same key structure the tuned-knob store uses
  (``tune.store``), extended with a content digest of the resolved
  knob dict so each distinct configuration accrues its OWN history
  (comparing a bf16+matmul arm against an f32 baseline is not a
  regression signal, it is noise).
- **Robust history statistics**: per-key median ± MAD bands
  (:func:`robust_band`) drive both the offline regression gate
  (:func:`gate`) and the live :class:`AnomalyWatch` the
  obs layer arms on a run's rolling roofline fraction — thermal
  throttle, silent recompiles, and bad knob picks surface while the
  run is still alive instead of at the next bench round.

Degraded rows (a bench that fell back to the CPU) are kept, keyed by
the chip that ACTUALLY measured them with ``degraded: true`` on the
record — the chip key already fences them off from card history, and
an honest cpu number is still cpu history. Chip-less rows never enter
the ledger (nothing honest to key by). A card run keys by the
roofline row of utils.perfmodel (``h100``).

Location: ``CCSC_PERF_LEDGER`` env > ``$CCSC_COMPILE_CACHE/
ccsc_perf_ledger.jsonl`` > repo-root ``perf_ledger.jsonl``. The
automatic appends are opt-in (:func:`enabled`): without
``CCSC_PERF_LEDGER`` no run writes any ledger.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence

from ..utils import env as _env

SCHEMA_VERSION = 1

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

__all__ = [
    "Ledger",
    "AnomalyWatch",
    "default_ledger_path",
    "enabled",
    "knob_digest",
    "normalize_record",
    "record_key",
    "robust_band",
    "gate",
    "watch_for",
    "maybe_append",
    "append_serve_record",
    "append_warmup_record",
    "warmup_shape_key",
    "coerce_record",
]


def default_ledger_path() -> str:
    override = _env.env_str("CCSC_PERF_LEDGER")
    if override:
        return override
    cache = _env.env_str("CCSC_COMPILE_CACHE")
    if cache:
        return os.path.join(cache, "ccsc_perf_ledger.jsonl")
    return os.path.join(_REPO_ROOT, "perf_ledger.jsonl")


def enabled() -> bool:
    """Auto-append from runs is opt-in: only an explicit
    ``CCSC_PERF_LEDGER`` path arms the run/bench/fleet append hooks
    (tests and casual runs must not grow a repo-root ledger as a side
    effect). The gate/seed tooling takes explicit paths."""
    return bool(_env.env_str("CCSC_PERF_LEDGER"))


def knob_digest(knobs: Optional[Dict]) -> str:
    """Content digest of a resolved knob dict — the ledger key's
    configuration component. Canonical-JSON sha256, first 12 hex
    chars; {} and None digest identically (an unknobbed record)."""
    try:
        blob = json.dumps(
            knobs or {}, sort_keys=True, default=str
        )
    except (TypeError, ValueError):  # pragma: no cover - defensive
        blob = str(sorted((knobs or {}).items()))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


def normalize_record(
    *,
    chip: str,
    kind: str,
    value: float,
    unit: str,
    workload: str = "",
    shape_key: str = "",
    knobs: Optional[Dict] = None,
    git_sha: Optional[str] = None,
    roofline_frac: Optional[float] = None,
    mfu: Optional[float] = None,
    hbm_frac: Optional[float] = None,
    n_compiles: Optional[int] = None,
    peak_hbm_bytes: Optional[int] = None,
    modeled_hbm_bytes: Optional[int] = None,
    degraded: bool = False,
    source: str = "",
    t: Optional[float] = None,
) -> Dict:
    """One normalized ledger record. ``kind`` is the run family the
    value measures ('learn' | 'bench' | 'serve' | 'solve');
    ``roofline_frac`` is the achieved fraction of the binding
    perfmodel roof (= max(mfu, hbm_frac) — the bound is set by the
    tighter of the two)."""
    if not chip:
        raise ValueError("ledger records require a chip (the key)")
    # canonical chip token: perfmodel.utilization labels an unknown
    # card '<name>->h100' — the ledger keys by the real chip
    chip = str(chip).split("->")[0]
    if roofline_frac is None and (
        mfu is not None or hbm_frac is not None
    ):
        roofline_frac = max(mfu or 0.0, hbm_frac or 0.0)
    return {
        "schema": SCHEMA_VERSION,
        "t": time.time() if t is None else float(t),
        "chip": str(chip),
        "kind": str(kind),
        "workload": str(workload),
        "shape_key": str(shape_key),
        "knobs": dict(knobs or {}),
        "knob_digest": knob_digest(knobs),
        "value": float(value),
        "unit": str(unit),
        "git_sha": git_sha,
        "roofline_frac": (
            None if roofline_frac is None else round(
                float(roofline_frac), 6
            )
        ),
        "mfu": None if mfu is None else round(float(mfu), 6),
        "hbm_frac": (
            None if hbm_frac is None else round(float(hbm_frac), 6)
        ),
        "n_compiles": (
            None if n_compiles is None else int(n_compiles)
        ),
        "peak_hbm_bytes": (
            None if peak_hbm_bytes is None else int(peak_hbm_bytes)
        ),
        "modeled_hbm_bytes": (
            None if modeled_hbm_bytes is None
            else int(modeled_hbm_bytes)
        ),
        "degraded": bool(degraded),
        "source": str(source),
    }


_RECORD_FIELDS = frozenset(
    ("chip", "kind", "value", "unit", "workload", "shape_key",
     "knobs", "git_sha", "roofline_frac", "mfu", "hbm_frac",
     "n_compiles", "peak_hbm_bytes", "modeled_hbm_bytes", "degraded",
     "source", "t")
)
_REQUIRED_FIELDS = frozenset(("chip", "kind", "value", "unit"))


def coerce_record(d: Dict) -> Dict:
    """Normalize an EXTERNAL record dict (a gate's ``--record``):
    unknown keys are dropped (a bench emit record carries metric/
    vs_baseline/... fields the ledger does not key on), required keys
    are checked up front — a malformed record is a :class:`ValueError`
    (a usage error the CLI reports as exit 2), never a TypeError
    traceback that CI would misread as a regression verdict."""
    if not isinstance(d, dict):
        raise ValueError("record must be a JSON object")
    missing = sorted(
        f for f in _REQUIRED_FIELDS if d.get(f) in (None, "")
    )
    if missing:
        raise ValueError(
            f"record missing required field(s) {missing} "
            "(chip, kind, value, unit)"
        )
    return normalize_record(
        **{k: v for k, v in d.items() if k in _RECORD_FIELDS}
    )


def record_key(rec: Dict) -> str:
    """The per-configuration history key."""
    return "|".join(
        (
            rec.get("chip", ""),
            rec.get("kind", ""),
            rec.get("workload", ""),
            rec.get("shape_key", ""),
            rec.get("knob_digest") or knob_digest(rec.get("knobs")),
        )
    )


class Ledger:
    """Append-only JSONL perf history at ``path`` (default resolved
    by :func:`default_ledger_path`). Reads are stateless — every
    query re-parses the file, so concurrent appenders (a bench child
    and a serving fleet) never fight an in-memory cache."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_ledger_path()

    # -- write ---------------------------------------------------------
    def append(self, rec: Dict) -> Dict:
        """Append one record (normalize first via
        :func:`normalize_record` if the digest is missing). A torn
        trailing line from a killed writer is terminated before the
        append so the new record can never be welded onto it; the
        line is flushed AND fsynced — the ledger is the durable
        record of record, one fsync per run is cheap."""
        if "knob_digest" not in rec:
            rec = normalize_record(
                **{
                    k: rec[k]
                    for k in rec
                    if k in normalize_record.__kwdefaults__
                    or k in ("chip", "kind", "value", "unit")
                }
            )
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        torn = False
        try:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                torn = f.read(1) != b"\n"
        except (OSError, ValueError):
            pass
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(
                ("\n" if torn else "")
                + json.dumps(rec, sort_keys=True, default=str)
                + "\n"
            )
            f.flush()
            try:
                os.fsync(f.fileno())
            except OSError:  # pragma: no cover - exotic filesystems
                pass
        return rec

    # -- read ----------------------------------------------------------
    def read(self) -> List[Dict]:
        """Every parseable record, in file order. Corrupt or torn
        lines are dropped (the crash window of a line-granular
        writer); a missing file reads as empty."""
        out: List[Dict] = []
        try:
            with open(self.path, encoding="utf-8", errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(rec, dict) and "value" in rec \
                            and rec.get("chip"):
                        out.append(rec)
        except OSError:
            return []
        return out

    def records(
        self,
        chip: Optional[str] = None,
        kind: Optional[str] = None,
        workload: Optional[str] = None,
        shape_key: Optional[str] = None,
        knob_digest_: Optional[str] = None,
        include_degraded: bool = True,
    ) -> List[Dict]:
        out = []
        for rec in self.read():
            if chip is not None and rec.get("chip") != chip:
                continue
            if kind is not None and rec.get("kind") != kind:
                continue
            if workload is not None and rec.get("workload") != workload:
                continue
            if shape_key is not None and \
                    rec.get("shape_key") != shape_key:
                continue
            if knob_digest_ is not None and \
                    rec.get("knob_digest") != knob_digest_:
                continue
            if not include_degraded and rec.get("degraded"):
                continue
            out.append(rec)
        return out

    def by_key(self) -> Dict[str, List[Dict]]:
        """Records grouped by :func:`record_key`, each group in
        timestamp order (the gate's unit of history)."""
        groups: Dict[str, List[Dict]] = {}
        for rec in self.read():
            groups.setdefault(record_key(rec), []).append(rec)
        for rows in groups.values():
            rows.sort(key=lambda r: r.get("t", 0.0))
        return groups

    @property
    def empty(self) -> bool:
        return not self.read()


# ---------------------------------------------------------------------
# robust statistics + the regression gate
# ---------------------------------------------------------------------

# MAD -> sigma for a normal distribution; the band is
# median - max(k * 1.4826 * MAD, frac * median): the MAD term adapts
# to a noisy history, the fractional floor keeps a zero-MAD history
# (identical repeat measurements) from flagging ordinary jitter.
_MAD_SIGMA = 1.4826


def robust_band(
    values: Iterable[float],
    mad_k: Optional[float] = None,
    frac: Optional[float] = None,
    abs_floor: float = 0.0,
) -> Optional[Dict[str, float]]:
    """Median / MAD / lower-band of a history sample (None when
    empty). ``mad_k`` defaults to CCSC_PERF_GATE_MAD, ``frac`` (the
    minimum relative drop treated as regression) to
    CCSC_PERF_GATE_FRAC. ``abs_floor`` is an ABSOLUTE minimum-drop
    floor in the value's own unit — the quality gate's dB band uses
    it with ``frac=0`` because a relative fraction of a log-domain
    quantity (dB) is meaningless as a tolerance."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return None
    if mad_k is None:
        mad_k = _env.env_float("CCSC_PERF_GATE_MAD")
    if frac is None:
        frac = _env.env_float("CCSC_PERF_GATE_FRAC")

    def _median(xs: List[float]) -> float:
        m = len(xs) // 2
        return xs[m] if len(xs) % 2 else 0.5 * (xs[m - 1] + xs[m])

    med = _median(vals)
    mad = _median(sorted(abs(v - med) for v in vals))
    lo = med - max(
        mad_k * _MAD_SIGMA * mad, frac * abs(med), float(abs_floor)
    )
    return {
        "n": len(vals),
        "median": med,
        "mad": mad,
        "lo": lo,
        "mad_k": float(mad_k),
        "frac": float(frac),
    }


def gate(
    ledger: Ledger,
    mad_k: Optional[float] = None,
    frac: Optional[float] = None,
    min_history: Optional[int] = None,
    record: Optional[Dict] = None,
) -> List[Dict]:
    """Per-key regression verdicts.

    Default mode judges each key's NEWEST record against the robust
    band of its prior history; with ``record`` given, only that
    record is judged, against the key's FULL ledger history (the
    CI shape: gate the run you just measured). Keys with fewer than
    ``min_history`` prior records are reported as ``skipped`` — a
    young ledger passes trivially and starts gating as history
    accrues. Verdict dicts carry ok/skipped/value/band fields;
    ``ok`` is False only for a judged regression."""
    if min_history is None:
        min_history = _env.env_int("CCSC_PERF_GATE_MIN_HISTORY")
    verdicts: List[Dict] = []

    def _judge(key: str, newest: Dict, history: List[Dict]) -> Dict:
        vals = [r["value"] for r in history]
        band = robust_band(vals, mad_k=mad_k, frac=frac)
        v = float(newest["value"])
        if band is None or band["n"] < min_history:
            return {
                "key": key,
                "value": v,
                "unit": newest.get("unit"),
                "n_history": 0 if band is None else band["n"],
                "skipped": True,
                "ok": True,
                "reason": (
                    f"history < {min_history} record(s)"
                ),
            }
        ok = v >= band["lo"]
        return {
            "key": key,
            "value": v,
            "unit": newest.get("unit"),
            "n_history": band["n"],
            "median": band["median"],
            "mad": band["mad"],
            "lo": band["lo"],
            "ratio_vs_median": (
                v / band["median"] if band["median"] else None
            ),
            "skipped": False,
            "ok": ok,
            "t": newest.get("t"),
            "source": newest.get("source"),
        }

    groups = ledger.by_key()
    if record is not None:
        rec = (
            record
            if "knob_digest" in record
            else coerce_record(record)
        )
        key = record_key(rec)
        verdicts.append(_judge(key, rec, groups.get(key, [])))
        return verdicts
    for key, rows in sorted(groups.items()):
        if len(rows) < 2:
            verdicts.append(
                _judge(key, rows[-1], [])
            )
            continue
        verdicts.append(_judge(key, rows[-1], rows[:-1]))
    return verdicts


# ---------------------------------------------------------------------
# live anomaly watch (rolling roofline fraction vs the historical band)
# ---------------------------------------------------------------------


class AnomalyWatch:
    """Rolling-window watch on a run's achieved roofline fraction.

    ``observe(frac)`` pushes one chunk's achieved fraction of the
    perfmodel roof; once the window is full, a rolling median below
    the historical band's lower edge returns a ``perf_anomaly``
    record (the obs layer emits it). Fires ONCE per excursion: the
    watch re-arms only after the rolling median recovers above the
    band — a long throttled stretch is one event, not one per chunk.
    Not thread-safe by design (a Run's chunks are sequential)."""

    def __init__(
        self,
        band: Dict[str, float],
        window: Optional[int] = None,
        key: str = "",
    ):
        self.band = dict(band)
        self.window = window or _env.env_int("CCSC_ANOMALY_WINDOW")
        self.key = key
        self._recent: List[float] = []
        self._armed = True
        self.n_fired = 0

    def observe(self, frac: float) -> Optional[Dict]:
        frac = float(frac)
        if not math.isfinite(frac):
            return None
        self._recent.append(frac)
        if len(self._recent) > self.window:
            self._recent.pop(0)
        if len(self._recent) < self.window:
            return None
        rolling = sorted(self._recent)[len(self._recent) // 2]
        lo = self.band["lo"]
        if rolling >= lo:
            self._armed = True
            return None
        if not self._armed:
            return None
        self._armed = False
        self.n_fired += 1
        return {
            "rolling_frac": round(rolling, 6),
            "band_lo": round(lo, 6),
            "median": round(self.band["median"], 6),
            "mad": round(self.band["mad"], 6),
            "n_history": int(self.band["n"]),
            "window": self.window,
            "key": self.key,
        }


def watch_for(
    chip: str,
    kind: str,
    workload: Optional[str] = None,
    shape_key: Optional[str] = None,
    knobs: Optional[Dict] = None,
    ledger: Optional[Ledger] = None,
    min_history: Optional[int] = None,
) -> Optional[AnomalyWatch]:
    """Build an :class:`AnomalyWatch` from the ledger's roofline-
    fraction history for THIS configuration: the knob digest is
    always part of the match (a legitimate f32 baseline judged
    against bf16-arm history would alarm on every run — the exact
    cross-configuration noise the ledger key exists to prevent),
    relaxing only shape then workload when the exact combination has
    no history yet. None (no watch) when even the relaxed history is
    thinner than ``min_history`` or the ledger is disabled. Degraded
    records never set the band."""
    if ledger is None:
        if not enabled():
            return None
        ledger = Ledger()
    if min_history is None:
        min_history = _env.env_int("CCSC_PERF_GATE_MIN_HISTORY")
    digest = knob_digest(knobs)
    tiers = []
    if workload and shape_key:
        tiers.append((workload, shape_key))
    if workload:
        tiers.append((workload, None))
    tiers.append((None, None))
    for wl, sk in tiers:
        fracs = [
            r["roofline_frac"]
            for r in ledger.records(
                chip=chip, kind=kind, workload=wl, shape_key=sk,
                knob_digest_=digest, include_degraded=False,
            )
            if r.get("roofline_frac")
        ]
        if len(fracs) >= min_history:
            band = robust_band(fracs)
            return AnomalyWatch(
                band,
                key="|".join(
                    (chip, kind, wl or "*", sk or "*", digest)
                ),
            )
    return None


def maybe_append(**fields) -> Optional[Dict]:
    """Append a normalized record iff the ledger is armed
    (``CCSC_PERF_LEDGER`` set) — the one-line hook every producer
    (bench arms, learner runs, serve sessions) calls. Never raises:
    a ledger IO failure must not take down the run it measures."""
    if not enabled():
        return None
    try:
        return Ledger().append(normalize_record(**fields))
    except Exception:
        return None


def append_serve_record(
    rec: Dict,
    degraded: bool = False,
    git_sha: Optional[str] = None,
    source: str = "serve.bench",
) -> Optional[Dict]:
    """Append a serving-workload record (the ``serve.bench
    run_serve_workload`` dict shape) — the ONE mapping from that
    record to a normalized ledger row (``serve.bench`` appends through
    it, as the JAX package's serve benches do). No-op (None) when the ledger is
    disarmed or the record is chip-less.

    A record carrying the bench's mesh arm
    (``mesh_requests_per_sec``, CCSC_SERVE_MESH) appends a SECOND
    row for that configuration: same chip/shape key, but the knob
    dict gains the mesh shape and device count, so the knob digest —
    the ledger's configuration key — separates mesh-serving history
    from single-device history from day one, and ``perf_gate``
    judges each against its own band. A record carrying the
    pipelined arm (``pipeline_requests_per_sec``,
    CCSC_SERVE_PIPELINE > 1) appends a THIRD row the same way — knob
    dict plus ``pipeline=depth`` — so pipelined-dispatch history
    accrues and gates under its own key too."""
    chip = rec.get("chip") or rec.get("platform")
    if not enabled() or not chip:
        return None
    out = maybe_append(
        chip=chip,
        kind="serve",
        workload="serve2d",
        shape_key=rec.get("shape_key", ""),
        knobs=rec.get("knobs") or {},
        value=rec["engine_requests_per_sec"],
        unit="requests/sec",
        git_sha=git_sha,
        n_compiles=rec.get("n_compiles"),
        peak_hbm_bytes=rec.get("peak_hbm_bytes"),
        degraded=bool(degraded),
        source=source,
    )
    if rec.get("mesh_requests_per_sec") is not None:
        maybe_append(
            chip=chip,
            kind="serve",
            workload="serve2d",
            shape_key=rec.get("shape_key", ""),
            # the mesh row keys by the same WORKLOAD knob dict as the
            # default row plus the topology — symmetric vocabularies,
            # so the two configurations differ by exactly mesh/
            # devices. NB if the mesh arm ever gains tune support,
            # its resolved solve arm (rec['mesh_knobs']) must join
            # this dict, or a tuned mesh row would key identically
            # to the untuned one it is not comparable with.
            knobs=dict(
                rec.get("knobs") or {},
                mesh=rec.get("mesh"),
                devices=rec.get("mesh_devices"),
            ),
            value=rec["mesh_requests_per_sec"],
            unit="requests/sec",
            git_sha=git_sha,
            n_compiles=rec.get("n_compiles"),
            peak_hbm_bytes=rec.get("peak_hbm_bytes"),
            degraded=bool(degraded),
            source=source,
        )
    if rec.get("pipeline_requests_per_sec") is not None:
        maybe_append(
            chip=chip,
            kind="serve",
            workload="serve2d",
            shape_key=rec.get("shape_key", ""),
            # same symmetric-vocabulary stance as the mesh row: the
            # pipelined configuration differs from the default by
            # exactly the pipeline key (the engine's own knob dict
            # adds it only when depth != 1, so depth-1 history keys
            # stay untouched)
            knobs=dict(
                rec.get("knobs") or {},
                pipeline=rec.get("pipeline_depth"),
            ),
            value=rec["pipeline_requests_per_sec"],
            unit="requests/sec",
            git_sha=git_sha,
            n_compiles=rec.get("n_compiles"),
            peak_hbm_bytes=rec.get("peak_hbm_bytes"),
            degraded=bool(degraded),
            source=source,
        )
    return out


def warmup_shape_key(
    buckets, mesh_shape: Optional[Sequence[int]] = None
) -> str:
    """The warmup configuration's shape key: the full bucket TABLE
    (``"4@16x16,8@32x32"``, volume order) plus the mesh — a
    two-bucket engine's join time is not comparable with a
    five-bucket engine's, and a mesh program is a different compile
    than a single-device one."""
    names = ",".join(
        f"{int(s)}@" + "x".join(str(int(x)) for x in sp)
        for s, sp in buckets
    )
    if mesh_shape:
        names += "|mesh" + "x".join(str(int(a)) for a in mesh_shape)
    return names


def append_warmup_record(
    *,
    chip: str,
    buckets,
    join_s: float,
    mesh_shape: Optional[Sequence[int]] = None,
    knobs: Optional[Dict] = None,
    staged: bool = False,
    artifact_store: bool = False,
    n_compiled: Optional[int] = None,
    git_sha: Optional[str] = None,
    source: str = "serve.engine",
) -> Optional[Dict]:
    """Append a ``kind=warmup`` record: join-to-first-request as a
    rate (``1/join_s``, warm_starts/sec) so the gate's higher-is-
    better band judges it directly — a 2x slower join halves the
    value and trips ``perf_gate``. One configuration per (chip, mesh,
    bucket-set, knob digest); ``staged`` and ``artifact_store`` ride
    in the knob dict (a pre-warmed staged engine IS a different
    configuration than a cold blocking one — their histories must
    not share a band), while the per-run live-compile count rides the
    ``n_compiles`` field, which never enters the key. No-op when the
    ledger is disarmed."""
    join_s = float(join_s)
    if join_s <= 0:
        # a sub-resolution join (warm store + trivial buckets) still
        # records: clamp to the timer's plausible floor rather than
        # divide by zero or drop the measurement
        join_s = 1e-6
    return maybe_append(
        chip=chip,
        kind="warmup",
        workload="serve_warmup",
        shape_key=warmup_shape_key(buckets, mesh_shape),
        knobs=dict(
            knobs or {},
            staged=bool(staged),
            artifact_store=bool(artifact_store),
        ),
        value=1.0 / join_s,
        unit="warm_starts/sec",
        git_sha=git_sha,
        n_compiles=n_compiled,
        source=source,
    )
