"""Quality observatory: served-PSNR telemetry, golden probes, and
the bank quality gate (the torch port of
``ccsc_code_iccv2017_tpu.serve.quality``; everything but
:func:`score_bank` is a copy, and ``score_bank`` builds a port
``CodecEngine`` on an explicit ``device``).

- :func:`valid_region_psnr` — THE one valid-region PSNR
  implementation (psf-radius border crop, request-shaped). The
  engine's dispatch path, the capture outcome records and every scorer
  below call this exact function, so a recorded dB and a recomputed dB
  can never drift apart.
- :class:`QualityMonitor` — per-(bank_id, tenant, bucket) dB
  histograms (``serve.slo.Histogram`` with dB buckets), declared
  per-tenant quality floors (``TenantSpec.min_psnr_db`` →
  ``quality_breach`` events, the SloMonitor re-fire discipline
  inverted for "provably BELOW the floor"), on-device solve
  diagnostics folded per bucket (read back with the dispatch's
  existing host read, never an extra launch), and drift detection
  against per-bank ledger history (``quality_drift`` events).
- :class:`ProbeSet` — golden probes: deterministic requests with
  content-addressed reference outcomes (the capture payload-store
  layout), scheduled through idle replicas at
  ``CCSC_PROBE_INTERVAL_S``, scored bit-exact (recon digest match)
  and in dB. A regression emits ``quality_probe_breach`` plus an
  advisory demotion signal (``quality_demote_advice``).
- :func:`score_bank` — shadow bank scoring: replay a captured
  segment through a candidate bank OFFLINE and append a
  ``kind=quality`` ledger record keyed by bank (the record carries
  the bank DIGEST); :func:`judge_candidate` — the perf-gate band
  math with an ABSOLUTE dB floor (``CCSC_QUALITY_GATE_DB``) — judges
  candidate-vs-live history. ``python -m
  ccsc_code_iccv2017_torch.serve.quality_gate`` runs it in CI and
  ``ServeFleet.publish_bank(..., quality_check=True)`` (or
  ``CCSC_QUALITY_GATE=1``) refuses a regressing candidate.

Thread-safety follows serve.slo: ``observe``/``observe_solve`` run on
worker threads, ``tick`` on the monitor thread; all mutation holds
the internal lock and NOTHING is emitted under it — every method
returns records for the caller to emit.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import env as _env
from . import slo as _slo

__all__ = [
    "DB_BOUNDS",
    "PROBE_KEY_PREFIX",
    "ProbeSet",
    "QualityGateError",
    "QualityMonitor",
    "judge_candidate",
    "quality_band",
    "resolve_probe_dir",
    "score_bank",
    "synth_probe",
    "valid_region_psnr",
]

# Idempotency-key prefix of golden-probe requests: probe traffic is
# real traffic (same admission, same solve), but the capture layer
# skips it (a probe must never pollute the replayable workload) and
# stream readers can filter it.
PROBE_KEY_PREFIX = "__probe__"

# The shared dB bucket table: 0.5 dB steps over (0, 80] dB + the
# overflow bucket. Linear, not log — PSNR is already a log-domain
# quantity, and a fixed table means every quality histogram in any
# stream merges (the slo.DEFAULT_BOUNDS_MS stance applied to dB).
DB_BOUNDS: Tuple[float, ...] = tuple(
    round(0.5 * i, 1) for i in range(1, 161)
)


def valid_region_psnr(
    rec: np.ndarray, ref: np.ndarray, radius: Tuple[int, ...]
) -> float:
    """PSNR of the cropped (request-shaped) reconstruction against its
    ground truth, with the same psf-radius border crop as common.psnr —
    the in-solve trace averages over the whole BUCKET canvas, which
    dilutes the MSE of a padded request with unconstrained pad pixels.

    This is THE shared implementation: the engine's per-request
    ``ServedResult.psnr``, the capture outcome records and the
    probe/shadow scorers all quote this exact computation, the same
    as the JAX package's, so both packages quote one number for one
    reconstruction."""
    rec = np.asarray(rec)
    ref = np.asarray(ref)
    nd = len(radius)
    sl = tuple(
        slice(r, s - r) for r, s in zip(radius, rec.shape[-nd:])
    )
    sl = (Ellipsis, *sl)
    mse = float(np.mean((rec[sl] - ref[sl]) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def quality_band(
    values: Iterable[float],
    mad_k: Optional[float] = None,
    db: Optional[float] = None,
) -> Optional[Dict[str, float]]:
    """The quality regression band: ``analysis.ledger.robust_band``
    with the relative frac floor replaced by an ABSOLUTE dB floor
    (``CCSC_QUALITY_GATE_DB``). The perf gate's relative band is
    meaningless in dB — 25% of a 30 dB median is 7.5 dB, far past any
    regression worth catching — so quality history is judged as
    ``median - max(mad_k * 1.4826 * MAD, db)``."""
    from ..analysis import ledger as _ledger

    if db is None:
        db = _env.env_float("CCSC_QUALITY_GATE_DB")
    return _ledger.robust_band(
        values, mad_k=mad_k, frac=0.0, abs_floor=float(db)
    )


class QualityGateError(RuntimeError):
    """A candidate bank's shadow-score history regresses below the
    live bank's quality band — raised by ``publish_bank`` when the
    opt-in quality check refuses the swap. Carries the verdict
    list (``.verdicts``) the refusal was based on."""

    def __init__(self, msg: str, verdicts: Optional[List[Dict]] = None):
        super().__init__(msg)
        self.verdicts = verdicts or []


# ---------------------------------------------------------------------
# the quality monitor
# ---------------------------------------------------------------------


class QualityMonitor:
    """Streaming served-quality telemetry for one engine or fleet.

    ``observe`` folds one delivered request's valid-region PSNR into
    the per-(bank_id, tenant, bucket) dB histogram (and the tenant's
    floor histogram, and the per-bank drift watch); ``observe_solve``
    folds one dispatch's on-device solve diagnostics. ``tick`` (check
    cadence ``CCSC_QUALITY_CHECK_S``) returns breach / histogram /
    solve-diagnostic records for the caller to emit as
    ``quality_breach`` / ``quality_histogram`` / ``quality_solve_diag``
    events; ``final`` flushes unconditionally at close.

    Floor breaches mirror SloMonitor's conservatism, INVERTED for a
    lower bound: a breach fires only when the tenant's median-rank
    bucket's UPPER edge sits below ``min_psnr_db`` — the true median
    is then provably below the floor (quality snapshots reuse the
    Histogram snapshot shape, so the ``*_ms`` keys carry dB — the
    ``unit`` field says so). Re-fire dedup is the same ``_last_n``
    discipline: a breached-and-idle tenant does not re-fire every
    tick.

    Drift detection: ``drift_band_for(bank_id, digest)`` (optional) is
    consulted once per (bank_id, digest) pair to build an
    :class:`~..analysis.ledger.AnomalyWatch` from per-bank
    ``kind=quality`` ledger history; a rolling median of served dB
    below the band's lower edge returns one ``quality_drift`` fire
    per excursion (re-arms on recovery)."""

    def __init__(
        self,
        specs=None,
        check_s: Optional[float] = None,
        bounds: Sequence[float] = DB_BOUNDS,
        drift_band_for=None,
        drift_window: Optional[int] = None,
    ):
        self.floors: Dict[str, float] = {}
        for spec in specs or ():
            floor = getattr(spec, "min_psnr_db", None)
            if floor is not None and floor > 0:
                self.floors[spec.tenant] = float(floor)
        if check_s is None:
            check_s = _env.env_float("CCSC_QUALITY_CHECK_S")
        self.check_s = max(0.0, float(check_s))
        self._bounds = tuple(bounds)
        # (bank_id, tenant, bucket) -> dB histogram
        self._hists: Dict[Tuple, _slo.Histogram] = {}
        # tenant -> dB histogram the floor is judged against
        self._tenant_hists: Dict[str, _slo.Histogram] = {}
        # bucket -> solve-diagnostic accumulators
        self._diags: Dict[str, Dict[str, float]] = {}
        self._last_check = 0.0
        self._last_n: Dict[str, int] = {}
        self._breached: set = set()
        self._drift_band_for = drift_band_for
        if drift_window is None:
            drift_window = _env.env_int("CCSC_QUALITY_DRIFT_WINDOW")
        self._drift_window = max(1, int(drift_window))
        self._drift: Dict[Tuple, object] = {}
        self._drift_unbanded: set = set()
        self._lock = threading.Lock()

    # -- observation ---------------------------------------------------
    def observe(
        self,
        db: Optional[float],
        *,
        bank_id: Optional[str] = None,
        tenant: Optional[str] = None,
        bucket: Optional[str] = None,
        digest: Optional[str] = None,
    ) -> List[Dict]:
        """Fold one delivered request's dB (None = untracked request,
        a no-op). Returns ``quality_drift`` fire records for the
        CALLER to emit — nothing is emitted under the lock."""
        if db is None:
            return []
        db = float(db)
        if not math.isfinite(db):
            return []
        fires: List[Dict] = []
        with self._lock:
            key = (bank_id, tenant, bucket)
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _slo.Histogram(self._bounds)
            h.observe(db)
            if tenant is not None and tenant in self.floors:
                th = self._tenant_hists.get(tenant)
                if th is None:
                    th = self._tenant_hists[tenant] = _slo.Histogram(
                        self._bounds
                    )
                th.observe(db)
            watch = self._drift_watch_locked(bank_id, digest)
            if watch is not None:
                rec = watch.observe(db)
                if rec:
                    fires.append(
                        {
                            "bank_id": bank_id,
                            "digest": digest,
                            # AnomalyWatch speaks roofline-frac; the
                            # quality plane renames to dB
                            "rolling_db": rec["rolling_frac"],
                            "band_lo": rec["band_lo"],
                            "median": rec["median"],
                            "n_history": rec["n_history"],
                            "window": rec["window"],
                        }
                    )
        return fires

    def _drift_watch_locked(self, bank_id, digest):
        if self._drift_band_for is None or digest is None:
            return None
        key = (bank_id, digest)
        if key in self._drift_unbanded:
            return None
        watch = self._drift.get(key)
        if watch is None:
            from ..analysis import ledger as _ledger

            try:
                band = self._drift_band_for(bank_id, digest)
            except Exception:
                band = None
            if not band:
                # one lookup per (bank, digest): a bank with no
                # quality history yet is not re-queried per request
                self._drift_unbanded.add(key)
                return None
            watch = self._drift[key] = _ledger.AnomalyWatch(
                band,
                window=self._drift_window,
                key=f"quality|{bank_id or 'default'}|{digest}",
            )
        return watch

    def observe_solve(
        self,
        bucket: str,
        iters,
        max_it: int,
        obj_fid=None,
        obj_l1=None,
        nonfinite=None,
    ) -> None:
        """Fold one dispatch's solve diagnostics: iterations-to-stop
        per filled slot (tol-stop = stopped short of ``max_it``), and
        — when the solve ran with ``SolveConfig.track_diagnostics`` —
        the on-device objective split (data residual vs L1) and
        nonfinite count read back at the EXISTING dispatch fence."""
        its = [int(v) for v in np.atleast_1d(np.asarray(iters))]
        with self._lock:
            d = self._diags.get(bucket)
            if d is None:
                d = self._diags[bucket] = {
                    "n": 0,
                    "iters_sum": 0,
                    "tol_stops": 0,
                    "maxit_stops": 0,
                    "nonfinite": 0,
                    "obj_fid_sum": 0.0,
                    "obj_l1_sum": 0.0,
                    "obj_n": 0,
                }
            for v in its:
                d["n"] += 1
                d["iters_sum"] += v
                if v < int(max_it):
                    d["tol_stops"] += 1
                else:
                    d["maxit_stops"] += 1
            if nonfinite is not None:
                d["nonfinite"] += int(np.sum(np.asarray(nonfinite)))
            if obj_fid is not None and obj_l1 is not None:
                fid = np.atleast_1d(np.asarray(obj_fid, np.float64))
                l1 = np.atleast_1d(np.asarray(obj_l1, np.float64))
                d["obj_fid_sum"] += float(np.sum(fid))
                d["obj_l1_sum"] += float(np.sum(l1))
                d["obj_n"] += int(fid.size)

    # -- checks / snapshots --------------------------------------------
    def _breaches_locked(self) -> List[Dict]:
        out: List[Dict] = []
        for tenant in sorted(self.floors):
            floor = self.floors[tenant]
            h = self._tenant_hists.get(tenant)
            if h is None or h.n == 0:
                continue
            # only re-judge once new observations arrived — a
            # breached-and-idle tenant must not re-fire every tick
            if self._last_n.get(tenant) == h.n:
                continue
            self._last_n[tenant] = h.n
            observed = h.percentile(0.50)
            # conservative, mirrored from SloMonitor: the median-rank
            # bucket's UPPER edge below the floor proves the true
            # median is below it; comparing the lower edge would
            # false-breach whenever the floor merely falls inside
            # the rank bucket
            if observed is not None and observed < floor:
                self._breached.add(tenant)
                out.append(
                    {
                        "tenant": tenant,
                        "min_psnr_db": floor,
                        "observed_db": round(observed, 3),
                        "n": h.n,
                    }
                )
            elif observed is not None:
                self._breached.discard(tenant)
        return out

    def _snapshots_locked(self) -> List[Dict]:
        out: List[Dict] = []
        for key in sorted(
            self._hists, key=lambda k: tuple(str(x) for x in k)
        ):
            h = self._hists[key]
            if h.n == 0:
                continue
            bank_id, tenant, bucket = key
            snap = {
                "bank_id": bank_id,
                "tenant": tenant,
                "bucket": bucket,
                "unit": "db",
            }
            snap.update(h.snapshot())
            out.append(snap)
        return out

    def _diags_locked(self) -> List[Dict]:
        out: List[Dict] = []
        for bucket in sorted(self._diags):
            d = self._diags[bucket]
            if not d["n"]:
                continue
            rec = {
                "bucket": bucket,
                "n": d["n"],
                "iters_mean": round(d["iters_sum"] / d["n"], 3),
                "tol_stop_frac": round(d["tol_stops"] / d["n"], 4),
                "maxit_stop_frac": round(
                    d["maxit_stops"] / d["n"], 4
                ),
                "nonfinite": d["nonfinite"],
            }
            if d["obj_n"]:
                rec["obj_fid_mean"] = round(
                    d["obj_fid_sum"] / d["obj_n"], 6
                )
                rec["obj_l1_mean"] = round(
                    d["obj_l1_sum"] / d["obj_n"], 6
                )
            out.append(rec)
        return out

    def tick(
        self, now: Optional[float] = None
    ) -> Tuple[List[Dict], List[Dict], List[Dict]]:
        """(breaches, histogram snapshots, solve diagnostics) when the
        check cadence elapsed, else ``([], [], [])``. The caller emits
        them (``quality_breach`` / ``quality_histogram`` /
        ``quality_solve_diag``)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if (
                self._last_check
                and now - self._last_check < self.check_s
            ):
                return [], [], []
            self._last_check = now
            return (
                self._breaches_locked(),
                self._snapshots_locked(),
                self._diags_locked(),
            )

    def final(self) -> Tuple[List[Dict], List[Dict], List[Dict]]:
        """Unconditional closing flush — the stream always ends with
        one complete quality histogram per (bank, tenant, bucket)."""
        with self._lock:
            return (
                self._breaches_locked(),
                self._snapshots_locked(),
                self._diags_locked(),
            )

    def raw_snapshots(self) -> List[Dict]:
        """Current dB snapshots WITHOUT touching breach bookkeeping —
        the metricsd scrape source (``ccsc_psnr_db``)."""
        with self._lock:
            return self._snapshots_locked()

    @property
    def n_breached(self) -> int:
        """Tenants currently judged below their declared floor — the
        ``ccsc_quality_breach`` gauge."""
        with self._lock:
            return len(self._breached)


# ---------------------------------------------------------------------
# golden probes
# ---------------------------------------------------------------------


def resolve_probe_dir(explicit: Optional[str]) -> Optional[str]:
    """Probe-dir resolution chain (the capture_dir stance): explicit
    config wins, else ``CCSC_PROBE_DIR``, else probing is off; an
    explicit empty string is off regardless of the env."""
    if explicit == "":
        return None
    return explicit or _env.env_str("CCSC_PROBE_DIR") or None


def synth_probe(
    d, spatial, seed: int, density: float = 0.08
) -> np.ndarray:
    """Deterministic in-distribution probe content: a sparse code
    drawn at ``density`` synthesized through the bank ``d``
    (circular convolution), zero-mean, scaled to unit peak. Content
    a bank can actually represent is the only content whose served
    dB RANKS banks — on generic noise the ordering between two banks
    is arbitrary (a smooth rank-1 bank out-scores a trained one by
    predicting the local mean), which is useless as a rot signal."""
    d = np.asarray(d, np.float32)
    rng = np.random.default_rng(seed)
    k = d.shape[0]
    z = np.zeros((k, *spatial), np.float32)
    nz = rng.random((k, *spatial)) < density
    z[nz] = rng.standard_normal(int(nz.sum())).astype(np.float32)
    dpad = np.zeros((k, *spatial), np.float32)
    dpad[(slice(None), *(slice(0, s) for s in d.shape[1:]))] = d
    x = np.real(
        np.fft.ifftn(
            (
                np.fft.fftn(dpad, axes=range(1, 1 + len(spatial)))
                * np.fft.fftn(z, axes=range(1, 1 + len(spatial)))
            ).sum(axis=0),
            axes=range(len(spatial)),
        )
    )
    return (x / max(float(np.abs(x).max()), 1e-6)).astype(
        np.float32
    )


class ProbeSet:
    """Golden probes with content-addressed reference outcomes.

    Layout is the capture payload store's: ``payloads/<sha256>.npy``
    holds every array (probe inputs AND reference reconstructions,
    deduplicated by content), ``probes.jsonl`` is the append-only
    manifest — ``kind=probe`` rows declare the deterministic inputs,
    ``kind=reference`` rows pin (probe, bank digest) → (recon sha,
    dB). References are SELF-SEALING with one guard: the first
    scored run of a digest with no stored reference records one —
    UNLESS the same (probe, bank id) already holds a reference under
    a DIFFERENT digest and the new digest scores more than
    ``CCSC_PROBE_DB_TOL`` below it. That is the bank-rot case (a
    hot-swap to a degraded bank): sealing would bless the rot as its
    own baseline, so the run is judged ``regressed`` against the
    bank's standing reference instead. Within a digest every later
    run is judged bit-exact first (sha match), then in dB. Swapping
    a bank back to a previously-referenced digest re-judges against
    the ORIGINAL reference, which is what makes "demotion restored
    the old quality" checkable."""

    MANIFEST = "probes.jsonl"
    _PAYLOAD_DIR = "payloads"

    def __init__(self, path: str):
        self.path = path
        self._probes: Dict[str, Dict] = {}
        self._refs: Dict[Tuple[str, str], Dict] = {}
        # (probe, bank id) -> newest reference across ALL digests of
        # that bank — the standing baseline a never-seen digest is
        # judged against before it may seal its own reference
        self._bank_refs: Dict[Tuple[str, str], Dict] = {}
        self._lock = threading.Lock()
        try:
            with open(
                os.path.join(path, self.MANIFEST),
                encoding="utf-8",
                errors="replace",
            ) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("kind") == "probe":
                        self._probes[rec["name"]] = rec
                    elif rec.get("kind") == "reference":
                        # newest wins (append order)
                        self._refs[
                            (rec["probe"], rec["digest"])
                        ] = rec
                        if rec.get("bank"):
                            self._bank_refs[
                                (rec["probe"], rec["bank"])
                            ] = rec
        except OSError:
            pass

    # -- construction --------------------------------------------------
    @classmethod
    def generate(
        cls,
        path: str,
        geom,
        buckets,
        n_per_bucket: int = 1,
        seed: int = 0,
        d=None,
    ) -> "ProbeSet":
        """Create a deterministic probe set for one serving
        geometry: ``n_per_bucket`` probes per configured bucket
        spatial size. With ``d`` (the serving fleet passes its
        pinned bank) probe content is :func:`synth_probe` — sparse
        codes synthesized THROUGH the bank, the only content whose
        served dB ranks banks — served unmasked. Without ``d`` it
        falls back to half-masked uniform noise (still a bit-exact
        determinism witness, but dB-blind to bank identity). Probes
        already present are kept — regenerating is idempotent, so
        references survive."""
        os.makedirs(
            os.path.join(path, cls._PAYLOAD_DIR), exist_ok=True
        )
        ps = cls(path)
        idx = 0
        for slots, spatial in buckets:
            for j in range(n_per_bucket):
                name = (
                    "probe-"
                    + "x".join(str(s) for s in spatial)
                    + f"-{j}"
                )
                idx += 1
                if name in ps._probes:
                    continue
                shape = (*geom.reduce_shape, *spatial)
                if d is not None:
                    x = synth_probe(d, tuple(spatial), seed + idx)
                    x = np.broadcast_to(x, shape).copy()
                    sha_x = ps._store_payload(x)
                    sha_b, sha_m = sha_x, None
                else:
                    rng = np.random.default_rng(seed + idx)
                    x = rng.random(shape, dtype=np.float32)
                    m = (
                        rng.random(shape) < 0.5
                    ).astype(np.float32)
                    sha_x = ps._store_payload(x)
                    sha_b = ps._store_payload(x * m)
                    sha_m = ps._store_payload(m)
                rec = {
                    "kind": "probe",
                    "name": name,
                    "spatial": list(spatial),
                    "psf_radius": list(geom.psf_radius),
                    "seed": seed + idx,
                    "b": sha_b,
                    "mask": sha_m,
                    "x_orig": sha_x,
                }
                ps._append(rec)
                ps._probes[name] = rec
        return ps

    def _store_payload(self, arr: np.ndarray) -> str:
        from . import capture as _capture

        arr = np.ascontiguousarray(arr)
        sha = _capture.payload_sha(arr)
        fpath = os.path.join(
            self.path, self._PAYLOAD_DIR, sha + ".npy"
        )
        if not os.path.exists(fpath):
            tmp = fpath + f".tmp-{os.getpid()}"
            with open(tmp, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, fpath)
        return sha

    def _append(self, rec: Dict) -> None:
        with self._lock:
            with open(
                os.path.join(self.path, self.MANIFEST),
                "a",
                encoding="utf-8",
            ) as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")

    def load(self, sha: str) -> np.ndarray:
        return np.load(
            os.path.join(self.path, self._PAYLOAD_DIR, sha + ".npy")
        )

    def probes(self) -> List[Dict]:
        return [self._probes[n] for n in sorted(self._probes)]

    def reference(
        self, probe: str, digest: str
    ) -> Optional[Dict]:
        return self._refs.get((probe, digest))

    def __len__(self) -> int:
        return len(self._probes)

    # -- scoring -------------------------------------------------------
    def run(
        self,
        target,
        bank_id: Optional[str] = None,
        db_tol: Optional[float] = None,
        key_seq: int = 0,
        timeout: Optional[float] = None,
    ) -> List[Dict]:
        """Serve every probe through ``target`` (a ServeFleet or
        CodecEngine — anything with ``reconstruct``/``bank_digest``)
        and score each against the stored reference for the bank's
        CURRENT digest. Returns one verdict dict per probe —
        ``status`` ∈ ``reference`` (first sighting of this digest,
        reference recorded) | ``exact`` (bit-identical recon) |
        ``db_ok`` (within ``db_tol`` of the reference dB) |
        ``regressed``. The caller emits ``quality_probe`` /
        ``quality_probe_breach`` events from these."""
        import inspect

        from . import capture as _capture

        if db_tol is None:
            db_tol = _env.env_float("CCSC_PROBE_DB_TOL")
        db_tol = float(db_tol)
        takes_key = "key" in inspect.signature(
            target.reconstruct
        ).parameters
        bank_key = bank_id or "default"
        out: List[Dict] = []
        for p in self.probes():
            b = self.load(p["b"])
            x = self.load(p["x_orig"])
            mask = (
                self.load(p["mask"]) if p.get("mask") else None
            )
            kw = {"timeout": timeout} if timeout else {}
            if takes_key:
                kw["key"] = (
                    f"{PROBE_KEY_PREFIX}{p['name']}-{key_seq}"
                )
            digest = target.bank_digest(bank_id)
            res = target.reconstruct(
                b, mask=mask, x_orig=x, bank_id=bank_id, **kw
            )
            recon = np.ascontiguousarray(
                np.asarray(res.recon, np.float32)
            )
            sha = _capture.payload_sha(recon)
            db = valid_region_psnr(
                recon, x, tuple(p["psf_radius"])
            )
            ref = self.reference(p["name"], digest)
            if ref is None:
                # bank-rot guard: a digest this bank has never
                # served may only seal its own reference if it does
                # not regress the bank's STANDING reference (the
                # newest one any prior digest recorded)
                prior = self._bank_refs.get((p["name"], bank_key))
                if prior is not None and db < (
                    float(prior["db"]) - db_tol
                ):
                    out.append(
                        {
                            "probe": p["name"],
                            "bank_id": bank_id,
                            "digest": digest,
                            "status": "regressed",
                            "db": round(db, 4),
                            "ref_db": prior["db"],
                            "db_tol": db_tol,
                        }
                    )
                    continue
                rec = {
                    "kind": "reference",
                    "probe": p["name"],
                    "digest": digest,
                    "bank": bank_key,
                    "recon_sha": self._store_payload(recon),
                    "db": round(db, 6),
                    "t": time.time(),
                }
                self._append(rec)
                self._refs[(p["name"], digest)] = rec
                self._bank_refs[(p["name"], bank_key)] = rec
                status = "reference"
                ref_db = None
            elif sha == ref["recon_sha"]:
                status = "exact"
                ref_db = ref["db"]
            elif db >= float(ref["db"]) - db_tol:
                status = "db_ok"
                ref_db = ref["db"]
            else:
                status = "regressed"
                ref_db = ref["db"]
            if ref is not None and status in ("exact", "db_ok"):
                # A bank that demonstrably serves a referenced digest
                # owns that reference as its standing baseline — even
                # when the reference was first sealed under a different
                # bank id (e.g. the pinned default bank sharing the
                # digest). Without this link a later never-seen digest
                # for the same bank id would self-seal unguarded.
                prev = self._bank_refs.get((p["name"], bank_key))
                if prev is None or prev.get("recon_sha") != ref["recon_sha"]:
                    link = dict(ref, bank=bank_key)
                    self._append(link)
                    self._bank_refs[(p["name"], bank_key)] = link
            out.append(
                {
                    "probe": p["name"],
                    "bank_id": bank_id,
                    "digest": digest,
                    "status": status,
                    "db": round(db, 4),
                    "ref_db": ref_db,
                    "db_tol": db_tol,
                }
            )
        return out


# ---------------------------------------------------------------------
# shadow bank scoring + the quality gate
# ---------------------------------------------------------------------


def _quality_key_fields(geom, buckets, device=None) -> Dict[str, str]:
    """chip/workload/shape_key of a quality record — the replay
    ledger-append recipe, so quality history and serving history
    speak the same key dialect."""
    from ..tune import store as tune_store
    from ..utils import perfmodel

    workload = tune_store.solve_workload(geom)
    largest = max(buckets, key=lambda bk: int(np.prod(bk[1])))
    return {
        "chip": perfmodel.detect_chip(device),
        "workload": workload,
        "shape_key": tune_store.solve_shape_key(
            workload,
            k=geom.num_filters,
            support=geom.spatial_support,
            spatial=largest[1],
        ),
    }


def score_bank(
    capture_dir: str,
    d,
    bank_id: Optional[str] = None,
    prob=None,
    cfg=None,
    serve_cfg=None,
    ledger_path: Optional[str] = None,
    limit: Optional[int] = None,
    timeout: Optional[float] = None,
    device="cuda",
) -> Dict:
    """Shadow-score a candidate bank: re-serve a captured segment's
    ground-truthed requests (those recorded with ``x_orig``) through
    a FRESH engine pinned to ``d``, offline — live traffic is never
    touched — and append one ``kind=quality`` ledger record whose
    ``digest`` field is the candidate bank's content digest. The
    record key shares chip|quality|workload|shape_key|knobs(bank)
    with every other score of the same bank id, so
    :func:`judge_candidate` / ``serve.quality_gate`` can split
    one key's history into live-vs-candidate and judge with the
    quality band.

    ``prob``/``cfg``/``serve_cfg`` default to the capture's recorded
    metadata (geometry, solve params, buckets) — the same solve the
    live fleet ran. The scoring engine runs on ``device`` (the card
    unless the caller asks for ``"cpu"``); the record's ``chip`` names
    it. Returns the appended record (also carrying
    ``n_scored``/``p10_db``/``min_db``)."""
    from ..analysis import ledger as _ledger
    from ..config import (
        ProblemGeom,
        ServeConfig,
        SolveConfig,
    )
    from ..models.reconstruct import ReconstructionProblem
    from . import capture as _capture
    from . import registry as _registry
    from .engine import CodecEngine

    meta = _capture.read_meta(capture_dir)
    entries = [
        e
        for e in _capture.read_workload(capture_dir)
        if e.get("x_orig")
    ]
    if limit:
        entries = entries[: int(limit)]
    if not entries:
        raise ValueError(
            f"no captured requests with x_orig under "
            f"{capture_dir!r} — shadow scoring needs ground truth"
        )
    gmeta = meta.get("geom") or {}
    if prob is None:
        geom = ProblemGeom(
            tuple(gmeta["spatial_support"]),
            int(gmeta["num_filters"]),
        )
        prob = ReconstructionProblem(geom)
    geom = prob.geom
    if cfg is None:
        smeta = meta.get("solve") or {}
        cfg = SolveConfig(
            max_it=int(smeta.get("max_it", 100)),
            tol=float(smeta.get("tol", 1e-3)),
            lambda_residual=float(
                smeta.get("lambda_residual", 5.0)
            ),
            lambda_prior=float(smeta.get("lambda_prior", 2.0)),
            verbose="none",
        )
    if serve_cfg is None:
        buckets = tuple(
            (int(bk["slots"]), tuple(bk["spatial"]))
            for bk in meta.get("buckets") or ()
        )
        if not buckets:
            raise ValueError(
                "capture metadata carries no bucket table — pass "
                "serve_cfg explicitly"
            )
        serve_cfg = ServeConfig(
            buckets=buckets, capture_dir="", verbose="none"
        )
    digest = _registry.bank_digest(d)
    dbs: List[float] = []
    eng = CodecEngine(d, prob, cfg, serve_cfg, device=device)
    try:
        futs = []
        for e in entries:
            b = _capture.load_payload(capture_dir, e["b"])
            mask = (
                _capture.load_payload(capture_dir, e["mask"])
                if e.get("mask")
                else None
            )
            smooth = (
                _capture.load_payload(
                    capture_dir, e["smooth_init"]
                )
                if e.get("smooth_init")
                else None
            )
            x = _capture.load_payload(capture_dir, e["x_orig"])
            futs.append(
                (x, eng.submit(b, mask, smooth, x_orig=x))
            )
        for x, fut in futs:
            res = fut.result(timeout=timeout)
            dbs.append(
                valid_region_psnr(
                    res.recon, x, geom.psf_radius
                )
            )
    finally:
        eng.close()
    dbs.sort()
    median = dbs[len(dbs) // 2] if len(dbs) % 2 else 0.5 * (
        dbs[len(dbs) // 2 - 1] + dbs[len(dbs) // 2]
    )
    rec = _ledger.normalize_record(
        kind="quality",
        value=round(median, 4),
        unit="db",
        knobs={"bank": bank_id or "default"},
        source="score_bank",
        **_quality_key_fields(geom, serve_cfg.buckets, device),
    )
    # the candidate's content digest is a record FIELD, not part of
    # the key: one key holds every score of the bank id, and the gate
    # partitions its history into candidate-vs-live by this field
    rec.update(
        digest=digest,
        n_scored=len(dbs),
        p10_db=round(dbs[max(0, int(0.1 * len(dbs)) - 1)], 4),
        min_db=round(dbs[0], 4),
    )
    led = _ledger.Ledger(ledger_path)
    led.append(rec)
    return rec


def judge_candidate(
    led,
    candidate_digest: str,
    bank_id: Optional[str] = None,
    mad_k: Optional[float] = None,
    db: Optional[float] = None,
    min_history: Optional[int] = None,
) -> List[Dict]:
    """Judge a candidate bank digest's ``kind=quality`` records
    against the LIVE history under the same ledger key (every record
    whose ``digest`` differs — the scores the currently-published
    banks accrued). The perf_gate verdict shape: one dict per key the
    candidate appears under, ``ok`` False only for a judged
    regression, ``skipped`` True while the live history is thinner
    than ``min_history`` (a young observatory passes trivially)."""
    from ..analysis import ledger as _ledger

    if min_history is None:
        min_history = _env.env_int("CCSC_PERF_GATE_MIN_HISTORY")
    bank_key = None if bank_id is None else (bank_id or "default")
    verdicts: List[Dict] = []
    for key, rows in sorted(led.by_key().items()):
        rows = [r for r in rows if r.get("kind") == "quality"]
        cand = [
            r for r in rows if r.get("digest") == candidate_digest
        ]
        if not cand:
            continue
        if bank_key is not None and (
            (cand[-1].get("knobs") or {}).get("bank") != bank_key
        ):
            continue
        live = [
            float(r["value"])
            for r in rows
            if r.get("digest") != candidate_digest
        ]
        newest = cand[-1]
        v = float(newest["value"])
        band = quality_band(live, mad_k=mad_k, db=db)
        if band is None or band["n"] < min_history:
            verdicts.append(
                {
                    "key": key,
                    "digest": candidate_digest,
                    "value": v,
                    "unit": "db",
                    "n_history": 0 if band is None else band["n"],
                    "skipped": True,
                    "ok": True,
                    "reason": f"live history < {min_history} "
                    "record(s)",
                }
            )
            continue
        verdicts.append(
            {
                "key": key,
                "digest": candidate_digest,
                "value": v,
                "unit": "db",
                "n_history": band["n"],
                "median": band["median"],
                "mad": band["mad"],
                "lo": band["lo"],
                "delta_db": round(v - band["median"], 4),
                "skipped": False,
                "ok": v >= band["lo"],
                "t": newest.get("t"),
                "source": newest.get("source"),
            }
        )
    return verdicts


def gate_publish(
    candidate_digest: str,
    bank_id: Optional[str] = None,
    ledger_path: Optional[str] = None,
) -> Optional[List[Dict]]:
    """The opt-in publish guard: judge ``candidate_digest`` against
    the ledger's live quality history and RAISE
    :class:`QualityGateError` on a regression verdict. Returns the
    verdict list (None when the ledger is off/absent — nothing to
    judge is an allow, the young-observatory stance)."""
    from ..analysis import ledger as _ledger

    if ledger_path is None and not _ledger.enabled():
        return None
    led = _ledger.Ledger(ledger_path)
    verdicts = judge_candidate(
        led, candidate_digest, bank_id=bank_id
    )
    bad = [v for v in verdicts if not v["ok"]]
    if bad:
        worst = min(bad, key=lambda v: v.get("delta_db", 0.0))
        raise QualityGateError(
            f"bank {bank_id or '<default>'} candidate "
            f"{candidate_digest} regresses served quality: "
            f"{worst['value']:.2f} dB vs live band lo "
            f"{worst['lo']:.2f} dB (median "
            f"{worst['median']:.2f} dB over {worst['n_history']} "
            "record(s)) — refusing to publish "
            "(quality_check/CCSC_QUALITY_GATE)",
            verdicts=verdicts,
        )
    return verdicts
