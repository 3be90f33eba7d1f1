"""Workload capture: durably record every admitted serving request (a
copy of ``ccsc_code_iccv2017_tpu.serve.capture``: the same layout,
records and readers, so either package reads the other's capture).

:class:`WorkloadRecorder` records the WORKLOAD itself — what bytes
arrived, when, and what the engine answered — so yesterday's traffic
can be re-served against tomorrow's engine and its answers checked.
Hooked into a standalone ``CodecEngine`` or the ``ServeFleet``'s
admission boundary, it appends one record per
admitted request to an
append-only JSONL segment with the ledger's torn-tail durability
stance, content-addresses every payload array by sha256 into a
shared ``payloads/`` store (identical arrays across requests are
stored once), and pairs each request with its outcome digest —
sha256 of the delivered reconstruction bytes — plus valid-region
PSNR and latency. Because the serving stack is deterministic
(identical request bytes through identical bucket programs reproduce
identical results), a captured stream is a bit-checkable oracle: a
replay re-submits it and verifies outcomes, not just load.

Capture-dir layout::

    capture_dir/
      meta.json            # capture identity + final counters (atomic)
      requests-0000.jsonl  # request/outcome records, segment-rotated
      payloads.jsonl       # payload index: sha -> shape/dtype/bytes
      payloads/<sha>.npy   # content-addressed arrays (deduplicated)

Knobs (``CCSC_CAPTURE_*``, utils.env): ``CCSC_CAPTURE_DIR`` arms
capture on any fleet/standalone engine without a config change;
``CCSC_CAPTURE_SAMPLE`` records a deterministic per-key fraction of
the stream (outcome records follow their request's verdict, so a
sampled capture is still pairable); ``CCSC_CAPTURE_ROTATE_MB`` bounds
segment size — a long-lived fleet rotates to a fresh segment instead
of growing one file forever (:func:`read_workload` merges segments in
name order; note ``obs.EventTail`` filters on ``events*.jsonl`` and
does NOT see these ``requests-*.jsonl`` files — tail a live capture
by re-running ``read_workload``, which is cheap per segment).

Overhead is accounted, not guessed: every second spent hashing and
writing is accumulated and reported in the ``capture_summary`` obs
event (plus per-request mean), so "capture is cheap" is a measured
claim in the stream.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils import env as _env
from ..utils import obs as _obs

__all__ = [
    "WorkloadRecorder",
    "resolve_capture_dir",
    "payload_sha",
    "read_workload",
    "read_payload_index",
    "load_payload",
]

_SCHEMA = 1
_SEGMENT_FMT = "requests-{:04d}.jsonl"
_INDEX_NAME = "payloads.jsonl"
_PAYLOAD_DIR = "payloads"
_ARRAY_FIELDS = ("b", "mask", "smooth_init", "x_orig")


def resolve_capture_dir(explicit: Optional[str]) -> Optional[str]:
    """The one resolution chain for the capture switch: an explicit
    config path wins, else ``CCSC_CAPTURE_DIR``, else capture is off
    (None). An explicit EMPTY STRING is "off regardless of the env"
    — the replay driver's fresh fleets use it so a replay run in a
    shell with ``CCSC_CAPTURE_DIR`` still armed can never re-capture
    itself into the directory being replayed. Shared by the fleet and
    the standalone engine so the two cannot diverge."""
    if explicit == "":
        return None
    return explicit or _env.env_str("CCSC_CAPTURE_DIR") or None


def payload_sha(arr: np.ndarray) -> str:
    """Content address of one payload array: sha256 over a dtype/shape
    header plus the raw bytes — two arrays with identical bytes but
    different shapes (a flattened copy) must not collide."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(f"{a.dtype.str}|{a.shape}|".encode("utf-8"))
    h.update(a.tobytes())
    return h.hexdigest()


def _sample_admits(key: str, sample: float) -> bool:
    """Deterministic per-key sampling verdict: the same key always
    lands on the same side, so a request's outcome record can never be
    captured without its request (or vice versa), and a re-capture of
    the same stream samples identically."""
    if sample >= 1.0:
        return True
    if sample <= 0.0:
        return False
    digest = hashlib.sha256(key.encode("utf-8")).digest()
    frac = int.from_bytes(digest[:8], "big") / float(1 << 64)
    return frac < sample


class WorkloadRecorder:
    """Durable request/outcome recorder for one serving session.

    Thread-safe: ``record_submit`` runs on submitter threads and
    ``record_outcome`` on replica worker threads; a private lock
    orders the segment appends (sha256 hashing — the expensive part —
    happens OUTSIDE it). All file I/O uses the append-only JSONL
    stance of :class:`~..utils.obs.EventWriter`: one flushed line per
    record, a torn trailing line from a killed writer is terminated
    before the next append, and readers drop torn lines instead of
    failing the stream.

    ``emit`` is an optional obs-event callable (``run.event``-shaped);
    when given, the recorder announces itself (``capture_start``),
    each segment rotation (``capture_rotate``), and its close-time
    accounting (``capture_summary`` — request/payload counts, dedup
    hits, total bytes, and the measured capture overhead).
    """

    def __init__(
        self,
        path: str,
        sample: Optional[float] = None,
        rotate_mb: Optional[float] = None,
        emit=None,
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.path = path
        self.sample = (
            float(sample)
            if sample is not None
            else float(_env.env_float("CCSC_CAPTURE_SAMPLE"))
        )
        rotate = (
            float(rotate_mb)
            if rotate_mb is not None
            else float(_env.env_float("CCSC_CAPTURE_ROTATE_MB"))
        )
        self.rotate_bytes = max(1, int(rotate * 1e6))
        self._emit = emit
        self._lock = threading.Lock()
        self.t0 = time.time()
        self._t0_perf = time.perf_counter()
        self.n_requests = 0
        self.n_outcomes = 0
        self.n_sampled_out = 0
        self.n_payloads = 0
        self.n_dedup_hits = 0
        self.payload_bytes = 0
        self.overhead_s = 0.0
        self.n_errors = 0
        self._closed = False
        self._broken = False
        # capture-session identity, stamped on every record: a
        # recorder reopened on the same dir (a restarted fleet)
        # starts a NEW session, and read_workload pairs outcomes by
        # (session, key) — so a second session re-using the same
        # idempotency keys (auto-keys restart at req-00000001 per
        # fleet) can never weld its requests onto an earlier
        # session's outcomes
        self.session = os.urandom(6).hex()
        os.makedirs(os.path.join(path, _PAYLOAD_DIR), exist_ok=True)
        # resume-aware: a recorder re-opened on an existing capture dir
        # (a restarted fleet) continues the segment sequence and trusts
        # the existing payload store (content addressing makes the
        # dedup index rebuildable from the torn-tolerant index file)
        self._known_shas = set(read_payload_index(path))
        self._segment = self._next_segment_index()
        self._writer = _obs.EventWriter(self._segment_path())
        self._index = _obs.EventWriter(
            os.path.join(path, _INDEX_NAME)
        )
        self._extra_meta: Dict[str, Any] = dict(meta or {})
        self._write_meta(status="open")
        if self._emit is not None:
            self._emit(
                "capture_start",
                path=self.path,
                sample=self.sample,
                rotate_bytes=self.rotate_bytes,
                segment=self._segment,
            )

    # -- internals -----------------------------------------------------
    def _segment_path(self) -> str:
        return os.path.join(self.path, _SEGMENT_FMT.format(self._segment))

    def _next_segment_index(self) -> int:
        try:
            existing = [
                n for n in os.listdir(self.path)
                if n.startswith("requests-") and n.endswith(".jsonl")
            ]
        except OSError:
            return 0
        return len(existing)

    def _write_meta(self, status: str) -> None:
        """Atomic meta rewrite (tmp + rename): the meta file is the
        capture's identity + final counters, and a reader must never
        see a torn JSON document."""
        meta = {
            "schema": _SCHEMA,
            "t0": self.t0,
            "status": status,
            "sample": self.sample,
            "n_requests": self.n_requests,
            "n_outcomes": self.n_outcomes,
            "n_sampled_out": self.n_sampled_out,
            "n_payloads": self.n_payloads,
            "payload_bytes": self.payload_bytes,
            "n_errors": self.n_errors,
            "broken": self._broken,
            "session": self.session,
            "git_sha": _obs.git_sha(),
        }
        meta.update(self._extra_meta)
        tmp = os.path.join(self.path, "meta.json.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(meta, f, default=str)
        os.replace(tmp, os.path.join(self.path, "meta.json"))

    def _store_payload(self, arr: Optional[np.ndarray]) -> Optional[str]:
        """Content-addressed store of one array; returns its sha (or
        None for an absent optional payload). Dedup across requests:
        an already-stored sha costs one set lookup."""
        if arr is None:
            return None
        arr = np.ascontiguousarray(arr)
        sha = payload_sha(arr)
        with self._lock:
            if self._closed:
                # racing a close(): drop rather than write through a
                # closed index writer
                return sha
            if sha in self._known_shas:
                self.n_dedup_hits += 1
                return sha
            self._known_shas.add(sha)
        fpath = os.path.join(self.path, _PAYLOAD_DIR, sha + ".npy")
        tmp = fpath + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, fpath)
        nbytes = os.path.getsize(fpath)
        self._index.write(
            {
                "sha": sha,
                "shape": list(arr.shape),
                "dtype": arr.dtype.str,
                "bytes": nbytes,
            }
        )
        with self._lock:
            self.n_payloads += 1
            self.payload_bytes += nbytes
        return sha

    def _append(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if self._closed:
                return
            self._writer.write(rec)
            try:
                size = os.path.getsize(self._segment_path())
            except OSError:
                size = 0
            if size < self.rotate_bytes:
                return
            # rotate: close the full segment, open the next —
            # read_workload merges segments by name order, so a new
            # segment appearing mid-capture is picked up on the next
            # read
            self._writer.close()
            self._segment += 1
            self._writer = _obs.EventWriter(self._segment_path())
            segment = self._segment
        if self._emit is not None:
            self._emit(
                "capture_rotate",
                path=self.path,
                segment=segment,
            )

    # -- recording -----------------------------------------------------
    def record_submit(
        self,
        key: str,
        trace_id: Optional[str],
        b: np.ndarray,
        mask: Optional[np.ndarray] = None,
        smooth_init: Optional[np.ndarray] = None,
        x_orig: Optional[np.ndarray] = None,
        bucket: Optional[str] = None,
        solve: Optional[Dict[str, Any]] = None,
        t_rel: Optional[float] = None,
        bank_id: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> None:
        """Record one ADMITTED request: relative arrival time, identity
        (idempotency key + trace id), shape/bucket, solve params,
        multi-tenant routing (``bank_id``/``tenant`` — so a
        mixed-tenant capture replays each request against ITS bank,
        per-bank digest parity intact), and the four payload arrays
        content-addressed into the store. ``t_rel`` overrides the
        wall-clock arrival offset — synthetic generators stamp curve
        time, not generation time.

        NEVER raises: the recorder sits on the serving hot path
        (fleet ``submit``/``_deliver``, the engine worker loop), and
        a capture I/O failure — disk full, a racing close — must
        degrade capture, not kill a healthy replica or surface a
        traceback to a client whose request was already admitted.
        The first failure marks the recorder broken (recording
        stops) and is announced with a ``capture_error`` event."""
        if self._closed or self._broken:
            return
        t_in = time.perf_counter()
        try:
            if not _sample_admits(key, self.sample):
                with self._lock:
                    self.n_sampled_out += 1
                return
            rec = {
                "kind": "request",
                "session": self.session,
                "key": key,
                "trace_id": trace_id,
                "t_rel": round(
                    time.time() - self.t0 if t_rel is None else t_rel,
                    6,
                ),
                "spatial": list(np.shape(b)),
                "bucket": bucket,
                "bank_id": bank_id,
                "tenant": tenant,
                "b": self._store_payload(b),
                "mask": self._store_payload(mask),
                "smooth_init": self._store_payload(smooth_init),
                "x_orig": self._store_payload(x_orig),
            }
            if solve:
                rec["solve"] = solve
            self._append(rec)
        except Exception as e:
            self._mark_broken(e)
            return
        dt = time.perf_counter() - t_in
        with self._lock:
            self.n_requests += 1
            self.overhead_s += dt

    def record_outcome(
        self,
        key: str,
        recon: np.ndarray,
        psnr: Optional[float],
        latency_ms: float,
        bucket: str,
        iters: Optional[int] = None,
    ) -> None:
        """Record one delivered result: the outcome digest (sha256 of
        the reconstruction bytes — the bit-parity oracle replay checks
        against), valid-region PSNR, and client-visible latency.

        ``psnr`` MUST be the shared
        :func:`serve.quality.valid_region_psnr` value (the engine's
        dispatch path computes exactly that) — replay's cross-bucket
        verifier and the shadow scorer recompute with the same
        function and compare against this recorded dB, rounded to
        6 decimals here (tests/test_quality.py pins the
        bit-equality). Never raises (same hot-path contract as
        :meth:`record_submit`)."""
        # the sampler's verdict is deterministic per key, so the
        # outcome follows its request's fate even when a worker
        # thread delivers before the submitter's record lands
        if self._closed or self._broken:
            return
        t_in = time.perf_counter()
        try:
            if not _sample_admits(key, self.sample):
                return
            rec = {
                "kind": "outcome",
                "session": self.session,
                "key": key,
                "t_rel": round(time.time() - self.t0, 6),
                "digest": payload_sha(np.asarray(recon)),
                "psnr": (
                    None if psnr is None else round(float(psnr), 6)
                ),
                "latency_ms": round(float(latency_ms), 3),
                "bucket": bucket,
                "iters": None if iters is None else int(iters),
            }
            self._append(rec)
        except Exception as e:
            self._mark_broken(e)
            return
        dt = time.perf_counter() - t_in
        with self._lock:
            self.n_outcomes += 1
            self.overhead_s += dt

    def _mark_broken(self, exc: Exception) -> None:
        """First capture failure: stop recording (a half-broken
        capture is worse than an honestly truncated one) and announce
        it in the stream — best-effort, the announcement itself must
        not raise either."""
        with self._lock:
            self.n_errors += 1
            first = not self._broken
            self._broken = True
        if first and self._emit is not None:
            try:
                self._emit(
                    "capture_error",
                    path=self.path,
                    error=f"{type(exc).__name__}: {exc}"[:300],
                )
            except Exception:
                pass

    # -- lifecycle -----------------------------------------------------
    def close(self, **final_meta) -> None:
        """Flush and seal the capture: final counters land in
        ``meta.json`` (plus any caller-supplied fields — the fleet
        passes its admission counters so replay can diff admission
        behavior) and the overhead accounting lands in the obs stream
        as ``capture_summary``."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._writer.close()
            self._index.close()
        self._extra_meta.update(final_meta)
        self._write_meta(status="closed")
        if self._emit is not None:
            n = max(1, self.n_requests)
            self._emit(
                "capture_summary",
                path=self.path,
                n_requests=self.n_requests,
                n_outcomes=self.n_outcomes,
                n_sampled_out=self.n_sampled_out,
                n_payloads=self.n_payloads,
                n_dedup_hits=self.n_dedup_hits,
                payload_bytes=self.payload_bytes,
                n_errors=self.n_errors,
                overhead_s=round(self.overhead_s, 6),
                overhead_ms_per_request=round(
                    1e3 * self.overhead_s / n, 4
                ),
                elapsed_s=round(
                    time.perf_counter() - self._t0_perf, 3
                ),
            )


# ---------------------------------------------------------------------
# read side (replay, reports, tests)
# ---------------------------------------------------------------------


def read_meta(path: str) -> Dict[str, Any]:
    """The capture's meta.json (empty dict when absent/corrupt)."""
    try:
        with open(
            os.path.join(path, "meta.json"), encoding="utf-8"
        ) as f:
            meta = json.load(f)
        return meta if isinstance(meta, dict) else {}
    except (OSError, ValueError):
        return {}


def read_payload_index(path: str) -> Dict[str, Dict[str, Any]]:
    """The payload index: sha -> {shape, dtype, bytes}. Torn-tolerant
    like every reader here — a torn final line (the crash window of
    the line-granular writer) is dropped, never fatal."""
    out: Dict[str, Dict[str, Any]] = {}
    for rec in _obs.read_events(os.path.join(path, _INDEX_NAME)):
        sha = rec.get("sha")
        if isinstance(sha, str):
            out[sha] = rec
    return out


def load_payload(path: str, sha: str) -> np.ndarray:
    return np.load(
        os.path.join(path, _PAYLOAD_DIR, sha + ".npy")
    )


def read_workload(path: str) -> List[Dict[str, Any]]:
    """Parse every segment into one request list in arrival order,
    each request dict carrying its paired ``outcome`` record (or None
    when the capture ended before delivery — a replay treats those as
    unverifiable but still re-serves them). Pairing is by
    ``(session, key)``: a restarted fleet re-recording auto-assigned
    keys like ``req-00000001`` into the same dir starts a new capture
    session, so its requests can never pick up an earlier session's
    outcome digests. Torn/corrupt lines are dropped; a duplicate
    outcome for one (session, key) keeps the first (the fleet's
    at-most-once delivery means duplicates are a capture-side anomaly
    worth tolerating, not propagating)."""
    requests: List[Dict[str, Any]] = []
    outcomes: Dict[Any, Dict[str, Any]] = {}
    try:
        names = sorted(
            n for n in os.listdir(path)
            if n.startswith("requests-") and n.endswith(".jsonl")
        )
    except OSError:
        return []
    for name in names:
        for rec in _obs.read_events(os.path.join(path, name)):
            kind = rec.get("kind")
            if kind == "request" and rec.get("key"):
                requests.append(rec)
            elif kind == "outcome" and rec.get("key"):
                outcomes.setdefault(
                    (rec.get("session"), rec["key"]), rec
                )
    for req in requests:
        req["outcome"] = outcomes.get(
            (req.get("session"), req["key"])
        )
    requests.sort(key=lambda r: r.get("t_rel", 0.0))
    return requests
