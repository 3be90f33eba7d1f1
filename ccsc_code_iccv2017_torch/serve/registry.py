"""Multi-tenant bank registry: durable bank manifests and the bounded
per-bank plan LRU of the serving engine (the torch port of
``ccsc_code_iccv2017_tpu.serve.registry``).

- :class:`BankRegistry` — durable bank manifests on disk. Each
  ``publish`` content-addresses the bank array into ``banks/<sha>.npy``
  (atomic tmp+rename; identical banks across publishes are stored
  once) and appends one manifest record to ``manifest.jsonl`` with the
  ``analysis.ledger`` torn-tail stance: one flushed line per record, a
  reader (:meth:`BankRegistry.resolve`) drops a torn trailing line
  instead of failing the registry. A manifest carries the bank id, the
  sha256 ``d_digest`` (the fingerprint ``models.reconstruct.ReconPlan``
  refuses stale plans by), the full payload sha, the geometry (filter
  count + support) and free tenant metadata, so a consumer can refuse a
  bank whose geometry does not match its pinned problem before any plan
  builds. Latest record per bank id wins; the full history stays
  readable (:meth:`BankRegistry.history`). The on-disk format is the
  JAX package's byte for byte: each package reads a registry the other
  wrote.
- :class:`PlanCache` — the per-bank plan LRU, keyed by
  ``(d_digest, bucket)`` and bounded in BYTES (the summed ``nbytes`` of
  a plan's tensors) against a budget (``CCSC_BANK_PLAN_CACHE_MB``),
  with the measured device-memory watermark (``utils.memwatch``)
  sampled at every build. A miss rebuilds from the retained bank bytes.

Zero-downtime hot-swap rides these two pieces: re-publishing a bank id
under a new digest makes the engine build the new digest's plans off
the hot path; in-flight requests finish on the old plan (they bound
their digest at admission), and the route flip is one dict write under
the queue lock (serve.engine / serve.fleet).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.reconstruct import _bank_digest
from ..utils import env as _env
from ..utils import obs as _obs

__all__ = [
    "BankRegistry",
    "BankManifest",
    "PlanCache",
    "bank_digest",
    "plan_nbytes",
    "resolve_registry_dir",
]

_MANIFEST_NAME = "manifest.jsonl"
_BANK_DIR = "banks"
_SCHEMA = 1


def resolve_registry_dir(explicit: Optional[str]) -> Optional[str]:
    """The one resolution chain for the registry location: an explicit
    path wins, else ``CCSC_BANK_REGISTRY``, else no registry (None).
    Shared by apps/serve.py and any publisher so the two cannot
    diverge (the ``resolve_capture_dir`` convention)."""
    if explicit == "":
        return None
    return explicit or _env.env_str("CCSC_BANK_REGISTRY") or None


def bank_digest(d) -> str:
    """Content fingerprint of a dictionary bank: the ``d_digest`` every
    :class:`~..models.reconstruct.ReconPlan` carries, and the same
    sha256 as the JAX package's for the same float32 bank."""
    return _bank_digest(d)


def plan_nbytes(plan) -> int:
    """Device bytes a plan pins: the summed ``nbytes`` of its distinct
    tensors (filter spectra and the z-solve factors; without a blur the
    clean and solve spectra are one tensor, counted once)."""
    tensors = [plan.dhat_clean, plan.dhat_solve, *plan.kern]
    seen = {id(t): t for t in tensors if torch.is_tensor(t)}
    return sum(t.numel() * t.element_size() for t in seen.values())


class BankManifest(Dict[str, Any]):
    """One manifest record (a plain dict subclass so readers can use
    ``rec["digest"]`` / ``rec.get("tenant")`` uniformly); declared
    keys: ``bank_id``, ``digest`` (the plan-refusal ``d_digest``),
    ``sha256`` (full payload sha), ``path`` (bank array on disk),
    ``geometry`` ({num_filters, spatial_support, reduce_shape}),
    ``tenant``, ``seq``, ``t``."""


class BankRegistry:
    """Durable bank manifests + content-addressed bank store.

    Thread-safe: ``publish`` may be called from any thread (an online
    learner publishing while a server resolves); the manifest append
    and the seq counter are ordered by a private lock, the array write
    is atomic (tmp + rename) and happens outside it.

    ``emit`` is an optional obs-event callable (``run.event``-shaped):
    when given, every publish is announced as a ``bank_publish``
    event. The registry itself never routes traffic — engines/fleets
    load banks from it and own the serving-side routing table.
    """

    def __init__(self, path: str, emit=None):
        self.path = path
        self._emit = emit
        self._lock = threading.Lock()
        os.makedirs(os.path.join(path, _BANK_DIR), exist_ok=True)
        # resume-aware: a registry reopened on an existing dir
        # continues the publish sequence after the newest durable
        # record (torn tail dropped by the reader)
        self._seq = max(
            (int(r.get("seq", 0)) for r in self._read_manifest()),
            default=0,
        )
        self._writer = _obs.EventWriter(
            os.path.join(path, _MANIFEST_NAME)
        )

    # -- read side ----------------------------------------------------
    def _read_manifest(self) -> List[BankManifest]:
        return [
            BankManifest(r)
            for r in _obs.read_events(
                os.path.join(self.path, _MANIFEST_NAME)
            )
            if r.get("bank_id") and r.get("digest")
        ]

    def bank_ids(self) -> List[str]:
        """Every bank id ever published, insertion order, deduped."""
        seen: Dict[str, None] = {}
        for rec in self._read_manifest():
            seen.setdefault(rec["bank_id"], None)
        return list(seen)

    def history(self, bank_id: str) -> List[BankManifest]:
        """Every manifest record for ``bank_id``, oldest first — the
        swap history (old -> new digests with publish timestamps)."""
        return [
            r for r in self._read_manifest()
            if r["bank_id"] == bank_id
        ]

    def previous(self, bank_id: str) -> Optional[BankManifest]:
        """The manifest published immediately BEFORE the current one
        for ``bank_id`` — the rollback target a quality demotion
        advisory (``quality_demote_advice``) points back to. Skips
        records carrying the same digest as the head (a refresh
        republish must not become its own rollback target). None when
        the bank has no distinct prior digest."""
        hist = self.history(bank_id)
        if not hist:
            return None
        head = hist[-1]["digest"]
        for rec in reversed(hist[:-1]):
            if rec["digest"] != head:
                return rec
        return None

    def resolve(self, bank_id: str) -> BankManifest:
        """The NEWEST manifest for ``bank_id`` (latest record wins —
        re-publishing a bank id under a new digest is the hot-swap
        trigger). Raises ``CCSCInputError`` for an unknown id, with
        the known ids in the message."""
        from ..utils import validate

        hist = self.history(bank_id)
        if not hist:
            raise validate.CCSCInputError(
                f"bank id {bank_id!r} is not in the registry at "
                f"{self.path} (known: {self.bank_ids() or 'none'})"
            )
        return hist[-1]

    def load(self, bank_id: str) -> Tuple[np.ndarray, BankManifest]:
        """Load the newest published bank array for ``bank_id``
        (refusing a store whose bytes drifted from the manifest
        digest — a torn or hand-edited payload must never serve)."""
        from ..utils import validate

        man = self.resolve(bank_id)
        arr = np.load(os.path.join(self.path, man["path"]))
        if bank_digest(arr) != man["digest"]:
            raise validate.CCSCInputError(
                f"bank {bank_id!r} payload {man['path']} does not "
                f"match its manifest digest {man['digest']} — the "
                "store is corrupt; re-publish the bank"
            )
        return arr, man

    # -- write side ---------------------------------------------------
    def publish(
        self,
        bank_id: str,
        d,
        tenant: Optional[str] = None,
        geom=None,
        **meta,
    ) -> BankManifest:
        """Durably publish (or re-publish) ``bank_id`` as the bank
        array ``d``. Content-addressed: identical bytes are stored
        once; a re-publish under a NEW digest is what downstream
        consumers treat as the hot-swap trigger. ``geom`` (a
        ``ProblemGeom``) pins the recorded reduce/spatial split for
        families with reduce axes; without it the trailing two axes
        are recorded as spatial (the 2D families). Returns the
        appended manifest."""
        import hashlib

        arr = np.ascontiguousarray(np.asarray(d, np.float32))
        digest = bank_digest(arr)
        full = hashlib.sha256(arr.tobytes()).hexdigest()
        rel = os.path.join(_BANK_DIR, f"{digest}.npy")
        fpath = os.path.join(self.path, rel)
        if not os.path.exists(fpath):
            tmp = fpath + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, fpath)
        if geom is not None:
            geometry = {
                "num_filters": int(arr.shape[0]),
                "reduce_shape": list(geom.reduce_shape),
                "spatial_support": list(geom.spatial_support),
            }
        else:
            geometry = {
                "num_filters": int(arr.shape[0]),
                "reduce_shape": list(arr.shape[1:-2]),
                "spatial_support": list(arr.shape[-2:]),
            }
        rec = BankManifest(
            schema=_SCHEMA,
            bank_id=str(bank_id),
            digest=digest,
            sha256=full,
            path=rel,
            geometry=geometry,
            tenant=tenant,
            t=time.time(),
            **meta,
        )
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._writer.write(dict(rec))
        if self._emit is not None:
            self._emit(
                "bank_publish",
                bank_id=rec["bank_id"],
                digest=digest,
                seq=rec["seq"],
                tenant=tenant,
                registry=self.path,
            )
        return rec

    def close(self) -> None:
        with self._lock:
            self._writer.close()

    def __enter__(self) -> "BankRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PlanCache:
    """Bounded per-bank plan LRU, keyed by ``(d_digest, bucket_key)``.

    ``max_bytes`` bounds the summed device bytes of cached plans
    (default ``CCSC_BANK_PLAN_CACHE_MB``); insertion past the budget
    evicts least-recently-used entries, except the entry just added and
    entries whose digest is in ``pin`` (the engine pins the digests of
    queued work). A miss is not fatal: the owner rebuilds the plan from
    the retained bank. The measured device-memory watermark
    (``utils.memwatch.MemWatch``) is sampled on every ``put`` and
    carried in the stats, beside the budget the cache enforces.
    Thread-safe (one lock; nothing blocking held under it)."""

    def __init__(self, max_bytes: Optional[int] = None, memwatch=None):
        if max_bytes is None:
            max_bytes = int(float(_env.env_float("CCSC_BANK_PLAN_CACHE_MB"))
                            * 1e6)
        self.max_bytes = max(1, int(max_bytes))
        if memwatch is None:
            from ..utils import memwatch as _memwatch

            memwatch = _memwatch.MemWatch()
        self._memwatch = memwatch
        self._lock = threading.Lock()
        # key -> (plan, nbytes); dict order is recency (get re-inserts)
        self._entries: Dict[Tuple[str, Any], Tuple[Any, int]] = {}
        self.total_bytes = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_evictions = 0

    def get(self, digest: str, bucket) -> Optional[Any]:
        """The cached plan for ``(digest, bucket)`` or None."""
        key = (digest, bucket)
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                self.n_misses += 1
                return None
            self._entries[key] = entry  # re-insert: newest
            self.n_hits += 1
            return entry[0]

    def put(
        self, digest: str, bucket, plan, pin: Optional[set] = None,
    ) -> List[Tuple[str, Any]]:
        """Insert a plan and evict past the budget; returns the evicted
        ``(digest, bucket)`` keys."""
        nbytes = plan_nbytes(plan)
        self._memwatch.sample()
        evicted: List[Tuple[str, Any]] = []
        with self._lock:
            old = self._entries.pop((digest, bucket), None)
            if old is not None:
                self.total_bytes -= old[1]
            self._entries[(digest, bucket)] = (plan, nbytes)
            self.total_bytes += nbytes
            for key in list(self._entries):
                if self.total_bytes <= self.max_bytes:
                    break
                if key == (digest, bucket) or (pin and key[0] in pin):
                    continue
                _plan, nb = self._entries.pop(key)
                self.total_bytes -= nb
                self.n_evictions += 1
                evicted.append(key)
        return evicted

    def drop_digest(self, digest: str) -> List[Tuple[str, Any]]:
        """Evict every bucket's plan for one digest (a retired bank)."""
        dropped: List[Tuple[str, Any]] = []
        with self._lock:
            for key in list(self._entries):
                if key[0] == digest:
                    _plan, nb = self._entries.pop(key)
                    self.total_bytes -= nb
                    self.n_evictions += 1
                    dropped.append(key)
        return dropped

    def digests(self) -> List[str]:
        with self._lock:
            out: Dict[str, None] = {}
            for dg, _bucket in self._entries:
                out.setdefault(dg, None)
            return list(out)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "n_plans": len(self._entries),
                "plan_bytes": self.total_bytes,
                "max_bytes": self.max_bytes,
                "hits": self.n_hits,
                "misses": self.n_misses,
                "evictions": self.n_evictions,
            }
        # the measured watermark next to the enforced budget
        out["measured_peak_hbm_bytes"] = self._memwatch.peak_bytes
        return out


def render_manifest(rec: BankManifest) -> str:
    """One-line human rendering of a manifest (apps/serve.py and the
    TENANTS report section share it)."""
    geo = rec.get("geometry") or {}
    return (
        f"{rec.get('bank_id')} @ {rec.get('digest')} "
        f"(K={geo.get('num_filters')}, support "
        f"{'x'.join(str(s) for s in geo.get('spatial_support') or [])}"
        + (f", tenant {rec['tenant']}" if rec.get("tenant") else "")
        + f", seq {rec.get('seq')})"
    )


def _json_default(o):  # pragma: no cover - defensive serialization
    return str(o)


def manifest_json(rec: BankManifest) -> str:
    return json.dumps(dict(rec), default=_json_default)
