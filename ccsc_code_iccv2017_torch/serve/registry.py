"""Bank identity and the per-bank plan LRU of the serving engine (the
torch port of ``ccsc_code_iccv2017_tpu.serve.registry``'s
``bank_digest`` and ``PlanCache``). The durable ``BankRegistry`` and
the plan cache's measured-memory sample (utils.memwatch, ported with the
run telemetry) belong to ROADMAP.md Queue 1 item 11."""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.reconstruct import _bank_digest

# the JAX package's default plan budget (CCSC_BANK_PLAN_CACHE_MB)
DEFAULT_PLAN_BYTES = 256_000_000


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


class PlanCache:
    """Bounded per-bank plan LRU, keyed by ``(d_digest, bucket_key)``.

    ``max_bytes`` bounds the summed device bytes of cached plans;
    insertion past the budget evicts least-recently-used entries,
    except the entry just added and entries whose digest is in ``pin``
    (the engine pins the digests of queued work). A miss is not fatal:
    the owner rebuilds the plan from the retained bank. Thread-safe
    (one lock; nothing blocking held under it)."""

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = max(
            1, int(DEFAULT_PLAN_BYTES if max_bytes is None else max_bytes)
        )
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

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "n_plans": len(self._entries),
                "plan_bytes": self.total_bytes,
                "max_bytes": self.max_bytes,
                "hits": self.n_hits,
                "misses": self.n_misses,
                "evictions": self.n_evictions,
            }
