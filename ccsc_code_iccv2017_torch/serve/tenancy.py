"""Tenancy runtime: per-tenant routing, quotas, and the weighted-fair
admission queue of the serving fleet.

Multi-tenant serving means one fleet carries MANY tenants' traffic —
each routing to its own bank (serve.registry), each with its own
declared latency band (serve.slo.TenantSlos) — and the failure mode
the layer exists for is noisy neighbors: one tenant's burst must get
its OWN explicit :class:`~.fleet.Overloaded` rejections while the
other tenants' latency bands hold. Two mechanisms, both declared per
tenant in :class:`~..config.TenantSpec`:

- **Quotas** — a per-tenant ceiling on QUEUED requests. Declared
  (``TenantSpec.quota``) or derived from the fleet's admission
  ceiling x the tenant's weight share x ``CCSC_TENANT_QUOTA_FRAC``
  (so quotas track a live serving_bound-derived ceiling without
  re-declaration). Enforced at fleet admission, before the global
  ceiling: a quota refusal is a ``tenant_reject`` event + Overloaded
  with the same retry-after contract, and it consumes NO shared queue
  capacity.
- **Weighted-fair dequeue** — :class:`WeightedFairScheduler` replaces
  the single FIFO with per-tenant deques drained by virtual-time fair
  queuing (each tenant's virtual clock advances by 1/weight per
  request taken; the lowest clock is served next). A tenant with
  nothing queued accrues no credit (its clock is brought up to the
  global floor on its next arrival — an idle tenant cannot bank a
  burst), FIFO order holds WITHIN a tenant, and requeued casualties
  go back to the front of their tenant's deque with their virtual
  cost refunded (they already paid for their turn).

The scheduler exposes the deque surface the fleet already speaks
(``append`` / ``appendleft`` / ``popleft`` / ``__len__`` /
``__iter__`` / ``clear``) so the queue swap is a data-structure
change, not a protocol change; it does NO locking of its own — every
method is called under the fleet's queue lock, same as the deque was.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Tuple

from ..config import TenantSpec
from ..utils import env as _env

__all__ = [
    "TenantSpec",
    "TenantTable",
    "WeightedFairScheduler",
    "parse_tenant_spec",
]


def parse_tenant_spec(spec: str) -> TenantSpec:
    """Parse a CLI/ops tenant spec string into a
    :class:`~..config.TenantSpec`:

        NAME[:key=value,...]   keys: bank, p50, p99, quota, weight,
                               deadline

    e.g. ``mobile:bank=bank-mobile,p99=250,quota=16,weight=2,
    deadline=2000``. Shared by ``apps/serve.py --tenant`` so the
    grammar cannot drift between surfaces."""
    name, _, rest = spec.partition(":")
    name = name.strip()
    kw: Dict[str, object] = {}
    keys = {
        "bank": ("bank_id", str),
        "p50": ("slo_p50_ms", float),
        "p99": ("slo_p99_ms", float),
        "quota": ("quota", int),
        "weight": ("weight", float),
        "deadline": ("deadline_ms", float),
    }
    for part in filter(None, (p.strip() for p in rest.split(","))):
        k, eq, v = part.partition("=")
        if not eq or k.strip() not in keys:
            raise ValueError(
                f"tenant spec {spec!r}: bad entry {part!r} (expected "
                f"key=value with key in {sorted(keys)})"
            )
        field, conv = keys[k.strip()]
        try:
            kw[field] = conv(v.strip())
        except ValueError:
            raise ValueError(
                f"tenant spec {spec!r}: {k.strip()}={v.strip()!r} is "
                f"not a valid {conv.__name__}"
            )
    return TenantSpec(tenant=name, **kw)  # type: ignore[arg-type]


class TenantTable:
    """The fleet's declared-tenant lookup: specs by name, bank
    routing, and quota resolution against a (possibly live-derived)
    admission ceiling. Immutable after construction; every method is
    cheap and lock-free (the fleet reads it under its own lock)."""

    def __init__(self, specs: Optional[Tuple[TenantSpec, ...]]):
        self.specs: Dict[str, TenantSpec] = {
            s.tenant: s for s in (specs or ())
        }
        self._total_weight = sum(
            s.weight for s in self.specs.values()
        ) or 1.0
        self._quota_frac = float(
            _env.env_float("CCSC_TENANT_QUOTA_FRAC")
        )

    def __bool__(self) -> bool:
        return bool(self.specs)

    def __contains__(self, tenant: Optional[str]) -> bool:
        return tenant in self.specs

    def get(self, tenant: Optional[str]) -> Optional[TenantSpec]:
        return self.specs.get(tenant) if tenant is not None else None

    def names(self) -> List[str]:
        return list(self.specs)

    def check(self, tenant: Optional[str]) -> None:
        """Refuse an UNKNOWN tenant name when tenants are declared —
        a typo'd tenant silently served untenanted would bypass its
        quota and SLO accounting. ``None`` (untenanted traffic) is
        always admitted."""
        from ..utils import validate

        if tenant is None or not self.specs:
            return
        if tenant not in self.specs:
            raise validate.CCSCInputError(
                f"unknown tenant {tenant!r} — declared tenants: "
                f"{sorted(self.specs)} (untenanted requests pass "
                "tenant=None)"
            )

    def route(
        self, tenant: Optional[str], bank_id: Optional[str]
    ) -> Optional[str]:
        """Effective bank id of one request: an explicit request
        ``bank_id`` wins, else the tenant's declared default, else
        None (the fleet's pinned default bank)."""
        if bank_id is not None:
            return bank_id
        spec = self.get(tenant)
        return spec.bank_id if spec is not None else None

    def weight(self, tenant: Optional[str]) -> float:
        spec = self.get(tenant)
        return spec.weight if spec is not None else 1.0

    def quota(
        self, tenant: Optional[str], ceiling: int
    ) -> Optional[int]:
        """The tenant's queued-request quota: declared, or derived as
        ``ceil(ceiling x weight_share x CCSC_TENANT_QUOTA_FRAC)``
        (floored at 1 so a declared tenant can always queue
        something). None for untenanted traffic — the global ceiling
        is its only bound."""
        spec = self.get(tenant)
        if spec is None:
            return None
        if spec.quota is not None:
            return spec.quota
        share = spec.weight / self._total_weight
        return max(1, int(ceiling * share * self._quota_frac + 0.999))


class WeightedFairScheduler:
    """Virtual-time weighted-fair queue over per-tenant deques.

    Drop-in for the fleet's ``deque`` front queue: ``append`` reads
    the item's ``tenant`` attribute, ``popleft`` returns the next
    item under weighted-fair order (min virtual time; FIFO within a
    tenant), ``appendleft`` is the requeue path (front of the
    tenant's deque, virtual cost refunded). NOT thread-safe by
    itself — every call happens under the fleet's queue lock, exactly
    like the deque it replaces."""

    def __init__(self, table: Optional[TenantTable] = None):
        self._table = table or TenantTable(None)
        self._queues: Dict[Optional[str], Deque] = {}
        self._vt: Dict[Optional[str], float] = {}
        self._vt_floor = 0.0
        self._n = 0

    def _cost(self, tenant: Optional[str]) -> float:
        return 1.0 / self._table.weight(tenant)

    def _lane(self, tenant: Optional[str]) -> Deque:
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
        return q

    def append(self, item) -> None:
        tenant = getattr(item, "tenant", None)
        q = self._lane(tenant)
        if not q:
            # an idle tenant re-enters at the global floor: it cannot
            # have banked credit while absent (no burst head start),
            # and it is not penalized for having been idle either
            self._vt[tenant] = max(
                self._vt.get(tenant, 0.0), self._vt_floor
            )
        q.append(item)
        self._n += 1

    def appendleft(self, item) -> None:
        """Requeue path: front of the tenant's lane (the request
        already waited its turn once) with the virtual cost refunded
        so the retry is not billed as a second serving."""
        tenant = getattr(item, "tenant", None)
        q = self._lane(tenant)
        if not q:
            self._vt[tenant] = max(
                self._vt.get(tenant, 0.0), self._vt_floor
            )
        self._vt[tenant] = max(
            0.0, self._vt.get(tenant, 0.0) - self._cost(tenant)
        )
        q.appendleft(item)
        self._n += 1

    def popleft(self):
        """Next item under weighted-fair order; raises ``IndexError``
        when empty (deque contract)."""
        best: Optional[Tuple[float, Optional[str]]] = None
        for tenant, q in self._queues.items():
            if not q:
                continue
            vt = self._vt.get(tenant, 0.0)
            key = (vt, "" if tenant is None else tenant)
            if best is None or key < (
                best[0], "" if best[1] is None else best[1]
            ):
                best = (vt, tenant)
        if best is None:
            raise IndexError("pop from an empty scheduler")
        _vt, tenant = best
        item = self._queues[tenant].popleft()
        self._n -= 1
        self._vt[tenant] = self._vt.get(tenant, 0.0) + self._cost(
            tenant
        )
        self._vt_floor = max(self._vt_floor, _vt)
        return item

    def depth_of(self, tenant: Optional[str]) -> int:
        q = self._queues.get(tenant)
        return len(q) if q is not None else 0

    def depths(self) -> Dict[Optional[str], int]:
        return {
            t: len(q) for t, q in self._queues.items() if q
        }

    def clear(self) -> None:
        for q in self._queues.values():
            q.clear()
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __iter__(self) -> Iterator:
        # tenant-grouped iteration order; consumers (close-time
        # failure sweep) treat the queue as a set, not an order
        for q in self._queues.values():
            yield from q
