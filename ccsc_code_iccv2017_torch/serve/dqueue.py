"""Durable shared-filesystem work queue with lease-based ownership (a
copy of ``ccsc_code_iccv2017_tpu.serve.dqueue``: the same directory
layout, item, lease, host, result and spent records, byte for byte, so
a queue one package writes the other drains).

``ServeFleet`` survives replica death because its front queue outlives
any one replica — but that queue lives in ONE process, so a host kill
still loses the entire serving surface. This module is the queue one
level up: a directory on a shared filesystem is the only thing hosts
have in common (the parallel multi-block independence of the solves,
PAPERS.md arXiv:1312.3040 — work items share no state), and every
operation is a single atomic filesystem primitive, so whole-host death
is just an expired lease:

- **submit** writes payload arrays content-addressed into the capture
  payload store layout (``payloads/<sha>.npy``, sha256 over
  dtype/shape/bytes — :func:`~.capture.payload_sha`) and then the item
  record via tmp + ``os.replace`` into ``queue/``: a reader can never
  observe a torn request file, only absent-then-present.
- **claim** is one ``os.rename`` of the item file into the claiming
  host's ``leases/<host>/`` dir. POSIX rename has exactly one winner —
  concurrent claimers of the same item race on the rename and every
  loser gets ENOENT, no lock file, no coordinator. The winner then
  rewrites the record (atomically, inside its own lease dir) with the
  ownership stamp: host, the host's join **epoch**, claim time, and
  the incremented cross-host ``attempts`` count.
- **heartbeat** atomically rewrites ``hosts/<host>.json`` with the
  host's epoch and wall clock. A lease's TTL is judged against its
  owner's newest heartbeat — a live host mid-long-solve keeps its
  leases by heartbeating, without touching every lease file.
- **reap** (any host may run it) requeues items whose lease expired:
  the owner's heartbeat is older than ``ttl_s`` plus a clock-skew
  allowance (``skew_s`` — hosts share a filesystem, not a clock), or
  the owner rejoined under a newer epoch (its previous incarnation is
  dead no matter what the clock says), or the owner announced
  ``left``. Requeue is the same single rename back into ``queue/``
  under the item's ORIGINAL sequence name, so a handed-off item drains
  at the front — it already waited its turn. An item whose
  ``attempts`` already reached the budget is failed instead: an
  explicit error result, never a silent retry-forever
  (exactly-once-or-error, the fleet's delivery contract made
  cross-host).
- **complete / fail** write the result durably (reconstruction bytes
  content-addressed, digest + PSNR + latency in an atomically-written
  ``results/<key>.json``) and then mark the key **spent** with an
  ``O_EXCL`` marker create — the one decision point of the delivery
  race. A late straggler (a host that stalled mid-solve, lost its
  lease to the reaper, and woke after a survivor served the item) is
  fenced twice: its lease file is gone / its epoch is stale (checked
  before any result write), and the spent marker already exists (the
  atomic tiebreak if it raced the reaper). Spent keys STAY spent:
  ``submit`` of a spent key is refused, and claimers drop requeued
  copies of spent keys on the floor.

Durability stance = ``analysis/ledger.py``: every multi-byte write is
tmp + atomic replace, every read of a JSON record tolerates torn or
truncated bytes by treating the file as absent, and a reader of the
queue dirs never throws on concurrent renames happening under it.

This module touches no device: frontends and reapers use it on a
machine without a card. :mod:`serve.federation` builds the
serving layer on top — each host drains this queue into its in-process
:class:`~.fleet.ServeFleet`.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils import env as _env
from ..utils import trace as trace_util
from .capture import load_payload, payload_sha

__all__ = ["DurableQueue", "safe_key"]

_SCHEMA = 1
_QUEUE = "queue"
_LEASES = "leases"
_RESULTS = "results"
_SPENT = "spent"
_HOSTS = "hosts"
_PAYLOADS = "payloads"
_CORRUPT = "corrupt"
_SEALED = "SEALED"


def safe_key(key: str) -> str:
    """Filesystem name of one idempotency key: keys are
    client-provided strings and must not be trusted as path
    components, so result/spent files are named by digest."""
    return hashlib.sha256(key.encode("utf-8")).hexdigest()[:24]


def _read_json(path: str) -> Optional[Dict[str, Any]]:
    """One JSON record, or None when absent / torn / truncated /
    not-a-dict — a file a crashed writer (or a racing rename) left
    unreadable is treated as absent, never as an error."""
    try:
        with open(path, encoding="utf-8") as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


def _write_json(path: str, rec: Dict[str, Any]) -> None:
    """Atomic record write (tmp + replace, same dir so the rename
    never crosses filesystems): readers see the old bytes or the new
    bytes, never a tear."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=d)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(rec, f, default=str)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _publish_json(path: str, rec: Dict[str, Any]) -> bool:
    """Atomic FIRST-WINS record write: full bytes land under a tmp
    name, then ``os.link`` publishes them — which fails if the path
    already exists, so a racing loser can never overwrite the
    winner's record with a contradictory one (the result-file
    contract: whoever durably records an outcome first defines the
    client-visible one). Falls back to plain atomic replace on
    filesystems without hard links."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=d)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(rec, f, default=str)
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        except OSError:
            os.replace(tmp, path)
            tmp = None
            return True
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


class DurableQueue:
    """One handle on the shared queue directory, scoped to one host
    identity (``host``; frontends pass their client id — they submit
    and read results but never claim).

    Not thread-safe per handle by design EXCEPT for the read side:
    the federation layer drives claim/complete from one drain thread
    and heartbeat/reap from one beat thread, each through its own
    method set, and every mutation is a single atomic filesystem op —
    cross-PROCESS safety is the point, and it comes from rename/
    O_EXCL semantics, not Python locks.

    ``emit`` is an optional obs-event callable (``run.event``-shaped)
    announcing queue traffic (``dqueue_*`` events, declared in
    ``analysis/obs_schema.py``).
    """

    def __init__(
        self,
        path: str,
        host: str,
        emit=None,
        ttl_s: Optional[float] = None,
        skew_s: Optional[float] = None,
        max_attempts: Optional[int] = None,
    ):
        self.path = path
        self.host = host
        self.epoch = 0  # assigned by join()
        self.ttl_s = (
            float(ttl_s)
            if ttl_s is not None
            else float(_env.env_float("CCSC_DQUEUE_TTL_S"))
        )
        self.skew_s = (
            float(skew_s)
            if skew_s is not None
            else float(_env.env_float("CCSC_DQUEUE_SKEW_S"))
        )
        self.max_attempts = (
            int(max_attempts)
            if max_attempts is not None
            else int(_env.env_int("CCSC_DQUEUE_ATTEMPTS"))
        )
        self._emit = emit or (lambda type_, **fields: None)
        self._seq = 0
        self.n_claimed = 0
        self.n_completed = 0
        self.n_suppressed = 0
        for sub in (
            _QUEUE, _RESULTS, _SPENT, _HOSTS, _PAYLOADS, _CORRUPT,
        ):
            os.makedirs(os.path.join(path, sub), exist_ok=True)
        os.makedirs(self._lease_dir(host), exist_ok=True)

    # -- paths ---------------------------------------------------------
    def _lease_dir(self, host: str) -> str:
        return os.path.join(self.path, _LEASES, host)

    def _host_path(self, host: str) -> str:
        return os.path.join(self.path, _HOSTS, host + ".json")

    def _result_path(self, key: str) -> str:
        return os.path.join(self.path, _RESULTS, safe_key(key) + ".json")

    def _spent_path(self, key: str) -> str:
        return os.path.join(self.path, _SPENT, safe_key(key) + ".json")

    # -- membership ----------------------------------------------------
    def join(self) -> int:
        """Register this host in the pool under a fresh epoch (one
        more than any epoch this host id ever announced — a restarted
        host fences its own previous incarnation's leases) and write
        the first heartbeat."""
        old = _read_json(self._host_path(self.host))
        self.epoch = int((old or {}).get("epoch", 0)) + 1
        os.makedirs(self._lease_dir(self.host), exist_ok=True)
        self.heartbeat()
        return self.epoch

    def heartbeat(self, **gauges) -> None:
        """Atomically renew this host's liveness record. The stamped
        wall clock is the reference every expiry judgment uses for
        this host's leases."""
        rec = dict(
            host=self.host,
            epoch=self.epoch,
            t=time.time(),
            pid=os.getpid(),
            status="live",
        )
        rec.update(gauges)
        _write_json(self._host_path(self.host), rec)

    def leave(self) -> int:
        """Orderly exit: requeue every lease this host still holds
        (they were claimed, not served — survivors must get them
        without waiting out the TTL) and mark the host record
        ``left``. Returns the number of items released."""
        released = 0
        for rec, lease_path in self._own_leases():
            if self._requeue(rec, lease_path, reason="leave"):
                released += 1
        rec = dict(
            host=self.host,
            epoch=self.epoch,
            t=time.time(),
            pid=os.getpid(),
            status="left",
        )
        _write_json(self._host_path(self.host), rec)
        return released

    # -- submit --------------------------------------------------------
    def _store_array(self, arr: Optional[np.ndarray]) -> Optional[str]:
        if arr is None:
            return None
        arr = np.ascontiguousarray(np.asarray(arr, np.float32))
        sha = payload_sha(arr)
        fpath = os.path.join(self.path, _PAYLOADS, sha + ".npy")
        if os.path.exists(fpath):
            return sha  # content-addressed: identical bytes stored once
        fd, tmp = tempfile.mkstemp(
            prefix=".tmp-", dir=os.path.join(self.path, _PAYLOADS)
        )
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, fpath)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return sha

    def load_array(self, sha: Optional[str]) -> Optional[np.ndarray]:
        if sha is None:
            return None
        return load_payload(self.path, sha)

    def submit(
        self,
        key: str,
        b: np.ndarray,
        mask: Optional[np.ndarray] = None,
        smooth_init: Optional[np.ndarray] = None,
        x_orig: Optional[np.ndarray] = None,
        trace_id: Optional[str] = None,
        root_span: Optional[str] = None,
        deadline: Optional[float] = None,
    ) -> str:
        """Durably enqueue one request; returns the item file name.
        A spent key (already served or already failed) is refused —
        the key resolved once, ever, anywhere in the pool.

        ``deadline`` is the request's ABSOLUTE wall-clock expiry
        (``time.time()`` seconds, stamped by the client): the item
        record carries the remaining budget across host boundaries,
        so a hand-off SHRINKS what is left instead of resetting it,
        and a claim of an already-expired item resolves it with a
        durable ``deadline`` error result instead of solving it."""
        if os.path.exists(self._spent_path(key)):
            raise ValueError(
                f"idempotency key {key!r} is spent (already served or "
                "failed somewhere in the pool; retry under a fresh "
                "key)"
            )
        self._seq += 1
        name = (
            f"{int(time.time() * 1e3):015d}-{self._seq:06d}-"
            f"{safe_key(key)}.json"
        )
        rec = {
            "schema": _SCHEMA,
            "name": name,
            "key": key,
            "client": self.host,
            "t_submit": time.time(),
            "attempts": 0,
            "max_attempts": self.max_attempts,
            "trace_id": trace_id,
            "root_span": root_span,
            "deadline": (
                None if deadline is None else float(deadline)
            ),
            "b": self._store_array(b),
            "mask": self._store_array(mask),
            "smooth_init": self._store_array(smooth_init),
            "x_orig": self._store_array(x_orig),
        }
        _write_json(os.path.join(self.path, _QUEUE, name), rec)
        self._emit("dqueue_submit", key=key, name=name)
        return name

    # -- seal (end of stream) ------------------------------------------
    def seal(self) -> None:
        """Announce end-of-stream: hosts draining until sealed exit
        once the queue and every lease are empty."""
        _write_json(
            os.path.join(self.path, _SEALED),
            {"t": time.time(), "by": self.host},
        )

    @property
    def sealed(self) -> bool:
        return os.path.exists(os.path.join(self.path, _SEALED))

    # -- claim ---------------------------------------------------------
    def claim(self, limit: int = 1) -> List[Dict[str, Any]]:
        """Claim up to ``limit`` items, oldest first. Exactly-one-
        winner: the rename into this host's lease dir either succeeds
        (the item is ours) or fails with ENOENT (someone else won).
        Requeued copies of spent keys are dropped here instead of
        solved again; a torn item file is quarantined."""
        try:
            names = sorted(os.listdir(os.path.join(self.path, _QUEUE)))
        except OSError:
            return []
        out: List[Dict[str, Any]] = []
        for name in names:
            if len(out) >= limit:
                break
            if not name.endswith(".json"):
                continue
            src = os.path.join(self.path, _QUEUE, name)
            dst = os.path.join(self._lease_dir(self.host), name)
            try:
                os.rename(src, dst)
            except OSError:
                continue  # lost the race (or the file just left)
            rec = _read_json(dst)
            if rec is None:
                # torn item file: unreadable-as-absent for every
                # reader; since we hold it now, quarantine the bytes
                # for forensics instead of requeueing garbage
                self._quarantine(dst)
                continue
            key = rec.get("key")
            if not key:
                self._quarantine(dst)
                continue
            if os.path.exists(self._spent_path(key)):
                # a requeued copy of a key a straggler already
                # resolved — solving it again could only be
                # suppressed at delivery; drop it for free here
                try:
                    os.unlink(dst)
                except OSError:
                    pass
                continue
            dl = rec.get("deadline")
            if dl is not None and time.time() >= float(dl):
                # the client's end-to-end budget expired while the
                # item sat queued/handed-off: resolve it durably as
                # a deadline error INSTEAD of solving — no solve
                # slot is ever spent on a request nobody waits for
                self._resolve_expired(rec, dst)
                continue
            rec["attempts"] = int(rec.get("attempts", 0)) + 1
            rec["lease_host"] = self.host
            rec["lease_epoch"] = self.epoch
            rec["lease_t"] = time.time()
            _write_json(dst, rec)
            self.n_claimed += 1
            out.append(rec)
            self._emit(
                "dqueue_claim",
                key=key,
                host=self.host,
                epoch=self.epoch,
                attempt=rec["attempts"],
            )
        return out

    def _quarantine(self, path: str) -> None:
        try:
            os.replace(
                path,
                os.path.join(
                    self.path, _CORRUPT, os.path.basename(path)
                ),
            )
        except OSError:
            pass

    def _resolve_expired(
        self, rec: Dict[str, Any], lease_path: str
    ) -> None:
        """Durably resolve a claimed-but-expired item: ``deadline``
        error result + spent marker + lease unlink. The result is
        first-wins like every other resolution — a racing owner that
        somehow completed it keeps its record."""
        key = rec["key"]
        dl = float(rec["deadline"])
        err = {
            "schema": _SCHEMA,
            "key": key,
            "status": "deadline",
            "error": (
                f"request {key!r} exceeded its deadline "
                f"({dl:.3f}) before any host could serve it"
            ),
            "deadline": dl,
            "host": self.host,
            "epoch": self.epoch,
            "attempts": int(rec.get("attempts", 0)),
            "t": time.time(),
        }
        _publish_json(self._result_path(key), err)
        if self._mark_spent(key, "deadline"):
            self._emit(
                "deadline_exceeded", where="claim",
                deadline=round(dl, 3), key=key, host=self.host,
            )
            if rec.get("trace_id"):
                # the expiry is this request's terminal ownership
                # story: written start+end together so the trace
                # reassembles complete without a live owner
                trace_util.emit_span(
                    self._emit,
                    trace_id=rec["trace_id"],
                    span="attempt",
                    parent_span=rec.get("root_span"),
                    t_start=time.time(),
                    t_end=time.time(),
                    status="deadline",
                    host=self.host,
                )
        try:
            os.unlink(lease_path)
        except OSError:
            pass

    # -- delivery ------------------------------------------------------
    def _mark_spent(self, key: str, status: str) -> bool:
        """Atomically create the spent marker; False when the key was
        already spent (the one tiebreak of the delivery race)."""
        try:
            fd = os.open(
                self._spent_path(key),
                os.O_WRONLY | os.O_CREAT | os.O_EXCL,
            )
        except FileExistsError:
            return False
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "key": key,
                    "status": status,
                    "host": self.host,
                    "epoch": self.epoch,
                    "t": time.time(),
                },
                f,
            )
        return True

    def _fenced(self, item: Dict[str, Any]) -> Optional[str]:
        """Why this host may no longer deliver ``item`` (None = still
        the owner): the lease was reaped/requeued out from under us,
        our epoch went stale (this host id rejoined), or the key is
        already spent."""
        if os.path.exists(self._spent_path(item["key"])):
            # the key resolved elsewhere — any lease copy we still
            # hold is dead weight (e.g. a ghost recreated by our own
            # claim stamp racing a reaper); drop it so `drained` can
            # become true
            try:
                os.unlink(
                    os.path.join(
                        self._lease_dir(self.host), item["name"]
                    )
                )
            except OSError:
                pass
            return "spent"
        if int(item.get("lease_epoch", -1)) != self.epoch:
            return "epoch"
        lease_path = os.path.join(
            self._lease_dir(self.host), item["name"]
        )
        if not os.path.exists(lease_path):
            return "lease_lost"
        return None

    def complete(
        self,
        item: Dict[str, Any],
        recon: np.ndarray,
        psnr: Optional[float] = None,
        latency_ms: Optional[float] = None,
        bucket: Optional[str] = None,
        iters: Optional[int] = None,
    ) -> bool:
        """Deliver one result durably: reconstruction bytes content-
        addressed, digest + metadata in an atomic result record, then
        the spent marker. Returns False when this delivery was FENCED
        — a late straggler whose ownership was reaped away (the
        survivors' result stands; by the determinism contract the
        bytes would have been identical anyway)."""
        key = item["key"]
        why = self._fenced(item)
        if why is not None:
            self.n_suppressed += 1
            self._emit(
                "dqueue_suppressed", key=key, host=self.host,
                reason=why,
            )
            return False
        # cast ONCE, then store and digest the same object: the
        # digest must describe exactly the bytes the frontend will
        # load back (a float64 recon digested uncast would name
        # bytes the store never held), and payload_sha of the stored
        # array IS its content address — one hash, not two
        recon = np.ascontiguousarray(np.asarray(recon, np.float32))
        sha = self._store_array(recon)
        rec = {
            "schema": _SCHEMA,
            "key": key,
            "status": "ok",
            "recon": sha,
            "digest": sha,
            "psnr": None if psnr is None else float(psnr),
            "latency_ms": (
                None if latency_ms is None else float(latency_ms)
            ),
            "bucket": bucket,
            "iters": None if iters is None else int(iters),
            "host": self.host,
            "epoch": self.epoch,
            "attempts": int(item.get("attempts", 0)),
            "t": time.time(),
        }
        # first-wins: a racing resolver that already published an
        # outcome for this key keeps it — we never overwrite a
        # durable result with a contradictory one
        _publish_json(self._result_path(key), rec)
        if not self._mark_spent(key, "ok"):
            # a racing reap handed the item off and the new owner won
            # the marker — at-most-once delivery holds
            self.n_suppressed += 1
            self._emit(
                "dqueue_suppressed", key=key, host=self.host,
                reason="spent_race",
            )
            return False
        self.n_completed += 1
        try:
            os.unlink(
                os.path.join(self._lease_dir(self.host), item["name"])
            )
        except OSError:
            pass
        self._emit(
            "dqueue_complete", key=key, host=self.host,
            digest=rec["digest"], latency_ms=rec["latency_ms"],
            attempts=rec["attempts"],
        )
        return True

    def fail(self, item: Dict[str, Any], error: str) -> bool:
        """Resolve one item with an explicit error (exactly-once-OR-
        error): durable error result + spent marker. Same fencing as
        :meth:`complete`."""
        key = item["key"]
        why = self._fenced(item)
        if why is not None:
            self.n_suppressed += 1
            self._emit(
                "dqueue_suppressed", key=key, host=self.host,
                reason=why,
            )
            return False
        rec = {
            "schema": _SCHEMA,
            "key": key,
            "status": "error",
            "error": str(error)[:500],
            "host": self.host,
            "epoch": self.epoch,
            "attempts": int(item.get("attempts", 0)),
            "t": time.time(),
        }
        _publish_json(self._result_path(key), rec)
        if not self._mark_spent(key, "error"):
            self.n_suppressed += 1
            self._emit(
                "dqueue_suppressed", key=key, host=self.host,
                reason="spent_race",
            )
            return False
        try:
            os.unlink(
                os.path.join(self._lease_dir(self.host), item["name"])
            )
        except OSError:
            pass
        self._emit(
            "dqueue_failed", key=key, attempts=rec["attempts"],
            error=rec["error"],
        )
        if item.get("trace_id") and item.get("lease_t"):
            # a FAILED ownership is still an ownership: the trace
            # contract (every ownership visible) holds for error
            # resolutions too
            trace_util.emit_span(
                self._emit,
                trace_id=item["trace_id"],
                span="attempt",
                parent_span=item.get("root_span"),
                t_start=float(item["lease_t"]),
                t_end=time.time(),
                status="error",
                host=self.host,
                attempt=int(item.get("attempts", 0)),
            )
        return True

    def expire(self, item: Dict[str, Any]) -> None:
        """Resolve one of OUR claimed items as deadline-expired —
        the drain worker's path when the budget runs out after the
        claim (e.g. while the item sat deferred behind an Overloaded
        fleet, or when fleet admission refuses it as already dead)."""
        self._resolve_expired(
            item,
            os.path.join(self._lease_dir(self.host), item["name"]),
        )

    def cancel(self, key: str) -> bool:
        """Durable cooperative cancellation of a still-unresolved
        key: cancelled result record + spent marker. After this, a
        later claim of the (queued or requeued) item drops it at the
        spent-key fence instead of solving it — the cross-host twin
        of the fleet's pre-dispatch cancel sweep. False when the key
        already resolved (the result stands; cancellation lost the
        race, which is the at-most-once contract, not an error)."""
        rec = {
            "schema": _SCHEMA,
            "key": key,
            "status": "cancelled",
            "host": self.host,
            "epoch": self.epoch,
            "t": time.time(),
        }
        # first-wins on the RESULT record, same as complete/fail: if
        # a host already published an outcome, the cancel lost and
        # that outcome stands (its own _mark_spent follows)
        if not _publish_json(self._result_path(key), rec):
            return False
        self._mark_spent(key, "cancelled")
        self._emit(
            "request_cancelled", where="dqueue", key=key,
            host=self.host,
        )
        return True

    def release(self, item: Dict[str, Any]) -> bool:
        """Hand one of our own claimed-but-unserved items back to the
        queue (the clean half of :meth:`leave`)."""
        lease_path = os.path.join(
            self._lease_dir(self.host), item["name"]
        )
        rec = _read_json(lease_path)
        if rec is None:
            return False
        return self._requeue(rec, lease_path, reason="release")

    # -- the reaper ----------------------------------------------------
    def _own_leases(self):
        out = []
        d = self._lease_dir(self.host)
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            rec = _read_json(os.path.join(d, name))
            if rec is not None:
                out.append((rec, os.path.join(d, name)))
        return out

    def _requeue(
        self, rec: Dict[str, Any], lease_path: str, reason: str
    ) -> bool:
        """One atomic rename back into ``queue/`` under the item's
        original (sequence-ordered) name — a hand-off drains at the
        front. An exhausted attempt budget fails the item here
        instead (requeueing it would be silent retry-forever)."""
        key = rec.get("key")
        if not key:
            self._quarantine(lease_path)
            return False
        if os.path.exists(self._spent_path(key)):
            try:
                os.unlink(lease_path)
            except OSError:
                pass
            return False
        budget = int(rec.get("max_attempts", self.max_attempts))
        from_host = rec.get("lease_host")
        attempts = int(rec.get("attempts", 0))
        if attempts >= budget:
            # the cross-host attempt budget is spent: durable error
            # result + spent marker, emitted by WHOEVER reaps it
            err = {
                "schema": _SCHEMA,
                "key": key,
                "status": "error",
                "error": (
                    f"request {key!r} failed after {attempts} "
                    "cross-host ownership(s) (exactly-once-or-error: "
                    "no result was delivered)"
                ),
                "host": self.host,
                "epoch": self.epoch,
                "attempts": attempts,
                "t": time.time(),
            }
            _publish_json(self._result_path(key), err)
            if self._mark_spent(key, "error"):
                self._emit(
                    "dqueue_failed", key=key, attempts=attempts,
                    error=err["error"],
                )
                if rec.get("trace_id") and rec.get("lease_t"):
                    # close the dead owner's final ownership story
                    # too: a budget-exhausted request still
                    # reassembles with every ownership visible
                    trace_util.emit_span(
                        self._emit,
                        trace_id=rec["trace_id"],
                        span="attempt",
                        parent_span=rec.get("root_span"),
                        t_start=float(rec["lease_t"]),
                        t_end=time.time(),
                        status="error",
                        host=from_host,
                        attempt=attempts,
                    )
            try:
                os.unlink(lease_path)
            except OSError:
                pass
            return False
        try:
            os.rename(
                lease_path,
                os.path.join(self.path, _QUEUE, rec["name"]),
            )
        except OSError:
            return False  # a racing reaper won, or the owner woke
        self._emit(
            "dqueue_requeue",
            key=key,
            from_host=from_host,
            by_host=self.host,
            attempt=attempts,
            reason=reason,
        )
        if rec.get("trace_id") and rec.get("lease_t"):
            # the dead owner can no longer close its ownership story:
            # the reaper writes it retrospectively (start + end
            # together — a killed host never orphans a span), so the
            # request's trace still reassembles complete across the
            # host boundary
            trace_util.emit_span(
                self._emit,
                trace_id=rec["trace_id"],
                span="attempt",
                parent_span=rec.get("root_span"),
                t_start=float(rec["lease_t"]),
                t_end=time.time(),
                status="requeued",
                host=from_host,
                reason=reason,
            )
        return True

    def _host_table(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        d = os.path.join(self.path, _HOSTS)
        try:
            names = os.listdir(d)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            rec = _read_json(os.path.join(d, name))
            if rec is not None and rec.get("host"):
                out[rec["host"]] = rec
        return out

    def _expired(
        self,
        rec: Dict[str, Any],
        hosts: Dict[str, Dict[str, Any]],
        now: float,
    ) -> Optional[str]:
        """Why this lease is dead (None = still live). Expiry is
        clock-skew-bounded: the owner's stamped clock and ours may
        disagree by up to ``skew_s`` without consequence — only a
        heartbeat older than ``ttl_s + skew_s`` is death, so a fast
        local clock can never reap a healthy host's lease."""
        owner = rec.get("lease_host")
        hb = hosts.get(owner) if owner else None
        lease_epoch = int(rec.get("lease_epoch", 0))
        if hb is not None:
            if int(hb.get("epoch", 0)) > lease_epoch:
                return "epoch"  # owner rejoined: old incarnation dead
            if (
                hb.get("status") == "left"
                and int(hb.get("epoch", 0)) == lease_epoch
            ):
                return "left"  # owner left without releasing
        t_ref = float(
            (hb or {}).get("t") or rec.get("lease_t") or 0.0
        )
        if now - t_ref > self.ttl_s + self.skew_s:
            return "expired"
        return None

    def reap(self) -> List[Dict[str, Any]]:
        """Requeue (or fail, at attempt-budget exhaustion) every item
        whose owning host died mid-solve. Any host may reap; racing
        reapers are safe (the requeue rename has one winner). Returns
        the records acted on."""
        hosts = self._host_table()
        now = time.time()
        acted: List[Dict[str, Any]] = []
        lease_root = os.path.join(self.path, _LEASES)
        try:
            host_dirs = sorted(os.listdir(lease_root))
        except OSError:
            return acted
        for hdir in host_dirs:
            d = os.path.join(lease_root, hdir)
            if not os.path.isdir(d):
                continue
            try:
                names = sorted(os.listdir(d))
            except OSError:
                continue
            for name in names:
                if not name.endswith(".json"):
                    continue
                fp = os.path.join(d, name)
                rec = _read_json(fp)
                if rec is None:
                    # torn lease: readers treat it as absent; after a
                    # full TTL with no owner able to repair it,
                    # quarantine the bytes
                    try:
                        age = now - os.stat(fp).st_mtime
                    except OSError:
                        continue
                    if age > self.ttl_s + self.skew_s:
                        self._quarantine(fp)
                    continue
                if "lease_host" not in rec:
                    # the claim-rename landed but the ownership stamp
                    # has not yet: the claimer is mid-claim RIGHT NOW
                    # (or died there). Judging this record by its
                    # absent lease fields would read as
                    # expired-since-epoch and steal a healthy host's
                    # fresh claim — judge by file age instead, with
                    # the full TTL grace
                    try:
                        age = now - os.stat(fp).st_mtime
                    except OSError:
                        continue
                    if age <= self.ttl_s + self.skew_s:
                        continue
                    if self._requeue(rec, fp, reason="unstamped"):
                        acted.append(rec)
                    continue
                why = self._expired(rec, hosts, now)
                if why is None:
                    continue
                if self._requeue(rec, fp, reason=why):
                    acted.append(rec)
        return acted

    # -- read side -----------------------------------------------------
    def result(self, key: str) -> Optional[Dict[str, Any]]:
        """The durable result record for ``key`` (None until a host
        delivers or fails it)."""
        return _read_json(self._result_path(key))

    def spent(self, key: str) -> bool:
        return os.path.exists(self._spent_path(key))

    def result_names(self) -> set:
        """Filenames present under ``results/`` — ONE directory scan
        a poller with N pending keys checks membership against
        (``safe_key(key) + ".json"``), instead of N open() round
        trips per tick against a possibly-remote filesystem."""
        try:
            return set(os.listdir(os.path.join(self.path, _RESULTS)))
        except OSError:
            return set()

    def _count(self, sub: str) -> int:
        try:
            return sum(
                1
                for n in os.listdir(os.path.join(self.path, sub))
                if n.endswith(".json")
            )
        except OSError:
            return 0

    def stats(self) -> Dict[str, Any]:
        """Live queue-wide gauges read straight off the directory
        tree (any host or frontend may call this)."""
        leased = 0
        lease_root = os.path.join(self.path, _LEASES)
        try:
            for hdir in os.listdir(lease_root):
                d = os.path.join(lease_root, hdir)
                if os.path.isdir(d):
                    try:
                        leased += sum(
                            1 for n in os.listdir(d)
                            if n.endswith(".json")
                        )
                    except OSError:
                        pass
        except OSError:
            pass
        return {
            "queued": self._count(_QUEUE),
            "leased": leased,
            "results": self._count(_RESULTS),
            "spent": self._count(_SPENT),
            "hosts": self._host_table(),
            "sealed": self.sealed,
        }

    @property
    def drained(self) -> bool:
        """True when nothing is queued and no lease is outstanding —
        with ``sealed``, the hosts' exit condition. Reads only the
        queue and lease dirs (polled every idle drain tick — it must
        not pay the results/spent/hosts listings ``stats`` does)."""
        if self._count(_QUEUE) > 0:
            return False
        lease_root = os.path.join(self.path, _LEASES)
        try:
            host_dirs = os.listdir(lease_root)
        except OSError:
            return True
        for hdir in host_dirs:
            d = os.path.join(lease_root, hdir)
            if not os.path.isdir(d):
                continue
            try:
                if any(n.endswith(".json") for n in os.listdir(d)):
                    return False
            except OSError:
                continue
        return True
