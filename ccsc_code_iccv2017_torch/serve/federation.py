"""Cross-host federated serving over the durable file-lease queue (the
torch port of ``ccsc_code_iccv2017_tpu.serve.federation``: the same
frontend, host and host pool over the port's :class:`~.fleet.ServeFleet`,
on the same queue format, so a port host drains a JAX frontend's queue
and the reverse).

One :class:`~.fleet.ServeFleet` already survives anything short of its
own process dying. Federation is the next level of the same ladder:
N fleet PROCESSES — typically one per host, each supervised by
``python -m ccsc_code_iccv2017_torch.supervise --federate DIR`` — share
nothing but a :class:`~.dqueue.DurableQueue` directory (the MPAX fleet
of solver instances scaled past one process, PAPERS.md
arXiv:2412.09734), so a SIGKILL of an entire fleet process is just an
expired lease the survivors reap:

- :class:`FederatedHost` runs the existing in-process fleet as a
  **drain worker**: claim items from the shared queue (at most the
  fleet's own slot capacity in flight), submit each ownership to the
  fleet under a per-attempt idempotency key, and on delivery write
  the result durably back through :meth:`~.dqueue.DurableQueue.
  complete` — content-digested bytes, the same sha256 the capture
  oracle records, so cross-host parity is bit-checkable. A heartbeat
  thread renews the host's lease epoch and runs the reaper, so every
  host is also every other host's undertaker. ``device`` (default
  ``"cuda"``) is the host fleet's device; several host processes may
  share one card.
- :class:`FederatedFrontend` is the thin client: ``submit`` writes a
  durable request (payloads content-addressed), returns a Future, and
  a poller resolves it from the durable result file whichever host
  produced it. ``seal()`` announces end-of-stream; hosts draining
  until sealed exit once the queue is empty. It touches no device.

Request-level traces cross the host boundary: the frontend opens the
root span, the item record carries ``trace_id``/``root_span`` through
the queue, each serving host writes its ownership RETROSPECTIVELY
(start + end in one emit — a killed host can never orphan a span),
and the reaper writes the dead host's ownership the same way when it
requeues. Merging the frontend's and every host's metrics dirs
reassembles each request as one complete story with both ownerships
visible (``utils.trace.assemble``, tests/test_torch_federation.py).

Delivery semantics are the in-process fleet's, made cross-host:
at-most-once (the spent marker is the atomic tiebreak; late stragglers
are fenced by lease epoch and suppressed), exactly-once-or-error (a
cross-host attempt budget in the item record; exhaustion writes an
explicit error result), and spent keys stay spent across the whole
pool.
"""
from __future__ import annotations

import dataclasses
import os
import queue as _pyqueue
import socket
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from ..utils import env as _env
from ..utils import trace as trace_util
from .dqueue import DurableQueue
from .fleet import (
    BucketCold,
    DeadlineExceeded,
    Overloaded,
    ServeFleet,
)

__all__ = [
    "FederatedHost",
    "FederatedHostPool",
    "FederatedFrontend",
    "FederatedResult",
]


class FederatedResult(NamedTuple):
    """One federated request's resolution, rebuilt from the durable
    result record (the cross-host analog of
    :class:`~.engine.ServedResult`)."""

    key: str
    recon: np.ndarray
    psnr: Optional[float]
    bucket: Optional[str]
    iters: Optional[int]
    latency_ms: float  # frontend-measured submit -> resolution
    host_latency_ms: Optional[float]  # serving host's solve latency
    digest: str  # sha256 of the reconstruction bytes
    host: Optional[str]  # the host that delivered
    attempts: int  # cross-host ownerships it took
    trace_id: Optional[str]


def _default_host() -> str:
    return f"{socket.gethostname()}-{os.getpid()}"


@dataclasses.dataclass
class _PendingReq:
    key: str
    future: Future
    t_submit: float  # perf_counter
    t_wall: float
    trace_id: str
    root_span: str
    deadline: Optional[float] = None  # absolute wall clock


class FederatedFrontend:
    """Submit requests into the shared queue and resolve them from
    the durable result files — no backend, no engine, importable on
    a host that has never seen a chip."""

    def __init__(
        self,
        queue_dir: str,
        client: Optional[str] = None,
        metrics_dir: Optional[str] = None,
        verbose: str = "brief",
        poll_s: Optional[float] = None,
    ):
        from ..utils import obs

        self.client = client or "client-" + _default_host()
        self.poll_s = (
            float(poll_s)
            if poll_s is not None
            else float(_env.env_float("CCSC_FED_POLL_S"))
        )
        self._run = obs.start_run(
            metrics_dir,
            algorithm="serve_federation_frontend",
            verbose=verbose,
            compile_monitor=False,
            queue_dir=queue_dir,
            client=self.client,
        )
        self.queue = DurableQueue(
            queue_dir, host=self.client, emit=self._emit
        )
        self._lock = threading.Lock()
        self._pending: Dict[str, _PendingReq] = {}
        self._seq = 0
        self.n_submitted = 0
        self.n_delivered = 0
        self.n_failed = 0
        self.n_cancelled = 0
        self._closed = False
        self._stop = threading.Event()
        self._poller = threading.Thread(
            target=self._poll_loop, name="ccsc-fed-frontend",
            daemon=True,
        )
        self._poller.start()

    def _emit(self, type_: str, **fields) -> None:
        self._run.event(type_, **fields)

    # -- submit --------------------------------------------------------
    def submit(
        self,
        b,
        mask=None,
        smooth_init=None,
        x_orig=None,
        key: Optional[str] = None,
        deadline_ms: Optional[float] = None,
    ) -> "Future[FederatedResult]":
        """Durably enqueue one request for the host pool; returns a
        Future resolved by the poller once ANY host delivers (or the
        pool fails it). A spent key is refused (ValueError) — the
        cross-host exactly-once-or-error contract.

        ``deadline_ms`` (default ``CCSC_REQ_DEADLINE_MS``) is the
        END-TO-END budget, stamped here as an absolute wall clock on
        the durable item — every hand-off downstream (claim, fleet
        admission, engine dispatch) sees the REMAINING budget shrink,
        and an expired item resolves as a durable ``deadline`` error
        instead of being solved. Cancelling the returned future is
        cooperative cancellation: the poller writes a durable cancel
        marker so no host ever solves the withdrawn request."""
        if self._closed:
            raise RuntimeError("frontend is closed")
        if deadline_ms is None:
            deadline_ms = _env.env_float("CCSC_REQ_DEADLINE_MS")
        trace_id = trace_util.new_trace_id()
        root_span = trace_util.new_span_id()
        t_wall = time.time()
        deadline = (
            None if deadline_ms is None
            else t_wall + float(deadline_ms) / 1e3
        )
        with self._lock:
            self._seq += 1
            if key is None:
                key = f"{self.client}-{self._seq:08d}"
            elif key in self._pending:
                # in-flight resubmit returns the SAME future (the
                # fleet submit contract, held at the frontend since
                # the queue cannot cheaply scan for duplicates)
                return self._pending[key].future
            # register BEFORE the durable write: check-then-register
            # split across a lock release would let two concurrent
            # submits of one key both pass the check, double-enqueue
            # the item, and strand the first caller's future
            req = _PendingReq(
                key=key,
                future=Future(),
                t_submit=time.perf_counter(),
                t_wall=t_wall,
                trace_id=trace_id,
                root_span=root_span,
                deadline=deadline,
            )
            self._pending[key] = req
            self.n_submitted += 1
        # the durable write happens OUTSIDE the lock (sha256 + file
        # I/O must not serialize submitters against the poller); the
        # poller cannot resolve the key early — no host has seen the
        # item yet
        try:
            self.queue.submit(
                key,
                b,
                mask=mask,
                smooth_init=smooth_init,
                x_orig=x_orig,
                trace_id=trace_id,
                root_span=root_span,
                deadline=deadline,
            )
        except BaseException as e:
            # a refused (spent) or failed durable write un-registers
            # the key; a concurrent duplicate submit that grabbed the
            # same future learns the refusal through it
            with self._lock:
                self._pending.pop(key, None)
                self.n_submitted -= 1
            try:
                req.future.set_exception(e)
            except Exception:
                pass
            raise
        trace_util.start_span(
            self._emit,
            trace_id=trace_id,
            span=trace_util.ROOT_SPAN,
            span_id=root_span,
            ts=t_wall,
            key=key,
            deadline=(
                None if deadline is None else round(deadline, 3)
            ),
        )
        return req.future

    def reconstruct(self, b, timeout: Optional[float] = None, **kw):
        """Synchronous submit-and-wait."""
        return self.submit(b, **kw).result(timeout=timeout)

    def serve_many(
        self, requests, timeout: Optional[float] = None
    ) -> List[FederatedResult]:
        futs = [self.submit(**req) for req in requests]
        return [f.result(timeout=timeout) for f in futs]

    def seal(self) -> None:
        """Announce end-of-stream to the host pool."""
        self.queue.seal()

    # -- the poller ----------------------------------------------------
    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self._poll_once()
            except Exception as e:
                # one bad record or transient I/O error must not kill
                # the only thread that resolves futures — every other
                # pending request would hang forever
                self._run.console(
                    f"federation: frontend poll error "
                    f"({type(e).__name__}: {e}) — retrying",
                    tier="always",
                )

    def _poll_once(self) -> int:
        from .dqueue import safe_key

        cancelled: List[_PendingReq] = []
        with self._lock:
            for ckey, creq in list(self._pending.items()):
                if creq.future.cancelled():
                    # cooperative cancellation: the client gave up on
                    # the future, so withdraw the durable item too —
                    # without the marker the item would stay live in
                    # the queue forever and some host would solve
                    # work nobody awaits
                    self._pending.pop(ckey, None)
                    cancelled.append(creq)
            keys = list(self._pending)
        for creq in cancelled:
            # durable cancel marker (spent fence): a later claim of
            # the queued/requeued item refuses it. Resolving the
            # pending entry keeps key-reuse policy-consistent with
            # spent keys — a resubmit of the key is refused by the
            # queue, not silently re-registered.
            self.queue.cancel(creq.key)
            with self._lock:
                self.n_cancelled += 1
            trace_util.end_span(
                self._emit,
                trace_id=creq.trace_id,
                span=trace_util.ROOT_SPAN,
                span_id=creq.root_span,
                status="cancelled",
                t_start=creq.t_wall,
                key=creq.key,
            )
        if not keys:
            return len(cancelled)
        # one directory scan per tick, then read only the records
        # that actually landed — N pending keys must not cost N
        # open() round trips against a shared (possibly remote)
        # filesystem every 50 ms
        present = self.queue.result_names()
        resolved = 0
        for key in keys:
            if safe_key(key) + ".json" not in present:
                continue
            rec = self.queue.result(key)
            if rec is None:
                continue  # torn mid-write: next tick
            with self._lock:
                req = self._pending.pop(key, None)
            if req is None:
                continue
            self._resolve(req, rec)
            resolved += 1
        return resolved

    def _resolve(self, req: _PendingReq, rec: Dict[str, Any]) -> None:
        lat_ms = (time.perf_counter() - req.t_submit) * 1e3
        status = rec.get("status")
        ok = status == "ok"
        err: Optional[BaseException] = None
        res: Optional[FederatedResult] = None
        if ok:
            try:
                recon = self.queue.load_array(rec.get("recon"))
            except (OSError, ValueError) as e:
                ok = False
                err = RuntimeError(
                    f"request {req.key!r}: result payload unreadable "
                    f"({type(e).__name__}: {e})"
                )
        if ok:
            res = FederatedResult(
                key=req.key,
                recon=recon,
                psnr=rec.get("psnr"),
                bucket=rec.get("bucket"),
                iters=rec.get("iters"),
                latency_ms=lat_ms,
                host_latency_ms=rec.get("latency_ms"),
                digest=rec.get("digest"),
                host=rec.get("host"),
                attempts=int(rec.get("attempts", 0)),
                trace_id=req.trace_id,
            )
        elif err is None:
            if status == "deadline":
                # the pool durably refused the expired item — the
                # client sees the SAME exception type the in-process
                # fleet raises, with the stamped deadline attached
                err = DeadlineExceeded(
                    "claim", float(rec.get("deadline") or 0.0)
                )
            else:
                err = RuntimeError(
                    rec.get("error")
                    or f"request {req.key!r} failed in the host pool"
                )
        span_status = "ok" if ok else (
            status if status in ("deadline", "cancelled") else "error"
        )
        trace_util.end_span(
            self._emit,
            trace_id=req.trace_id,
            span=trace_util.ROOT_SPAN,
            span_id=req.root_span,
            status=span_status,
            t_start=req.t_wall,
            key=req.key,
            attempts=int(rec.get("attempts", 0)),
        )
        with self._lock:
            if ok:
                self.n_delivered += 1
            else:
                self.n_failed += 1
        try:
            if ok:
                req.future.set_result(res)
            else:
                req.future.set_exception(err)
        except Exception:
            pass  # client cancelled the future; the result stands

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._poller.join(timeout=30.0)
        self._poll_once()  # final sweep: results that landed mid-stop
        with self._lock:
            leftovers = list(self._pending.values())
            self._pending.clear()
        wall = time.time()
        for req in leftovers:
            trace_util.end_span(
                self._emit,
                trace_id=req.trace_id,
                span=trace_util.ROOT_SPAN,
                span_id=req.root_span,
                status="shutdown",
                ts=wall,
                t_start=req.t_wall,
            )
            try:
                req.future.set_exception(
                    RuntimeError(
                        "frontend closed before this request resolved "
                        "(the durable item remains in the queue; a "
                        "new frontend can poll its key)"
                    )
                )
            except Exception:
                pass
        if not self._run.closed:
            self._run.close(
                status="ok",
                n_submitted=self.n_submitted,
                n_delivered=self.n_delivered,
                n_failed=self.n_failed,
                n_cancelled=self.n_cancelled,
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FederatedHost:
    """One host of the pool: the existing in-process
    :class:`~.fleet.ServeFleet` run as a drain worker against the
    shared queue.

    The drain thread claims at most the fleet's slot capacity, submits
    each ownership under a per-attempt fleet key (``key#aN`` — a
    re-claimed item after a suppressed delivery can never collide with
    this fleet's previous ownership of the same key), honors the
    fleet's :class:`~.fleet.Overloaded` backpressure by deferring the
    claimed item for the (jittered) retry hint, and writes every
    delivery durably back through the queue. The beat thread renews
    the host's heartbeat, runs the reaper, and emits
    ``fed_heartbeat``. ``device`` (default ``"cuda"``) is passed to
    the host's fleet; it raises when CUDA is absent. ``serve_cfg``
    reaches every replica engine of the host's fleet, so a host process
    started with ``serve_cfg.artifact_store`` fetches K1's library from
    the shared store instead of running nvcc (and ``compile_cache`` /
    ``staged_warmup`` apply as on a bare engine).
    """

    def __init__(
        self,
        queue_dir: str,
        d,
        prob,
        cfg,
        serve_cfg,
        fleet_cfg,
        blur_psf=None,
        host: Optional[str] = None,
        metrics_dir: Optional[str] = None,
        verbose: str = "brief",
        poll_s: Optional[float] = None,
        heartbeat_s: Optional[float] = None,
        ttl_s: Optional[float] = None,
        skew_s: Optional[float] = None,
        max_attempts: Optional[int] = None,
        device="cuda",
    ):
        from ..utils import obs

        self.host = host or _default_host()
        self.poll_s = (
            float(poll_s)
            if poll_s is not None
            else float(_env.env_float("CCSC_FED_POLL_S"))
        )
        self.heartbeat_s = (
            float(heartbeat_s)
            if heartbeat_s is not None
            else float(_env.env_float("CCSC_FED_HEARTBEAT_S"))
        )
        self._run = obs.start_run(
            metrics_dir,
            algorithm="serve_federation",
            verbose=verbose,
            queue_dir=queue_dir,
            fed_host=self.host,
        )
        self.queue = DurableQueue(
            queue_dir,
            host=self.host,
            emit=self._emit,
            ttl_s=ttl_s,
            skew_s=skew_s,
            max_attempts=max_attempts,
        )
        # the fleet's own stream nests under this host's metrics dir
        # (replica streams nest under the fleet's in turn); one
        # recursive read_events merges the whole host
        if (
            metrics_dir is not None
            and fleet_cfg.metrics_dir is None
        ):
            fleet_cfg = dataclasses.replace(
                fleet_cfg,
                metrics_dir=os.path.join(metrics_dir, "fleet"),
            )
        self._closed = False
        self._close_lock = threading.Lock()
        try:
            self.fleet = ServeFleet(
                d, prob, cfg, serve_cfg, fleet_cfg, blur_psf=blur_psf,
                device=device,
            )
        except BaseException:
            self._run.close(status="error")
            raise
        self.capacity = self.fleet.capacity_hint * 2
        self.served = 0
        self.n_failed = 0
        self._inflight: Dict[str, Dict[str, Any]] = {}  # name -> item
        self._deferred: List = []  # (t_due_monotonic, item)
        self._done: "_pyqueue.Queue" = _pyqueue.Queue()
        self.epoch = self.queue.join()
        self._emit("fed_join", host=self.host, epoch=self.epoch)
        self._stop = threading.Event()  # stops the drain worker
        # the beat thread has ITS OWN stop: close() must keep
        # heartbeating through the (possibly long) fleet drain-close
        # or this host's own in-flight leases expire mid-drain and
        # its completes get suppressed while survivors re-solve them
        self._stop_beat = threading.Event()
        self._fatal = False  # the fleet can no longer serve, ever
        self._drained_sealed = threading.Event()
        self._drain_thread = threading.Thread(
            target=self._drain_loop, name="ccsc-fed-drain",
            daemon=True,
        )
        self._beat_thread = threading.Thread(
            target=self._beat_loop, name="ccsc-fed-beat", daemon=True,
        )
        self._drain_thread.start()
        self._beat_thread.start()
        self._run.console(
            f"federation: host {self.host} (epoch {self.epoch}) "
            f"joined {queue_dir}, claim capacity {self.capacity}",
            tier="brief",
        )

    def _emit(self, type_: str, **fields) -> None:
        self._run.event(type_, **fields)

    # -- the drain worker ----------------------------------------------
    def _drain_loop(self) -> None:
        errors = 0
        while not self._stop.is_set():
            try:
                moved = self._settle_done()
                moved += self._submit_deferred()
                # deferred items hold leases too: an Overloaded fleet
                # must not keep claiming fresh items every tick and
                # hoard the queue away from healthy hosts
                room = (
                    self.capacity
                    - len(self._inflight)
                    - len(self._deferred)
                )
                if room > 0:
                    for item in self.queue.claim(limit=room):
                        self._dispatch(item)
                        moved += 1
                if (
                    not self._inflight
                    and not self._deferred
                    and self.queue.sealed
                    and self.queue.drained
                ):
                    self._drained_sealed.set()
                errors = 0
            except Exception as e:
                # a transient I/O error (disk full, a shared-fs
                # hiccup) must not kill the drain thread while the
                # beat thread keeps this host's leases alive forever
                # — the exact stranding federation exists to prevent.
                # Back off and retry; give up for good only after a
                # sustained streak (survivors then reap our leases
                # once the heartbeat stops).
                errors += 1
                self._run.console(
                    f"federation: drain error ({type(e).__name__}: "
                    f"{e}) — retry {errors}/10",
                    tier="always",
                )
                if errors >= 10:
                    self._retire(f"sustained drain errors: {e}")
                    return
                moved = 0
                self._stop.wait(min(0.25 * errors, 2.0))
            if not moved:
                self._stop.wait(self.poll_s)

    def _retire(self, why: str) -> None:
        """This host can no longer serve (dead fleet, broken queue
        I/O): stop draining AND heartbeating so the pool sees a dead
        host and reaps whatever we still hold — a retiring host that
        kept claiming would steal items from healthy hosts in a hot
        loop. Unblocks serve_until_sealed; close() finishes the
        cleanup."""
        self._fatal = True
        self._run.console(
            f"federation: host {self.host} retiring — {why}",
            tier="always",
        )
        self._stop.set()
        self._stop_beat.set()
        self._drained_sealed.set()

    def _settle_done(self) -> int:
        n = 0
        while True:
            try:
                item, fut = self._done.get_nowait()
            except _pyqueue.Empty:
                return n
            self._settle(item, fut)
            n += 1

    def _submit_deferred(self) -> int:
        if not self._deferred:
            return 0
        now = time.monotonic()
        due = [x for x in self._deferred if x[0] <= now]
        self._deferred = [x for x in self._deferred if x[0] > now]
        for _t, item in due:
            self._dispatch(item)
        return len(due)

    def _dispatch(self, item: Dict[str, Any]) -> None:
        from ..utils import validate

        dl = item.get("deadline")
        dl = None if dl is None else float(dl)
        if dl is not None and time.time() >= dl:
            # the budget ran out AFTER our claim (typically while the
            # item sat deferred behind an Overloaded/BucketCold
            # fleet): resolve it durably as expired before paying for
            # the payload loads
            self.queue.expire(item)
            return
        try:
            arrays = {
                f: self.queue.load_array(item.get(f))
                for f in ("b", "mask", "smooth_init", "x_orig")
            }
        except (OSError, ValueError) as e:
            self.queue.fail(
                item, f"payload unreadable: {type(e).__name__}: {e}"
            )
            return
        # per-attempt fleet key: this host may legitimately own the
        # same queue key twice (suppressed delivery, later re-claim)
        # and the in-process fleet's spent-key refusal must not
        # conflate the two ownerships
        fkey = f"{item['key']}#a{item['attempts']}"
        try:
            fut = self.fleet.submit(
                arrays["b"],
                mask=arrays["mask"],
                smooth_init=arrays["smooth_init"],
                x_orig=arrays["x_orig"],
                key=fkey,
                # ABSOLUTE pass-through: the remaining budget shrinks
                # through the hand-off instead of resetting
                _deadline=dl,
            )
        except DeadlineExceeded:
            # fleet admission judged it already dead (must be caught
            # BEFORE the RuntimeError release path — expiry is a
            # verdict on the request, not on this host's fleet)
            self.queue.expire(item)
            return
        except (Overloaded, BucketCold) as e:
            # explicit backpressure: hold OUR lease (heartbeats keep
            # it live) and re-offer after the jittered hint. A
            # BucketCold host (staged warmup still building this
            # bucket's program) defers exactly like an overloaded
            # one — the request is fine, the host just isn't ready
            # for THAT bucket yet
            self._deferred.append(
                (time.monotonic() + e.retry_after_s, item)
            )
            return
        except validate.CCSCInputError as e:
            self.queue.fail(item, f"invalid request: {e}")
            return
        except RuntimeError as e:
            # fleet closed / all replicas abandoned — release the
            # lease so a healthy host serves it
            self.queue.release(item)
            if not (self._stop.is_set() or self.fleet.closed):
                # not a shutdown: the fleet is permanently unable to
                # serve (e.g. every replica's restart budget is
                # exhausted). Claiming again would hot-spin the same
                # claim/release rename forever — retire instead
                self._retire(f"fleet cannot serve: {e}")
            return
        self._inflight[item["name"]] = item
        fut.add_done_callback(
            lambda f, item=item: self._done.put((item, f))
        )

    def _settle(self, item: Dict[str, Any], fut: Future) -> None:
        self._inflight.pop(item["name"], None)
        try:
            res = fut.result()
        except DeadlineExceeded:
            # expired inside the fleet/engine mid-ownership: the
            # durable resolution says deadline, not error — the
            # client can tell honesty from failure
            self.queue.expire(item)
            return
        except BaseException as e:
            if self._stop.is_set() or self.fleet.closed:
                # shutdown, not a verdict on the request: hand the
                # lease back for the survivors
                self.queue.release(item)
            else:
                self.n_failed += 1
                self.queue.fail(
                    item, f"{type(e).__name__}: {e}"
                )
            return
        delivered = self.queue.complete(
            item,
            res.recon,
            psnr=res.psnr,
            latency_ms=res.latency_s * 1e3,
            bucket=res.bucket,
            iters=int(res.trace.num_iters),
        )
        if delivered:
            self.served += 1
        if item.get("trace_id"):
            # this host's ownership, written retrospectively (one
            # emit, start + end): a SIGKILL mid-solve can never
            # orphan it — the reaper writes the dead ownership
            # instead when it requeues
            trace_util.emit_span(
                self._emit,
                trace_id=item["trace_id"],
                span="attempt",
                parent_span=item.get("root_span"),
                t_start=float(item.get("lease_t") or time.time()),
                t_end=time.time(),
                status="ok" if delivered else "suppressed",
                host=self.host,
                attempt=int(item.get("attempts", 0)),
            )

    # -- heartbeat + reaper --------------------------------------------
    def _beat_loop(self) -> None:
        # first beat IMMEDIATELY, not one cadence in: a host that
        # joins, drains a short queue, and leaves inside a single
        # heartbeat_s window must still be visible in the stream (and
        # to per-host liveness) as having been alive at all
        self._beat_once()
        while not self._stop_beat.wait(self.heartbeat_s):
            self._beat_once()

    def _beat_once(self) -> None:
        try:
            leased = len(self._inflight) + len(self._deferred)
            self.queue.heartbeat(leased=leased, served=self.served)
            self.queue.reap()
            self._emit(
                "fed_heartbeat",
                host=self.host,
                epoch=self.epoch,
                leased=leased,
                served=self.served,
            )
        except Exception as e:
            # the drain loop retries transient I/O errors; its
            # heartbeat must survive the same blip — a dead beat
            # thread under a live drain would let survivors reap and
            # re-solve everything this host is still serving
            self._run.console(
                f"federation: heartbeat error ({type(e).__name__}: "
                f"{e}) — retrying",
                tier="always",
            )

    # -- lifecycle -----------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def serve_until_sealed(
        self, timeout: Optional[float] = None
    ) -> bool:
        """Block until the queue is sealed AND fully drained (every
        item resolved somewhere in the pool) — or until this host
        retired itself because its fleet can no longer serve (check
        ``fatal``; the caller should close() either way). Returns
        False on timeout."""
        return self._drained_sealed.wait(timeout)

    @property
    def fatal(self) -> bool:
        """True when the host retired itself (dead fleet, broken
        queue I/O) rather than finishing the stream."""
        return self._fatal

    def close(self) -> None:
        """Leave the pool cleanly: stop draining, release every
        unserved lease back to the queue, close the fleet, announce
        the departure."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        self._drain_thread.join(timeout=60.0)
        # the fleet's close drains its queued work first — every
        # in-flight ownership this host can still finish is finished
        # and durably completed before any lease is handed back. The
        # beat thread keeps heartbeating THROUGH the drain: a drain
        # longer than the lease TTL must not let survivors reap and
        # re-solve work this host is about to complete.
        try:
            self.fleet.close()
        except Exception:
            pass
        self._settle_done()
        for item in list(self._inflight.values()):
            self.queue.release(item)
        self._inflight.clear()
        for _t, item in self._deferred:
            self.queue.release(item)
        self._deferred = []
        self._stop_beat.set()
        self._beat_thread.join(timeout=60.0)
        released = self.queue.leave()
        self._emit(
            "fed_leave",
            host=self.host,
            epoch=self.epoch,
            served=self.served,
            released=released,
        )
        if not self._run.closed:
            self._run.close(
                status="ok",
                served=self.served,
                n_failed=self.n_failed,
                released=released,
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FederatedHostPool:
    """The coarse-grain elasticity actuator: N in-process
    :class:`FederatedHost`\\ s draining ONE durable queue, grown and
    shrunk one host at a time (serve.controller's ``hosts`` actuator).

    ``grow()`` constructs a full host — its own fleet, its own obs
    stream under ``metrics_dir/host-NN`` — which joins the queue with
    a fresh epoch and starts draining immediately (in this process the
    kernel library is already loaded, so a grown host builds plans and
    nothing else; ``device`` rides ``host_kw``). ``shrink()`` retires
    the newest host through its clean ``close()``: unserved leases
    are RELEASED back to the queue for the survivors — scale-down
    never loses work, the same drain-then-retire contract as
    ``ServeFleet.set_replica_count``. All mutation is serialized
    under one lock; the pool holds no state a restarted controller
    could disagree with (``n_hosts`` IS the state)."""

    def __init__(
        self,
        queue_dir: str,
        d,
        prob,
        cfg,
        serve_cfg,
        fleet_cfg,
        blur_psf=None,
        metrics_dir: Optional[str] = None,
        verbose: str = "brief",
        host_prefix: Optional[str] = None,
        **host_kw,
    ):
        self.queue_dir = queue_dir
        self._factory_args = (d, prob, cfg, serve_cfg, fleet_cfg)
        self._blur_psf = blur_psf
        self._metrics_dir = metrics_dir
        self._verbose = verbose
        self._host_prefix = host_prefix or _default_host()
        self._host_kw = dict(host_kw)
        self._hosts: List[FederatedHost] = []
        self._next_id = 0
        self._lock = threading.Lock()
        self._closed = False

    @property
    def n_hosts(self) -> int:
        with self._lock:
            return len(self._hosts)

    @property
    def hosts(self) -> List[FederatedHost]:
        with self._lock:
            return list(self._hosts)

    def grow(self) -> str:
        """Spin one more host up against the queue; returns its host
        id. Raises on a closed pool — the controller's actuator
        ladder turns that into a failed invocation, never a crash."""
        with self._lock:
            if self._closed:
                raise RuntimeError("host pool is closed")
            hid = self._next_id
            self._next_id += 1
        name = f"{self._host_prefix}-{hid}"
        mdir = (
            os.path.join(self._metrics_dir, f"host-{hid:02d}")
            if self._metrics_dir is not None
            else None
        )
        d, prob, cfg, serve_cfg, fleet_cfg = self._factory_args
        host = FederatedHost(
            self.queue_dir, d, prob, cfg, serve_cfg, fleet_cfg,
            blur_psf=self._blur_psf, host=name, metrics_dir=mdir,
            verbose=self._verbose, **self._host_kw,
        )
        stillborn = False
        with self._lock:
            if self._closed:
                # lost the race with close(): retire immediately,
                # leases go straight back to the queue
                stillborn = True
            else:
                self._hosts.append(host)
        if stillborn:
            host.close()
            raise RuntimeError("host pool is closed")
        return name

    def shrink(self) -> str:
        """Retire the newest host (clean leave: finish in-flight,
        release unserved leases, ``fed_leave``); returns its host id.
        The caller owns the floor — the controller never calls this
        below its ``min_hosts`` bound."""
        with self._lock:
            if not self._hosts:
                raise RuntimeError("host pool is empty")
            host = self._hosts.pop()
        try:
            host.close()
        except Exception:
            # the host is out of the pool either way; its leases are
            # reaped by the survivors' heartbeat reaper
            pass
        return host.host

    def serve_until_sealed(
        self, timeout: Optional[float] = None
    ) -> bool:
        """Block until every current host drained the sealed queue
        (or the timeout elapsed). Hosts grown mid-wait are NOT
        awaited — the caller owns quiescence ordering."""
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        for host in self.hosts:
            left = (
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            if not host.serve_until_sealed(left):
                return False
        return True

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            hosts, self._hosts = self._hosts, []
        for host in reversed(hosts):
            try:
                host.close()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
