"""The reconstruction serving engine (torch port of
``ccsc_code_iccv2017_tpu.serve.engine``'s single-device core).

:class:`CodecEngine` pins one (bank, problem, SolveConfig) and serves
many requests:

1. **Per-bank plans**: ``models.reconstruct.build_plan`` hoists the
   operator precompute (filter spectra, z-solve factors) out of the
   request path, one plan per (bank digest, bucket) in a bounded LRU
   (serve.registry.PlanCache). Requests route by ``bank_id`` and bind
   their bank's digest at admission; ``publish_bank`` hot-swaps a bank
   id to a new digest while admitted work finishes on the old plan.
2. **Shape buckets**: a small configured set of (slots, spatial)
   shapes. A request is padded top-left to the smallest bucket that
   fits, with a zero mask over the pad, so the valid-region result is
   the exact-shape solve's up to boundary coupling. With
   ``aot_warmup`` every bucket runs one short warm dispatch at
   construction, which builds the kernels and the cuFFT plans.
3. **Micro-batching**: a bucket's lane flushes when it holds ``slots``
   requests or its oldest request has waited ``max_wait_ms``; the batch
   rides one dispatch, a slot-wise solve of the whole bucket
   (``models.reconstruct._reconstruct_impl(slotwise=True)``): each slot
   is its own n=1 solve with its own gamma, traces and stop, a stopped
   slot is frozen, and the z-solve (K1 on the card) runs once per
   iteration for all slots. Filler slots carry zero data and a zero
   mask and stop after one iteration.

4. **Mesh serving** (``ServeConfig.mesh_shape`` or ``CCSC_SERVE_MESH``):
   one engine process drives every position of a (batch[, 'freq'])
   mesh (``parallel.local_mesh.LocalMesh``), each position a device
   with its own worker thread and CUDA stream and its own copy of each
   bucket's plan (``models.reconstruct.place_plan``). A dispatch
   scatters the bucket's slots over the batch axis; each position runs
   the slot-wise solve on its slots with no collective (as the JAX
   batch-mesh program, which lowers to zero collectives). On a 'freq'
   axis each position of a group solves its F / nf bins against its
   resident slice of the z-solve factors, and one all-gather an
   iteration reassembles the z-spectrum, so the group's positions hold
   the same spectrum and stop at the same iteration. Results assemble
   in slot order; a position that raises fails the whole dispatch.

5. **Telemetry and SLOs** (``ServeConfig.metrics_dir``, ``slo_*``): the
   engine's run (utils.obs, ``algorithm="serve"``) records each bucket's
   warmup, each request's ``request`` / ``engine_queue`` / ``solve``
   spans (written retrospectively, utils.trace) and ``serve_request``
   record, each dispatch's ``serve_dispatch`` with its
   perfmodel.serving_bound, and the SLO monitor's ``slo_breach`` /
   ``slo_histogram`` records (serve.slo). The first breach arms a
   one-shot profiler capture of the next dispatch
   (``slo_profile_dir``), recorded as ``slo_profile`` even when that
   dispatch raises. ``stats()`` reads its percentiles from the O(1)
   latency histograms. The quality plane (serve.quality) folds each
   request's valid-region PSNR into per-(bank, tenant, bucket) dB
   histograms and each dispatch's solve diagnostics
   (``SolveConfig.track_diagnostics``, read back with the dispatch's
   one host read) per bucket, flushed as ``quality_histogram`` /
   ``quality_solve_diag`` on the SLO cadence. Only the dispatching
   thread writes spans and serve records.

6. **Workload capture** (``ServeConfig.capture_dir`` or
   ``CCSC_CAPTURE_DIR``; serve.capture): a standalone engine records
   every admitted request (payloads content-addressed by sha256) and
   its outcome digest, PSNR and latency, under the solve parameters it
   serves with, so a capture replays bit for bit. With
   ``CCSC_PERF_LEDGER`` set, warmup appends the join-to-first-request
   ``kind=warmup`` ledger record (analysis.ledger).

The host reads one scalar per iteration per bucket (the count of
active slots; on a mesh, per position) instead of one per request.
Dispatch is synchronous in one worker thread, which pins the engine's
device (or hands the shards to the positions' threads) and surfaces
every exception on its batch's futures; nothing falls back to the CPU.
The fleet layer (serve.fleet) drives replica engines through the
fleet-internal ``submit`` arguments, ``replica_id`` and the members
``bucket_warm``, ``cache_dir``, ``last_it_rate`` and ``_knob_dict``.
Tuning, pipelining, artifacts and staged warmup are later ROADMAP.md
Queue 1 items (9, 11 second half); ``ServeConfig`` refuses them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ServeConfig, SolveConfig
from ..models.reconstruct import (
    ReconTrace,
    SolveExtras,
    _reconstruct_impl,
    build_plan,
    place_plan,
)
from ..parallel.local_mesh import LocalMesh, MeshBarrierError
from ..utils import env, obs, perfmodel, profiling, validate
from ..utils import trace as trace_util
from ..utils.device import resolve_device
from . import capture as _capture_mod
from . import quality as _quality_mod
from . import registry
from . import slo as _slo
from .quality import valid_region_psnr


class BucketCold(RuntimeError):
    """Admission refusal for a bucket whose program is still building
    under staged warmup (``ServeConfig.staged_warmup``, ROADMAP.md
    Queue 1 item 11, second half): the engine is live for its warm
    buckets, only this one is not ready. Carries ``retry_after_s`` like
    the fleet's ``Overloaded``. Without staged warmup every bucket is
    warm once the engine is constructed, so the port raises it
    nowhere yet; the fleet imports it."""

    def __init__(self, bucket: str, retry_after_s: float):
        super().__init__(
            f"bucket {bucket} is still warming (staged warmup) — "
            f"retry in {retry_after_s:.2f}s"
        )
        self.bucket = bucket
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(RuntimeError):
    """Refusal of a request whose end-to-end deadline (absolute
    wall-clock epoch seconds, stamped at admission) expired before a
    solve slot was spent on it. ``where`` says where it died:
    ``engine`` (at submit) or ``dispatch`` (swept from the queue)."""

    def __init__(self, where: str, deadline: float):
        super().__init__(
            f"request deadline expired at {where} (deadline epoch "
            f"{deadline:.3f}, now past it)"
        )
        self.where = where
        self.deadline = float(deadline)


class ServedResult(NamedTuple):
    """One request's result, cropped back to the request shape."""

    recon: np.ndarray  # [*reduce, *request_spatial]
    # models.reconstruct.ReconTrace with numpy leaves; for a request
    # padded into a larger bucket, psnr_vals are the solve canvas's
    trace: "object"
    # final PSNR over the request's valid region (serve.quality); None
    # unless x_orig was given and the SolveConfig tracks PSNR
    psnr: Optional[float]
    bucket: str  # bucket the request dispatched in
    wait_s: float  # queue time (submit -> dispatch start)
    latency_s: float  # submit -> result ready
    z: Optional[np.ndarray]  # codes, ServeConfig.return_codes only


@dataclasses.dataclass
class _Pending:
    b: np.ndarray
    mask: Optional[np.ndarray]
    smooth_init: Optional[np.ndarray]
    x_orig: Optional[np.ndarray]
    spatial: Tuple[int, ...]
    future: Future
    t_submit: float
    digest: str = ""  # the bank digest bound at admission
    bank_id: Optional[str] = None
    tenant: Optional[str] = None
    deadline: Optional[float] = None  # absolute epoch seconds
    trace_id: Optional[str] = None  # the request's span tree (utils.trace)
    # the fleet's ownership span the engine's spans nest under; a
    # standalone request owns its root span (own_root)
    parent_span: Optional[str] = None
    own_root: bool = True
    # workload-capture key (serve.capture): pairs this request's capture
    # record with its outcome
    cap_key: Optional[str] = None


def _bucket_name(slots: int, spatial: Tuple[int, ...]) -> str:
    return f"{slots}@" + "x".join(str(s) for s in spatial)


def pick_bucket(
    buckets: Sequence[Tuple[int, Tuple[int, ...]]],
    spatial: Sequence[int],
) -> Tuple[int, Tuple[int, ...]]:
    """Smallest bucket (of a volume-sorted table) that fits
    ``spatial``."""
    spatial = tuple(int(s) for s in spatial)
    for slots, bsp in buckets:  # sorted by volume
        if len(spatial) == len(bsp) and all(
            s <= t for s, t in zip(spatial, bsp)
        ):
            return (slots, bsp)
    raise validate.CCSCInputError(
        f"request spatial {spatial} exceeds every configured "
        f"bucket {[sp for _, sp in buckets]} — add a larger "
        "bucket to ServeConfig.buckets"
    )


def parse_mesh_shape(spec: str) -> Tuple[int, ...]:
    """Parse a serving-mesh spec string — ``"BATCH"`` or
    ``"BATCHxFREQ"`` (e.g. ``"4"``, ``"2x2"``) — into the
    ServeConfig.mesh_shape tuple. Shared by the CCSC_SERVE_MESH env
    fallback and ``serve.bench --mesh``, so the grammar cannot drift."""
    # empty segments are not filtered: a truncated '4x' must refuse, not
    # serve a (4,) batch-only mesh
    parts = spec.lower().replace("*", "x").split("x")
    try:
        shape = tuple(int(p) for p in parts)
    except ValueError:
        shape = ()
    if not 1 <= len(shape) <= 2 or any(a < 1 for a in shape):
        raise ValueError(
            f"mesh spec {spec!r} is not BATCH or BATCHxFREQ with "
            "positive integer axes (e.g. '8' or '4x2')"
        )
    return shape


def _device_pool(device: torch.device) -> Optional[List[torch.device]]:
    """The devices a mesh of ``device``'s type may take: every visible
    card, or None for the CPU (every position is the CPU)."""
    if device.type != "cuda":
        return None
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _resolve_mesh(serve_cfg: ServeConfig, device: torch.device):
    """Resolve the engine's mesh: ServeConfig.mesh_shape, else the
    CCSC_SERVE_MESH env knob, else None (one device). Returns ``(mesh,
    shape, note)``: a :class:`LocalMesh` (batch axis first, 'freq'
    second when 2-D), and a console note when a non-strict resolution
    fell back. On the card the positions are ``cuda:mesh_devices[i]``,
    else the first prod(shape) visible cards; with fewer visible cards
    than the mesh needs, CCSC_SERVE_MESH_STRICT (default on) refuses
    with the shortage, and 0 falls back to a single-device engine."""
    shape = serve_cfg.mesh_shape
    if shape == ():
        # explicitly one device (the bench's baseline): the env knob
        # must not re-arm it
        return None, None, None
    if shape is None:
        spec = env.env_str("CCSC_SERVE_MESH")
        if not spec:
            return None, None, None
        try:
            shape = parse_mesh_shape(spec)
        except ValueError as e:
            raise validate.CCSCInputError(str(e))
    need = math.prod(shape)
    pool = _device_pool(device)
    if pool is None:
        devs = [device] * need
    elif serve_cfg.mesh_devices is not None:
        missing = [i for i in serve_cfg.mesh_devices if i >= len(pool)]
        if missing:
            raise validate.CCSCInputError(
                f"mesh_devices {serve_cfg.mesh_devices} names device "
                f"index(es) {missing} but only {len(pool)} device(s) "
                "are visible"
            )
        devs = [pool[i] for i in serve_cfg.mesh_devices]
    else:
        devs = pool
    if len(devs) < need:
        msg = (
            f"serving mesh {shape} needs {need} device(s) but only "
            f"{len(devs)} are visible — shrink the mesh, share a card "
            "by repeating its index in mesh_devices (e.g. "
            "mesh_devices=(0, 0)), or set CCSC_SERVE_MESH_STRICT=0 to "
            "fall back to a single-device engine"
        )
        if env.env_flag("CCSC_SERVE_MESH_STRICT"):
            raise validate.CCSCInputError(msg)
        return None, None, f"serve: {msg}; serving single-device"
    names = ("batch",) if len(shape) == 1 else ("batch", "freq")
    return LocalMesh(shape, names, devs[:need]), tuple(shape), None


class CodecEngine:
    """Pin (bank, problem, config) once; serve many requests.

    Construction does the expensive work once: full bank/config/bucket
    validation, per-bucket plans, and (``aot_warmup``) one warm dispatch
    per bucket. The per-request path is: cheap shape/finite checks,
    queue, one batched dispatch, slice. ``submit`` may be called from
    any thread; one worker thread owns dispatch order and the device.
    ``device`` (default ``"cuda"``) raises when CUDA is absent; on a
    mesh its type picks the pool the positions come from (cards, or
    the CPU for every position).
    """

    def __init__(
        self,
        d,
        prob,
        cfg: SolveConfig,
        serve_cfg: ServeConfig,
        blur_psf=None,
        device="cuda",
    ):
        # close machinery first: close() must be a no-op on an engine
        # whose constructor raised, and re-entrant
        self._close_lock = threading.Lock()
        self._close_started = False
        self._close_done = threading.Event()

        self.prob = prob
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        geom = prob.geom
        self.geom = geom
        ndim_s = geom.ndim_spatial
        self.device = resolve_device(device)
        self._mesh, self._mesh_shape, note = _resolve_mesh(
            serve_cfg, self.device)
        if self._mesh is not None:
            self.device = self._mesh.devices[0]
        self._pools: List[ThreadPoolExecutor] = []

        # once-per-engine validation (requests get the cheap subset)
        validate.check_solve_config(cfg)
        validate.check_filters(d, geom)
        for slots, spatial in serve_cfg.buckets:
            if len(spatial) != ndim_s:
                raise validate.CCSCInputError(
                    f"bucket spatial {spatial} has {len(spatial)} dims "
                    f"but the problem family has {ndim_s}"
                )
            if any(s < k for s, k in zip(spatial, geom.spatial_support)):
                raise validate.CCSCInputError(
                    f"bucket spatial {spatial} is smaller than the "
                    f"kernel support {geom.spatial_support}"
                )
        if blur_psf is not None:
            validate.check_finite("blur_psf", blur_psf)

        # SLO layer: per-phase latency histograms and declared targets,
        # checked on the dispatch path; a breach may arm a one-shot
        # profiler capture of the next dispatch
        self._slo = _slo.SloMonitor(
            _slo.resolve_targets(serve_cfg.slo_p50_ms, serve_cfg.slo_p99_ms),
            check_s=serve_cfg.slo_check_s,
        )
        self._slo_profile_dir = (serve_cfg.slo_profile_dir
                                 or env.env_str("CCSC_SLO_XPROF_DIR"))
        self._profile_armed: Optional[str] = None
        self._profiled = False
        # quality plane (serve.quality): per-(bank, tenant, bucket) dB
        # histograms and per-bucket solve diagnostics on the SLO
        # cadence; floors and drift live at the fleet scope
        self._quality = _quality_mod.QualityMonitor(
            check_s=serve_cfg.slo_check_s)
        self._replica_id = serve_cfg.replica_id
        # the persistent compile cache is item 11's second half: a
        # restarted replica rebuilds plans, never kernels (the library
        # is loaded once a process)
        self.cache_dir: Optional[str] = None
        self._last_it_rate = 0.0  # newest dispatch's measured it/s
        self._knob_dict = {
            k: getattr(cfg, k) for k in ("fft_impl", "fft_pad",
                                         "storage_dtype", "use_pallas",
                                         "herm_inv")
        }
        self._knob_dict.update(tune=serve_cfg.tune, tuned=False)
        if self._mesh_shape:
            self._knob_dict["devices"] = self.devices
            self._knob_dict["mesh"] = "x".join(map(str, self._mesh_shape))
        self._run = obs.start_run(
            serve_cfg.metrics_dir, algorithm="serve",
            verbose=serve_cfg.verbose, geom=geom, cfg=cfg, mesh=self._mesh,
            device=self.device,
            buckets=[{"slots": s, "spatial": list(sp)}
                     for s, sp in serve_cfg.buckets],
            compile_cache=None, serve_devices=self.devices,
            serve_mesh=list(self._mesh_shape) if self._mesh_shape else None,
            problem={"pad": prob.pad, "dirac": prob.dirac,
                     "data_term": prob.data_term},
        )
        if note:
            self._run.console(note, tier="always")

        self._capture = None
        self._cap_seq = 0
        # per-engine key salt: a recorder reopened on the same capture
        # dir must never reuse a previous engine's keys (read_workload
        # pairs outcomes by key)
        self._cap_prefix = f"req-{trace_util.new_trace_id()[:8]}"
        try:
            # a standalone engine captures its own workload, under the
            # solve params requests are served with (fleet replicas are
            # built with capture_dir=None: the fleet captures at
            # admission)
            cap_dir = _capture_mod.resolve_capture_dir(serve_cfg.capture_dir)
            if cap_dir:
                self._capture = _capture_mod.WorkloadRecorder(
                    cap_dir, emit=self._emit, meta={
                        "source": "serve_engine",
                        "buckets": [{"slots": s, "spatial": list(sp)}
                                    for s, sp in serve_cfg.buckets],
                        "geom": {
                            "spatial_support": list(geom.spatial_support),
                            "num_filters": geom.num_filters,
                        },
                        "solve": {
                            "max_it": cfg.max_it, "tol": cfg.tol,
                            "lambda_residual": cfg.lambda_residual,
                            "lambda_prior": cfg.lambda_prior,
                        },
                        "knobs": self._knob_dict,
                    },
                )
            self._build(d, blur_psf)
        except BaseException:
            # a failed construction stops the worker it may have
            # started and consumes the close latch
            with self._close_lock:
                self._close_started = True
            self._stop_worker()
            if self._capture is not None:
                self._capture.close(status_note="init_failed")
            self._run.close(status="error")
            self._close_done.set()
            raise

    def _build(self, d, blur_psf):
        serve_cfg = self.serve_cfg
        # ServeConfig keeps the table in volume order (pick_bucket
        # takes the first that fits)
        self._buckets: List[Tuple[int, Tuple[int, ...]]] = list(
            serve_cfg.buckets
        )
        self._blur_psf = blur_psf
        default_digest = registry.bank_digest(d)
        self._banks: Dict[str, object] = {default_digest: d}
        self._routes: Dict[Optional[str], str] = {None: default_digest}
        self._default_digest = default_digest
        self._plan_cache = registry.PlanCache()

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # lanes keyed ((slots, spatial), digest)
        self._pending: Dict[Tuple, List[_Pending]] = {
            (bk, default_digest): [] for bk in self._buckets
        }
        self._n_pending = 0
        # digest of the batch being dispatched: retire_bank refuses it
        self._dispatching: Optional[str] = None
        self._closed = False
        self._max_wait_s = serve_cfg.max_wait_ms / 1e3
        self._n_dispatches = 0
        self._occupancy_sum = 0.0
        # one entry per request dispatch: its requests, the iterations
        # it ran (max num_iters over its batch: one K1 launch each on
        # the card), the loop iterations and all-gathers of each mesh
        # position, and its wall seconds (canvas fill to last readback)
        self._dispatch_log: List[Dict[str, object]] = []

        if self._mesh is not None:
            # one worker thread per position, holding its position, its
            # device and its stream for the engine's life
            self._streams: List[Optional[torch.cuda.Stream]] = (
                [None] * self._mesh.size)
            self._pools = [
                ThreadPoolExecutor(
                    1, thread_name_prefix=f"ccsc-serve-pos{pos}",
                    initializer=self._enter_position, initargs=(pos,),
                )
                for pos in range(self._mesh.size)
            ]
        where = (self.device if self._mesh is None else
                 f"mesh {self._mesh_shape} on "
                 f"{[str(v) for v in self._mesh.devices]}")
        t_warm0 = time.perf_counter()
        for stage, bkey in enumerate(self._buckets):
            t0 = time.perf_counter()
            plan = self._install_plan(default_digest, bkey, d,
                                      announce=False)
            if serve_cfg.aot_warmup:
                self._warm_dispatch(bkey, plan)
            dt = time.perf_counter() - t0
            name = _bucket_name(*bkey)
            # "compiled": the warm dispatch built the kernels and the
            # cuFFT plans; "lazy": the first request pays them
            source = "compiled" if serve_cfg.aot_warmup else "lazy"
            self._emit(
                "serve_warmup", bucket=name, aot=bool(serve_cfg.aot_warmup),
                source=source, warmup_s=round(dt, 4), fetch_s=None,
                compile_s=None, devices=self.devices, digest=default_digest,
                mesh=list(self._mesh_shape) if self._mesh_shape else None,
                knobs=self._knob_dict,
            )
            self._emit(
                "warmup_stage", bucket=name, stage=stage,
                n_stages=len(self._buckets), source=source,
                ready_s=round(time.perf_counter() - t_warm0, 4),
            )
            self._run.console(f"serve: bucket {name} warm in {dt:.3f} s on "
                              f"{where}", tier="brief")
        total = time.perf_counter() - t_warm0
        self._emit(
            "serve_ready", n_buckets=len(self._buckets),
            warmup_s=round(total, 4), first_ready_s=round(total, 4),
            staged=False, n_fetched=0,
            n_compiled=len(self._buckets) if serve_cfg.aot_warmup else 0,
            persistent_cache_hits=None, devices=self.devices,
            mesh=list(self._mesh_shape) if self._mesh_shape else None,
            knobs=self._knob_dict,
        )
        # join-to-first-request as a ledger configuration (a no-op
        # unless CCSC_PERF_LEDGER is set; never raises); lazy engines
        # skip it
        if serve_cfg.aot_warmup:
            from ..analysis import ledger as _ledger

            _ledger.append_warmup_record(
                chip=perfmodel.detect_chip(self.device),
                buckets=self._buckets, join_s=total,
                mesh_shape=self._mesh_shape, knobs=self._knob_dict,
                staged=False, artifact_store=False,
                n_compiled=len(self._buckets),
            )

        self._worker = threading.Thread(
            target=self._work_loop, name="ccsc-serve", daemon=True
        )
        self._worker.start()

    def _warm_dispatch(self, bkey, plan) -> None:
        """One iteration on an all-filler canvas at the bucket's shape:
        builds the kernels and the cuFFT plans and sizes the allocator,
        so no request pays them."""
        slots, spatial = bkey
        zeros = np.zeros((slots, *self.geom.reduce_shape, *spatial),
                         np.float32)
        self._solve(plan, zeros, zeros, zeros, None,
                    dataclasses.replace(self.cfg, max_it=1))

    def _solve(self, plan, bb, mm, ss, xx, cfg) -> Dict[str, object]:
        """The bucket's slot-wise solve, read back to the host: on the
        engine's device, or scattered over the mesh's positions
        (``plan`` is then the list of their plans)."""
        if self._mesh is not None:
            return self._solve_mesh(plan, bb, mm, ss, xx, cfg)
        out = self._slotwise(self.device, plan, bb, mm, ss, xx, cfg)
        host = self._readback(out, cfg, xx is not None)
        host["position_iters"] = [int(host["iters"].max())]
        host["gathers"] = [0]
        return host

    def _slotwise(self, dev, plan, bb, mm, ss, xx, cfg, mesh=None):
        def put(a):
            return None if a is None else torch.from_numpy(a).to(dev)

        has_freq = mesh is not None and "freq" in mesh.shape
        return _reconstruct_impl(
            put(bb), None, self.prob, cfg, put(mm), put(ss), None, put(xx),
            plan=plan, slotwise=True, mesh=mesh,
            freq_axis_name="freq" if has_freq else None,
            kern_presliced=has_freq,
        )

    def _readback(self, out, cfg, has_x: bool) -> Dict[str, object]:
        """One slot-wise result as host arrays. Trace readbacks only
        where the config tracks them; untracked traces are zeros on the
        device and zeros here."""
        iters = out.trace.num_iters.cpu().numpy()
        zeros_tr = np.zeros((iters.shape[0], cfg.max_it + 1), np.float32)
        ex = out.trace.extras
        return {
            "iters": iters,
            "obj": (out.trace.obj_vals.cpu().numpy() if cfg.with_objective
                    else zeros_tr),
            "psnr": (out.trace.psnr_vals.cpu().numpy()
                     if cfg.with_psnr and has_x else zeros_tr),
            "diff": (out.trace.diff_vals.cpu().numpy()
                     if cfg.with_objective or cfg.track_diagnostics
                     else zeros_tr),
            "recon": out.recon.cpu().numpy(),
            "z": (out.z.cpu().numpy() if self.serve_cfg.return_codes
                  else None),
            "extras": (None if ex is None
                       else [t.cpu().numpy() for t in ex]),
        }

    # -- the mesh's positions ------------------------------------------
    def _enter_position(self, pos: int) -> None:
        """A position thread's start: its mesh position, its device as
        the thread's current card, and its own stream."""
        self._mesh.enter(pos)
        dev = self._mesh.devices[pos]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            self._streams[pos] = torch.cuda.Stream(dev)

    def _run_position(self, pos, plan, bb, mm, ss, xx, cfg):
        """One position's shard of a dispatch, on its own thread and
        stream, read back to the host. A failure aborts the mesh's
        barriers so the peers fail at once instead of waiting out the
        timeout."""
        mesh = self._mesh
        dev = mesh.devices[pos]
        stream = self._streams[pos]
        try:
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                out = self._slotwise(dev, plan, bb, mm, ss, xx, cfg, mesh)
                return self._readback(out, cfg, xx is not None)
        except BaseException:
            mesh.abort()
            raise

    def _solve_mesh(self, plans, bb, mm, ss, xx, cfg) -> Dict[str, object]:
        """Scatter the bucket's slots over the batch axis, run every
        position, and assemble the batch groups' results in slot order
        (a 'freq' group's positions hold the same result; its first is
        read). Any position's exception fails the dispatch, the first
        root cause before the barrier errors it caused."""
        mesh = self._mesh
        nb = mesh.mesh_shape[0]
        nf = mesh.size // nb
        per = bb.shape[0] // nb
        mesh.reset()
        futs = []
        for pos in range(mesh.size):
            sl = slice((pos // nf) * per, (pos // nf + 1) * per)
            futs.append(self._pools[pos].submit(
                self._run_position, pos, plans[pos], bb[sl], mm[sl], ss[sl],
                None if xx is None else xx[sl], cfg,
            ))
        results, errors = [], []
        for f in futs:
            try:
                results.append(f.result())
            except BaseException as e:  # every position ends first
                errors.append(e)
        gathers = mesh.gathers()
        mesh.reset()  # drops the last iteration's deposits
        if errors:
            root = [e for e in errors if not isinstance(e, MeshBarrierError)]
            raise (root or errors)[0]
        leads = results[::nf]
        host = {}
        for key in ("iters", "obj", "psnr", "diff", "recon", "z"):
            vals = [r[key] for r in leads]
            host[key] = None if vals[0] is None else np.concatenate(vals)
        host["extras"] = (
            None if leads[0]["extras"] is None else
            [np.concatenate([r["extras"][i] for r in leads])
             for i in range(len(leads[0]["extras"]))])
        host["position_iters"] = [int(r["iters"].max()) for r in results]
        host["gathers"] = gathers
        return host

    # ------------------------------------------------------------------
    def _emit(self, type_: str, **fields) -> None:
        """Every serve record rides through here, so it carries the
        replica identity (None for a standalone engine), as in the JAX
        package."""
        self._run.event(type_, replica_id=self._replica_id, **fields)

    def _emit_span(self, type_: str, **fields) -> None:
        """Span-event adapter for utils.trace: ``_emit`` stamps the
        replica id itself."""
        fields.pop("replica_id", None)
        self._emit(type_, **fields)

    def bucket_for(self, spatial: Sequence[int]) -> Tuple[int, Tuple[int, ...]]:
        """Smallest configured bucket that fits ``spatial``."""
        return pick_bucket(self._buckets, spatial)

    def submit(
        self, b, mask=None, smooth_init=None, x_orig=None,
        bank_id: Optional[str] = None,
        tenant: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        _validated: bool = False,
        _trace=None,
        _digest: Optional[str] = None,
        _deadline: Optional[float] = None,
    ) -> "Future[ServedResult]":
        """Enqueue one observation [*reduce, *spatial] (no batch axis);
        returns a Future resolving to :class:`ServedResult`. Only the
        cheap per-request checks run here. ``bank_id`` routes to a
        published bank (None = the default bank); the request binds that
        bank's digest now, so a later hot-swap never retargets it.
        ``tenant`` rides through to telemetry, quality and capture.
        ``deadline_ms`` bounds the request end to end; an expired
        request is refused with :class:`DeadlineExceeded` before it
        costs a solve slot.

        Fleet-internal, as in the JAX package: ``_validated`` skips the
        request checks the fleet already ran at admission; ``_trace``
        is the fleet's span context ``(trace_id, parent_span_id)``, so
        the engine's spans nest under the fleet's ownership span;
        ``_digest`` is the admission-time digest binding (the fleet
        owns the routing table); ``_deadline`` is the absolute
        wall-clock deadline stamped at the original admission."""
        if not _validated:
            validate.check_serve_request(
                b, self.geom, mask=mask, smooth_init=smooth_init,
                x_orig=x_orig,
            )
        deadline = _deadline
        if deadline is None and deadline_ms is not None:
            deadline = time.time() + float(deadline_ms) / 1e3
        if deadline is not None and time.time() >= deadline:
            self._emit("deadline_exceeded", where="engine",
                       deadline=round(deadline, 3))
            raise DeadlineExceeded("engine", deadline)
        if _trace is None:
            trace_id = (trace_util.new_trace_id() if self._run.active
                        else None)
            parent_span, own_root = None, True
        else:
            (trace_id, parent_span), own_root = _trace, False
        spatial = tuple(int(s) for s in b.shape[self.geom.ndim_reduce:])
        key = self.bucket_for(spatial)

        def host(a):
            return None if a is None else np.asarray(
                a.detach().cpu() if torch.is_tensor(a) else a, np.float32
            )

        p = _Pending(
            b=host(b), mask=host(mask), smooth_init=host(smooth_init),
            x_orig=host(x_orig), spatial=spatial, future=Future(),
            t_submit=time.perf_counter(), bank_id=bank_id, tenant=tenant,
            deadline=deadline, trace_id=trace_id, parent_span=parent_span,
            own_root=own_root,
        )
        with self._cv:
            if self._closed or self._close_started:
                raise RuntimeError("engine is closed")
            # the digest binds under the queue lock: publish_bank flips
            # routes and retires digests under the same lock
            if _digest is not None:
                digest = _digest
                if digest not in self._banks:
                    raise validate.CCSCInputError(
                        f"bank digest {digest!r} is not published on "
                        "this engine — publish the bank (add_bank) "
                        "before routing requests to it"
                    )
            else:
                digest = self._routes.get(bank_id)
                if digest is None:
                    raise validate.CCSCInputError(
                        f"unknown bank id {bank_id!r} — published: "
                        f"{sorted(k for k in self._routes if k)} "
                        "(default bank routes as bank_id=None)"
                    )
            p.digest = digest
            if self._capture is not None:
                self._cap_seq += 1
                p.cap_key = f"{self._cap_prefix}-{self._cap_seq:08d}"
            self._pending.setdefault((key, digest), []).append(p)
            self._n_pending += 1
            self._cv.notify()
        if p.cap_key is not None:
            # recorded outside the queue lock: hashing and the segment
            # append must not serialize submitters against dispatch
            self._capture.record_submit(
                p.cap_key, p.trace_id, p.b, mask=p.mask,
                smooth_init=p.smooth_init, x_orig=p.x_orig,
                bucket=_bucket_name(*key), bank_id=bank_id, tenant=tenant,
            )
        return p.future

    def reconstruct(
        self, b, mask=None, smooth_init=None, x_orig=None,
        bank_id: Optional[str] = None,
        tenant: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> ServedResult:
        """Synchronous submit-and-wait."""
        return self.submit(
            b, mask=mask, smooth_init=smooth_init, x_orig=x_orig,
            bank_id=bank_id, tenant=tenant,
        ).result(timeout=timeout)

    def serve_many(self, requests, timeout=None) -> List[ServedResult]:
        """Submit an iterable of request dicts (keys b/mask/smooth_init/
        x_orig/bank_id/deadline_ms) and wait for all results, in
        order."""
        futs = [self.submit(**req) for req in requests]
        return [f.result(timeout=timeout) for f in futs]

    # ------------------------------------------------------------------
    def _work_loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            expired: List[_Pending] = []
            key = None
            with self._cv:
                while not self._closed and self._n_pending == 0:
                    self._cv.wait()
                if self._closed and self._n_pending == 0:
                    return
                max_wait = self._max_wait_s
                now = time.perf_counter()
                # expire dead requests before they cost a solve slot;
                # dl_min is the earliest surviving deadline
                wall = time.time()
                dl_min = None
                for k, lst in self._pending.items():
                    keep = []
                    for p in lst:
                        if p.deadline is not None and wall >= p.deadline:
                            expired.append(p)
                        else:
                            keep.append(p)
                            if p.deadline is not None:
                                dl_min = (p.deadline if dl_min is None
                                          else min(dl_min, p.deadline))
                    if len(keep) != len(lst):
                        self._pending[k] = keep
                self._n_pending -= len(expired)
                if not expired and self._n_pending:
                    # the oldest lane flushes first at max_wait: a full
                    # lane must not starve another bucket's lone request
                    ok, ot = None, None
                    for k, lst in self._pending.items():
                        if lst and (ot is None or lst[0].t_submit < ot):
                            ok, ot = k, lst[0].t_submit
                    if self._closed or now >= ot + max_wait:
                        key = ok
                    else:
                        for k, lst in self._pending.items():
                            if len(lst) >= k[0][0]:  # a full lane
                                key = k
                                break
                        if key is None:
                            t_wait = ot + max_wait - now
                            if dl_min is not None:
                                # notice an expiry when it happens
                                t_wait = min(t_wait,
                                             max(dl_min - wall, 0.0) + 1e-3)
                            self._cv.wait(timeout=t_wait)
                            continue
                if key is not None:
                    slots = key[0][0]
                    batch = self._pending[key][:slots]
                    self._pending[key] = self._pending[key][slots:]
                    self._n_pending -= len(batch)
                    self._dispatching = key[1]
                    depth_after = self._n_pending
            for p in expired:
                # a cancelled future is dropped; a live one fails
                if p.future.set_running_or_notify_cancel():
                    p.future.set_exception(
                        DeadlineExceeded("dispatch", p.deadline)
                    )
                    self._emit("deadline_exceeded", where="dispatch",
                               deadline=round(p.deadline, 3))
            if key is None:
                continue
            # a client-cancelled request is dropped here: set_result on
            # a cancelled Future would raise and poison its siblings
            batch = [p for p in batch
                     if p.future.set_running_or_notify_cancel()]
            try:
                if batch:
                    self._dispatch(key, batch, depth_after)
            except Exception as e:
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)
                self._emit("serve_error", error=str(e)[:300])
            finally:
                self._release_digest()

    def _release_digest(self) -> None:
        """The batch no longer consults its plan: its digest becomes
        retirable (early, before its futures resolve, so a client that
        publishes a bank the moment its result lands can retire the old
        one)."""
        with self._cv:
            self._dispatching = None

    def _dispatch(self, key, batch: List[_Pending], depth_after: int) -> None:
        """One synchronous dispatch: canvas fill, the bucket's slot-wise
        solve, readback, per-request crop and futures, then the
        dispatch's telemetry (spans, serve records, the SLO tick).
        ``depth_after``: the requests still queued once this batch was
        taken."""
        bkey, digest = key
        slots, spatial = bkey
        geom = self.geom
        cfg = self.cfg
        name = _bucket_name(slots, spatial)
        plan = self._plan_for(digest, bkey)
        t0 = time.perf_counter()

        shape = (slots, *geom.reduce_shape, *spatial)
        bb = np.zeros(shape, np.float32)
        mm = np.zeros(shape, np.float32)  # filler slots observe nothing
        ss = np.zeros(shape, np.float32)
        has_x = any(p.x_orig is not None for p in batch)
        xx = np.zeros(shape, np.float32) if has_x else None
        for i, p in enumerate(batch):
            # top-left placement; the zero mask over the pad region
            # excludes it from the data term
            sl = (i, *(slice(None),) * geom.ndim_reduce) + tuple(
                slice(0, s) for s in p.spatial
            )
            bb[sl] = p.b
            mm[sl] = p.mask if p.mask is not None else 1.0
            if p.smooth_init is not None:
                ss[sl] = p.smooth_init
            if p.x_orig is not None:
                xx[sl] = p.x_orig
        # a breach armed a ONE-SHOT capture of this dispatch (serve.slo);
        # it is consumed and recorded even when the solve raises
        prof_dir, self._profile_armed = self._profile_armed, None
        try:
            with profiling.xla_trace(prof_dir, self.device):
                out = self._solve(plan, bb, mm, ss, xx, cfg)
        finally:
            if prof_dir:
                self._emit("slo_profile", trace_dir=prof_dir, bucket=name)
        iters, obj, psnr, diff = (out[k] for k in ("iters", "obj", "psnr",
                                                   "diff"))
        recon, z, ex = out["recon"], out["z"], out["extras"]
        t_done = time.perf_counter()
        # the solve diagnostics came back with the dispatch's one host
        # read; filler slots are no diagnostics
        nb = len(batch)
        self._quality.observe_solve(
            name, iters[:nb], cfg.max_it,
            obj_fid=None if ex is None else ex[0][:nb],
            obj_l1=None if ex is None else ex[1][:nb],
            nonfinite=None if ex is None else ex[2][:nb],
        )
        self._release_digest()

        max_it = int(iters[: len(batch)].max())
        dt = t_done - t0
        # the dispatch is on the books before any of its futures resolves,
        # so a client holding its result sees it in stats() and the log
        occ = len(batch) / slots
        with self._lock:
            self._n_dispatches += 1
            self._occupancy_sum += occ
            self._dispatch_log.append({
                "requests": len(batch), "iters": max_it,
                "position_iters": out["position_iters"],
                "gathers": out["gathers"], "wall_s": dt,
            })
        # span timestamps on the wall clock, from the perf-counter
        # measurements through one offset
        wall_off = time.time() - time.perf_counter()
        for i, p in enumerate(batch):
            crop = tuple(slice(0, s) for s in p.spatial)
            rec_i = recon[i][(..., *crop)]
            tracked = p.x_orig is not None and cfg.with_psnr
            tr = ReconTrace(
                obj[i],
                psnr[i] if tracked else np.zeros_like(psnr[i]),
                diff[i],
                np.int32(iters[i]),
                SolveExtras(*(e[i] for e in ex)) if ex is not None else None,
            )
            res = ServedResult(
                recon=rec_i,
                trace=tr,
                psnr=(valid_region_psnr(rec_i, p.x_orig, geom.psf_radius)
                      if tracked else None),
                bucket=name,
                wait_s=t0 - p.t_submit,
                latency_s=t_done - p.t_submit,
                z=z[i] if z is not None else None,
            )
            with self._lock:  # stats() reads n and percentiles together
                self._slo.observe("queue", res.wait_s * 1e3)
                self._slo.observe("solve", dt * 1e3)
                self._slo.observe("total", res.latency_s * 1e3)
            self._quality.observe(res.psnr, bank_id=p.bank_id,
                                  tenant=p.tenant, bucket=name)
            if p.trace_id is not None:
                # retrospective spans: start and end written together,
                # so no failure can orphan a span_start; under a fleet
                # they nest under its ownership span
                root = p.parent_span
                if p.own_root:
                    root = trace_util.emit_span(
                        self._emit_span, trace_id=p.trace_id,
                        span=trace_util.ROOT_SPAN,
                        t_start=wall_off + p.t_submit,
                        t_end=wall_off + t_done,
                    )
                trace_util.emit_span(
                    self._emit_span, trace_id=p.trace_id,
                    span="engine_queue", parent_span=root,
                    t_start=wall_off + p.t_submit, t_end=wall_off + t0,
                )
                trace_util.emit_span(
                    self._emit_span, trace_id=p.trace_id, span="solve",
                    parent_span=root, t_start=wall_off + t0,
                    t_end=wall_off + t_done, bucket=name,
                    iters=int(iters[i]),
                )
            p.future.set_result(res)
            self._emit(
                "serve_request", trace_id=p.trace_id, bucket=name,
                spatial=list(p.spatial), wait_ms=round(res.wait_s * 1e3, 3),
                latency_ms=round(res.latency_s * 1e3, 3),
                iters=int(iters[i]), psnr=res.psnr, bank_id=p.bank_id,
                tenant=p.tenant,
            )
            if p.cap_key is not None:
                self._capture.record_outcome(
                    p.cap_key, rec_i, res.psnr, res.latency_s * 1e3, name,
                    iters=int(iters[i]),
                )
        it_rate = max_it / dt if dt > 0 and max_it else 0.0
        if it_rate > 0:
            # the fleet's derived admission ceiling reads the newest
            # measured rate
            self._last_it_rate = it_rate
        # the full-bucket ceiling at this dispatch's measured iteration
        # rate: the achieved len(batch)/dt sits below it by the unfilled
        # slots
        bound = perfmodel.serving_bound(it_rate, max(max_it, 1), slots,
                                        occupancy=1.0)
        self._emit(
            "serve_dispatch", bucket=name, digest=digest, n=len(batch),
            slots=slots, occupancy=round(occ, 4), queue_depth=depth_after,
            dt_s=round(dt, 5), max_iters=max_it,
            it_per_sec=round(it_rate, 3),
            requests_per_sec=round(len(batch) / dt if dt > 0 else 0.0, 3),
            bound_requests_per_sec=round(bound["requests_per_sec"], 3),
        )
        # the SLO check (cadence-gated in the monitor): breaches and
        # histogram snapshots land in the stream, and the first breach
        # arms the one-shot capture of the NEXT dispatch
        breaches, snaps = self._slo.tick()
        for br in breaches:
            self._emit("slo_breach", **br)
        for sn in snaps:
            self._emit("slo_histogram", **sn)
        if breaches and self._slo_profile_dir and not self._profiled:
            self._profiled = True
            self._profile_armed = self._slo_profile_dir
        # the quality plane's cadence-gated flush (the engine declares
        # no floors: breaches are the fleet's)
        q_breaches, q_snaps, q_diags = self._quality.tick()
        for br in q_breaches:
            self._emit("quality_breach", **br)
        for sn in q_snaps:
            self._emit("quality_histogram", **sn)
        for dg in q_diags:
            self._emit("quality_solve_diag", **dg)

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Request-latency percentiles and dispatch aggregates. The
        percentiles come from the streaming log-bucketed histogram of
        submit-to-result latency (serve.slo: O(1) memory on a long-lived
        engine, each within one bucket width of the exact value), the
        numbers the ``slo_histogram`` records quote."""
        with self._lock:
            n_disp, occ = self._n_dispatches, self._occupancy_sum
            n = self._slo.n("total")
            ms = {q: self._slo.percentile("total", q) for q in (0.50, 0.99)}

        def to_s(v):
            return None if v is None else v / 1e3

        return {
            "n_requests": n,
            "n_dispatches": n_disp,
            "mean_occupancy": occ / n_disp if n_disp else 0.0,
            "p50_latency_s": to_s(ms[0.50]),
            "p99_latency_s": to_s(ms[0.99]),
        }

    def metrics(self) -> Dict[str, object]:
        """Live counters, gauges and histograms in the shape
        ``serve.metricsd.render_prometheus`` renders: the scrape source
        of a standalone engine's metrics endpoint, with the latency and
        the quality plane's dB histograms."""
        with self._cv:
            depth = self._n_pending
            banks = len(self._routes)
        st = self.stats()
        with self._lock:
            lat = self._slo.raw_snapshots()
        return {
            "counters": {
                "requests_total": st["n_requests"],
                "dispatches_total": st["n_dispatches"],
            },
            "gauges": {
                "queue_depth": depth,
                "mean_occupancy": round(st["mean_occupancy"], 4),
                "banks": banks,
                "plan_cache_bytes": self._plan_cache.total_bytes,
            },
            "histograms": [
                ("latency_ms", {"phase": sn["phase"]}, sn) for sn in lat
            ] + [
                ("psnr_db", {"bank_id": sn["bank_id"],
                             "tenant": sn["tenant"],
                             "bucket": sn["bucket"]}, sn)
                for sn in self._quality.raw_snapshots()
            ],
        }

    def bucket_warm(self, key) -> bool:
        """Is ``key``'s (slots, spatial) bucket serveable? Without the
        staged warmup every configured bucket is, once the engine is
        constructed."""
        slots, spatial = key
        return (int(slots), tuple(int(v) for v in spatial)) in self._buckets

    def warmup_eta_s(self) -> float:
        """Retry-after hint for a cold bucket: none is ever cold before
        the staged warmup."""
        return 0.0

    @property
    def last_it_rate(self) -> float:
        """Measured iteration rate of the newest dispatch (it/s; 0.0
        before any): the ``perfmodel.serving_bound`` input of the
        fleet's derived admission ceiling."""
        return self._last_it_rate

    @property
    def buckets(self) -> List[Tuple[int, Tuple[int, ...]]]:
        """The bucket table, smallest volume first."""
        return list(self._buckets)

    @property
    def dispatch_log(self) -> List[Dict[str, object]]:
        """One dict per request dispatch, in order: ``requests`` (real
        slots), ``iters`` (the max of num_iters over its batch),
        ``position_iters`` (the loop iterations of each mesh position,
        one z-solve launch each; one entry without a mesh), ``gathers``
        (each position's all-gathers: one an iteration on a 'freq'
        axis, else 0) and ``wall_s`` (canvas fill to the last
        readback)."""
        with self._lock:
            return [dict(e) for e in self._dispatch_log]

    @property
    def dispatch_iters(self) -> List[int]:
        """Iterations each request dispatch ran, in order (the max of
        num_iters over its batch, and over the mesh's positions): one
        z-solve launch each on one device."""
        return [e["iters"] for e in self.dispatch_log]

    @property
    def devices(self) -> int:
        """Number of mesh positions this engine solves on (1 for a
        single-device engine)."""
        return 1 if self._mesh is None else self._mesh.size

    @property
    def mesh_shape(self) -> Optional[Tuple[int, ...]]:
        """The resolved serving-mesh shape ((batch,) or (batch, freq)),
        or None for a single-device engine."""
        return self._mesh_shape

    @property
    def mesh(self) -> Optional[LocalMesh]:
        """The in-process mesh of the positions (None without one); its
        ``time_collectives`` / ``collective_ms`` time the all-gathers."""
        return self._mesh

    @property
    def position_devices(self) -> List[torch.device]:
        """The device of each mesh position ([the engine's device]
        without a mesh)."""
        return ([self.device] if self._mesh is None
                else list(self._mesh.devices))

    @property
    def closed(self) -> bool:
        """True once close() has been called (or construction failed)."""
        return self._close_started

    # -- multi-bank serving --------------------------------------------
    def _plan_for(self, digest: str, bkey):
        """The plan serving ``(digest, bucket)`` (on a mesh, the list of
        the positions' plans): an LRU hit, or a rebuild from the
        retained bank."""
        if self._mesh is None:
            plan = self._plan_cache.get(digest, bkey)
        else:
            plan = [self._plan_cache.get(digest, (bkey, pos))
                    for pos in range(self._mesh.size)]
            if any(p is None for p in plan):
                plan = None
        if plan is not None:
            return plan
        d = self._banks.get(digest)
        if d is None:
            raise RuntimeError(
                f"bank digest {digest} has no retained bytes on this "
                "engine — publish the bank before routing requests to it"
            )
        return self._install_plan(digest, bkey, d)

    def _install_plan(self, digest: str, bkey, d, announce: bool = True):
        """Build one bucket's plan for one bank and insert it into the
        LRU, pinning the digests with queued work against eviction. On a
        mesh the plan is built once (the mesh refused first if it cannot
        shard the bucket) and placed on every position, keyed (digest,
        (bucket, position)); returns the list of the positions' plans.
        ``announce``: write ``bank_plan_build`` / ``bank_plan_evict`` (the
        warmup's own installs are ``serve_warmup`` records instead, as in
        the JAX package)."""
        mesh = self._mesh
        t0 = time.perf_counter()
        plan = build_plan(
            d, self.prob, self.cfg, bkey[1], blur_psf=self._blur_psf,
            device=self.device,
            mesh_shape=self._mesh_shape, slots=bkey[0],
            buckets=self._buckets if mesh is not None else None,
        )
        with self._cv:
            pin = {lane[1] for lane, lst in self._pending.items() if lst}
        if mesh is None:
            evicted = self._plan_cache.put(digest, bkey, plan, pin=pin)
            if announce:
                self._emit_plan_build(digest, bkey, t0, evicted)
            return plan
        nf = mesh.size // mesh.mesh_shape[0]
        plans = [place_plan(plan, dev, pos % nf, nf)
                 for pos, dev in enumerate(mesh.devices)]
        for dev in {v for v in mesh.devices if v.type == "cuda"}:
            # the placement copies ran on the default streams; the
            # positions read the plans on their own
            torch.cuda.synchronize(dev)
        evicted = []
        for pos, p in enumerate(plans):
            evicted += self._plan_cache.put(digest, (bkey, pos), p,
                                            pin=pin | {digest})
        # a mesh key is (digest, (bucket, position)): one record a bucket
        evicted = list(dict.fromkeys((dg, k[0]) for dg, k in evicted))
        if announce:
            self._emit_plan_build(digest, bkey, t0, evicted)
        return plans

    def _emit_plan_build(self, digest: str, bkey, t0: float,
                         evicted) -> None:
        """``bank_plan_build`` for a built plan, ``bank_plan_evict`` for
        each plan its insertion evicted."""
        self._emit(
            "bank_plan_build", digest=digest, bucket=_bucket_name(*bkey),
            build_s=round(time.perf_counter() - t0, 4),
            plan_bytes=self._plan_cache.total_bytes,
        )
        for ev_digest, ev_bkey in evicted:
            self._emit("bank_plan_evict", digest=ev_digest,
                       bucket=_bucket_name(*ev_bkey),
                       plan_bytes=self._plan_cache.total_bytes)

    def add_bank(self, d, blur_psf=None) -> str:
        """Register a bank and build its per-bucket plans without
        touching any route (the make-servable half of a hot-swap).
        Idempotent per digest; returns the bank's digest. Per-bank blur
        PSFs are refused (plans compose the engine's pinned blur)."""
        if blur_psf is not None:
            raise validate.CCSCInputError(
                "add_bank serves the engine's pinned blur operator — "
                "per-bank blur PSFs are not supported (build a "
                "second engine)"
            )
        validate.check_filters(d, self.geom)
        digest = registry.bank_digest(d)
        with self._cv:
            if self._close_started:
                raise RuntimeError("engine is closed")
            known = digest in self._banks
            self._banks[digest] = d
        if not known:
            for bkey in self._buckets:
                self._install_plan(digest, bkey, d)
        return digest

    def publish_bank(
        self, bank_id: Optional[str], d, tenant: Optional[str] = None,
    ) -> Tuple[Optional[str], str]:
        """Hot-swap: make ``d`` servable, then route ``bank_id`` (None =
        the default bank) to its digest. Queued and in-flight requests
        finish on the digest they bound; later admissions serve the new
        one; the cutover is a ``bank_swap`` record with both digests
        (and the publishing ``tenant``). Superseded digests nothing
        references are retired. Returns ``(old_digest, new_digest)``."""
        digest = self.add_bank(d)
        with self._cv:
            if self._close_started:
                raise RuntimeError("engine is closed")
            old = self._routes.get(bank_id)
            self._routes[bank_id] = digest
            stale = [dg for dg in self._banks
                     if dg not in self._routes.values()]
        self._emit("bank_swap", bank_id=bank_id, old_digest=old,
                   new_digest=digest, tenant=tenant)
        for dg in stale:
            self.retire_bank(dg)
        return old, digest

    def retire_bank(self, digest: str) -> bool:
        """Drop one digest's bank, plans and empty lanes. Refused
        (False) while the digest is routed by any bank id, queued in any
        lane or mid-dispatch; True when it is gone."""
        with self._cv:
            if digest in self._routes.values():
                return False
            if digest == self._dispatching:
                return False
            if any(lane[1] == digest and lst
                   for lane, lst in self._pending.items()):
                return False
            self._banks.pop(digest, None)
            for lane in [ln for ln in self._pending if ln[1] == digest]:
                del self._pending[lane]
        self._plan_cache.drop_digest(digest)
        return True

    @property
    def bank_ids(self) -> List[str]:
        """Published bank ids (the default bank routes as None and is
        not listed)."""
        with self._cv:
            return sorted(k for k in self._routes if k is not None)

    def bank_digest(self, bank_id: Optional[str] = None) -> str:
        """The digest ``bank_id`` routes to (None = the default bank)."""
        with self._cv:
            digest = self._routes.get(bank_id)
        if digest is None:
            raise validate.CCSCInputError(f"unknown bank id {bank_id!r}")
        return digest

    def plan_cache_stats(self) -> Dict[str, object]:
        """The plan LRU's accounting (serve.registry.PlanCache)."""
        return self._plan_cache.stats()

    def set_max_wait_ms(self, ms: float) -> None:
        """Retarget the micro-batch flush deadline live."""
        with self._cv:
            self._max_wait_s = max(0.0, float(ms)) / 1e3
            self._cv.notify_all()

    def drain_pending(self) -> List[Dict]:
        """Atomically remove every request still queued (not yet in a
        dispatch) and return its payload (b, mask, smooth_init, x_orig,
        future, bank_id, digest); each returned future is cancelled.
        Requests already dispatching resolve normally."""
        cv = getattr(self, "_cv", None)
        if cv is None:  # construction never reached the queue
            return []
        taken: List[_Pending] = []
        with cv:
            for k in self._pending:
                taken.extend(self._pending[k])
                self._n_pending -= len(self._pending[k])
                self._pending[k] = []
        if taken:
            self._emit("serve_drain", n=len(taken))
        out = []
        for p in taken:
            p.future.cancel()
            out.append({
                "b": p.b, "mask": p.mask, "smooth_init": p.smooth_init,
                "x_orig": p.x_orig, "future": p.future,
                "bank_id": p.bank_id, "digest": p.digest,
            })
        return out

    def _stop_worker(self) -> None:
        cv = getattr(self, "_cv", None)
        if cv is None:
            return
        with cv:
            self._closed = True
            cv.notify_all()
        worker = getattr(self, "_worker", None)
        if worker is not None:
            worker.join()
        for pool in getattr(self, "_pools", ()):
            pool.shutdown(wait=True)

    def close(self):
        """Flush every pending request, stop the worker, and close the
        telemetry run: one closing ``slo_histogram`` per phase, then the
        summary with the latency percentiles. Re-entrant and race-safe:
        the first caller shuts down, the others block until it has
        finished. A no-op on an engine whose constructor raised."""
        with self._close_lock:
            owner = not self._close_started
            self._close_started = True
        if not owner:
            self._close_done.wait()
            return
        try:
            self._stop_worker()
            cap = getattr(self, "_capture", None)
            if cap is not None:
                # seal the capture (meta.json counters and the
                # capture_summary record) while the run is still open
                with contextlib.suppress(Exception):
                    cap.close()
            run = getattr(self, "_run", None)  # None: validation raised
            if run is not None and not run.closed:
                if run.active:
                    for sn in self._slo.final()[1]:
                        self._emit("slo_histogram", **sn)
                    _qb, q_snaps, q_diags = self._quality.final()
                    for sn in q_snaps:
                        self._emit("quality_histogram", **sn)
                    for dg in q_diags:
                        self._emit("quality_solve_diag", **dg)
                st = self.stats()
                run.close(
                    status="ok", n_requests=st["n_requests"],
                    n_dispatches=st["n_dispatches"],
                    mean_occupancy=round(st["mean_occupancy"], 4),
                    **{k: (None if st[k] is None else round(st[k], 5))
                       for k in ("p50_latency_s", "p99_latency_s")},
                )
        finally:
            self._close_done.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
