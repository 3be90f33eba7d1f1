"""Run telemetry: the structured event stream, kernel-library compile
records, heartbeats and the live roofline (torch port of
``ccsc_code_iccv2017_tpu.utils.obs``).

Every learner, the reconstruction and the serving engine emit a
machine-readable stream when one knob is set (``LearnConfig.metrics_dir``
/ ``SolveConfig.metrics_dir`` / ``ServeConfig.metrics_dir`` /
``--metrics-dir``). The record types and field names are the JAX
package's (``analysis.obs_schema``), so its readers
(``scripts/obs_report.py``, ``utils.trace.assemble``,
``serve.slo.from_snapshot``) read the port's stream unchanged.

- ``EventWriter`` / ``read_events`` / ``EventTail`` — an append-only
  JSONL stream, one file per process (``events-pNNNNN.jsonl``, NNNNN the
  ``torch.distributed`` rank when a process group is up), one flushed
  line per record; readers drop a torn trailing line.
- ``Run`` — the per-run handle the drivers hold: typed records
  (``run_meta``, ``step``, ``roofline``, ``heartbeat``, ``phase``,
  ``log``, ``compile``, ``mem_watermark``, ``summary``, ...), and the
  console tier: ``Run.console`` prints and records the same line.
- ``CompileMonitor`` — the port has no jit: its compiles are its
  kernel libraries. While a run is open, ``ops.kernels`` reports each
  nvcc build (``kind="build"``) and each load of a built library
  (``kind="load"``) through :func:`report_compile`; the closing summary
  counts them per library, and a library loaded twice in one process
  lands in ``recompiled_funs``.
- roofline — ``Run.chunk`` scores each chunk's achieved iteration rate
  against the analytic utils.perfmodel bounds.

All record fields are host values read at the driver's existing fence;
no ``Run`` method touches a device tensor.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import socket
import subprocess
import threading
import time
from typing import Any, Dict, List, Optional

from . import env as _env

SCHEMA_VERSION = 1

# console tiers, most to least important; a Run at verbose level v
# prints every message whose tier is at or above v ('always' prints even
# at verbose='none')
_TIERS = {"always": 0, "brief": 1, "all": 2}
_VERBOSE_ADMITS = {"none": 0, "brief": 1, "all": 2}


def percentile(vals: List[float], q: float) -> Optional[float]:
    """Exact nearest-rank percentile of a sample (None when empty). The
    serving stack's streaming percentiles come from serve.slo.Histogram;
    this exact form is for small one-shot samples."""
    if not vals:
        return None
    sorted_vals = sorted(vals)
    i = min(len(sorted_vals) - 1, int(math.ceil(q * len(sorted_vals))) - 1)
    return sorted_vals[max(0, i)]


def git_sha() -> Optional[str]:
    """Best-effort git revision of the running tree (provenance field of
    run_meta). ``CCSC_GIT_SHA`` first, so copies without a .git can
    still stamp records."""
    override = _env.env_str("CCSC_GIT_SHA")
    if override:
        return override
    return _checkout_sha(_REPO_ROOT)


# the directory that holds the package: the top of its checkout
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@functools.lru_cache(maxsize=None)
def _checkout_sha(root: str) -> Optional[str]:
    """HEAD of the git checkout whose top is ``root``, read once a
    process; None when ``root`` is not the top of a checkout. The search
    for a .git stops at ``root``'s parent, so a copy without its own
    .git never stamps a surrounding repository's revision."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--show-toplevel", "HEAD"],
            cwd=root,
            capture_output=True,
            text=True,
            timeout=10,
            env=dict(os.environ,
                     GIT_CEILING_DIRECTORIES=os.path.dirname(root)),
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.splitlines()
    if out.returncode != 0 or len(lines) != 2:
        return None
    top, sha = lines
    return sha if os.path.realpath(top) == os.path.realpath(root) else None


def _process_group():
    """(rank, world size) of the initialised torch.distributed group, else
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _process_index() -> int:
    return _process_group()[0]


class EventWriter:
    """Append-only JSONL writer; one flushed line per record.

    Append mode means a resumed run keeps extending the same file — the
    stream is the union of all attempts, each starting with its own
    run_meta record. fsync is reserved for ``sync()`` (checkpoints and
    close). The lock is re-entrant: a signal handler may emit while the
    main thread is mid-write, and the serving engine's dispatch thread
    writes beside the caller's."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        # a previous attempt killed mid-write leaves a torn final line
        # with no newline; terminate it before appending
        try:
            with open(path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                torn = f.read(1) != b"\n"
        except (OSError, ValueError):
            torn = False
        self._f = open(path, "a", encoding="utf-8")
        if torn:
            self._f.write("\n")
        self._lock = threading.RLock()

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, default=_json_default)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def sync(self) -> None:
        with self._lock:
            self._f.flush()
            try:
                os.fsync(self._f.fileno())
            except OSError:  # pragma: no cover - exotic filesystems
                pass

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


def _json_default(o):
    """numpy scalars and arrays, and host tensors, as JSON values. A
    tensor on a device is refused: its value must be read back at the
    driver's fence, never inside the stream."""
    import numpy as np

    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    import torch

    if torch.is_tensor(o):
        if o.device.type != "cpu":
            raise TypeError(
                f"a {o.device} tensor in an obs record: read it back at "
                "the step's fence and pass host values"
            )
        return o.tolist()
    return str(o)


def _event_files(path: str, recursive: bool) -> List[str]:
    """The ``events*.jsonl`` files of a dir (and, with ``recursive``,
    of its subdirs), in name order."""
    out: List[str] = []
    if recursive:
        for root, _dirs, files in sorted(os.walk(path)):
            out.extend(os.path.join(root, n) for n in sorted(files)
                       if n.startswith("events") and n.endswith(".jsonl"))
        return out
    try:
        names = sorted(os.listdir(path))
    except OSError:
        return []
    return [os.path.join(path, n) for n in names
            if n.startswith("events") and n.endswith(".jsonl")]


def read_events(path: str, recursive: bool = False) -> List[Dict[str, Any]]:
    """Parse one events file or every ``events-*.jsonl`` in a dir (with
    ``recursive``, its subdirs too), merged in timestamp order. A torn
    or malformed line is dropped rather than failing the stream."""
    if os.path.isdir(path):
        recs: List[Dict[str, Any]] = []
        for f in _event_files(path, recursive):
            recs.extend(read_events(f))
        recs.sort(key=lambda r: r.get("t", 0.0))
        return recs
    out = []
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn write
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        return []
    return out


class EventTail:
    """Incremental reader of a live event stream: remembers a byte
    offset per file and parses only APPENDED whole lines on each
    ``poll()``. A torn trailing line waits for the next poll; a file
    that shrank (rotation/truncation) is re-read from byte 0; files that
    appear later are picked up. Each batch comes back in timestamp
    order."""

    def __init__(self, path: str, recursive: bool = False):
        self.path = path
        self.recursive = recursive
        self._offsets: Dict[str, int] = {}

    def _files(self) -> List[str]:
        if not os.path.isdir(self.path):
            return [self.path] if os.path.exists(self.path) else []
        return _event_files(self.path, self.recursive)

    def poll(self) -> List[Dict[str, Any]]:
        recs: List[Dict[str, Any]] = []
        for path in self._files():
            off = self._offsets.get(path, 0)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            if size < off:  # rotated/truncated under us
                off = 0
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read()
            except OSError:
                continue
            if not chunk:
                continue
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                continue  # torn line only; retry next poll
            self._offsets[path] = off + last_nl + 1
            for line in chunk[: last_nl + 1].splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line.decode("utf-8", "replace"))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue
                if isinstance(rec, dict):
                    recs.append(rec)
        recs.sort(key=lambda r: r.get("t", 0.0))
        return recs


# --------------------------------------------------------------------
# compile records: the kernel libraries
# --------------------------------------------------------------------

class _MonitorHub:
    """Process-wide fan-out of kernel-library compile reports to every
    subscribed monitor (runs can overlap, each with its own monitor)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: List["CompileMonitor"] = []

    def subscribe(self, mon: "CompileMonitor") -> None:
        with self._lock:
            self._subs.append(mon)

    def unsubscribe(self, mon: "CompileMonitor") -> None:
        with self._lock:
            if mon in self._subs:
                self._subs.remove(mon)

    def publish(self, rec: Dict[str, Any]) -> None:
        # dispatch outside the lock: a monitor's sink writes the stream
        with self._lock:
            subs = list(self._subs)
        for m in subs:
            m._on_compile(rec)


_HUB = _MonitorHub()


def report_compile(kind: str, fun_name: str, duration_s: float) -> None:
    """Called by ops.kernels: a kernel library was built with nvcc
    (``kind="build"``) or a built library was loaded (``"load"``),
    taking ``duration_s``. Reaches every open run's monitor."""
    _HUB.publish({"kind": kind, "fun_name": fun_name,
                  "duration_s": float(duration_s), "t": time.time()})


class CompileMonitor:
    """Collects the kernel-library compile reports of one run."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._installed = False
        self._sink = None

    def _on_compile(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self.events.append(rec)
        if self._sink is not None:
            self._sink(rec)

    def install(self, sink=None) -> "CompileMonitor":
        if not self._installed:
            self._sink = sink
            _HUB.subscribe(self)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            _HUB.unsubscribe(self)
            self._sink = None
            self._installed = False

    def summary(self) -> Dict[str, Any]:
        """The closing summary under JAX's keys: ``n_compiles`` (builds
        plus loads), ``n_builds``, ``compile_time_s`` (their seconds),
        ``compiles_by_fun`` (loads per library) and ``recompiled_funs``
        (libraries loaded more than once). The port traces nothing, so
        ``trace_time_s`` is 0."""
        with self._lock:
            events = list(self.events)
        by_fun: Dict[str, int] = {}
        for ev in events:
            if ev["kind"] == "load":
                by_fun[ev["fun_name"]] = by_fun.get(ev["fun_name"], 0) + 1
        return {
            "n_compiles": len(events),
            "n_builds": sum(ev["kind"] == "build" for ev in events),
            "compile_time_s": round(sum(ev["duration_s"] for ev in events),
                                    4),
            "trace_time_s": 0.0,
            "compiles_by_fun": by_fun,
            "recompiled_funs": sorted(f for f, c in by_fun.items() if c > 1),
        }


# --------------------------------------------------------------------
# the Run handle
# --------------------------------------------------------------------

_CURRENT: List["Run"] = []
_CURRENT_LOCK = threading.Lock()


def current_run() -> Optional["Run"]:
    """Innermost active Run, if any — the hook utils.checkpoint and
    utils.resilience use to emit without threading a handle through."""
    with _CURRENT_LOCK:
        return _CURRENT[-1] if _CURRENT else None


def record(type_: str, **fields) -> None:
    """Append a record to the current run's stream (no-op without an
    active run or with telemetry off)."""
    run = current_run()
    if run is not None:
        run.event(type_, **fields)


def console(msg: str, tier: str = "brief") -> None:
    """Route a console line through the current run's verbose tier; a
    plain print when no run is open and the tier is important enough."""
    run = current_run()
    if run is not None:
        run.console(msg, tier=tier)
    elif _TIERS.get(tier, 1) <= _TIERS["brief"]:
        print(msg, flush=True)


class Run:
    """One run's telemetry handle.

    ``writer`` None = telemetry off: the console tier still works (the
    drivers hold one code path) and every event method is a cheap no-op.
    All record fields must already be host values: the drivers call
    these methods after their existing host read, so instrumentation
    adds no read and no launch.

    ``anomaly`` and ``_ledger_meta`` are the performance ledger's hooks
    (``analysis.ledger``, not in the port yet): they stay None, so
    ``_ledger_record`` is a no-op and no ``ledger_append`` or
    ``perf_anomaly`` record is written.
    """

    def __init__(
        self,
        writer: Optional[EventWriter],
        verbose: str = "brief",
        heartbeat_every_s: Optional[float] = None,
    ):
        self.writer = writer
        self.verbose = verbose if verbose in _VERBOSE_ADMITS else "brief"
        self.closed = False
        self.compile_monitor: Optional[CompileMonitor] = None
        self.chip: Optional[str] = None
        self.anomaly = None
        self.memwatch = None  # utils.memwatch.MemWatch
        self.modeled_hbm_bytes: Optional[int] = None
        self._ledger_meta: Optional[Dict[str, Any]] = None
        self._host = _process_index()
        if heartbeat_every_s is None:
            heartbeat_every_s = _env.env_float("CCSC_OBS_HEARTBEAT_S")
        self._hb_every = heartbeat_every_s
        self._hb_last = 0.0
        self._n_events = 0

    @property
    def active(self) -> bool:
        return self.writer is not None and not self.closed

    # -- primitives ----------------------------------------------------
    def event(self, type_: str, **fields) -> None:
        if not self.active:
            return
        rec = {"t": time.time(), "type": type_, "host": self._host}
        rec.update(fields)
        self.writer.write(rec)
        self._n_events += 1

    def console(self, msg: str, tier: str = "brief") -> None:
        """Print ``msg`` when the run's verbose level admits ``tier``,
        and record the printed line as a ``log`` record (lines the tier
        suppresses are not recorded either)."""
        if _TIERS.get(tier, 1) <= _VERBOSE_ADMITS[self.verbose]:
            print(msg, flush=True)
            self.event("log", tier=tier, msg=msg)

    # -- typed records -------------------------------------------------
    def step(self, it: int, **metrics) -> None:
        self.event("step", it=int(it), **metrics)

    def chunk(
        self,
        start_it: int,
        length: int,
        n_adopted: int,
        dt_s: float,
        cost: Optional[Dict[str, float]] = None,
    ) -> None:
        """Per-chunk throughput record; with a perfmodel ``cost`` the
        live roofline (MFU + memory fraction vs the card's bounds) rides
        the same record and the 'all' console tier."""
        ips = (n_adopted / dt_s) if dt_s > 0 and n_adopted else 0.0
        # the chunk's fence just completed: the point where allocator
        # state is meaningful
        if self.memwatch is not None:
            self.memwatch.sample()
        fields: Dict[str, Any] = {
            "start_it": int(start_it),
            "length": int(length),
            "n_adopted": int(n_adopted),
            "dt_s": round(float(dt_s), 6),
            "it_per_sec": round(ips, 5),
        }
        line = (
            f"chunk {start_it + 1}..{start_it + n_adopted}: "
            f"{ips:.3g} it/s"
        )
        if cost is not None and ips > 0:
            from . import perfmodel

            util = perfmodel.utilization(cost, ips, chip=self.chip)
            self.chip = util["chip"]
            bound = perfmodel.bound_iters_per_sec(cost, chip=util["chip"])
            fields.update(
                chip=util["chip"],
                mfu=round(util["mfu_vs_bf16_peak"], 6),
                hbm_frac=round(util["hbm_frac"], 5),
                achieved_tflops=round(util["achieved_tflops"], 4),
                achieved_gbps=round(util["achieved_gbps"], 3),
                bound_it_per_sec=round(bound, 4),
            )
            if bound > 0 and math.isfinite(bound):
                fields["roofline_frac"] = round(ips / bound, 6)
            line += (
                f", MFU {100 * util['mfu_vs_bf16_peak']:.2f}%, "
                f"HBM {100 * util['hbm_frac']:.1f}%, "
                f"{100 * ips / bound:.0f}% of the {util['chip']} "
                f"roofline bound ({bound:.3g} it/s)"
            )
        self.event("roofline", **fields)
        if _VERBOSE_ADMITS[self.verbose] >= _TIERS["all"]:
            print(line, flush=True)

    def heartbeat(self, step: int, fence_latency_s: float) -> None:
        """Periodic per-process liveness record (cadence
        CCSC_OBS_HEARTBEAT_S seconds, default 30; 0 = every fence)."""
        if not self.active:
            return
        now = time.time()
        if self._hb_last and now - self._hb_last < self._hb_every:
            return
        self._hb_last = now
        self.event(
            "heartbeat",
            step=int(step),
            fence_latency_s=round(float(fence_latency_s), 6),
        )

    def drain_timers(self, timers, phase: str = "run") -> None:
        """Flush a utils.profiling.SectionTimers into one ``phase``
        record (totals since the previous drain) and reset it."""
        if timers is None:
            return
        drained = timers.drain()
        if drained:
            self.event("phase", phase=phase, sections=drained)

    def _ledger_record(self, status: str) -> None:
        """The perf ledger's close-time append: a no-op until
        analysis.ledger arms ``_ledger_meta``."""
        return None

    # -- lifecycle -----------------------------------------------------
    def close(self, status: str = "ok", **fields) -> None:
        """Write the closing records (``mem_watermark`` and the
        ``summary`` with the compile summary) and release the monitor
        and the file. Idempotent: drivers call it from a finally with
        status='error' as the backstop; the first close wins."""
        with _CURRENT_LOCK:
            if self.closed:
                return
            self.closed = True
            if self in _CURRENT:
                _CURRENT.remove(self)
        if self.compile_monitor is not None:
            summary = self.compile_monitor.summary()
            self.compile_monitor.uninstall()
        else:
            summary = None
        if self.memwatch is not None:
            self.memwatch.sample()
        self._ledger_record(status)
        if self.writer is None:
            return
        # written directly (the run is already closed, so event() would
        # no-op) and before the summary, so readers see them inside it
        if self.memwatch is not None:
            wm = self.memwatch.watermark_record(self.modeled_hbm_bytes)
            if wm is not None:
                self.writer.write({"t": time.time(), "type": "mem_watermark",
                                   "host": self._host, **wm})
        rec = {
            "t": time.time(),
            "type": "summary",
            "host": self._host,
            "status": status,
            "n_events": self._n_events + 1,
        }
        if summary is not None:
            rec["compile"] = summary
            if summary["recompiled_funs"]:
                msg = ("obs: kernel libraries loaded more than once: "
                       + ", ".join(summary["recompiled_funs"]))
                if _VERBOSE_ADMITS[self.verbose] >= _TIERS["all"]:
                    print(msg, flush=True)
        rec.update(fields)
        self.writer.write(rec)
        self.writer.sync()
        self.writer.close()


class _NullWriterRun(Run):
    """Telemetry-off Run (console tier only)."""

    def __init__(self, verbose: str = "brief"):
        super().__init__(None, verbose=verbose)


def _device_meta(device) -> Dict[str, Any]:
    """The run_meta fields that name the software and the device."""
    import torch

    from . import perfmodel

    rank, world = _process_group()
    dev = (torch.device("cuda" if torch.cuda.is_available() else "cpu")
           if device is None else torch.device(device))
    gpu = dev.type == "cuda"
    meta = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": "gpu" if gpu else "cpu",
        "device_count": torch.cuda.device_count() if gpu else 1,
        "process_index": rank,
        "process_count": world,
        "chip": perfmodel.detect_chip(dev),
    }
    if gpu:
        meta["device_name"] = torch.cuda.get_device_name(dev)
    return meta


def start_run(
    metrics_dir: Optional[str],
    algorithm: str,
    verbose: str = "brief",
    geom=None,
    cfg=None,
    fingerprint: Optional[str] = None,
    mesh=None,
    compile_monitor: bool = True,
    device=None,
    **extra_meta,
) -> Run:
    """Open a telemetry run (or a console-only null run when
    ``metrics_dir`` is None) and push it as the current run.

    Writes the run_meta record — git sha, host identity, the torch and
    CUDA versions, platform, device name and counts, process index and
    count, chip, mesh shape, the full knob dict of ``cfg``, geometry and
    the checkpoint fingerprint — arms the memory watermark (on a card,
    unless ``CCSC_MEMWATCH=0``) and the compile monitor.
    ``compile_monitor=False`` skips the monitor (a run nested under
    another open run lets the outer one record the compiles).
    ``device``: the run's device (None: cuda:0 when a card is visible)."""
    if metrics_dir is None:
        run = _NullWriterRun(verbose=verbose)
        with _CURRENT_LOCK:
            _CURRENT.append(run)
        return run
    pid = _process_index()
    writer = EventWriter(
        os.path.join(metrics_dir, f"events-p{pid:05d}.jsonl")
    )
    run = Run(writer, verbose=verbose)
    meta: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "algorithm": algorithm,
        "git_sha": git_sha(),
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "fingerprint": fingerprint,
    }
    meta.update(_device_meta(device))
    run.chip = meta["chip"]
    if mesh is not None:
        meta["mesh_shape"] = {str(k): int(v) for k, v in mesh.shape.items()}
    if geom is not None:
        meta["geom"] = {
            "spatial_support": list(geom.spatial_support),
            "num_filters": geom.num_filters,
            "reduce_shape": list(geom.reduce_shape),
        }
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
    meta.update(extra_meta)
    if meta["platform"] == "gpu":
        import torch

        from . import memwatch as _memwatch

        dev = torch.device("cuda" if device is None else device)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        mw = _memwatch.MemWatch(devices=[dev])
        if mw.enabled:
            run.memwatch = mw
    run.event("run_meta", **meta)
    if compile_monitor:
        run.compile_monitor = CompileMonitor().install(
            sink=lambda ev: run.event(
                "compile",
                kind=ev["kind"],
                fun_name=ev["fun_name"],
                duration_s=round(ev["duration_s"], 6),
                shapes=None,
            )
        )
    with _CURRENT_LOCK:
        _CURRENT.append(run)
    return run
