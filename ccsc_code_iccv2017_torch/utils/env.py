"""The port's ``CCSC_*`` environment knobs (the counterpart of
``ccsc_code_iccv2017_tpu.utils.env``, reduced to the knobs the port
reads, with the JAX package's names, defaults and meanings).

Every read goes through the typed helpers here, so a malformed value
never crashes a run: it warns once and falls back to the declared
default. Values are read from ``os.environ`` on every query, so tests
arm and disarm knobs with ``monkeypatch.setenv``.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional

__all__ = ["Knob", "REGISTRY", "env_str", "env_float", "env_int",
           "env_flag", "env_int_list"]


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # 'str' | 'path' | 'float' | 'int' | 'flag' | 'int_list'
    default: object
    help: str
    surface: str  # the consuming module


REGISTRY: Dict[str, Knob] = {
    k.name: k
    for k in (
        Knob("CCSC_STREAM_RESIDENT_GB", "float", 10.0,
             "byte budget of the streaming learner's auto placement tiers",
             "parallel.streaming"),
        Knob("CCSC_STREAM_MODE", "str", "auto",
             "force a streaming placement tier: device | kern | paged",
             "parallel.streaming"),
        Knob("CCSC_DIST_CONNECT_RETRIES", "int", 5,
             "extra process-group connect attempts of "
             "parallel.distributed.initialize",
             "parallel.distributed"),
        Knob("CCSC_DIST_CONNECT_BACKOFF", "float", 1.0,
             "seconds before the first connect retry (doubling, capped "
             "at 30 s)",
             "parallel.distributed"),
        Knob("CCSC_SERVE_MESH", "str", None,
             "serving-mesh shape 'BATCH' or 'BATCHxFREQ' (e.g. '4', "
             "'2x2'): every bucket's slots split over the mesh's batch "
             "axis and its z-solves over 'freq' (fallback of "
             "ServeConfig.mesh_shape; mesh_shape=() pins an engine to one "
             "device regardless); every bucket's slots must divide by "
             "BATCH",
             "serve.engine, serve.bench"),
        Knob("CCSC_GIT_SHA", "str", None,
             "git revision override for run_meta provenance (deployed "
             "copies without a .git)",
             "utils.obs"),
        Knob("CCSC_OBS_HEARTBEAT_S", "float", 30.0,
             "per-host heartbeat cadence in seconds (0 = every fence)",
             "utils.obs"),
        Knob("CCSC_MEMWATCH", "flag", True,
             "sample torch.cuda.memory_stats() at dispatch fences for the "
             "measured device-memory watermark (0 disables the poller)",
             "utils.memwatch, utils.obs"),
        Knob("CCSC_MEM_DELTA_FRAC", "float", 0.5,
             "modeled-vs-measured peak-memory relative delta above which "
             "the mem_watermark record is flagged",
             "utils.memwatch"),
        Knob("CCSC_MEM_DUMP_DIR", "path", None,
             "OOM forensic dump directory override (default: the run's "
             "metrics dir, else the system temp dir)",
             "utils.memwatch"),
        Knob("CCSC_SLO_P50_MS", "float", None,
             "declared p50 submit->result latency target in ms (fallback "
             "of ServeConfig.slo_p50_ms; unset = no p50 SLO)",
             "serve.slo"),
        Knob("CCSC_SLO_P99_MS", "float", None,
             "declared p99 submit->result latency target in ms (fallback "
             "of ServeConfig.slo_p99_ms; unset = no p99 SLO)",
             "serve.slo"),
        Knob("CCSC_SLO_CHECK_S", "float", 5.0,
             "SLO check + slo_histogram snapshot cadence in seconds",
             "serve.slo"),
        Knob("CCSC_SLO_XPROF_DIR", "path", None,
             "arm a one-shot profiler capture (utils.profiling.xla_trace) "
             "around the next dispatch after an SLO breach, written here "
             "(fallback of ServeConfig.slo_profile_dir; unset = off)",
             "serve.slo, serve.engine"),
        Knob("CCSC_SERVE_MESH_STRICT", "flag", True,
             "refuse a serving mesh the visible devices cannot back (the "
             "shortage in the error); 0 falls back to a single-device "
             "engine with a console note instead",
             "serve.engine"),
        # -- supervision (utils.watchdog) ----------------------------
        Knob("CCSC_WATCHDOG_ACTION", "str", "abort",
             "'abort' hard-exits with EXIT_STALL on a stalled fence; "
             "'event' only records it",
             "utils.watchdog"),
        Knob("CCSC_WATCHDOG_MIN_S", "float", 30.0,
             "per-fence deadline floor in seconds",
             "utils.watchdog"),
        Knob("CCSC_WATCHDOG_COMPILE_S", "float", 300.0,
             "extra allowance on fences that may build kernels (the "
             "first fence includes the nvcc build of K1/K2)",
             "utils.watchdog"),
        Knob("CCSC_WATCHDOG_PEER_STALE_S", "float", 120.0,
             "peer-heartbeat staleness threshold in seconds",
             "utils.watchdog"),
        # -- memory budget (utils.perfmodel, apps._common) ------------
        Knob("CCSC_INMEM_HBM_GB", "float", None,
             "device byte budget of the in-memory learn preflight "
             "(--auto-degrade); unset = the learner device's free bytes "
             "(torch.cuda.mem_get_info), and no preflight on the CPU",
             "utils.perfmodel, apps._common"),
        # -- workload capture (serve.capture) -------------------------
        Knob("CCSC_CAPTURE_DIR", "path", None,
             "workload-capture directory: every admitted request is "
             "durably recorded (payloads content-addressed by sha256, "
             "outcome digest + PSNR + latency) for deterministic replay "
             "(unset = capture off; fallback of ServeConfig.capture_dir)",
             "serve.capture, serve.engine"),
        Knob("CCSC_CAPTURE_SAMPLE", "float", 1.0,
             "fraction of admitted requests captured, deterministic per "
             "key (a request and its outcome always land on the same "
             "side)",
             "serve.capture"),
        Knob("CCSC_CAPTURE_ROTATE_MB", "float", 64.0,
             "request-segment rotation threshold in MB",
             "serve.capture"),
        # -- performance ledger (analysis.ledger) ---------------------
        Knob("CCSC_PERF_LEDGER", "path", None,
             "durable perf-ledger JSONL path; setting it arms the "
             "automatic run/bench/serve appends and the live roofline "
             "anomaly watch (unset = ledger off)",
             "analysis.ledger, utils.obs, serve.bench, serve.engine"),
        Knob("CCSC_COMPILE_CACHE", "path", None,
             "cache directory: the default ledger location "
             "($CCSC_COMPILE_CACHE/ccsc_perf_ledger.jsonl) when "
             "CCSC_PERF_LEDGER is unset",
             "analysis.ledger"),
        Knob("CCSC_PERF_GATE_MAD", "float", 3.0,
             "regression band half-width in MAD-sigmas below the per-key "
             "history median",
             "analysis.ledger"),
        Knob("CCSC_PERF_GATE_FRAC", "float", 0.25,
             "minimum relative drop treated as a regression (the band "
             "floor when the history MAD is ~0)",
             "analysis.ledger"),
        Knob("CCSC_PERF_GATE_MIN_HISTORY", "int", 3,
             "prior records a key needs before the gate/anomaly watch "
             "judge it (younger keys pass trivially)",
             "analysis.ledger"),
        Knob("CCSC_ANOMALY_WINDOW", "int", 3,
             "rolling chunk window of the live anomaly watch",
             "analysis.ledger, utils.obs"),
        # -- chaos / fault injection (utils.faults) -------------------
        Knob("CCSC_FAULT_NAN_IT", "int", None,
             "poison the code iterate inside the step of this 1-based "
             "outer iteration", "utils.faults"),
        Knob("CCSC_FAULT_CKPT_SAVE", "flag", False,
             "crash checkpoint.save between payload write and atomic "
             "commit", "utils.faults"),
        Knob("CCSC_FAULT_SIGTERM_IT", "int", None,
             "raise SIGTERM in the driver thread after this outer "
             "iteration", "utils.faults"),
        Knob("CCSC_FAULT_HANG_IT", "int", None,
             "sleep inside the armed fence after this outer iteration",
             "utils.faults"),
        Knob("CCSC_FAULT_HANG_S", "float", 3600.0,
             "hang-fault sleep duration", "utils.faults"),
        Knob("CCSC_FAULT_ENGINE_KILL_REQ", "int", None,
             "kill a serving replica while processing its k-th taken "
             "request", "utils.faults"),
        Knob("CCSC_FAULT_ENGINE_HANG_REQ", "int", None,
             "hang a serving replica while processing its k-th taken "
             "request", "utils.faults"),
        Knob("CCSC_FAULT_ENGINE_HANG_S", "float", 3600.0,
             "engine hang-fault sleep duration", "utils.faults"),
        Knob("CCSC_FAULT_ENGINE_KILL_REPLICA", "int_list", None,
             "comma list of replica ids armed for the kill fault (unset "
             "= all)", "utils.faults"),
        Knob("CCSC_FAULT_ENGINE_HANG_REPLICA", "int_list", None,
             "comma list of replica ids armed for the hang fault (unset "
             "= all)", "utils.faults"),
        Knob("CCSC_FAULT_ENGINE_SLOW_REQ", "int", None,
             "slow a serving replica (gray failure: delayed, not hung) "
             "starting at its k-th taken request", "utils.faults"),
        Knob("CCSC_FAULT_ENGINE_SLOW_S", "float", 2.0,
             "engine slow-fault added latency per request; keep well "
             "under CCSC_WATCHDOG_MIN_S", "utils.faults"),
        Knob("CCSC_FAULT_ENGINE_SLOW_REPLICA", "int_list", None,
             "comma list of replica ids armed for the slow fault (unset "
             "= all)", "utils.faults"),
        Knob("CCSC_FAULT_CTRL_SENSOR_BLACKOUT", "int", None,
             "blind the capacity controller's sensors starting at its "
             "k-th tick (1-based)", "utils.faults"),
        Knob("CCSC_FAULT_CTRL_BLACKOUT_S", "float", 3.0,
             "sensor-blackout fault duration in seconds", "utils.faults"),
        Knob("CCSC_FAULT_CTRL_ACT_HANG", "int", None,
             "hang the controller's next k actuator invocations",
             "utils.faults"),
        Knob("CCSC_FAULT_CTRL_ACT_HANG_S", "float", 3600.0,
             "actuator hang-fault sleep duration", "utils.faults"),
        Knob("CCSC_FAULT_CTRL_CRASH_SCALE", "flag", False,
             "crash the controller thread between a scale decision and "
             "its actuation (fires once per process/state dir)",
             "utils.faults"),
        Knob("CCSC_FAULT_STATE_DIR", "path", None,
             "cross-restart fire-once marker dir (supervise exports the "
             "metrics dir)", "utils.faults"),
    )
}

_warned: set = set()
_UNSET = object()


def _warn_once(key: str, msg: str) -> None:
    if key not in _warned:
        _warned.add(key)
        warnings.warn(msg)


def _raw(name: str) -> Optional[str]:
    """The stripped value, or None when unset or empty; warns once on a
    name missing from the registry."""
    if name not in REGISTRY:
        _warn_once(f"unregistered:{name}",
                   f"env knob {name} is not declared in utils.env.REGISTRY")
    raw = os.environ.get(name)
    if raw is None:
        return None
    return raw.strip() or None


def _default(name: str, default):
    if default is not _UNSET:
        return default
    knob = REGISTRY.get(name)
    return knob.default if knob is not None else None


def env_str(name: str, default=_UNSET) -> Optional[str]:
    raw = _raw(name)
    return raw if raw is not None else _default(name, default)


def env_float(name: str, default=_UNSET) -> Optional[float]:
    raw = _raw(name)
    if raw is None:
        return _default(name, default)
    try:
        return float(raw)
    except ValueError:
        _warn_once(f"malformed:{name}",
                   f"ignoring malformed env {name}={raw!r} (expected a "
                   "number)")
        return _default(name, default)


def env_int(name: str, default=_UNSET) -> Optional[int]:
    raw = _raw(name)
    if raw is None:
        return _default(name, default)
    try:
        return int(raw)
    except ValueError:
        _warn_once(f"malformed:{name}",
                   f"ignoring malformed env {name}={raw!r} (expected an "
                   "integer)")
        return _default(name, default)


def env_flag(name: str, default=_UNSET) -> bool:
    """Truthy unless unset/empty/'0' (any explicit non-zero value arms
    the switch); unset falls back to the declared default."""
    raw = _raw(name)
    if raw is None:
        return bool(_default(name, default))
    return raw != "0"


def env_int_list(name: str, default=_UNSET):
    """Comma list of ints -> tuple; None when unset; () with a one-time
    warning when malformed (a typo'd restriction list disarms rather
    than arming everything)."""
    raw = _raw(name)
    if raw is None:
        return _default(name, default)
    try:
        return tuple(int(x) for x in raw.split(",") if x.strip())
    except ValueError:
        _warn_once(f"malformed:{name}",
                   f"ignoring malformed env {name}={raw!r} (expected a "
                   "comma list of integers)")
        return ()
