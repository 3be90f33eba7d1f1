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
           "env_flag"]


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # 'str' | 'path' | 'float' | 'int' | 'flag'
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
