"""Mid-run checkpoint/resume for the learner (a copy of
``ccsc_code_iccv2017_tpu.utils.checkpoint`` without its chaos hooks,
for torch state). Each committed save and each load is a
``checkpoint_save`` / ``checkpoint_load`` record of the current
telemetry run (utils.obs), as in the JAX package.

The file format is the JAX package's, so a checkpoint written by either
package resumes in the other: ``ccsc_state.npz`` holds one array per
LearnState field (bfloat16 fields as their uint16 bit pattern, listed in
``__bf16_fields__``), ``__iteration__`` and ``__fingerprint__``
(utils.resilience.config_fingerprint); ``trace.json`` holds the trace.

Durability contract: every write is tempfile + ``os.replace``; the last
two generations are kept (``ccsc_state.npz`` / ``ccsc_state.prev.npz``,
each with its trace and a sha256 sidecar); ``load`` falls back to the
previous generation when the newest is torn or corrupt, and refuses a
checkpoint whose fingerprint differs from the caller's.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import warnings
from typing import Optional

import numpy as np
import torch

_STATE = "ccsc_state.npz"
_STATE_PREV = "ccsc_state.prev.npz"
_TRACE = "trace.json"
_TRACE_PREV = "trace.prev.json"
_SHA_SUFFIX = ".sha256"

_META_KEYS = {"__iteration__", "__bf16_fields__", "__fingerprint__"}


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _atomic_write_bytes(path_dir: str, final: str, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=path_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    os.replace(tmp, os.path.join(path_dir, final))


def _rotate(path_dir: str, name: str, prev_name: str) -> None:
    cur = os.path.join(path_dir, name)
    if os.path.exists(cur):
        os.replace(cur, os.path.join(path_dir, prev_name))


def _to_numpy(t: torch.Tensor):
    """-> (numpy array, is_bf16); bfloat16 as its uint16 bit pattern."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def save(
    path_dir: str,
    state,
    trace: dict,
    it: int,
    fingerprint: Optional[str] = None,
) -> str:
    """Atomically snapshot ``state`` (a NamedTuple of tensors, e.g.
    models.learn.LearnState) at outer iteration ``it``, rotating the
    existing snapshot to the previous generation."""
    os.makedirs(path_dir, exist_ok=True)
    payload = {}
    bf16 = []
    for f in state._fields:
        payload[f], is_bf16 = _to_numpy(getattr(state, f))
        if is_bf16:
            bf16.append(f)
    payload["__iteration__"] = np.asarray(it)
    payload["__bf16_fields__"] = np.asarray(json.dumps(sorted(bf16)).encode())
    if fingerprint is not None:
        payload["__fingerprint__"] = np.asarray(fingerprint.encode())
    fd, tmp = tempfile.mkstemp(dir=path_dir, suffix=".npz.tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    trace_blob = json.dumps(trace).encode()
    sha = _sha256_file(tmp)
    # rotate sidecar + trace first, then the state, then commit: every
    # crash point leaves at least one loadable generation
    _rotate(path_dir, _STATE + _SHA_SUFFIX, _STATE_PREV + _SHA_SUFFIX)
    _rotate(path_dir, _TRACE, _TRACE_PREV)
    _rotate(path_dir, _STATE, _STATE_PREV)
    final = os.path.join(path_dir, _STATE)
    os.replace(tmp, final)
    _atomic_write_bytes(path_dir, _STATE + _SHA_SUFFIX, sha.encode())
    _atomic_write_bytes(path_dir, _TRACE, trace_blob)
    # one record per committed generation, and a durability point for
    # the event stream itself
    from . import obs

    obs.record("checkpoint_save", iteration=int(it), path=final,
               bytes=os.path.getsize(final))
    run = obs.current_run()
    if run is not None and run.active:
        run.writer.sync()
    return final


def _load_generation(
    path_dir: str, state_name: str, trace_name: str,
    expect_fingerprint: Optional[str], require_trace: bool = False,
):
    """-> (fields, trace, it) for one generation, or None when absent or
    corrupt. Raises ValueError on a fingerprint mismatch."""
    final = os.path.join(path_dir, state_name)
    if not os.path.exists(final):
        return None
    sha_path = final + _SHA_SUFFIX
    if os.path.exists(sha_path):
        with open(sha_path) as f:
            expect_sha = f.read().strip()
        if _sha256_file(final) != expect_sha:
            warnings.warn(
                f"checkpoint {final} fails its sha256 sidecar check "
                "(torn or corrupted write)"
            )
            return None
    try:
        with np.load(final) as z:
            fields = {k: z[k] for k in z.files if k not in _META_KEYS}
            it = int(z["__iteration__"])
            bf16 = (
                json.loads(bytes(z["__bf16_fields__"]).decode())
                if "__bf16_fields__" in z.files
                else []
            )
            fp = (
                bytes(z["__fingerprint__"]).decode()
                if "__fingerprint__" in z.files
                else None
            )
    except Exception as e:  # torn zip, truncated member, bad pickle...
        warnings.warn(f"checkpoint {final} unreadable ({e})")
        return None
    if (
        expect_fingerprint is not None
        and fp is not None
        and fp != expect_fingerprint
    ):
        raise ValueError(
            f"checkpoint {final} was written by a different run "
            f"(fingerprint {fp[:12]}… != expected "
            f"{expect_fingerprint[:12]}…); refusing to resume — point "
            "checkpoint_dir at a fresh directory or delete the stale one"
        )
    tensors = {}
    for k, a in fields.items():
        a = np.ascontiguousarray(a)
        if k in bf16:
            tensors[k] = torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16
            )
        else:
            tensors[k] = torch.from_numpy(a)
    trace = None
    trace_path = os.path.join(path_dir, trace_name)
    if os.path.exists(trace_path):
        try:
            with open(trace_path) as f:
                trace = json.load(f)
        except Exception as e:
            # state + trace rotate as a pair
            warnings.warn(f"checkpoint trace {trace_path} unreadable ({e})")
            return None
    elif require_trace:
        return None
    return tensors, trace, it


def load(path_dir: str, expect_fingerprint: Optional[str] = None):
    """-> (field dict of CPU tensors, trace, iteration) or None if no
    checkpoint. Tries the newest complete (state + trace) generation
    first, then the previous one; a state without its trace is accepted
    last (with a warning). Raises ValueError on a fingerprint mismatch
    and RuntimeError when snapshots exist but none is readable."""
    gens = ((_STATE, _TRACE), (_STATE_PREV, _TRACE_PREV))
    had_newest = os.path.exists(os.path.join(path_dir, _STATE))
    for require_trace in (True, False):
        for idx, (state_name, trace_name) in enumerate(gens):
            got = _load_generation(
                path_dir, state_name, trace_name, expect_fingerprint,
                require_trace=require_trace,
            )
            if got is None:
                continue
            if idx > 0 and had_newest:
                warnings.warn(
                    f"resuming from the previous checkpoint generation in "
                    f"{path_dir} (newest snapshot corrupt or incomplete)"
                )
            if not require_trace and got[1] is None:
                warnings.warn(
                    f"checkpoint {state_name} in {path_dir} has no paired "
                    "trace (crash mid-save?) — resuming its state with a "
                    "fresh trace"
                )
            from . import obs

            obs.record("checkpoint_load", iteration=int(got[2]),
                       path=os.path.join(path_dir, state_name),
                       generation="prev" if idx > 0 else "newest")
            return got
    if had_newest or os.path.exists(os.path.join(path_dir, _STATE_PREV)):
        raise RuntimeError(
            f"checkpoint directory {path_dir} holds snapshots but no "
            "generation is readable — refusing to silently restart"
        )
    return None
