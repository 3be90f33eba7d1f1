"""The library store: content-addressed kernel libraries (torch port of
``ccsc_code_iccv2017_tpu.serve.artifacts``).

An engine of the port compiles no program: its one slow build that can
be reused is a kernel library, the ``.so`` nvcc builds from
``csrc/<name>.cu`` (``ops.kernels``), or the one g++ builds from
``native/ccsc_data.cpp`` (``data.native``). A freshly started host pays
that build before it serves a request. This module is the store that
lets a host fetch the library another host built, the port's
counterpart of the JAX store of AOT executables.

- :func:`library_key` — the store key: one library fingerprint on one
  chip. The fingerprint (``ops.kernels.library_fingerprint``,
  ``data.native.library_fingerprint``) holds everything the build
  depends on: the source's sha256, the compiler flags, the compiler's
  version, the arch and the chip (for the native library, the host
  CPU). A library for another card or CPU is never offered.
- :class:`ArtifactStore` — the JAX store's discipline: one
  ``manifest.jsonl`` appended a record per publish and read with the
  ``analysis.ledger`` torn-tail stance (a torn or truncated record reads
  as ABSENT, never as an error); payloads under ``libraries/<key>.so``
  written tmp + ``os.link`` (O_EXCL first-wins: exactly one of N
  concurrent publishers links the payload and appends the record).
  Fetch re-verifies the payload's sha against the manifest, and refuses
  a record for another chip (``chip_mismatch``), fingerprint
  (``fingerprint_mismatch``) or compiler version (``version_skew``); the
  caller then builds the library and re-publishes it (the repair path
  replaces a corrupt payload atomically).
- :func:`rank_buckets` — the staged-warmup ordering: declared order
  first, else request frequency from a workload capture
  (serve.capture), else the configured volume order. The hottest
  bucket warms FIRST so a joining host serves it while cold buckets
  warm in the background.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import re
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils import env as _env
from ..utils import obs as _obs

__all__ = [
    "ArtifactStore",
    "bucket_label",
    "library_key",
    "rank_buckets",
    "resolve_artifact_dir",
]

_MANIFEST_NAME = "manifest.jsonl"
_LIBRARY_DIR = "libraries"
_SCHEMA = 1


def resolve_artifact_dir(explicit: Optional[str]) -> Optional[str]:
    """The one resolution chain for the store's location: an explicit
    path wins, ``""`` is explicitly off (even with the env knob armed),
    else ``CCSC_ARTIFACT_STORE``, else no store (None) — the
    ``resolve_registry_dir`` convention."""
    if explicit == "":
        return None
    return explicit or _env.env_str("CCSC_ARTIFACT_STORE") or None


def bucket_label(slots: int, spatial: Sequence[int]) -> str:
    """The engine's bucket naming (``"slots@HxW"``) without importing
    the engine (this module stays import-light for tooling)."""
    return f"{int(slots)}@" + "x".join(str(int(s)) for s in spatial)


def library_key(fingerprint: str, chip: str) -> str:
    """The store key: one library fingerprint on one chip (a card
    kind, or a host CPU's identity for the native library).
    Human-readable on purpose — ``ls libraries/`` answers "what is
    stored for which chip" without parsing the manifest; characters a
    file name should not hold become ``_``."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", f"{chip}-{fingerprint}")


class ArtifactStore:
    """Durable content-addressed store of built libraries.

    Concurrency discipline (hosts share a filesystem, nothing else):

    - payloads: written to a pid/thread-suffixed tmp file, then
      ``os.link``\\ ed into place — the link either creates the final
      name (this publisher WON) or raises ``FileExistsError`` (a
      concurrent publisher won; discard). ``os.replace`` fallback for
      filesystems without hard links.
    - manifest: one flushed JSONL line per publish through
      ``utils.obs.EventWriter`` (torn-tail terminated on open); reads
      via ``read_events`` drop torn/corrupt lines — a killed publisher
      leaves an absent record, never a poisoned store.
    - repair: a publish whose payload DIFFERS from the bytes already
      on disk (a corrupt library a fetch just refused) atomically
      replaces them and appends a fresh manifest record — newest
      record wins on read, so the store heals forward.

    ``emit`` is an optional obs-event callable (``run.event``-shaped):
    every publish is then announced as an ``artifact_publish`` event.
    """

    def __init__(self, path: str, emit=None):
        self.path = path
        self._emit = emit
        self._lock = threading.Lock()
        os.makedirs(os.path.join(path, _LIBRARY_DIR), exist_ok=True)
        self._seq = max(
            (int(r.get("seq", 0)) for r in self._read_manifest()),
            default=0,
        )
        self._writer = _obs.EventWriter(
            os.path.join(path, _MANIFEST_NAME)
        )

    # -- read side ----------------------------------------------------
    def _read_manifest(self) -> List[Dict[str, Any]]:
        return [
            r
            for r in _obs.read_events(
                os.path.join(self.path, _MANIFEST_NAME)
            )
            if r.get("key") and r.get("sha256")
        ]

    def keys(self) -> List[str]:
        """Every library key ever published, insertion order."""
        seen: Dict[str, None] = {}
        for rec in self._read_manifest():
            seen.setdefault(rec["key"], None)
        return list(seen)

    def resolve(self, key: str) -> Optional[Dict[str, Any]]:
        """The NEWEST manifest record for ``key`` (a repair republish
        supersedes the record of the corrupt payload it replaced), or
        None."""
        newest = None
        for rec in self._read_manifest():
            if rec["key"] == key:
                newest = rec
        return newest

    def fetch(
        self,
        key: str,
        *,
        fingerprint: Optional[str] = None,
        chip: Optional[str] = None,
        toolkit: Optional[str] = None,
    ) -> Tuple[Optional[bytes], str]:
        """The verified payload for ``key``, or ``(None, reason)``.

        Refusals — all read as a MISS by the caller, which then builds
        the library (and republishes, healing the store):

        - ``miss``: no durable manifest record (includes a torn one);
        - ``chip_mismatch`` / ``fingerprint_mismatch``: the record is
          for another card or host CPU, or another library identity,
          than asked — a foreign library must never be loaded;
        - ``version_skew``: built by another compiler version than
          ``toolkit`` (nvcc's or g++'s version line);
        - ``missing_payload`` / ``corrupt``: payload unreadable, or
          its bytes drifted from the manifest sha (truncation, torn
          write, hand edit).
        """
        rec = self.resolve(key)
        if rec is None:
            return None, "miss"
        if chip is not None and rec.get("chip") != chip:
            return None, "chip_mismatch"
        if (
            fingerprint is not None
            and rec.get("fingerprint") != fingerprint
        ):
            return None, "fingerprint_mismatch"
        if toolkit is not None and rec.get("toolkit") != toolkit:
            return None, "version_skew"
        try:
            with open(
                os.path.join(self.path, rec["path"]), "rb"
            ) as f:
                blob = f.read()
        except OSError:
            return None, "missing_payload"
        if hashlib.sha256(blob).hexdigest() != rec["sha256"]:
            return None, "corrupt"
        return blob, "hit"

    # -- write side ---------------------------------------------------
    def publish(
        self,
        key: str,
        payload: bytes,
        *,
        fingerprint: str,
        chip: str,
        toolkit: Optional[str] = None,
        bucket: Optional[str] = None,
        **meta,
    ) -> Tuple[Optional[Dict[str, Any]], str]:
        """Durably publish one built library. Returns
        ``(manifest_record, status)`` with status one of:

        - ``won``: this call linked the payload in and appended the
          manifest record (exactly one of N concurrent publishers);
        - ``lost``: a concurrent publisher linked first — payload
          discarded, their record (possibly not yet durable) wins;
        - ``exists``: identical bytes already stored — deduped, no new
          record;
        - ``repair``: the on-disk payload differed (corrupt store) —
          replaced atomically and re-recorded.
        """
        sha = hashlib.sha256(payload).hexdigest()
        rel = os.path.join(_LIBRARY_DIR, f"{key}.so")
        fpath = os.path.join(self.path, rel)
        status = "won"
        if os.path.exists(fpath):
            existing = None
            with contextlib.suppress(OSError):
                with open(fpath, "rb") as f:
                    existing = hashlib.sha256(f.read()).hexdigest()
            if existing == sha:
                status = "exists"
            else:
                status = "repair"
        if status != "exists":
            tmp = (
                fpath
                + f".tmp.{os.getpid()}.{threading.get_ident()}"
            )
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            if status == "won":
                try:
                    # O_EXCL discipline: the link either creates the
                    # final name or a concurrent publisher beat us
                    os.link(tmp, fpath)
                except FileExistsError:
                    status = "lost"
                except OSError:  # pragma: no cover - no-hardlink fs
                    os.replace(tmp, fpath)
                    tmp = None
                if tmp:
                    with contextlib.suppress(OSError):
                        os.unlink(tmp)
            else:
                os.replace(tmp, fpath)
        rec: Optional[Dict[str, Any]]
        if status in ("won", "repair"):
            rec = dict(
                schema=_SCHEMA,
                key=str(key),
                fingerprint=str(fingerprint),
                chip=str(chip),
                bucket=bucket,
                toolkit=toolkit,
                sha256=sha,
                size=len(payload),
                path=rel,
                host=socket.gethostname(),
                pid=os.getpid(),
                t=time.time(),
                **meta,
            )
            with self._lock:
                self._seq += 1
                rec["seq"] = self._seq
                self._writer.write(dict(rec))
        else:
            rec = self.resolve(key)
        if self._emit is not None:
            self._emit(
                "artifact_publish",
                key=str(key),
                status=status,
                bucket=bucket,
                chip=str(chip),
                size=len(payload),
                store=self.path,
            )
        return rec, status

    def close(self) -> None:
        with self._lock:
            self._writer.close()

    def __enter__(self) -> "ArtifactStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def rank_buckets(
    buckets: Sequence[Tuple[int, Tuple[int, ...]]],
    declared: Optional[Sequence[str]] = None,
    capture_dir: Optional[str] = None,
) -> List[Tuple[int, Tuple[int, ...]]]:
    """Hot-to-cold ordering of a bucket table for staged warmup.

    ``declared`` (bucket labels, ``"slots@HxW"``) wins — an operator
    who knows the traffic shape states it; labels must name configured
    buckets (a typo must not silently demote the hot bucket), and
    unlisted buckets follow in configured (volume) order. Else, when
    ``capture_dir`` holds a workload capture (serve.capture), buckets
    are ranked by recorded request frequency — the measured
    distribution of the traffic the engine is about to serve. Else the
    configured volume order stands (smallest first — also the
    cheapest bucket to warm, so time-to-first-serveable is minimized
    even without traffic knowledge)."""
    from ..utils import validate

    table = list(buckets)
    labels = {bucket_label(s, sp): (s, sp) for s, sp in table}
    if declared:
        order: List[Tuple[int, Tuple[int, ...]]] = []
        for name in declared:
            if name not in labels:
                raise validate.CCSCInputError(
                    f"warm_order names bucket {name!r} which is not "
                    f"configured — buckets: {sorted(labels)}"
                )
            key = labels[name]
            if key not in order:
                order.append(key)
        order.extend(k for k in table if k not in order)
        return order
    if capture_dir:
        from . import capture as _capture

        counts: Dict[str, int] = {}
        for rec in _capture.read_workload(capture_dir):
            name = rec.get("bucket")
            if name:
                counts[name] = counts.get(name, 0) + 1
        if counts:
            return sorted(
                table,
                key=lambda k: -counts.get(bucket_label(*k), 0),
            )
    return table
