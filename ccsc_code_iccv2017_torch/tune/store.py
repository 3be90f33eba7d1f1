"""The tuned-knob store: measured winners, persisted and keyed (the
port of ``ccsc_code_iccv2017_tpu.tune.store``).

One JSON file holds ranked arm measurements keyed by
``(chip, kind, shape-bucket)`` plus the knob-space code fingerprint
(tune.space.code_fingerprint):

- **The chip is part of the key, and another chip's entry is refused.**
  The chip is ``utils.perfmodel.detect_chip``'s row name (``h100`` for an
  H100 with HBM3, ``cpu`` for a CPU run), so a CPU-measured arm never
  configures a card run and vice versa.
- **The code fingerprint ages entries out**: an arm measured under
  another knob vocabulary stops matching.

Location (:func:`default_store_path`): ``CCSC_TUNE_STORE`` >
``$CCSC_COMPILE_CACHE/ccsc_tuned_knobs.json`` > the kernel build
directory's ``ccsc_tuned_knobs.json`` (a compile cache latched by
``serve.enable_compile_cache``, else the port's gitignored ``build/``).
Unlike JAX's, the default never falls back to the repo-root
``tuned_knobs.json``, the JAX package's TPU store, and the port reads no
TPU or CPU round file (``tuned_knobs.json``, ``bench_tuned.json``,
``onchip_r*.jsonl``): an H100 store starts empty and fills from sweeps
on the card. Writes are atomic (tmp + rename).

The workload tokens and shape keys are JAX's, so the perf ledger
(analysis.ledger) keys a port record exactly as a JAX one of the same
problem.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional

from . import space

SCHEMA_VERSION = 1


def default_store_path() -> str:
    from ..ops import kernels
    from ..utils import env as _env

    override = _env.env_str("CCSC_TUNE_STORE")
    if override:
        return override
    cache = _env.env_str("CCSC_COMPILE_CACHE")
    return os.path.join(cache or kernels.build_dir(),
                        "ccsc_tuned_knobs.json")


def _pow2_bucket(x: int) -> int:
    """Shape-bucket rounding: nearby problem sizes share one key."""
    x = max(1, int(x))
    return 1 << max(0, math.ceil(math.log2(x)))


def learn_workload(geom, algo: str = "consensus") -> str:
    """Workload token of a learner run: algorithm family + spatial
    rank + reduce rank ('consensus2d', 'masked2d+r1', 'streaming3d')."""
    tok = f"{algo}{geom.ndim_spatial}d"
    if geom.ndim_reduce:
        tok += f"+r{geom.ndim_reduce}"
    return tok


def solve_workload(geom) -> str:
    """Workload token of a reconstruction/serving problem
    ('solve2d', 'solve2d+r1', 'solve3d')."""
    tok = f"solve{geom.ndim_spatial}d"
    if geom.ndim_reduce:
        tok += f"+r{geom.ndim_reduce}"
    return tok


def learn_shape_key(
    workload: str, *, k: int, support, n: int, size, blocks: int
) -> str:
    """Shape bucket of a learning problem. ``support``/``size`` may be
    ints or per-dim tuples; n and size are pow2-bucketed, the
    structural dims (k, support, blocks) stay exact."""
    sup = "x".join(
        str(s) for s in (
            support if isinstance(support, (tuple, list)) else [support]
        )
    )
    sz = "x".join(
        str(_pow2_bucket(s)) for s in (
            size if isinstance(size, (tuple, list)) else [size]
        )
    )
    return (
        f"{workload}:k{k}:s{sup}:n{_pow2_bucket(n)}:sz{sz}:b{blocks}"
    )


def solve_shape_key(
    workload: str, *, k: int, support, spatial, mesh=None
) -> str:
    """Shape bucket of a reconstruction/serving problem. ``mesh`` (a
    serving-mesh shape tuple) suffixes the key: a sharded engine is a
    different configuration."""
    sup = "x".join(
        str(s) for s in (
            support if isinstance(support, (tuple, list)) else [support]
        )
    )
    sz = "x".join(str(_pow2_bucket(s)) for s in spatial)
    key = f"{workload}:k{k}:s{sup}:sz{sz}"
    if mesh:
        key += ":m" + "x".join(str(int(a)) for a in mesh)
    return key


_METRIC_RE = None


def _parse_learn_metric(metric: str):
    """(k, support, n, size, blocks) from a north-star bench metric
    string like '2D consensus ADMM outer iters/sec (k=100 11x11
    filters, n=128x100^2, 8 blocks, 1 chip)'; None when unparsable."""
    global _METRIC_RE
    if _METRIC_RE is None:
        import re

        _METRIC_RE = re.compile(
            r"\(k=(\d+) (\d+)x\d+ filters, n=(\d+)x(\d+)\^2, "
            r"(\d+) blocks"
        )
    m = _METRIC_RE.search(metric)
    if not m:
        return None
    k, sup, n, size, blocks = (int(g) for g in m.groups())
    return k, sup, n, size, blocks


def _key(chip: str, kind: str, shape_key: str) -> str:
    return f"{chip}|{kind}|{shape_key}"


class TunedStore:
    """Ranked arm measurements per (chip, kind, shape-bucket) key.

    Entries: {"arm": {...}, "value": float, "unit": str, "source": str,
    "fp": str, "t": float, "demoted": bool, "guard": None | {...}}.
    ``candidates`` returns the non-demoted, fingerprint-current entries
    for ONE chip, fastest first; there is no cross-chip lookup, and
    ``chips_with_entries`` exists only so a caller can say why it
    refused."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_store_path()
        self._data: Dict[str, List[Dict]] = {}
        self.load()

    # -- persistence ---------------------------------------------------
    def load(self) -> "TunedStore":
        self._data = {}
        try:
            with open(self.path, encoding="utf-8") as f:
                raw = json.load(f)
            if (
                isinstance(raw, dict)
                and raw.get("schema") == SCHEMA_VERSION
                and isinstance(raw.get("entries"), dict)
            ):
                self._data = {
                    k: [e for e in v if isinstance(e, dict)]
                    for k, v in raw["entries"].items()
                    if isinstance(v, list)
                }
        except (OSError, ValueError):
            pass  # a missing or corrupt store reads as empty
        return self

    def save(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {"schema": SCHEMA_VERSION, "entries": self._data}, f,
                indent=1, sort_keys=True,
            )
        os.replace(tmp, self.path)

    @property
    def empty(self) -> bool:
        return not any(self._data.values())

    # -- write ---------------------------------------------------------
    def add(self, chip: str, kind: str, shape_key: str,
            arm: Dict[str, object], value: float, unit: str,
            source: str = "") -> Dict:
        """Record one measured arm. Re-measuring an arm REPLACES its
        entry (the newest measurement wins) and clears any demotion: a
        re-measured arm earns a fresh guard verdict."""
        rows = self._data.setdefault(_key(chip, kind, shape_key), [])
        entry = {
            "arm": dict(arm),
            "value": float(value),
            "unit": unit,
            "source": source,
            "fp": space.code_fingerprint(),
            "t": time.time(),
            "demoted": False,
            "guard": None,
        }
        rows[:] = [e for e in rows if e.get("arm") != entry["arm"]]
        rows.append(entry)
        rows.sort(key=lambda e: -float(e.get("value", 0.0)))
        return entry

    def demote(self, chip: str, kind: str, shape_key: str, arm: Dict,
               reason: str = "") -> None:
        for e in self._data.get(_key(chip, kind, shape_key), []):
            if e.get("arm") == arm:
                e["demoted"] = True
                e["demote_reason"] = reason

    def mark_guard(self, chip: str, kind: str, shape_key: str, arm: Dict,
                   ok: bool, dev: float, tol: float) -> None:
        for e in self._data.get(_key(chip, kind, shape_key), []):
            if e.get("arm") == arm:
                e["guard"] = {"ok": bool(ok), "dev": float(dev),
                              "tol": float(tol), "t": time.time()}

    # -- read ----------------------------------------------------------
    @staticmethod
    def _eligible(e: Dict) -> bool:
        return (
            not e.get("demoted")
            and e.get("fp") == space.code_fingerprint()
            and float(e.get("value", 0.0)) > 0
        )

    def candidates(self, chip: str, kind: str, shape_key: str) -> List[Dict]:
        return [e for e in self._data.get(_key(chip, kind, shape_key), [])
                if self._eligible(e)]

    def chips_with_entries(self, kind: str, shape_key: str) -> List[str]:
        """Chips holding an applicable entry for this (kind, shape): used
        only to explain a cross-chip refusal, never to apply one. The
        eligibility filter of ``candidates`` applies, so a chip whose
        entries are all demoted or stale is not reported."""
        out = []
        for key, rows in self._data.items():
            chip, k, sk = key.split("|", 2)
            if k == kind and sk == shape_key and any(
                self._eligible(e) for e in rows
            ):
                out.append(chip)
        return sorted(set(out))
