"""The tuned-knob store's workload tokens and shape keys (copies of
``ccsc_code_iccv2017_tpu.tune.store``'s ``learn_workload``,
``solve_workload``, ``learn_shape_key``, ``solve_shape_key`` and
``_parse_learn_metric``): the perf ledger (analysis.ledger) keys its
records by them, so a port record keys exactly as a JAX one of the same
problem. The store itself (ranked arms, seeding, lookups) is ROADMAP.md
Queue 1 item 9."""
from __future__ import annotations

import math


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
