"""Reading functions shared by the metric files (``portbench/metrics``):
a metric file binds ``read`` to one of these, so that metrics of the
same quantity in different cells read alike. Each returns None where
the run has nothing to read. The operation and byte counts of the
rooflines are the algorithm's at the cell's shapes (each input read
once, each output written once), whatever kernel implements it."""
from __future__ import annotations

import statistics
from typing import Optional

from . import stats
from .record import RunRecord

# device operations of the port's hand-written kernels, by name
K1_NAMES = ("k1_registers", "k1_loop")
K2_NAMES = ("fused_z_pass_a", "fused_z_pass_b")


# ---- end to end -------------------------------------------------------
def setup_s(run: RunRecord) -> Optional[float]:
    return run.setup_s


def latencies_ms(run: RunRecord):
    """Each completed request's time from when it was due to its result
    on the host."""
    return [1e3 * (q["done"] - q["due"]) for q in run.completed()]


def latency_ms(q: float):
    def read(run: RunRecord) -> Optional[float]:
        lat = latencies_ms(run)
        return stats.percentile(lat, q) if lat else None
    return read


def served_rps(run: RunRecord) -> Optional[float]:
    """Requests whose results came back inside the window, over its
    seconds."""
    if not run.requests:
        return None
    end = run.window_t0 + run.window_s
    return sum(q["done"] <= end for q in run.completed()) / run.window_s


def learn_steps_per_s(run: RunRecord) -> Optional[float]:
    return run.steps / run.window_s if run.steps else None


# ---- serving engine, solve loop ----------------------------------------
def queue_wait_ms(run: RunRecord) -> Optional[float]:
    """Median of the engine's submit -> dispatch start."""
    w = [1e3 * q["wait_s"] for q in run.completed()]
    return statistics.median(w) if w else None


def slots_filled_pct(run: RunRecord) -> Optional[float]:
    d = run.dispatches
    if not d:
        return None
    return 100.0 * sum(e["requests"] for e in d) / (
        run.shapes["slots"] * len(d))


def ms_per_iter(run: RunRecord) -> Optional[float]:
    d = run.dispatches
    iters = sum(e["iters"] for e in d)
    return 1e3 * sum(e["wall_s"] for e in d) / iters if iters else None


# ---- learner -----------------------------------------------------------
def pass_ms(key: str):
    def read(run: RunRecord) -> Optional[float]:
        v = (run.learn_trace or {}).get(key)
        return statistics.median(v) if v else None
    return read


# ---- device ------------------------------------------------------------
def idle_pct(run: RunRecord) -> Optional[float]:
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


# ---- kernels -----------------------------------------------------------
def k1_launch_bytes(K: int, F: int) -> int:
    """What one Sherman-Morrison z-solve launch reads whatever its
    images: the filter spectra [K, F] (complex64) and the rank-one
    denominators [F] (float32). The served solve's Gamma is rho * I, so
    the algorithm reads no diagonal inverse."""
    return 8 * K * F + 4 * F


def k1_image_bytes(K: int, F: int) -> int:
    """What one image of a z-solve adds: its data-side target [F], its
    sparsity-side target [K, F] (read) and its codes [K, F] (written),
    complex64."""
    return 8 * F + 16 * K * F


def _within(ops, lo: float, hi: float) -> float:
    return sum(e - s for _, s, e in ops if s >= lo and e <= hi)


def k1_roofline(run: RunRecord) -> Optional[float]:
    """The engine's z-solves: the bytes the dispatches inside the traced
    stretch needed (one launch an iteration of the dispatch; each
    request's own iterations, never a filler slot's) at the HBM rate,
    over the device time of the z-solve kernels in those dispatches."""
    tr = run.trace
    if tr is None or not run.dispatches:
        return None
    K, F = run.shapes["K"], run.shapes["F"]
    ops = tr.ops_named(K1_NAMES)
    need = took = 0.0
    for d in run.dispatches:
        lo, hi = d["t_end"] - d["wall_s"], d["t_end"]
        if lo < tr.t0 or hi > tr.t1:
            continue
        t = _within(ops, lo, hi)
        if t <= 0:
            continue
        need += (d["iters"] * k1_launch_bytes(K, F)
                 + sum(d["members"]) * k1_image_bytes(K, F))
        took += t
    if took <= 0:
        return None
    return 100.0 * need / run.peaks["hbm_bytes_per_s"] / took


def k2_iter_bytes(codes: int, K: int, S: int, F: int) -> int:
    """One z-iteration of the learner over ``codes`` images: the codes
    and their duals read and written (float32 planes [codes, K, S, S]),
    the data spectra [codes, F] and filter spectra [K, F] (complex64)
    and the rank-one denominators [F] read."""
    return 4 * 4 * codes * K * S * S + 8 * F * (codes + K) + 4 * F


def k2_roofline(run: RunRecord) -> Optional[float]:
    """The learner's fused z-iterations in the traced stretch: their
    bytes at the HBM rate over the device time of the kernels that ran
    them (one iteration = one launch of each of the two passes)."""
    tr = run.trace
    if tr is None:
        return None
    ops = tr.ops_named(K2_NAMES)
    a = sum(K2_NAMES[0] in n for n, _, _ in ops)
    b = sum(K2_NAMES[1] in n for n, _, _ in ops)
    took = sum(e - s for _, s, e in ops)
    if not a or a != b or took <= 0:
        return None
    sh = run.shapes
    need = a * k2_iter_bytes(sh["codes"], sh["K"], sh["S"], sh["F"])
    return 100.0 * need / run.peaks["hbm_bytes_per_s"] / took
