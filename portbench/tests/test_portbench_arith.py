"""The yardstick's arithmetic: the open-loop schedule, latency from the
due time, percentiles, the interval union of the idle share, and the
byte counts of the rooflines."""
from __future__ import annotations

import time
from concurrent.futures import Future

import numpy as np
import pytest

from portbench import drivers, inputs, readers, stats
from portbench.record import PEAKS, RunRecord
from portbench.trace import Trace, Tracer, breakdown

BW = PEAKS["hbm_bytes_per_s"]


def test_schedule_is_fixed_by_the_seed():
    a = inputs.poisson_gaps(2 ** 31 + 7, 255, 30.0)
    b = inputs.poisson_gaps(2 ** 31 + 7, 255, 30.0)
    c = inputs.poisson_gaps(2 ** 31 + 8, 255, 30.0)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # every seed offers the same set of gaps, in another order
    assert np.allclose(np.sort(a), np.sort(c))
    assert a.sum() == pytest.approx(30.0)
    assert inputs.window_count(8.5, 30.0) == 255


class _SlowServer:
    """Answers each request 0.05 s after it is sent, one at a time, and
    stalls 0.3 s once, at the third: the stall must count against every
    later request through its due time."""

    def __init__(self):
        self.t_free = 0.0
        self.n = 0

    def submit(self, j):
        fut = Future()
        self.n += 1
        start = max(time.time(), self.t_free)
        self.t_free = start + 0.05 + (0.3 if self.n == 3 else 0.0)
        delay = self.t_free - time.time()
        import threading

        threading.Timer(delay, fut.set_result, ("r",)).start()
        return fut


def test_open_loop_times_from_the_due_time():
    srv = _SlowServer()
    t0, recs = drivers.open_loop(
        {"rate_rps": 10.0, "pool": 4, "arrival_seed": 3}, srv.submit, 5,
        1.0, Tracer(False), 0.0)
    assert len(recs) == 10
    due = [r["due"] for r in recs]
    assert due[0] == pytest.approx(t0)
    assert all(b >= a for a, b in zip(due, due[1:]))
    run = RunRecord({}, {}, {}, 0.0, 1.0, t0, requests=[
        dict(r, ok=True) for r in recs])
    lat = readers.latencies_ms(run)
    assert all(x >= 50.0 - 5.0 for x in lat)
    # requests after the stall wait for it too
    assert max(lat[3:]) > 150.0
    assert lat == [1e3 * (r["done"] - r["due"]) for r in recs]


def test_percentiles_match_numpy():
    v = list(np.random.default_rng(0).random(255))
    for q in (50, 95, 99):
        assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q))
    assert stats.percentile([3.0], 95) == 3.0


def test_idle_share_is_the_union_not_the_sum():
    ops = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0)]
    tr = Trace(0.0, 10.0, ops, [("submit", 3.5, 4.5)],
               [("aten::item", 3.0, 5.0)])
    assert tr.busy_s() == pytest.approx(4.0)
    run = RunRecord({}, {}, {}, 0.0, 10.0, trace=tr)
    assert readers.idle_pct(run) == pytest.approx(60.0)
    assert stats.gaps([(0, 2), (1, 3), (5, 6)], 0, 10) == [(3, 5), (6, 10)]
    bd = breakdown(tr)
    assert bd["device_ops"][0] == ["a", 2.0]
    assert bd["idle_gaps"][0][1] == pytest.approx(4.0)
    assert bd["idle_gaps"][1] == ["submit / aten::item", 2.0]


@pytest.mark.parametrize("n,bound_ms,with_dinv_ms",
                         [(1, 0.02566, 0.0299), (4, 0.07699, 0.0812)])
def test_k1_bytes_reproduce_the_byte_bounds(n, bound_ms, with_dinv_ms):
    """A z-solve of n 256 x 256 requests (padded by the 11 x 11 support)
    against the k=100 bank. The bounds in the port's kernel table
    (0.0299 / 0.0812 ms) also count a diagonal Gamma^-1 [K, F] float32,
    which the Sherman-Morrison solve with Gamma = rho * I never reads."""
    K, F = 100, 266 * 134
    nbytes = readers.k1_launch_bytes(K, F) + n * readers.k1_image_bytes(K, F)
    assert 1e3 * nbytes / BW == pytest.approx(bound_ms, abs=5e-6)
    assert 1e3 * (nbytes + 4 * K * F) / BW == pytest.approx(with_dinv_ms,
                                                           abs=5e-5)


def test_k2_bytes_at_the_north_star():
    """A fused z-iteration at N=800, K=100, 110 x 110: one code plane set
    is 3.872 GB. The program's two passes each move three of them
    (PERF.md's 3.492 ms a pass); the algorithm reads the codes and duals
    once and writes them once: four planes, 4.64 ms."""
    N, K, S = 800, 100, 110
    F = S * (S // 2 + 1)
    plane = 4 * N * K * S * S
    per_pass = 3 * plane + 8 * F * (K + 2 * N)
    assert 1e3 * per_pass / BW == pytest.approx(3.492, abs=5e-4)
    it = readers.k2_iter_bytes(N, K, S, F)
    assert it == 4 * plane + 8 * F * (N + K) + 4 * F
    assert 1e3 * it / BW == pytest.approx(4.636, abs=5e-3)


def test_k1_roofline_counts_the_requests_not_the_slots():
    K, F = 100, 35644
    t_end = 10.0
    ops = [("void k1_registers<13>(Args)", 9.0 + 0.01 * i,
            9.0 + 0.01 * i + 1e-4) for i in range(50)]
    tr = Trace(8.0, 11.0, ops, [], [])
    run = RunRecord({}, {}, {}, 0.0, 3.0, shapes={"K": K, "F": F,
                                                  "slots": 4},
                    dispatches=[{"requests": 2, "iters": 50, "wall_s": 1.5,
                                 "t_end": t_end, "members": [50, 30]}],
                    trace=tr)
    need = 50 * readers.k1_launch_bytes(K, F) + 80 * readers.k1_image_bytes(
        K, F)
    assert readers.k1_roofline(run) == pytest.approx(
        100 * need / BW / (50 * 1e-4))
    # a dispatch outside the traced stretch is not read
    run.dispatches[0]["t_end"] = 12.0
    assert readers.k1_roofline(run) is None
