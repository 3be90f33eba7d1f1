"""K1's launch plan (``ops.kernels.k1_launch_plan``).

The plan is pure Python, so its cover is checked here for every K in
1..512 and for the image counts and frequency counts the port meets: the
register instantiation it picks holds K (or it takes the generic loop),
its tiles and chunks cover every (n, k, f) of the output exactly once,
and its grid stays inside CUDA's limits. The constants it shares with
``csrc/solve_z_rank1.cu`` (tile, groups, instantiations) are read from
the source. The plain version is held against the JAX package's Pallas
kernel on each side of the instantiations' edges in
``tests/test_torch_freq_solvers.py``; the CUDA kernel itself runs on the
card only: ``test_kernel_matches_plain_on_card`` there and
``chip_smoke.py`` phase 3.
"""
import re
import sys
import threading
import time

import numpy as np
import pytest

from ccsc_code_iccv2017_torch.ops import kernels

H100_SMS, H100_L2 = 132, 50 * 2**20
GRID_X_MAX, GRID_Y_MAX = 2**31 - 1, 65535


def _source():
    with open(kernels.SOURCE) as f:
        return f.read()


def test_plan_constants_match_the_source():
    src = _source()
    assert int(re.search(r"constexpr int kTF = (\d+);", src)[1]) == kernels.K1_TF
    assert int(re.search(r"constexpr int kG = (\d+);", src)[1]) == kernels.K1_G
    cases = {int(c) for c in re.findall(r"case (\d+):", src)}
    assert cases == {0, *kernels.K1_KPT}
    assert kernels.K1_TF * kernels.K1_G <= 1024  # threads per block


@pytest.mark.parametrize("N", [1, 4, 800, 65535, 200000])
def test_plan_covers_every_k(N):
    G, top = kernels.K1_G, max(kernels.K1_KPT)
    for K in range(1, 513):
        plan = kernels.k1_launch_plan(N, K, 6160, H100_SMS, H100_L2)
        kpt = plan["kpt"]
        if K > G * top:
            assert kpt == 0, (K, plan)
        else:
            assert kpt in kernels.K1_KPT and G * kpt >= K, (K, plan)
            smaller = [p for p in kernels.K1_KPT if p < kpt]
            assert all(G * p < K for p in smaller), (K, plan)
        tiles, chunks = plan["grid"]
        assert (plan["tf"], plan["g"]) == (kernels.K1_TF, G)
        assert 1 <= tiles <= GRID_X_MAX and 1 <= chunks <= GRID_Y_MAX
        assert plan["nc"] >= 1 and (chunks - 1) * plan["nc"] < N <= chunks * plan["nc"]


@pytest.mark.parametrize("F", [1, 31, 32, 6160, 35644])
def test_plan_tiles_cover_f(F):
    for N in (1, 4, 800, 65535, 200000):
        plan = kernels.k1_launch_plan(N, 100, F, H100_SMS, H100_L2)
        tiles = plan["grid"][0]
        assert (tiles - 1) * plan["tf"] < F <= tiles * plan["tf"]


@pytest.mark.parametrize(
    "N, K, F, sm, l2, nc, grid",
    [
        # dhat/dinv (12 K F bytes) take more than half the L2: a block
        # takes several images while the grid keeps 8 blocks per SM
        (1, 100, 266 * 134, H100_SMS, H100_L2, 1, (1114, 1)),  # a request
        (4, 100, 266 * 134, H100_SMS, H100_L2, 4, (1114, 1)),  # 4 slots
        (13, 100, 266 * 134, H100_SMS, H100_L2, 8, (1114, 2)),
        (800, 100, 110 * 56, H100_SMS, 8 * 2**20, 8, (193, 100)),
        # the 3D learner's z-solve: 64 clips, K = 49, 60x60x31 bins
        # (dhat + dinv 65.6 MB); its kpt is 8 (49 <= 8 k-groups x 8)
        (64, 49, 60 * 60 * 31, H100_SMS, H100_L2, 8, (3488, 8)),
        # they fit: one image per block (the learner's composition path)
        (800, 100, 110 * 56, H100_SMS, H100_L2, 1, (193, 800)),
        (200000, 100, 1, H100_SMS, H100_L2, 4, (1, 50000)),  # but for
        (600000, 100, 1, H100_SMS, H100_L2, 10, (1, 60000)),  # the y limit
        (600000, 100, 266 * 134, H100_SMS, H100_L2, 10, (1114, 60000)),
    ],
)
def test_plan_images_per_block(N, K, F, sm, l2, nc, grid):
    plan = kernels.k1_launch_plan(N, K, F, sm, l2)
    assert (plan["nc"], plan["grid"]) == (nc, grid)


def _cover(plan, N, K, F):
    """How often the plan's blocks and threads write each (n, k, f),
    following the kernel's index map."""
    tf, G, nc = plan["tf"], plan["g"], plan["nc"]
    tiles, chunks = plan["grid"]
    kpt = plan["kpt"] or -(-K // G)  # the generic loop's count
    count = np.zeros((N, K, F), np.int64)
    bx, by, g, lane, j = np.meshgrid(
        np.arange(tiles), np.arange(chunks), np.arange(G), np.arange(tf),
        np.arange(kpt), indexing="ij",
    )
    f, k = bx * tf + lane, g + j * G
    for i in range(nc):
        n = by * nc + i
        ok = (f < F) & (k < K) & (n < N)
        np.add.at(count, (n[ok], k[ok], f[ok]), 1)
    return count


@pytest.mark.parametrize(
    "N, K, F, sm",
    [
        (1, 1, 1, 1), (3, 7, 33, 1), (5, 13, 40, 1), (9, 100, 70, 1),
        (17, 105, 31, 1), (4, 129, 65, 2), (2, 300, 32, 1),
    ],
)
@pytest.mark.parametrize("l2", [1, H100_L2])  # several images a block, one
def test_plan_writes_each_output_once(N, K, F, sm, l2):
    plan = kernels.k1_launch_plan(N, K, F, sm, l2)
    assert (_cover(plan, N, K, F) == 1).all()


@pytest.mark.parametrize(
    "args",
    [
        (0, 100, 10, 132, H100_L2), (1, 0, 10, 132, H100_L2),
        (1, 100, 0, 132, H100_L2), (1, 100, 10, 0, H100_L2),
        (1, 100, 10, 132, 0), (1.0, 100, 10, 132, H100_L2),
        (1, 100, 2**31, 132, H100_L2), (1, 100, 2**31 - 8, 132, H100_L2),
    ],
)
def test_plan_refuses_what_the_kernel_cannot_take(args):
    with pytest.raises(ValueError):
        kernels.k1_launch_plan(*args)


# ---- the wrappers' bookkeeping under concurrent serving threads


def _hammer(fn, threads=8):
    barrier = threading.Barrier(threads)

    def run():
        barrier.wait()
        fn()

    ts = [threading.Thread(target=run) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)


def test_launch_counts_are_exact_under_eight_threads(monkeypatch):
    """Eight threads bump K1's and K2's launch counts (the wrappers'
    ``count_launch``) 20,000 times each: no count is lost."""
    from ccsc_code_iccv2017_torch.ops import fused_z

    monkeypatch.setattr(kernels.solve_z_rank1, "launches", 0)
    monkeypatch.setattr(fused_z.fused_z_iter, "launches_a", 0)
    monkeypatch.setattr(fused_z.fused_z_iter, "launches_b", 0)
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        def bump():
            for _ in range(20_000):
                kernels.count_launch(kernels.solve_z_rank1)
                kernels.count_launch(fused_z.fused_z_iter, "launches_a")
                kernels.count_launch(fused_z.fused_z_iter, "launches_b")

        _hammer(bump)
    finally:
        sys.setswitchinterval(0.005)
    assert kernels.solve_z_rank1.launches == 160_000
    assert fused_z.fused_z_iter.launches_a == 160_000
    assert fused_z.fused_z_iter.launches_b == 160_000


def test_library_builds_and_binds_once_under_eight_threads(monkeypatch):
    """Eight positions reaching K1 at once: one build, one load, one
    bind, and every thread gets the same library (a mocked build and
    load: no nvcc here)."""
    calls = {"build": 0, "load": 0, "bind": 0}

    def build(name):
        calls["build"] += 1
        time.sleep(0.05)  # a slow build: the others must wait for it
        return {"path": f"/lib{name}.so"}

    class FakeLib:
        def __init__(self, path):
            calls["load"] += 1
            self.path = path

    def bind(lib):
        calls["bind"] += 1
        return lib

    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(kernels, "_LIBRARIES", {})
    got = []
    _hammer(lambda: got.append(kernels.bound_library("k", bind)))
    assert calls == {"build": 1, "load": 1, "bind": 1}
    assert len(got) == 8 and all(g is got[0] for g in got)
