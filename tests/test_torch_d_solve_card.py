"""The d-solve kernel (ops.d_solve, csrc/d_solve.cu) on the card: against
its plain version at the north star's shape ([8, 6160, 100, 100], W = 1)
and at the 4D learner's (W = 25), against a complex128 solve, bitwise
repeatable, on both of its copy paths, its shared memory as the
library computes it, refusing what it does not fit, and launched once a
d-iteration by the learner.

The file imports no JAX, so it runs on a machine with a card and
without JAX (the tests directory's conftest imports JAX)::

    python -m pytest tests/test_torch_d_solve_card.py -m cuda --noconftest

Without a card every test skips (decided in the ``card`` fixture).
"""
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_torch.ops import d_solve as tds
from ccsc_code_iccv2017_torch.ops import freq_solvers as tfs

# the kernel's distance from the plain version, relative to max|x|: two
# float32 sums over ni and K terms taken in another order
VS_PLAIN = 1e-5
# its deviation from a complex128 solve may be at most this many times
# the plain version's (floored at float32's class)
VS_F128 = 2.0
FLOOR = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(card, L, F, ni, K, W, rho, seed):
    """Frequency-major codes, the Woodbury inverse of their Gram (the
    learner's precompute on the kernel's route) and random targets."""
    g = torch.Generator(device=card).manual_seed(seed)

    def c(*shape):
        return torch.randn(shape, dtype=torch.complex64, device=card,
                           generator=g)

    kern = tfs.precompute_d_kernel(c(L, ni, K, F), rho,
                                   b_hat=c(L, ni, W, F))
    assert kern.zhat.is_contiguous() and kern.zhat.shape == (L, F, ni, K)
    return kern, c(L, K, W, F)


def _held(kern, xi, rho, zt=None, blocks=1, freqs=48):
    """(kernel's, plain's) deviation from complex128 on the first
    ``blocks`` blocks and ``freqs`` frequencies, relative to the
    solution's largest entry."""
    zt = (kern.zhat if zt is None else zt)[:blocks, :freqs]
    ginv = kern.ginv[:blocks, :freqs]
    zb, x = kern.zb[:blocks, ..., :freqs], xi[:blocks, ..., :freqs]
    r = (zb.to(torch.complex128) + rho * x.to(torch.complex128))
    Z = zt.to(torch.complex128)
    A = rho * torch.eye(Z.shape[-1], dtype=torch.complex128,
                        device=Z.device) + Z.mH @ Z
    ref = torch.linalg.solve(A, r.movedim(-1, -3)).movedim(-3, -1)
    scale = ref.abs().max()
    got = tds.solve(zt.contiguous(), ginv.contiguous(), zb.contiguous(),
                    x.contiguous(), rho)
    plain = tds.plain(zt, ginv, zb, x, rho)
    return (float((got.to(torch.complex128) - ref).abs().max() / scale),
            float((plain.to(torch.complex128) - ref).abs().max() / scale))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 6160, 100, 100, 1),
                                   (8, 1860, 8, 49, 25)],
                         ids=["north_star", "learn_4d"])
def test_kernel_against_plain_and_complex128(card, shape):
    L, F, ni, K, W = shape
    rho = 50.0
    kern, xi = _inputs(card, L, F, ni, K, W, rho, seed=F)
    before = tds.solve.launches
    got = tds.solve(kern.zhat, kern.ginv, kern.zb, xi, rho)
    want = tds.plain(kern.zhat, kern.ginv, kern.zb, xi, rho)
    torch.cuda.synchronize()
    assert tds.solve.launches == before + 1
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= VS_PLAIN, err
    dev, plain = _held(kern, xi, rho)
    assert dev <= max(FLOOR, VS_F128 * plain), (dev, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((2, 37, 33, 37, 3), 0),
                                          ((2, 37, 10, 12, 1), 1),
                                          ((1, 21, 130, 20, 2), 0),
                                          ((1, 9, 4, 300, 5), 0)],
                         ids=["odd_ni_K", "unaligned", "ni_past_128",
                              "K_past_the_block"])
def test_kernel_copy_paths_and_tiles(card, shape, offset):
    """8-byte copies (odd ni K, a base off 16 bytes), two rounds of a
    row's column chunks, more (k, tile) items than threads: each as close
    to a complex128 solve as the plain version (with ni past K the
    Woodbury difference r - Z^H s cancels most of r, so the distance from
    the plain version, relative to x, is not float32's class)."""
    L, F, ni, K, W = shape
    kern, xi = _inputs(card, L, F, ni, K, W, 7.0, seed=ni)
    zt = kern.zhat
    if offset:  # the same codes one complex past a 16-byte boundary
        zt = torch.empty(zt.numel() + offset, dtype=zt.dtype,
                         device=card)[offset:].view_as(zt).copy_(zt)
    assert (zt.data_ptr() % 16 != 0) == bool(offset)
    dev, plain = _held(kern, xi, 7.0, zt=zt, blocks=L, freqs=F)
    assert dev <= max(FLOOR, VS_F128 * plain), (dev, plain)


@pytest.mark.cuda
def test_bitwise_repeatable(card):
    kern, xi = _inputs(card, 2, 300, 100, 100, 1, 5000.0, seed=3)
    a = tds.solve(kern.zhat, kern.ginv, kern.zb, xi, 5000.0)
    b = tds.solve(kern.zhat, kern.ginv, kern.zb, xi, 5000.0)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_smem_bytes_is_the_compiled_formula(card):
    """fits' twin of the source's shared-memory formula against the
    library's own, over the widths either side of every branch."""
    lib = tds._library()
    for W in (1, 2, 3, 4, 5, 8, 9, 25, 31):
        for ni in (1, 4, 8, 31, 32, 33, 100, 130):
            for K in (1, 7, 49, 100, 300):
                assert tds.smem_bytes(ni, K, W) == \
                    lib.ccsc_d_solve_smem_bytes(ni, K, W), (ni, K, W)


@pytest.mark.cuda
def test_refuses_what_does_not_fit(card):
    ni = K = 200
    assert not tds.fits(ni, K, 1)
    assert tds.route("cuda", torch.complex64, ni, K, 1) == "torch"
    z = torch.zeros((1, 2, ni, K), dtype=torch.complex64, device=card)
    g = torch.zeros((1, 2, ni, ni), dtype=torch.complex64, device=card)
    x = torch.zeros((1, K, 1, 2), dtype=torch.complex64, device=card)
    with pytest.raises(ValueError, match="does not take"):
        tds.solve(z, g, x, x, 1.0)


@pytest.mark.cuda
def test_learner_launches_once_a_d_iteration(card):
    """The consensus learner's hoisted d-pass takes the kernel once a
    d-iteration, and learns what the CPU's einsum route learns from the
    same start."""
    from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
    from ccsc_code_iccv2017_torch.models import common
    from ccsc_code_iccv2017_torch.models import learn as lm
    from ccsc_code_iccv2017_torch.parallel import consensus

    b = np.random.default_rng(0).random((2 * 3, 20, 20), np.float32)
    cfg = LearnConfig(num_blocks=2, max_it=3, max_it_d=4, tol=0.0,
                      verbose="none")
    geom = ProblemGeom((5, 5), 8)
    fg = common.FreqGeom.create(geom, (20, 20))
    init = lm.init_state(torch.Generator().manual_seed(1), geom, fg, 2, 3)
    before = tds.solve.launches
    got = consensus.learn(b, geom, cfg, device=card, initial_state=init)
    launches = tds.solve.launches - before
    want = consensus.learn(b, geom, cfg, device="cpu", initial_state=init)
    steps = len(got.trace["tim_vals"]) - 1
    assert steps == 3 and launches == steps * cfg.max_it_d
    d, ref = got.d.cpu(), want.d
    assert float((d - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    for key in ("obj_vals_d", "obj_vals_z"):
        np.testing.assert_allclose(got.trace[key], want.trace[key],
                                   rtol=1e-4)
