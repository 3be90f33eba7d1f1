"""The d-solve kernel's plain version, limits and wrapper (ops.d_solve),
and ``freq_solvers.solve_d``'s gate around it, on the CPU.

The plain version is held to the einsum body the port ran before the
kernel (written out below) and to a float64 solve; ``fits`` to the CUDA
source's shared-memory limit; the off-gate routes (a target
that is not hoisted, a filter axis, the CPU) to the einsum body bit for
bit. The gate itself is driven here by routing as the card would
(``d_solve.route`` patched to 'kernel'), where ``d_solve.solve`` runs its
plain version on CPU tensors. The kernel is compared with the plain
version on the card (``tests/test_torch_d_solve_card.py``).
"""
import os
import re

import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_torch.ops import d_solve as tds
from ccsc_code_iccv2017_torch.ops import freq_solvers as tfs
from ccsc_code_iccv2017_torch.ops import kernels

RTOL = 1e-5  # float32 sums over ni and K terms in another order
# a cut of the north star's block (8 blocks of ni = K = 100 at F = 6160):
# blocks, ni, K, an odd F
CUT = (2, 10, 12, 37)


def _c(r, *shape):
    return torch.from_numpy((r.normal(size=shape) + 1j * r.normal(size=shape))
                            .astype(np.complex64))


def _problem(W, seed=0):
    r = np.random.default_rng(seed)
    L, ni, K, F = CUT
    return _c(r, L, ni, K, F), _c(r, L, ni, W, F), _c(r, L, K, W, F)


def _einsum_precompute(zhat, rho, b_hat=None):
    """The d-kernel as the port built it before the d-solve kernel: the
    Gram and Z^H b by einsums over the k-major spectra [..., ni, K, F]."""
    G = torch.einsum("...nkf,...mkf->...fnm", zhat, zhat.conj())
    zb = None
    if b_hat is not None:
        zb = torch.einsum("...nkf,...nwf->...kwf", zhat.conj(), b_hat)
    return tfs.shifted_hermitian_inverse(G, rho), zb


def _einsum_solve(zhat, ginv, zb, b_hat, xi, rho):
    """solve_d's einsum body as it was (no filter axis)."""
    if zb is None:
        zb = torch.einsum("...nkf,...nwf->...kwf", zhat.conj(), b_hat)
    r = zb + rho * xi
    t = torch.einsum("...nkf,...kwf->...nwf", zhat, r)
    s = torch.einsum("...fnm,...mwf->...nwf", ginv, t)
    return (r - torch.einsum("...nkf,...nwf->...kwf", zhat.conj(), s)) / rho


def _close(got, want, rtol=RTOL):
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), err


@pytest.fixture
def as_on_the_card(monkeypatch):
    """Route as the card would for complex64 that fits; count the calls
    of d_solve.solve (which runs the plain version on CPU tensors)."""
    calls = []
    solve = tds.solve

    def counted(*a, **k):
        calls.append(a[0].shape)
        return solve(*a, **k)

    monkeypatch.setattr(
        tds, "route", lambda dev, dtype, ni, K, W:
        "kernel" if dtype == torch.complex64 and tds.fits(ni, K, W)
        else "torch")
    monkeypatch.setattr(tds, "solve", counted)
    return calls


@pytest.mark.parametrize("W", [1, 3])
def test_plain_matches_the_einsum_body_and_float64(W):
    zhat, bhat, xi = _problem(W, seed=W)
    rho = 50.0
    ginv, zb = _einsum_precompute(zhat, rho, bhat)
    want = _einsum_solve(zhat, ginv, zb, None, xi, rho)
    zt = zhat.movedim(-1, -3).contiguous()
    ginv, zb = ginv.contiguous(), zb.contiguous()
    got = tds.plain(zt, ginv, zb, xi, rho)
    assert got.shape == xi.shape and got.is_contiguous()
    _close(got, want)
    assert torch.equal(tds.solve(zt, ginv, zb, xi, rho), got)
    L, ni, K, F = CUT
    z64, b64, x64 = (t.numpy().astype(np.complex128) for t in (zhat, bhat, xi))
    for blk in range(L):
        for f in (0, F // 2, F - 1):
            Z = z64[blk, :, :, f]
            A = rho * np.eye(K) + Z.conj().T @ Z
            rhs = Z.conj().T @ b64[blk, :, :, f] + rho * x64[blk, :, :, f]
            np.testing.assert_allclose(got[blk, :, :, f].numpy(),
                                       np.linalg.solve(A, rhs),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("W", [1, 2, 3, 8, 25, 31])
def test_fits_is_the_sources_limit(W):
    """THREADS and MAX_SMEM are the source's kThreads and kMaxSmem; fits
    is smem_bytes under that limit (smem_bytes is held to the compiled
    formula on the card, tests/test_torch_d_solve_card.py), holding at
    least the codes, r and t, and growing with ni and K."""
    path = kernels.sources()["d_solve"]
    assert os.path.basename(path) == "d_solve.cu"
    src = open(path).read()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src)[1]) == \
        tds.THREADS == 256
    assert int(re.search(r"constexpr size_t kMaxSmem = (\d+);", src)[1]) \
        == tds.MAX_SMEM
    for ni in (1, 4, 8, 31, 32, 33, 100, 130):
        for K in (1, 7, 49, 100, 300):
            assert tds.fits(ni, K, W) == (
                tds.smem_bytes(ni, K, W) <= tds.MAX_SMEM)
            assert tds.smem_bytes(ni, K, W) >= 8 * (ni * K + W * (K + ni))
            assert tds.smem_bytes(ni + 1, K, W) > tds.smem_bytes(ni, K, W)
            assert tds.smem_bytes(ni, K + 1, W) > tds.smem_bytes(ni, K, W)
    # the largest ni x ni codes that fit, and one more
    n = max(n for n in range(1, 300) if tds.fits(n, n, W))
    assert tds.smem_bytes(n + 1, n + 1, W) > tds.MAX_SMEM
    assert tds.route("cuda", torch.complex64, n, n, W) == "kernel"
    assert tds.route("cuda", torch.complex64, n + 1, n + 1, W) == "torch"


def test_the_learners_shapes_fit():
    """The north star (ni = K = 100, W = 1) with two blocks an SM, the 3D
    (8, 49, 1), 4D (8, 49, 25) and streamed hyperspectral (4, 100, 31)
    learners' blocks; only complex64 on the card routes to the kernel."""
    assert 2 * tds.smem_bytes(100, 100, 1) <= 228 * 1024 - 2 * 1024
    for ni, K, W in ((100, 100, 1), (8, 49, 1), (8, 49, 25), (4, 100, 31)):
        assert tds.route("cuda", torch.complex64, ni, K, W) == "kernel"
        assert tds.route("cpu", torch.complex64, ni, K, W) == "torch"
        assert tds.route("cuda", torch.complex128, ni, K, W) == "torch"
    assert not tds.fits(200, 200, 1) and not tds.fits(0, 4, 1)


def _args():
    zhat, bhat, xi = _problem(1)
    ginv, zb = _einsum_precompute(zhat, 5.0, bhat)
    return [zhat.movedim(-1, -3).contiguous(), ginv.contiguous(),
            zb.contiguous(), xi]


@pytest.mark.parametrize("case,exc,match", [
    ("complex128", TypeError, "complex64"),
    ("strided", ValueError, "contiguous"),
    ("ginv_shape", ValueError, "ginv must be"),
    ("xi_shape", ValueError, "xi must be"),
    ("zb_shape", ValueError, "zb must be"),
    ("rho_tensor", TypeError, "python number"),
    ("meta_device", ValueError, "cuda or cpu"),
])
def test_wrapper_refusals(case, exc, match):
    zt, ginv, zb, xi = _args()
    rho = 5.0
    if case == "complex128":
        ginv = ginv.to(torch.complex128)
    elif case == "strided":
        zt = zt.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif case == "ginv_shape":
        ginv = ginv[:, :-1].contiguous()
    elif case == "xi_shape":
        xi = xi[:, :-1].contiguous()
    elif case == "zb_shape":
        zb = torch.cat([zb, zb], dim=-2)
    elif case == "rho_tensor":
        rho = torch.tensor(5.0)
    elif case == "meta_device":
        zt, ginv, zb, xi = (t.to("meta") for t in (zt, ginv, zb, xi))
    with pytest.raises(exc, match=match):
        tds.solve(zt, ginv, zb, xi, rho)


@pytest.mark.parametrize("route", ["cpu", "as_on_the_card"])
@pytest.mark.parametrize("case", ["not_hoisted", "filter_axis"])
def test_off_gate_routes_are_bitwise_the_einsum_body(request, route, case):
    """A target that is not hoisted (the masked learner) and a filter axis
    (the 'filter' mesh; the identity without a mesh) keep the einsum body
    over the k-major spectra, bit for bit, wherever the kernel would
    otherwise run; so does every call on the CPU."""
    calls = request.getfixturevalue("as_on_the_card") \
        if route == "as_on_the_card" else []
    zhat, bhat, xi = _problem(3, seed=4)
    rho = 500.0
    hoist = case == "filter_axis"
    axis = "filter" if case == "filter_axis" else None
    kern = tfs.precompute_d_kernel(zhat, rho, b_hat=bhat if hoist else None,
                                   axis_name=axis)
    ginv, zb = _einsum_precompute(zhat, rho, bhat if hoist else None)
    assert kern.zhat.shape == zhat.movedim(-1, -3).shape
    assert torch.equal(kern.zhat.movedim(-3, -1), zhat)
    assert kern.zhat.movedim(-3, -1).stride() == zhat.stride()
    assert torch.equal(kern.ginv, ginv)
    assert (kern.zb is None) == (zb is None)
    if hoist:
        assert torch.equal(kern.zb, zb)
    out = tfs.solve_d(kern, None if hoist else bhat, xi, rho, axis_name=axis)
    assert torch.equal(out, _einsum_solve(zhat, ginv, zb,
                                          None if hoist else bhat, xi, rho))
    assert calls == []


def test_hoisted_cpu_route_is_bitwise_the_einsum_body():
    zhat, bhat, xi = _problem(1, seed=5)
    kern = tfs.precompute_d_kernel(zhat, 50.0, b_hat=bhat)
    ginv, zb = _einsum_precompute(zhat, 50.0, bhat)
    assert torch.equal(kern.zb, zb) and torch.equal(kern.ginv, ginv)
    assert torch.equal(tfs.solve_d(kern, None, xi, 50.0),
                       _einsum_solve(zhat, ginv, zb, None, xi, 50.0))


@pytest.mark.parametrize("W", [1, 3])
def test_the_gate_takes_the_kernel_on_frequency_major_spectra(
        as_on_the_card, W):
    """Routed as on the card, a hoisted kernel with no filter axis keeps
    the spectra frequency-major and contiguous (the Gram and Z^H b by
    batched products over them), solve_d calls d_solve.solve once, and
    the result is the einsum body's; a move between devices (the
    streaming learner's _kern_to) keeps the layout."""
    zhat, bhat, xi = _problem(W, seed=6)
    rho = 50.0
    kern = tfs.precompute_d_kernel(zhat, rho, b_hat=bhat)
    L, ni, K, F = CUT
    assert kern.zhat.shape == (L, F, ni, K) and kern.zhat.is_contiguous()
    assert kern.ginv.shape == (L, F, ni, ni) and kern.ginv.is_contiguous()
    assert kern.zb.shape == (L, K, W, F) and kern.zb.is_contiguous()
    assert not kern.zb.is_conj()
    ginv, zb = _einsum_precompute(zhat, rho, bhat)
    _close(kern.ginv, ginv)
    _close(kern.zb, zb)
    out = tfs.solve_d(kern, None, xi, rho)
    assert as_on_the_card == [kern.zhat.shape]
    _close(out, _einsum_solve(zhat, ginv, zb, None, xi, rho))
    moved = tfs.DSolveKernel(*(t.to("cpu", copy=True) for t in kern))
    assert all(t.is_contiguous() for t in moved)
    assert torch.equal(tfs.solve_d(moved, None, xi, rho), out)
    with pytest.raises(ValueError, match="hoisted"):
        tfs.solve_d(kern, bhat, xi, rho)


def test_the_gate_reads_the_shape(as_on_the_card):
    """Codes too wide for a block's shared memory stay on the einsum
    body, bit for bit, even routed as on the card."""
    r = np.random.default_rng(7)
    ni = K = 180
    assert not tds.fits(ni, K, 1)
    zhat, bhat, xi = _c(r, 1, ni, K, 3), _c(r, 1, ni, 1, 3), _c(r, 1, K, 1, 3)
    kern = tfs.precompute_d_kernel(zhat, 1e3, b_hat=bhat)
    ginv, zb = _einsum_precompute(zhat, 1e3, bhat)
    assert torch.equal(kern.ginv, ginv) and torch.equal(kern.zb, zb)
    assert torch.equal(tfs.solve_d(kern, None, xi, 1e3),
                       _einsum_solve(zhat, ginv, zb, None, xi, 1e3))
    assert as_on_the_card == []
