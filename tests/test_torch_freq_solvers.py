"""The rank-1 z-solve: K1's plain version (``solve_z_rank1_reference``),
the port's ``solve_z`` routing and its einsum body, against the JAX
package's interpret-mode Pallas kernel and its einsum ``solve_z``; and
the d-side solve (``hermitian_inverse``, ``precompute_d_kernel``,
``solve_d``) against the JAX package's.

Tolerance rtol 1e-5 (of the output's scale): a float32 sum over K terms
taken in another order. The CUDA kernel itself is compared with the
plain version on the card only (``test_kernel_matches_plain_on_card``,
which skips without a CUDA device, and ``chip_smoke.py`` phase 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.ops import freq_solvers as jfs
from ccsc_code_iccv2017_tpu.ops import pallas_kernels
from ccsc_code_iccv2017_torch.ops import freq_solvers as tfs
from ccsc_code_iccv2017_torch.ops import kernels

RTOL = 1e-5


def _problem(r, K, F, N, extra):
    def c(*shape):
        return (r.normal(size=shape) + 1j * r.normal(size=shape)).astype(
            np.complex64
        )

    e = None
    if extra:
        e = np.zeros((K, F), np.float32)
        e[-1] = r.uniform(0.0, 3.0, F)  # the dirac channel's regularization
    return c(K, F), c(N, F), c(N, K, F), e


def _close(port, ref, rtol=RTOL):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    err = float(np.abs(port - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), err


def _jax_kernel(dhat, rho, extra):
    return jfs.precompute_z_kernel(
        jnp.asarray(dhat)[:, None, :], rho,
        None if extra is None else jnp.asarray(extra),
    )


def _port_kernel(dhat, rho, extra):
    return tfs.precompute_z_kernel(
        torch.from_numpy(dhat)[:, None, :], rho,
        None if extra is None else torch.from_numpy(extra),
    )


@pytest.mark.parametrize("extra", [False, True])
# one K on each side of the register instantiations' edges (K1_G * KPT)
@pytest.mark.parametrize("K", [1, 7, 8, 13, 100, 105])
def test_plain_version_matches_interpret_pallas(K, extra):
    r = np.random.default_rng(K)
    rho = 0.7
    dhat, xi1, xi2, e = _problem(r, K, 700, 3, extra)
    jk = _jax_kernel(dhat, rho, e)
    ref = pallas_kernels.solve_z_rank1_pallas(
        jnp.asarray(dhat), jnp.asarray(xi1), jnp.asarray(xi2), rho,
        dinv=jk.dinv, interpret=True,
    )
    out = kernels.solve_z_rank1_reference(
        torch.from_numpy(dhat), torch.from_numpy(xi1), torch.from_numpy(xi2),
        rho, torch.from_numpy(np.array(jk.dinv)),
    )
    _close(out, ref)


@pytest.mark.parametrize("extra", [False, True])
def test_plain_version_and_einsum_match_jax_solve_z(extra):
    r = np.random.default_rng(1)
    rho = 100.0
    dhat, xi1, xi2, e = _problem(r, 6, 300, 2, extra)
    jk = _jax_kernel(dhat, rho, e)
    ref = jfs.solve_z(jk, jnp.asarray(xi1)[:, None, :], jnp.asarray(xi2), rho)
    tk = _port_kernel(dhat, rho, e)
    _close(tk.dinv, jk.dinv, 1e-7)
    _close(tk.minv_diag, jk.minv_diag, 1e-6)
    assert tk.minv is None and jk.minv is None
    x1, x2 = torch.from_numpy(xi1)[:, None, :], torch.from_numpy(xi2)
    _close(tfs.solve_z_reference(tk, x1, x2, rho), ref)
    _close(tfs.solve_z(tk, x1, x2, rho), ref)
    _close(
        kernels.solve_z_rank1_reference(
            torch.from_numpy(dhat), torch.from_numpy(xi1), x2, rho, tk.dinv
        ),
        ref,
    )


def test_solve_z_on_cpu_runs_plain_version_without_launch():
    r = np.random.default_rng(2)
    dhat, xi1, xi2, _ = _problem(r, 5, 64, 2, False)
    tk = _port_kernel(dhat, 3.0, None)
    before = kernels.solve_z_rank1.launches
    out = tfs.solve_z(tk, torch.from_numpy(xi1)[:, None, :], torch.from_numpy(xi2), 3.0)
    assert kernels.solve_z_rank1.launches == before
    plain = kernels.solve_z_rank1_reference(
        torch.from_numpy(dhat), torch.from_numpy(xi1), torch.from_numpy(xi2),
        3.0, tk.dinv,
    )
    assert torch.equal(out, plain)
    # dinv=None means 1/rho, like the TPU kernel
    assert torch.equal(
        kernels.solve_z_rank1(
            torch.from_numpy(dhat), torch.from_numpy(xi1), torch.from_numpy(xi2), 3.0
        ),
        plain,
    )


def _good_args():
    r = np.random.default_rng(3)
    dhat, xi1, xi2, _ = _problem(r, 4, 32, 2, False)
    return dict(
        dhat=torch.from_numpy(dhat), xi1=torch.from_numpy(xi1),
        xi2=torch.from_numpy(xi2), rho=2.0,
        dinv=torch.full((4, 32), 0.5),
    )


@pytest.mark.parametrize(
    "change, exc",
    [
        (lambda a: a.update(xi2=a["xi2"].to(torch.complex128)), TypeError),
        (lambda a: a.update(dinv=a["dinv"].double()), TypeError),
        (lambda a: a.update(xi2=a["xi2"][:, :3]), ValueError),
        (lambda a: a.update(xi1=a["xi1"][:1]), ValueError),
        (lambda a: a.update(dinv=a["dinv"].t().contiguous().t()), ValueError),
        (lambda a: a.update(xi2=a["xi2"].transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
        (lambda a: a.update(rho=torch.tensor(2.0)), TypeError),
        (lambda a: a.update(dhat=a["dhat"].to("meta")), ValueError),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(change, exc):
    args = _good_args()
    change(args)
    with pytest.raises(exc):
        kernels.solve_z_rank1(**args)


def test_w_greater_than_one_is_not_ported():
    """W > 1 solves now (the Woodbury tests below); what is still not
    ported there is the Schur/Newton choice of its Gram inverse."""
    dhat = torch.ones(3, 2, 10, dtype=torch.complex64)
    assert tfs.precompute_z_kernel(dhat, 1.0).minv.shape == (10, 2, 2)
    for method in ("schur", "newton"):
        with pytest.raises(NotImplementedError, match="item 9"):
            tfs.precompute_z_kernel(dhat, 1.0, herm_inv=method)


def _woodbury_problem(r, K, W, F, N, extra):
    def c(*shape):
        return (r.normal(size=shape) + 1j * r.normal(size=shape)).astype(
            np.complex64
        )

    e = None
    if extra:
        e = np.zeros((K, F), np.float32)
        e[0] = r.uniform(0.0, 3.0, F)
    return c(K, W, F), c(N, W, F), c(N, K, F), e


# W: two bands, the 5x5 lightfield views, the 31 hyperspectral bands
@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("W, K", [(2, 3), (25, 8), (31, 8)])
def test_woodbury_solve_matches_jax(W, K, extra):
    """The W > 1 z-solve (precompute_z_kernel's W x W inverse and
    solve_z's Woodbury body) against the JAX package's, rtol 1e-5 of
    the output's scale; solve_z_reference gives the same.

    rho is the apps' coupling (SolveConfig.gamma_ratio, 100). With
    K < W and |d|^2 / rho >> 1 the Woodbury correction cancels most of
    g in float32: at rho = 0.8 both packages land 1e-4 to 6e-4 of the
    scale from float64 (the next test holds the math there)."""
    r = np.random.default_rng(100 + W + K)
    rho, F, N = 100.0, 40, 2
    dhat, xi1, xi2, e = _woodbury_problem(r, K, W, F, N, extra)
    jk = jfs.precompute_z_kernel(
        jnp.asarray(dhat), rho, None if e is None else jnp.asarray(e),
        herm_inv="cholesky",
    )
    tk = tfs.precompute_z_kernel(
        torch.from_numpy(dhat), rho, None if e is None else torch.from_numpy(e),
    )
    assert tk.minv_diag is None and jk.minv_diag is None
    _close(tk.dinv, jk.dinv, 1e-7)
    _close(tk.minv, jk.minv)
    ref = jfs.solve_z(jk, jnp.asarray(xi1), jnp.asarray(xi2), rho)
    x1, x2 = torch.from_numpy(xi1), torch.from_numpy(xi2)
    before = kernels.solve_z_rank1.launches
    out = tfs.solve_z(tk, x1, x2, rho)
    assert kernels.solve_z_rank1.launches == before
    _close(out, ref)
    _close(tfs.solve_z_reference(tk, x1, x2, rho), ref)


def test_woodbury_solve_is_exact():
    """z solves (Gamma + A^H A) z = A^H xi1 + rho xi2 at every
    frequency, against numpy's dense solve: complex128 spectra, and
    Gamma^{-1} float32 as the solver keeps it (so rtol 1e-6), at a
    rho where float32 would lose 1e-4 (K < W, |d|^2 / rho >> 1)."""
    r = np.random.default_rng(7)
    K, W, F, rho = 5, 3, 6, 0.5
    dhat, xi1, xi2, e = _woodbury_problem(r, K, W, F, 1, True)
    tk = tfs.precompute_z_kernel(
        torch.from_numpy(dhat).to(torch.complex128), rho,
        torch.from_numpy(e).double(),
    )
    tk = tk._replace(dinv=tk.dinv.double())
    z = tfs.solve_z(
        tk, torch.from_numpy(xi1).to(torch.complex128),
        torch.from_numpy(xi2).to(torch.complex128), rho,
    ).numpy()
    for f in range(F):
        A = dhat[:, :, f].T.astype(np.complex128)  # W x K
        lhs = np.diag(rho + e[:, f]) + A.conj().T @ A
        want = np.linalg.solve(lhs, A.conj().T @ xi1[0, :, f] + rho * xi2[0, :, f])
        np.testing.assert_allclose(z[0, :, f], want, rtol=1e-6)


def test_kernel_source_names_what_it_replaces():
    with open(kernels.SOURCE) as f:
        src = f.read()
    assert "pallas_kernels.py::" in src and "solve_z_rank1_pallas" in src
    assert "extern \"C\" int ccsc_solve_z_rank1" in src
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


# the serve path's shapes (K=100, F=266*134, N in {1, 4}), the learner
# composition path's (N=800, F=110*56), each side of the register
# instantiations' edges (K1_G * KPT) and the generic loop at an F that is
# not a multiple of the tile, and N=13 at the serve path's F, where blocks
# take 8 images and the last chunk is partial (registers and the loop)
_CARD_CASES = (
    [(n, 100, 266 * 134, extra) for n in (1, 4) for extra in (False, True)]
    + [(800, 100, 110 * 56, False)]
    + [(45, k, 6161, k % 2 == 1)
       for k in (1, 7, 8, 9, 100, 104, 105, 128, 129, 300)]
    + [(13, k, 266 * 134, False) for k in (100, 300)]
)


@pytest.mark.parametrize("n, K, F, extra", _CARD_CASES)
def test_kernel_matches_plain_on_card(n, K, F, extra):
    """K1 on the card against its plain version, and two launches on the
    same inputs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    r = np.random.default_rng(4)
    rho = 100.0
    dhat, xi1, xi2, e = _problem(r, K, F, n, extra)
    dev = torch.device("cuda")
    tk = tfs.precompute_z_kernel(
        torch.from_numpy(dhat).to(dev)[:, None, :], rho,
        None if e is None else torch.from_numpy(e).to(dev),
    )
    args = (
        tk.dhat[:, 0, :], torch.from_numpy(xi1).to(dev),
        torch.from_numpy(xi2).to(dev), rho, tk.dinv,
    )
    before = kernels.solve_z_rank1.launches
    out = kernels.solve_z_rank1(*args)
    again = kernels.solve_z_rank1(*args)
    torch.cuda.synchronize()
    assert kernels.solve_z_rank1.launches == before + 2
    assert torch.equal(out, again)
    ref = kernels.solve_z_rank1_reference(*args)
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, err


def _herm_pd(r, batch, m, rho):
    z = (r.normal(size=(*batch, m, 2 * m))
         + 1j * r.normal(size=(*batch, m, 2 * m))).astype(np.complex64)
    return (z @ np.conj(np.swapaxes(z, -1, -2))
            + rho * np.eye(m, dtype=np.complex64)).astype(np.complex64)


@pytest.mark.parametrize("m", [1, 2, 5])
def test_hermitian_inverse_matches_jax_cholesky(m):
    """The port inverts complex64 directly; JAX through its real block
    embedding. Same math: rtol 1e-5 of the inverse's scale."""
    G = _herm_pd(np.random.default_rng(5), (7,), m, 0.5)
    ref = jfs.hermitian_inverse(jnp.asarray(G), method="cholesky")
    out = tfs.hermitian_inverse(torch.from_numpy(G))
    _close(out, ref)
    eye = out @ torch.from_numpy(G)
    assert float((eye - torch.eye(m)).abs().max()) < 1e-4


@pytest.mark.parametrize("method", ["schur", "newton"])
def test_hermitian_inverse_other_methods_not_ported(method):
    G = torch.from_numpy(_herm_pd(np.random.default_rng(6), (2,), 3, 1.0))
    with pytest.raises(NotImplementedError, match="item 9"):
        tfs.hermitian_inverse(G, method=method)


def _d_problem(r, Ni, K, W, F):
    def c(*shape):
        return (r.normal(size=shape) + 1j * r.normal(size=shape)).astype(
            np.complex64
        )

    return c(Ni, K, F), c(Ni, W, F), c(K, W, F)


@pytest.mark.parametrize("hoist", [False, True])
def test_d_kernel_and_solve_match_jax(hoist):
    r = np.random.default_rng(7)
    rho = 500.0
    zhat, bhat, xi = _d_problem(r, 3, 6, 1, 40)
    jk = jfs.precompute_d_kernel(
        jnp.asarray(zhat), rho, b_hat=jnp.asarray(bhat) if hoist else None
    )
    tk = tfs.precompute_d_kernel(
        torch.from_numpy(zhat), rho,
        b_hat=torch.from_numpy(bhat) if hoist else None,
    )
    _close(tk.ginv, jk.ginv)
    if hoist:
        _close(tk.zb, jk.zb)
    else:
        assert tk.zb is None and jk.zb is None
    b_arg = None if hoist else bhat
    ref = jfs.solve_d(jk, None if b_arg is None else jnp.asarray(b_arg),
                      jnp.asarray(xi), rho)
    out = tfs.solve_d(tk, None if b_arg is None else torch.from_numpy(b_arg),
                      torch.from_numpy(xi), rho)
    _close(out, ref)


def test_d_solve_is_exact_and_batches_over_blocks():
    """solve_d solves (rho I + Z^H Z) x = Z^H b + rho xi per frequency,
    and a leading block axis gives each block's own solve."""
    r = np.random.default_rng(8)
    rho = 3.0
    blocks = [_d_problem(r, 2, 4, 1, 5) for _ in range(3)]
    zs, bs, xs = (torch.from_numpy(np.stack(a)) for a in zip(*blocks))
    tk = tfs.precompute_d_kernel(zs, rho, b_hat=bs)
    x = tfs.solve_d(tk, None, xs, rho)  # [L, K, W, F]
    for i, (z, b, xi) in enumerate(blocks):
        one = tfs.solve_d(
            tfs.precompute_d_kernel(torch.from_numpy(z), rho,
                                    b_hat=torch.from_numpy(b)),
            None, torch.from_numpy(xi), rho,
        )
        _close(x[i], one.numpy())
        for f in range(z.shape[-1]):
            Z = z[:, :, f].astype(np.complex128)  # [Ni, K]
            A = rho * np.eye(Z.shape[1]) + np.conj(Z.T) @ Z
            rhs = np.conj(Z.T) @ b[:, 0, f] + rho * xi[:, 0, f]
            np.testing.assert_allclose(
                x[i, :, 0, f].numpy(), np.linalg.solve(A, rhs),
                rtol=1e-4, atol=1e-5,
            )


def test_hoisted_d_kernel_refuses_a_second_target():
    zhat, bhat, xi = _d_problem(np.random.default_rng(9), 2, 3, 1, 4)
    tk = tfs.precompute_d_kernel(torch.from_numpy(zhat), 1.0,
                                 b_hat=torch.from_numpy(bhat))
    with pytest.raises(ValueError, match="hoisted"):
        tfs.solve_d(tk, torch.from_numpy(bhat), torch.from_numpy(xi), 1.0)
