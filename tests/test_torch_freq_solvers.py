"""The rank-1 z-solve: K1's plain version (``solve_z_rank1_reference``),
the port's ``solve_z`` routing and its einsum body, against the JAX
package's interpret-mode Pallas kernel and its einsum ``solve_z``.

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
def test_plain_version_matches_interpret_pallas(extra):
    r = np.random.default_rng(0)
    rho = 0.7
    dhat, xi1, xi2, e = _problem(r, 8, 700, 3, extra)
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
    dhat = torch.zeros(3, 2, 10, dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="item 7"):
        tfs.precompute_z_kernel(dhat, 1.0)


def test_kernel_source_names_what_it_replaces():
    with open(kernels.SOURCE) as f:
        src = f.read()
    assert "pallas_kernels.py::" in src and "solve_z_rank1_pallas" in src
    assert "extern \"C\" int ccsc_solve_z_rank1" in src
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("extra", [False, True])
def test_kernel_matches_plain_on_card(n, extra):
    """K1 on the card at the slice's full shapes (K=100, F=266*134)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    r = np.random.default_rng(4)
    K, F, rho = 100, 266 * 134, 100.0
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
    torch.cuda.synchronize()
    assert kernels.solve_z_rank1.launches == before + 1
    ref = kernels.solve_z_rank1_reference(*args)
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, err
