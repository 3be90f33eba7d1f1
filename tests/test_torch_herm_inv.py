"""The port's Gram inverses (ops.freq_solvers: Cholesky, the Schur block
recursion, Newton-Schulz with its condition guard) held to the JAX
package's ``hermitian_inverse`` and to numpy on the same inputs, at the
tolerances of the JAX package's tests/test_ops.py."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.ops import freq_solvers as jfs
from ccsc_code_iccv2017_torch.config import ProblemGeom, SolveConfig
from ccsc_code_iccv2017_torch.models import reconstruct as trec
from ccsc_code_iccv2017_torch.ops import freq_solvers as tfs


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for v in ("CCSC_HERM_INV", "CCSC_HERM_INV_ITERS", "CCSC_NEWTON_COND_MAX",
              "CCSC_NEWTON_COND_GUARD"):
        monkeypatch.delenv(v, raising=False)


def _gram(m, seed=0, batch=7):
    """JAX tests/test_ops.py's Hermitian PD batch with a safe shift."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((batch, m, m))
         + 1j * rng.standard_normal((batch, m, m))).astype(np.complex64)
    return A @ np.conj(np.swapaxes(A, -1, -2)) + (m + 2.0) * np.eye(
        m, dtype=np.complex64)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 16, 25, 32])
@pytest.mark.parametrize("method", ["schur", "newton"])
def test_matches_cholesky_numpy_and_jax(method, m):
    """JAX's test_hermitian_inverse_schur_matches_cholesky_and_numpy
    bound (5e-6 of max|inv|) against numpy's float64 inverse and the
    port's Cholesky, and the JAX package's inverse of the same method
    on the same input."""
    G = _gram(m)
    got = tfs.hermitian_inverse(torch.from_numpy(G), method=method).numpy()
    chol = tfs.hermitian_inverse(torch.from_numpy(G),
                                 method="cholesky").numpy()
    ref = np.linalg.inv(G.astype(np.complex128))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got - ref)) / scale < 5e-6
    assert np.max(np.abs(got - chol)) / scale < 5e-6
    jgot = np.asarray(jfs.hermitian_inverse(jnp.asarray(G), method=method))
    assert np.max(np.abs(got - jgot)) / scale < 5e-6


@pytest.mark.parametrize("m, shift, tol", [(2, 2.0, 1e-5), (31, 2.0, 1e-5),
                                           (31, 1e-3, 5e-4)])
def test_newton_converges_like_jax(m, shift, tol):
    """JAX's test_hermitian_inverse_newton_converges: the float32
    Cholesky class up to the HS z-kernel's conditioning (~1e4), and an
    exactly Hermitian result."""
    rng = np.random.default_rng(1)
    A = (rng.standard_normal((7, m, 2 * m))
         + 1j * rng.standard_normal((7, m, 2 * m))).astype(
             np.complex64) / np.sqrt(2 * m)
    G = A @ np.conj(np.swapaxes(A, -1, -2)) + shift * np.eye(
        m, dtype=np.complex64)
    inv_n = tfs.hermitian_inverse(torch.from_numpy(G),
                                  method="newton").numpy()
    ref = np.linalg.inv(G.astype(np.complex128))
    assert np.max(np.abs(inv_n - ref)) / np.max(np.abs(ref)) < tol
    np.testing.assert_array_equal(inv_n, np.conj(np.swapaxes(inv_n, -1, -2)))


def _ill(m=8, seed=2):
    """A Hermitian PD batch with cond 1e7, past the Newton window."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((3, m, m)) + 1j * rng.standard_normal((3, m, m))
    U, _ = np.linalg.qr(A)
    ev = np.logspace(0, -7, m)
    return ((U * ev) @ np.conj(np.swapaxes(U, -1, -2))).astype(np.complex64)


def test_guard_falls_back_to_cholesky():
    """Past the condition window the guard selects the Cholesky inverse
    (bitwise the cholesky method) and warns, as JAX's does; within it
    the Newton iterate stands."""
    G = torch.from_numpy(_ill())
    with pytest.warns(UserWarning, match="exceeds the"):
        out = tfs.hermitian_inverse(G, method="newton")
    torch.testing.assert_close(out, tfs.hermitian_inverse(G, "cholesky"),
                               atol=0, rtol=0)
    with pytest.warns(UserWarning, match="exceeds the"):
        jfs.hermitian_inverse(jnp.asarray(G.numpy()), method="newton")
    well = torch.from_numpy(_gram(8))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = tfs.hermitian_inverse(well, method="newton")
    assert not torch.equal(out, tfs.hermitian_inverse(well, "cholesky"))
    assert tfs.report_newton_guard(wait=True) == 0


def test_guard_off_trusts_the_iteration_count(monkeypatch):
    """CCSC_NEWTON_COND_GUARD=0: the Newton iterate, no estimate, no
    warning, whatever the conditioning."""
    monkeypatch.setenv("CCSC_NEWTON_COND_GUARD", "0")
    G = torch.from_numpy(_ill())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = tfs.hermitian_inverse(G, method="newton")
    torch.testing.assert_close(out, tfs._hermitian_inverse_newton(G),
                               atol=0, rtol=0)
    # a wider window keeps the iterate too
    monkeypatch.setenv("CCSC_NEWTON_COND_GUARD", "1")
    monkeypatch.setenv("CCSC_NEWTON_COND_MAX", "1e12")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tfs.hermitian_inverse(G, method="newton")


def test_resolution_and_env(monkeypatch):
    """'auto' is the Cholesky off the TPU (JAX's CPU resolution); the env
    knob and the explicit method win over it, as in JAX."""
    for m in (1, 2, 8, 31):
        assert tfs.resolve_herm_method(m) == jfs.resolve_herm_method(m) \
            == "cholesky"
    monkeypatch.setenv("CCSC_HERM_INV", "newton")
    assert tfs.resolve_herm_method(8) == jfs.resolve_herm_method(8) == \
        "newton"
    assert tfs.resolve_herm_method(8, "schur") == "schur"
    monkeypatch.delenv("CCSC_HERM_INV")
    assert tfs.resolve_newton_iters() == jfs.resolve_newton_iters() == 30
    monkeypatch.setenv("CCSC_HERM_INV_ITERS", "42")
    assert tfs.resolve_newton_iters() == 42 and \
        tfs.resolve_newton_iters(7) == 7
    with pytest.raises(ValueError, match="method"):
        tfs.hermitian_inverse(torch.from_numpy(_gram(3)), method="lu")


def test_default_path_is_the_cholesky_bit_for_bit():
    """Every default path runs what it ran before the other methods were
    ported: the batched Cholesky factor and its inverse."""
    G = torch.from_numpy(_gram(5, seed=4))
    want = torch.cholesky_inverse(torch.linalg.cholesky(G))
    for method in (None, "auto", "cholesky"):
        assert torch.equal(tfs.hermitian_inverse(G, method), want)


@pytest.mark.parametrize("method", ["cholesky", "schur", "newton"])
def test_solve_config_reaches_the_z_kernel(method):
    """SolveConfig.herm_inv reaches the W > 1 plan's inner inverse (the
    JAX plan passes it to precompute_z_kernel, freq_solvers.py:390-432):
    the plan's minv is the method's inverse, within float32 of JAX's
    precompute_z_kernel with the same method."""
    r = np.random.default_rng(5)
    geom = ProblemGeom((3, 3), 4, reduce_shape=(3,))
    d = r.normal(size=(4, 3, 3, 3)).astype(np.float32)
    cfg = SolveConfig(herm_inv=method, verbose="none")
    plan = trec.build_plan(d, trec.ReconstructionProblem(geom), cfg, (8, 8),
                           device="cpu")
    assert plan.herm_inv == method
    dhat = plan.kern.dhat
    jk = jfs.precompute_z_kernel(jnp.asarray(dhat.numpy()),
                                 float(plan.rho), herm_inv=method)
    got, ref = plan.kern.minv.numpy(), np.asarray(jk.minv)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))
