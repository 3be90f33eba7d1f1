"""The port's matmul-DFT tiers (ops.fourier, ``fft_impl`` 'matmul',
'matmul_high', 'matmul_bf16') held to the JAX package's tiers and to
numpy.fft on the same inputs, forward and inverse, even and odd lengths,
2D and 3D, with the refusals of JAX's ops/fourier.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.ops import fourier as jfourier
from ccsc_code_iccv2017_torch.config import (LearnConfig, ProblemGeom,
                                             SolveConfig)
from ccsc_code_iccv2017_torch.ops import fourier as tfourier

SHAPES = [((3, 4, 18, 18), 2), ((2, 10, 10, 10), 3), ((5, 7, 9), 2),
          ((2, 3, 8, 11), 2)]
TIERS = ["matmul", "matmul_high", "matmul_bf16"]
# the relative bound each tier is held to against numpy.fft: JAX's
# test_ops.py bounds for 'matmul' (2e-5 of max|X|) and 'matmul_bf16'
# (2e-2, its emulated bf16 class); 'matmul_high' sits between (JAX's
# test_matmul_high_impl_matches_fft: 1e-3 absolute at unit data)
REL = {"matmul": 2e-5, "matmul_high": 1e-4, "matmul_bf16": 2e-2}


def _x(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("shape, nd", SHAPES)
def test_tier_matches_numpy_forward_and_inverse(shape, nd, tier):
    x = _x(shape)
    sp = shape[-nd:]
    ref = np.fft.rfftn(x.astype(np.float64),
                       axes=tuple(range(len(shape) - nd, len(shape))))
    got = tfourier.rfftn_spatial(torch.from_numpy(x), nd, impl=tier).numpy()
    assert np.abs(got - ref).max() <= REL[tier] * np.abs(ref).max()
    back = tfourier.irfftn_spatial(
        torch.from_numpy(ref.astype(np.complex64)), sp, impl=tier).numpy()
    assert np.abs(back - x).max() <= REL[tier] * 5 * np.abs(x).max()


@pytest.mark.parametrize("shape, nd", SHAPES)
def test_matmul_tier_matches_jax(shape, nd):
    """'matmul' (JAX HIGHEST) against JAX's 'matmul' on the same input,
    at JAX's tolerance: 2e-5 of max|X| forward, 1e-5 inverse."""
    x = _x(shape, seed=9)
    got = tfourier.rfftn_spatial(torch.from_numpy(x), nd,
                                 impl="matmul").numpy()
    ref = np.asarray(jfourier.rfftn_spatial(jnp.asarray(x), nd,
                                            impl="matmul"))
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())
    back = tfourier.irfftn_spatial(torch.from_numpy(got), shape[-nd:],
                                   impl="matmul").numpy()
    jback = np.asarray(jfourier.irfftn_spatial(jnp.asarray(ref),
                                               shape[-nd:], impl="matmul"))
    np.testing.assert_allclose(back, jback, atol=1e-5)


def test_bf16_tiers_are_their_accuracy_classes():
    """'matmul_bf16' rounds each product's operands to bf16 and
    accumulates in float32: its error is JAX's emulated DEFAULT class
    (a few 1e-3, test_ops.py::test_matmul_bf16_dft_error_bound), not
    float tolerance, and not bf16 output rounding. 'matmul_high' (three
    bf16 passes) sits orders of magnitude below it."""
    x = _x((4, 16, 16), seed=3)
    ref = np.fft.rfftn(x.astype(np.float64), axes=(-2, -1))
    err = {}
    for tier in TIERS:
        got = tfourier.rfftn_spatial(torch.from_numpy(x), 2, impl=tier)
        assert got.dtype == torch.complex64
        err[tier] = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert 1e-4 < err["matmul_bf16"] < 2e-2
    assert err["matmul_high"] < err["matmul_bf16"] / 50
    assert err["matmul"] < 2e-6
    # the bf16 class computed by hand: JAX's emulation of DEFAULT
    bf = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).to(torch.float32).numpy()
    f = jfourier._rdft_mat(16)
    d = jfourier._dft_mat(16, inverse=False)
    xh = bf(x) @ bf(f.real) + 1j * (bf(x) @ bf(f.imag))
    xh = xh.astype(np.complex64)
    emu = (np.einsum("byk,yu->buk", bf(xh.real), bf(d.real))
           - np.einsum("byk,yu->buk", bf(xh.imag), bf(d.imag))
           + 1j * (np.einsum("byk,yu->buk", bf(xh.real), bf(d.imag))
                   + np.einsum("byk,yu->buk", bf(xh.imag), bf(d.real))))
    got = tfourier.rfftn_spatial(torch.from_numpy(x), 2,
                                 impl="matmul_bf16").numpy()
    # the same rounding up to float32 summation order
    assert np.abs(got - emu).max() <= 1e-5 * np.abs(ref).max()


def test_refusals_are_jax():
    """float64 input, a mismatched inverse spectrum and an unknown impl
    are refused with JAX's errors; the xla path crops/pads as before."""
    x64 = torch.zeros(2, 8, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="float64"):
        tfourier.rfftn_spatial(x64, 2, impl="matmul")
    spec = torch.zeros(2, 8, 4, dtype=torch.complex64)
    for tier in TIERS:
        with pytest.raises(ValueError, match="exact half-spectrum"):
            tfourier.irfftn_spatial(spec, (8, 8), impl=tier)
    with pytest.raises(ValueError, match="unknown fft impl"):
        tfourier.rfftn_spatial(torch.zeros(4, 4), 2, impl="fftw")
    with pytest.raises(ValueError, match="unknown fft impl"):
        tfourier.irfftn_spatial(spec, (8, 6), impl="fftw")
    # bfloat16 storage reaches the transform as float32, as in JAX
    xb = torch.from_numpy(_x((2, 8, 8))).to(torch.bfloat16)
    torch.testing.assert_close(
        tfourier.rfftn_spatial(xb, 2, impl="matmul"),
        tfourier.rfftn_spatial(xb.float(), 2, impl="matmul"))


def test_dft_matrices_are_cached_per_size_and_device():
    a = tfourier._mat("dft", 12, torch.device("cpu"))
    assert tfourier._mat("dft", 12, torch.device("cpu")) is a
    assert tfourier._mat("idft", 12, torch.device("cpu")) is not a
    np.testing.assert_array_equal(a.numpy(), jfourier._dft_mat(12, False))


@pytest.mark.parametrize("tier", TIERS)
def test_configs_take_the_tiers_through_a_solve(tier):
    """The refusals in the configs are lifted: a reconstruction under
    each tier runs (models.common passes fg.fft_impl through) and lands
    in the tier's class of the 'xla' solve."""
    from ccsc_code_iccv2017_torch.models.reconstruct import (
        ReconstructionProblem, reconstruct)

    r = np.random.default_rng(1)
    d = r.normal(size=(4, 5, 5)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    x = r.random((2, 16, 16)).astype(np.float32)
    m = (r.random(x.shape) < 0.6).astype(np.float32)
    prob = ReconstructionProblem(ProblemGeom((5, 5), 4))
    base = SolveConfig(max_it=5, tol=0.0, verbose="none", lambda_prior=0.3)
    ref = reconstruct(x * m, d, prob, base, mask=m, device="cpu")
    got = reconstruct(x * m, d, prob, dataclasses.replace(base, fft_impl=tier),
                      mask=m, device="cpu")
    rel = float((got.recon - ref.recon).abs().max() / ref.recon.abs().max())
    assert rel <= {"matmul": 1e-5, "matmul_high": 1e-3,
                   "matmul_bf16": 5e-2}[tier]
    assert LearnConfig(fft_impl=tier).fft_impl == tier
