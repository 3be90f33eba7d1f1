"""K2, the fused z-iteration: the port's ``ops.fused_z`` (on the CPU its
plain version) against the JAX package's Pallas kernel in interpret mode
and its ``fused_z_iter_reference``, on the same numpy inputs.

Tolerances (tests/test_pallas_fused.py's own): atol 2e-5 on z' (an f32
FFT/solve/inverse-FFT chain, pocketfft vs the JAX kernel's matmul DFTs)
and 1e-6 on dual' (elementwise f32, the same operations on both sides);
bf16 state within 0.02 max|z'| (storage rounding, math in f32). The CUDA
kernels themselves are held against the plain version on the card only
(``test_kernels_match_plain_on_card``, which skips without a card, and
``chip_smoke.py`` phase 6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.ops import pallas_fused_z as jfz
from ccsc_code_iccv2017_torch.ops import fused_z as tfz
from ccsc_code_iccv2017_torch.ops import kernels

THETA = 0.35


def _problem(N=3, K=6, Sy=12, Sx=10, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((N, K, Sy, Sx)).astype(np.float32)
    du = rng.standard_normal((N, K, Sy, Sx)).astype(np.float32)
    d = rng.standard_normal((K, Sy, Sx)).astype(np.float32)
    dhat = np.fft.rfftn(d, axes=(-2, -1)).astype(np.complex64)
    b = rng.standard_normal((N, Sy, Sx)).astype(np.float32)
    bhat = np.fft.rfftn(b, axes=(-2, -1)).astype(np.complex64)
    rho = 1.0
    minv = (1.0 / (1.0 + np.sum(np.abs(dhat) ** 2, 0) / rho)).astype(
        np.float32
    )
    return z, du, bhat, dhat, minv, rho


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _main_path_spectra(N, K, Sy, Sx, seed=1, support=11, pad=5):
    """dhat, bhat, minv shaped like the learner's: unit-norm filters on a
    support x support window, data inside the plane's pad-wide border.
    (Noise spectra over the whole plane make the rank-1 correction
    cancel by orders of magnitude, beyond float32's reach on either
    side.)"""
    rng = np.random.default_rng(seed)
    d = np.zeros((K, Sy, Sx), np.float32)
    d[:, :support, :support] = rng.standard_normal((K, support, support))
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    b = np.zeros((N, Sy, Sx), np.float32)
    b[:, pad:Sy - pad, pad:Sx - pad] = rng.standard_normal(
        (N, Sy - 2 * pad, Sx - 2 * pad)
    )
    dhat = np.fft.rfftn(d, axes=(-2, -1)).astype(np.complex64)
    bhat = np.fft.rfftn(b, axes=(-2, -1)).astype(np.complex64)
    minv = (1.0 / (1.0 + np.sum(np.abs(dhat) ** 2, 0))).astype(np.float32)
    return dhat, bhat, minv


@pytest.mark.parametrize(
    "Sy,Sx",
    [
        (12, 10),
        (9, 9),
        # the shapes at which chip_smoke.py phase 6 holds the kernels, one
        # per branch of their P x Q split plan (csrc/fused_z.cu):
        (15, 12),  # odd Sy: an unpaired packed row; splits 3x5, 3x4
        (13, 11),  # prime on both axes: the dense routines
        (38, 20),  # 38 = 2x19 stays dense on y; 20 splits 4x5
    ],
)
def test_plain_version_matches_interpret_pallas_and_reference(Sy, Sx):
    z, du, bhat, dhat, minv, rho = _problem(Sy=Sy, Sx=Sx)
    jin = [jnp.asarray(a) for a in (z, du, bhat, dhat, minv)]
    zk, dk = jfz.fused_z_iter(*jin, rho, THETA, interpret=True)
    zr, dr = jfz.fused_z_iter_reference(*jin, rho, THETA)
    tz, td = tfz.fused_z_iter(*_torch((z, du, bhat, dhat, minv)), rho, THETA)
    assert tz.dtype == torch.float32 and td.dtype == torch.float32
    for ref_z, ref_d in ((zk, dk), (zr, dr)):
        np.testing.assert_allclose(tz.numpy(), np.asarray(ref_z), atol=2e-5)
        np.testing.assert_allclose(td.numpy(), np.asarray(ref_d), atol=1e-6)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_precision_tiers_meet_the_jax_bounds(precision):
    """LearnConfig.fused_z_precision: the port has one float32 body for
    every tier. Held to the JAX kernel at each tier, it stays within
    tests/test_pallas_fused.py's 1e-3 of the scale of the "high" run
    (interpret mode), and within this file's atol 2e-5 of JAX's CPU run
    of "default" (on the CPU JAX computes its 1-pass tier in float32)."""
    z, du, bhat, dhat, minv, rho = _problem()
    jin = [jnp.asarray(a) for a in (z, du, bhat, dhat, minv)]
    zj, dj = jfz.fused_z_iter(*jin, rho, THETA, interpret=True,
                              precision=precision)
    zt, dt = tfz.fused_z_iter(*_torch((z, du, bhat, dhat, minv)), rho, THETA)
    err = float(np.abs(zt.numpy() - np.asarray(zj)).max())
    if precision == "high":
        assert err <= 1e-3 * float(np.abs(np.asarray(zj)).max()), err
    else:
        assert err <= 2e-5, err
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)


def test_passes_compose_to_the_reference():
    args = _torch(_problem()[:5])
    z, du, bhat, dhat, minv = args
    dual_a, t = tfz.pass_a(z, du, bhat, dhat, 1.0, THETA)
    z_b = tfz.pass_b(z, du, bhat, dhat, minv, t, 1.0, THETA)
    z_ref, d_ref = tfz.fused_z_iter_reference(*args, 1.0, THETA)
    assert torch.equal(z_b, z_ref) and torch.equal(dual_a, d_ref)
    assert t.shape == (3, 12, 6) and t.dtype == torch.complex64


def test_plain_version_tracks_float64_on_main_path_inputs():
    """On inputs shaped like the learner's, the plain float32 iteration
    stays within 1e-6 of max|z'| of the same iteration run in float64
    (measured ~2e-7 here and at 110x110, K=100). The kernels are held to
    float64 on the card by ``chip_smoke.py`` phase 6."""
    z, du = _problem(N=2, K=16, Sy=42, Sx=42)[:2]
    dhat, bhat, minv = _main_path_spectra(2, 16, 42, 42)
    args = _torch((z, du, bhat, dhat, minv))
    wide = [a.to(torch.complex128) if a.is_complex() else a.double()
            for a in args]
    z32, d32 = tfz.fused_z_iter_reference(*args, 1.0, THETA)
    z64, d64 = tfz.fused_z_iter_reference(*wide, 1.0, THETA)
    assert z64.dtype == torch.float64 and d64.dtype == torch.float64
    scale = float(z64.abs().max())
    assert float((z32.double() - z64).abs().max()) <= 1e-6 * scale
    assert float((d32.double() - d64).abs().max()) <= 1e-6 * float(
        d64.abs().max()
    )


def test_bf16_state_matches_jax_bf16():
    z, du, bhat, dhat, minv, rho = _problem()
    zb = torch.from_numpy(z).to(torch.bfloat16)
    db = torch.from_numpy(du).to(torch.bfloat16)
    tz, td = tfz.fused_z_iter(zb, db, *_torch((bhat, dhat, minv)), rho, THETA)
    assert tz.dtype == torch.bfloat16 and td.dtype == torch.bfloat16
    jz, jd = jfz.fused_z_iter(
        jnp.asarray(z).astype(jnp.bfloat16),
        jnp.asarray(du).astype(jnp.bfloat16),
        jnp.asarray(bhat), jnp.asarray(dhat), jnp.asarray(minv),
        rho, THETA, interpret=True,
    )
    zf, _ = jfz.fused_z_iter_reference(
        *[jnp.asarray(a) for a in (z, du, bhat, dhat, minv)], rho, THETA
    )
    scale = float(jnp.abs(zf).max())
    port_z = tz.to(torch.float32).numpy()
    # the JAX test's bound against the f32 iteration, and the two bf16
    # iterations against each other
    assert np.abs(port_z - np.asarray(zf)).max() < 0.02 * scale
    assert np.abs(port_z - np.asarray(jz.astype(jnp.float32))).max() < (
        0.02 * scale
    )
    np.testing.assert_allclose(
        td.to(torch.float32).numpy(), np.asarray(jd.astype(jnp.float32)),
        atol=0.02 * float(np.abs(np.asarray(jd.astype(jnp.float32))).max()),
    )


def test_cpu_runs_the_plain_version_without_launch():
    args = _torch(_problem()[:5])
    before = (tfz.fused_z_iter.launches_a, tfz.fused_z_iter.launches_b)
    out = tfz.fused_z_iter(*args, 1.0, THETA)
    ref = tfz.fused_z_iter_reference(*args, 1.0, THETA)
    assert (tfz.fused_z_iter.launches_a, tfz.fused_z_iter.launches_b) == before
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def _good_args():
    z, du, bhat, dhat, minv, _ = _problem(N=2, K=3, Sy=8, Sx=8)
    return dict(zip(("z", "dual", "bhat", "dhat", "minv_diag"),
                    _torch((z, du, bhat, dhat, minv))), rho=1.0, theta=THETA)


@pytest.mark.parametrize(
    "change, exc",
    [
        (lambda a: a.update(z=a["z"].double(), dual=a["dual"].double()),
         TypeError),
        (lambda a: a.update(dual=a["dual"].to(torch.bfloat16)), TypeError),
        (lambda a: a.update(dhat=a["dhat"].to(torch.complex128)), TypeError),
        (lambda a: a.update(bhat=a["bhat"][:1]), ValueError),
        (lambda a: a.update(minv_diag=a["minv_diag"][:, :3]), ValueError),
        (lambda a: a.update(z=a["z"][0]), ValueError),
        (lambda a: a.update(dual=a["dual"].transpose(2, 3).contiguous()
                            .transpose(2, 3)), ValueError),
        (lambda a: a.update(rho=torch.tensor(1.0)), TypeError),
        # the kernel runs on cuda, the plain version on cpu: any other
        # device is refused, never quietly routed
        (lambda a: a.update(**{k: v.to("meta") for k, v in a.items()
                               if torch.is_tensor(v)}), ValueError),
    ],
)
def test_wrapper_refuses_what_the_kernels_do_not_take(change, exc):
    args = _good_args()
    change(args)
    with pytest.raises(exc):
        tfz.fused_z_iter(**args)


def test_kernel_source_names_what_it_replaces():
    src_path = kernels.sources()["fused_z"]
    with open(src_path) as f:
        src = f.read()
    assert "pallas_fused_z.py::" in src and "kernel_a" in src
    assert "kernel_b" in src
    for entry in ("ccsc_fused_z_pass_a", "ccsc_fused_z_pass_b",
                  "ccsc_fused_z_smem_bytes"):
        assert f'extern "C"' in src and entry in src
    # no float atomics: the k-sum is a fixed-order loop
    assert "atomicAdd" not in src
    assert set(kernels.sources()) == {"solve_z_rank1", "fused_z"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "Sy,Sx", [(110, 110), (9, 9), (15, 12), (13, 11), (38, 20)]
)
def test_kernels_match_plain_on_card(dtype, Sy, Sx):
    """K2a + K2b on the card against the plain version (the chip
    smoke's limits), and bitwise repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K2 has no CPU mode)")
    z, du, bhat, dhat, minv, rho = _problem(N=2, K=8, Sy=Sy, Sx=Sx)
    if Sy > 11:  # the main path's filters (see _main_path_spectra)
        dhat, _, minv = _main_path_spectra(2, 8, Sy, Sx)
    dev = torch.device("cuda")
    sd = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(dev) for a in (z, du, bhat, dhat, minv)]
    args[0], args[1] = args[0].to(sd), args[1].to(sd)
    before = tfz.fused_z_iter.launches_a
    z1, d1 = tfz.fused_z_iter(*args, rho, THETA)
    z2, d2 = tfz.fused_z_iter(*args, rho, THETA)
    torch.cuda.synchronize()
    assert tfz.fused_z_iter.launches_a == before + 2
    assert torch.equal(z1, z2) and torch.equal(d1, d2)
    zr, dr = tfz.fused_z_iter_reference(*args, rho, THETA)
    scale = float(zr.float().abs().max())
    err = float((z1.float() - zr.float()).abs().max())
    assert err <= (1e-5 if dtype == "float32" else 0.02) * scale, err


# ---- K2's plane-size gate: a plane K2 cannot hold takes the composition


def _cuda_smem_bytes(Sy, Sx, pass_b):
    """csrc/fused_z.cu's smem_bytes, plan_axis and odd_pitch written out
    again from the source: an independent yardstick for the twin."""
    def split_p(S):  # plan_axis(S).P
        divs = [p for p in range(2, int(S**0.5) + 1) if S % p == 0]
        P = divs[-1] if divs else 1
        return 1 if P == 1 or S // P > 16 else P

    Fx = Sx // 2 + 1
    tw = 8 * (Sx + Sy)
    a = 8 * Sy * (Fx | 1)
    r = (8 * ((Sy + 1) // 2) * (Sx | 1) if split_p(Sx) > 1
         else 4 * Sy * Sx)
    if pass_b and split_p(Sy) == 1 and a > r:
        r = a
    return tw + a + r + 4 * (Sx + Sy)


@pytest.mark.parametrize("Sy", range(16, 301, 7))
def test_smem_bytes_twin_matches_the_cuda_formula(Sy):
    """The Python twin against the source's formula for Sy in 16..300
    (every 7th) and every Sx in 16..300, both passes; on the card
    chip_smoke.py phase 16 holds it to the library's own
    ccsc_fused_z_smem_bytes for every pair."""
    for Sx in range(16, 301):
        for pass_b in (False, True):
            assert tfz.smem_bytes(Sy, Sx, pass_b) == _cuda_smem_bytes(
                Sy, Sx, pass_b), (Sy, Sx, pass_b)


def test_fits_square_planes_up_to_168():
    assert [S for S in range(16, 301) if tfz.fits(S, S)] == list(
        range(16, 169))
    assert tfz.fits(110, 110)  # the north star's padded plane
    assert not tfz.fits(266, 266)  # 256² images padded by 11x11 filters
    assert tfz.plan_axis(110) == (10, 11) and tfz.plan_axis(13) == (1, 13)


def test_fused_z_gate_sends_large_planes_on_the_card_to_composition():
    """``models.learn.fused_z_ok`` decides by shape before any launch:
    a 266² plane on a CUDA-typed device takes the composition (and
    says so), on the CPU K2's plain version takes it, as JAX's fused
    path does; a 110² plane takes K2 on either."""
    from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
    from ccsc_code_iccv2017_torch.models import common, learn

    geom = ProblemGeom((11, 11), 100)
    cfg = LearnConfig(fused_z=True, verbose="none")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    big = common.FreqGeom.create(geom, (256, 256))
    small = common.FreqGeom.create(geom, (100, 100))
    assert big.spatial_shape == (266, 266)
    assert not learn.fused_z_ok(cfg, big, None, cuda)
    assert learn.fused_z_ok(cfg, big, None, cpu)
    assert learn.fused_z_ok(cfg, small, None, cuda)
    note = learn.fused_z_note(cfg, big, None, cuda)
    assert "266x266" in note and "composition" in note
    assert learn.fused_z_note(cfg, big, None, cpu) is None
    assert learn.fused_z_note(cfg, small, None, cuda) is None
    off = LearnConfig(fused_z=False, verbose="none")
    assert not learn.fused_z_ok(off, small, None, cpu)
    assert learn.fused_z_note(off, big, None, cuda) is None
    geom3 = ProblemGeom((5, 5, 5), 4)
    fg3 = common.FreqGeom.create(geom3, (12, 12, 12))
    assert not learn.fused_z_ok(cfg, fg3, None, cpu)
    assert learn.fused_z_note(cfg, fg3, None, cuda) is None
