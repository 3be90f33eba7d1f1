"""The port's Fourier operators, proxes, frequency geometry, loaders and
validation against their JAX counterparts, on the same numpy inputs.

Floating results are held to 1e-6 of the reference's scale (both sides
are float32 FFTs/products summed in different orders); pure data
movement (padding, cropping, embedding) must be exact.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.data import images as jimages
from ccsc_code_iccv2017_tpu.data import native as jnative
from ccsc_code_iccv2017_tpu.models import common as jcommon
from ccsc_code_iccv2017_tpu.ops import fourier as jfourier
from ccsc_code_iccv2017_tpu.ops import proxes as jproxes
from ccsc_code_iccv2017_tpu.utils import io_mat as jio
from ccsc_code_iccv2017_torch.config import ProblemGeom
from ccsc_code_iccv2017_torch.data import images as timages
from ccsc_code_iccv2017_torch.models import common as tcommon
from ccsc_code_iccv2017_torch.ops import fourier as tfourier
from ccsc_code_iccv2017_torch.ops import proxes as tproxes
from ccsc_code_iccv2017_torch.utils import io_mat as tio
from ccsc_code_iccv2017_torch.utils import validate as tvalidate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(REPO, "artifacts_2d", "learned_bank.mat")
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, tol=TOL):
    """max|port - ref| <= tol * max(1, max|ref|)."""
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, (err, scale)


def _rand(r, shape, cplx=False):
    a = r.normal(size=shape).astype(np.float32)
    if cplx:
        a = (a + 1j * r.normal(size=shape)).astype(np.complex64)
    return a


@pytest.mark.parametrize("spatial", [(9, 8), (8, 9), (16, 16)])
def test_rfftn_irfftn(spatial):
    r = np.random.default_rng(0)
    x = _rand(r, (2, 3, *spatial))
    xh = tfourier.rfftn_spatial(_t(x), 2)
    _close(xh, jfourier.rfftn_spatial(jnp.asarray(x), 2))
    back = tfourier.irfftn_spatial(xh, spatial)
    _close(back, jfourier.irfftn_spatial(jnp.asarray(np.asarray(xh)), spatial))
    _close(back, x)


@pytest.mark.parametrize("size", [(7, 6), (6, 7), (3, 4)])
@pytest.mark.parametrize("radius", [(2, 2), (5, 5), (2, 3)])
@pytest.mark.parametrize("mode", ["zero", "symmetric"])
def test_pad_spatial(size, radius, mode):
    """jnp.pad(mode="symmetric") repeats the edge sample; radius 5 on a
    3- or 4-wide axis pads wider than the data."""
    r = np.random.default_rng(1)
    x = _rand(r, (2, *size))
    out = tfourier.pad_spatial(_t(x), radius, mode=mode)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jfourier.pad_spatial(jnp.asarray(x), radius, mode=mode))
    )
    target = tuple(s + 2 * rr + 3 for s, rr in zip(size, radius))
    out = tfourier.pad_spatial(_t(x), radius, mode=mode, target=target)
    np.testing.assert_array_equal(
        out.numpy(),
        np.asarray(
            jfourier.pad_spatial(jnp.asarray(x), radius, mode=mode, target=target)
        ),
    )


def test_pad_spatial_refusals():
    x = torch.zeros(1, 6, 6)
    with pytest.raises(ValueError, match="trailing pad"):
        tfourier.pad_spatial(x, (2, 2), target=(9, 10))
    with pytest.raises(ValueError, match="unknown pad mode"):
        tfourier.pad_spatial(x, (2, 2), mode="reflect")


def test_crop_spatial():
    r = np.random.default_rng(2)
    x = _rand(r, (2, 3, 14, 15))
    for out_spatial in (None, (8, 7)):
        np.testing.assert_array_equal(
            tfourier.crop_spatial(_t(x), (2, 3), out_spatial).numpy(),
            np.asarray(jfourier.crop_spatial(jnp.asarray(x), (2, 3), out_spatial)),
        )


@pytest.mark.parametrize("support, spatial", [((5, 5), (20, 26)), ((11, 11), (32, 31))])
def test_psf2otf_and_circ_embed(support, spatial):
    r = np.random.default_rng(3)
    psf = _rand(r, (4, *support))
    emb = tfourier.circ_embed(_t(psf), spatial)
    np.testing.assert_array_equal(
        emb.numpy(), np.asarray(jfourier.circ_embed(jnp.asarray(psf), spatial))
    )
    np.testing.assert_array_equal(tfourier.circ_extract(emb, support).numpy(), psf)
    _close(
        tfourier.psf2otf(_t(psf), spatial),
        jfourier.psf2otf(jnp.asarray(psf), spatial),
    )


def test_fft_sizes_and_shapes():
    for n in range(1, 300):
        for mode in ("none", "pow2", "fast"):
            assert tfourier.next_fast_size(n, mode) == jfourier.next_fast_size(n, mode)
    for sp in [(26, 26), (9, 8), (4, 5, 7)]:
        assert tfourier.rfreq_shape(sp) == jfourier.rfreq_shape(sp)
    with pytest.raises(ValueError):
        tfourier.next_fast_size(10, "bogus")
    # the matmul-DFT tier runs (tests/test_torch_matmul_dft.py holds it to
    # JAX); an unknown impl is refused as in JAX
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 4, 4)).astype(np.float32))
    torch.testing.assert_close(
        tfourier.rfftn_spatial(x, 2, impl="matmul"),
        tfourier.rfftn_spatial(x, 2), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="unknown fft impl"):
        tfourier.rfftn_spatial(x, 2, impl="bogus")


def test_apply_dictionary_and_adjoint():
    r = np.random.default_rng(4)
    dhat = _rand(r, (5, 1, 40), cplx=True)
    zhat = _rand(r, (3, 5, 40), cplx=True)
    rhat = _rand(r, (3, 1, 40), cplx=True)
    _close(
        tfourier.apply_dictionary(_t(dhat), _t(zhat)),
        jfourier.apply_dictionary(jnp.asarray(dhat), jnp.asarray(zhat)),
    )
    _close(
        tfourier.apply_dictionary_adjoint(_t(dhat), _t(rhat)),
        jfourier.apply_dictionary_adjoint(jnp.asarray(dhat), jnp.asarray(rhat)),
    )


def test_proxes():
    r = np.random.default_rng(5)
    u = _rand(r, (2, 4, 6, 6))
    u[0, 0, 0, :3] = 0.0
    theta = np.float32(0.3)
    _close(
        tproxes.soft_threshold(_t(u), torch.tensor(theta)),
        jproxes.soft_threshold(jnp.asarray(u), jnp.asarray(theta)),
    )
    _close(tproxes.soft_threshold(_t(u), 0.3), jproxes.soft_threshold(jnp.asarray(u), 0.3))
    m = (r.uniform(size=(2, 6, 6)) > 0.5).astype(np.float32)
    b = r.uniform(size=(2, 6, 6)).astype(np.float32)
    v = _rand(r, (2, 6, 6))
    _close(
        tproxes.masked_quadratic_prox(_t(v), torch.tensor(theta), _t(m * m), _t(b * m)),
        jproxes.masked_quadratic_prox(
            jnp.asarray(v), jnp.asarray(theta), jnp.asarray(m * m), jnp.asarray(b * m)
        ),
    )
    counts = r.poisson(5.0, size=(2, 6, 6)).astype(np.float32)
    _close(
        tproxes.poisson_prox(_t(v), torch.tensor(theta), _t(m), _t(counts * m)),
        jproxes.poisson_prox(
            jnp.asarray(v), jnp.asarray(theta), jnp.asarray(m), jnp.asarray(counts * m)
        ),
    )
    cm = np.array([True, False, True, True])
    raw = _rand(r, (2, 4, 6, 6))
    _close(
        tproxes.skip_channels(_t(u), _t(raw), _t(cm)),
        jproxes.skip_channels(jnp.asarray(u), jnp.asarray(raw), jnp.asarray(cm)),
    )
    assert torch.equal(tproxes.skip_channels(_t(u), _t(raw), None), _t(u))


@pytest.mark.parametrize("fft_pad", ["none", "pow2", "fast"])
def test_freq_geom_and_spectra(fft_pad):
    r = np.random.default_rng(6)
    tg, jg = ProblemGeom((5, 5), 4), JGeom((5, 5), 4)
    fg = tcommon.FreqGeom.create(tg, (13, 10), fft_pad=fft_pad)
    jfg = jcommon.FreqGeom.create(jg, (13, 10), fft_pad=fft_pad)
    assert tuple(fg) == tuple(jfg)
    assert tcommon.FreqGeom.create(tg, (13, 10), pad=False) == tuple(
        jcommon.FreqGeom.create(jg, (13, 10), pad=False)
    )
    d = _rand(r, (4, 5, 5))
    _close(tcommon.filters_to_freq(_t(d), fg), jcommon.filters_to_freq(jnp.asarray(d), jfg))
    b = _rand(r, (2, *fg.spatial_shape))
    _close(tcommon.data_to_freq(_t(b), fg), jcommon.data_to_freq(jnp.asarray(b), jfg))
    z = _rand(r, (2, 4, *fg.spatial_shape))
    zh = tcommon.codes_to_freq(_t(z), fg)
    _close(zh, jcommon.codes_to_freq(jnp.asarray(z), jfg))
    _close(tcommon.codes_from_freq(zh, fg), z)
    dh = tcommon.filters_to_freq(_t(d), fg)
    _close(
        tcommon.recon_from_freq(dh, zh, fg),
        jcommon.recon_from_freq(jnp.asarray(dh.numpy()), jnp.asarray(zh.numpy()), jfg),
    )


def test_objective_terms_and_metrics():
    r = np.random.default_rng(7)
    Dz = _rand(r, (2, 14, 14))
    b = _rand(r, (2, 10, 10))
    m = (r.uniform(size=b.shape) > 0.5).astype(np.float32)
    for mask in (None, m):
        _close(
            tcommon.data_fidelity(_t(Dz), _t(b), (2, 2), 5.0, None if mask is None else _t(mask)),
            jcommon.data_fidelity(
                jnp.asarray(Dz), jnp.asarray(b), (2, 2), 5.0,
                None if mask is None else jnp.asarray(mask),
            ),
        )
    z = _rand(r, (2, 3, 8, 8))
    z2 = _rand(r, (2, 3, 8, 8))
    _close(tcommon.l1_penalty(_t(z), 2.0), jcommon.l1_penalty(jnp.asarray(z), 2.0))
    _close(tcommon.rel_change(_t(z), _t(z2)), jcommon.rel_change(jnp.asarray(z), jnp.asarray(z2)))
    x = r.uniform(size=(2, 12, 12)).astype(np.float32)
    ref = r.uniform(size=(2, 12, 12)).astype(np.float32)
    for crop in ((), (2, 2)):
        _close(
            tcommon.psnr(_t(x), _t(ref), crop),
            jcommon.psnr(jnp.asarray(x), jnp.asarray(ref), crop),
        )


def test_load_filters_2d_matches_jax(tmp_path):
    d = tio.load_filters_2d(BANK)
    assert d.shape == (100, 11, 11) and d.dtype == np.float32
    np.testing.assert_array_equal(d, jio.load_filters_2d(BANK))
    with pytest.raises(tvalidate.CCSCInputError, match="no such"):
        tio.load_filters_2d(str(tmp_path / "missing.mat"))
    bad = tmp_path / "bad.mat"
    bad.write_bytes(b"not a mat file")
    with pytest.raises(tvalidate.CCSCInputError, match="cannot read"):
        tio.load_filters_2d(str(bad))


def test_images_and_smooth_fill_match_jax(tmp_path):
    from PIL import Image

    np.testing.assert_array_equal(timages.gaussian_kernel(), jimages.gaussian_kernel())
    r = np.random.default_rng(8)
    for i in range(3):
        arr = (r.uniform(size=(20, 22)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / f"{i}.png")
    b = timages.load_images(str(tmp_path))
    np.testing.assert_array_equal(b, jimages.load_images(str(tmp_path)))
    np.testing.assert_array_equal(
        timages.load_images(str(tmp_path), limit=2, size=(16, 16)),
        jimages.load_images(str(tmp_path), limit=2, size=(16, 16)),
    )
    k = timages.gaussian_kernel()
    np.testing.assert_array_equal(timages.rconv2(b[0], k), jimages.rconv2(b[0], k))
    mask = (r.uniform(size=b.shape) > 0.5).astype(np.float32)
    _close(timages.smooth_fill_batch(b, mask), jnative.smooth_fill_batch(b, mask), 1e-5)
    _close(timages.smooth_fill_batch(b[0], mask[0]), jnative.smooth_fill_batch(b[0], mask[0]), 1e-5)
    # a single file loads as a one-image stack, as in the JAX loader
    np.testing.assert_array_equal(
        timages.load_images(str(tmp_path / "0.png")),
        jimages.load_images(str(tmp_path / "0.png")),
    )


def test_smooth_noise_images_are_seeded_unit_range():
    a = timages.smooth_noise_images(np.random.default_rng(3), 2, 32)
    b = timages.smooth_noise_images(np.random.default_rng(3), 2, 32)
    assert a.shape == (2, 32, 32) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert a.min() == 0.0 and a.max() == 1.0
    assert not np.array_equal(a[0], a[1])


def test_validation_refusals():
    geom = ProblemGeom((5, 5), 4)
    b = torch.ones(2, 12, 12)
    d = torch.ones(4, 5, 5)
    tvalidate.check_solve_data(b, d, geom, mask=torch.ones(2, 12, 12))
    bad = b.clone()
    bad[0, 0, 0] = float("nan")
    with pytest.raises(tvalidate.CCSCInputError, match="non-finite"):
        tvalidate.check_solve_data(bad, d, geom)
    with pytest.raises(tvalidate.CCSCInputError, match="identically zero"):
        tvalidate.check_solve_data(b, d, geom, mask=torch.zeros(2, 12, 12))
    with pytest.raises(tvalidate.CCSCInputError, match="axes"):
        tvalidate.check_solve_data(b[0], d, geom)
    with pytest.raises(tvalidate.CCSCInputError, match="filter shape"):
        tvalidate.check_solve_data(b, d[:3], geom)
    with pytest.raises(tvalidate.CCSCInputError, match="exceeds"):
        tvalidate.check_solve_data(torch.ones(2, 4, 4), d, geom)
    with pytest.raises(tvalidate.CCSCInputError, match="smooth_init"):
        tvalidate.check_solve_data(b, d, geom, smooth_init=torch.ones(2, 10, 10))
    with pytest.raises(tvalidate.CCSCInputError, match="non-numeric"):
        tvalidate.check_finite("data", np.array([["a"]]))
    tvalidate.check_finite("counts", np.arange(4))


@pytest.mark.parametrize("norm_over_reduce", [False, True])
@pytest.mark.parametrize("reduce_shape", [(), (3,)])
def test_kernel_constraint_proj(reduce_shape, norm_over_reduce):
    r = np.random.default_rng(20)
    # some filters inside the unit ball (kept), some outside (scaled)
    d = _rand(r, (5, *reduce_shape, 14, 12)) * np.array(
        [0.01, 0.05, 1.0, 3.0, 0.02], np.float32
    ).reshape(5, *([1] * (len(reduce_shape) + 2)))
    ref = jproxes.kernel_constraint_proj(
        jnp.asarray(d), (5, 3), (14, 12), norm_over_reduce=norm_over_reduce
    )
    out = tproxes.kernel_constraint_proj(
        _t(d), (5, 3), (14, 12), norm_over_reduce=norm_over_reduce
    )
    _close(out, ref)
    sup = tfourier.circ_extract(out, (5, 3))
    axes = tuple(range(1, sup.ndim)) if norm_over_reduce else (-2, -1)
    assert float(torch.sqrt((sup**2).sum(dim=axes)).max()) <= 1 + 1e-6


@pytest.mark.parametrize("reduce_shape", [(), (2,)])
def test_full_filters_to_freq(reduce_shape):
    r = np.random.default_rng(21)
    geom, jgeom = (ProblemGeom((5, 5), 4, reduce_shape),
                   JGeom((5, 5), 4, reduce_shape))
    fg = tcommon.FreqGeom.create(geom, (10, 9))
    jfg = jcommon.FreqGeom.create(jgeom, (10, 9))
    d = _rand(r, (4, *reduce_shape, *fg.spatial_shape))
    _close(tcommon.full_filters_to_freq(_t(d), fg),
           jcommon.full_filters_to_freq(jnp.asarray(d), jfg))
    # a leading block axis passes through
    blocks = np.stack([d, 2 * d])
    out = tcommon.full_filters_to_freq(_t(blocks), fg)
    assert tuple(out.shape) == (2, 4, fg.reduce_size, fg.num_freq)
    _close(out[1], np.asarray(jcommon.full_filters_to_freq(
        jnp.asarray(2 * d), jfg)))


@pytest.mark.parametrize("kind", ["noise", "flat", "sparse"])
def test_local_contrast_normalize(kind):
    r = np.random.default_rng(22)
    img = r.random((23, 31)).astype(np.float32)
    if kind == "flat":
        img[:] = 0.5  # zero local std everywhere: the eps floor
    elif kind == "sparse":
        img = np.zeros((23, 31), np.float32)
        img[5:8, 9:12] = 1.0  # median std 0: the median of nonzeros
    np.testing.assert_array_equal(
        timages.local_contrast_normalize(img),
        jimages.local_contrast_normalize(img),
    )


def test_load_images_local_cn_zero_mean_square(tmp_path):
    from PIL import Image

    r = np.random.default_rng(23)
    for i in range(3):
        Image.fromarray((r.random((20, 26)) * 255).astype(np.uint8)).save(
            tmp_path / f"{i}.png"
        )
    kw = dict(contrast_normalize="local_cn", zero_mean=True, square=True)
    np.testing.assert_array_equal(
        timages.load_images(str(tmp_path), **kw),
        jimages.load_images(str(tmp_path), **kw),
    )
    np.testing.assert_array_equal(
        timages.load_images(str(tmp_path), contrast_normalize="local_cn",
                            size=(16, 16)),
        jimages.load_images(str(tmp_path), contrast_normalize="local_cn",
                            size=(16, 16)),
    )
    with pytest.raises(NotImplementedError, match="contrast mode"):
        timages.load_images(str(tmp_path), contrast_normalize="zca")


def test_save_filters_round_trips_through_jax_loaders(tmp_path):
    r = np.random.default_rng(24)
    d, Dz = _rand(r, (4, 5, 5)), _rand(r, (3, 12, 10))
    trace = {"obj_vals_z": [3.0, 2.0], "algorithm": "consensus"}
    tio.save_filters(str(tmp_path / "t.mat"), _t(d), trace, Dz=_t(Dz))
    jio.save_filters(str(tmp_path / "j.mat"), d, trace, layout="2d", Dz=Dz)
    for name in ("t.mat", "j.mat"):
        np.testing.assert_array_equal(
            jio.load_filters_2d(str(tmp_path / name)), d
        )
        np.testing.assert_array_equal(jio.load_dz(str(tmp_path / name)), Dz)
    np.testing.assert_array_equal(
        tio.load_filters_2d(str(tmp_path / "t.mat")), d
    )
    # a 4-D bank with a reduce axis unlike its support infers the
    # hyperspectral layout, as in JAX (every layout: test_torch_learn_apps)
    hs = _rand(r, (2, 3, 5, 5))
    tio.save_filters(str(tmp_path / "h.mat"), _t(hs))
    np.testing.assert_array_equal(
        jio.load_filters_hyperspectral(str(tmp_path / "h.mat")), hs
    )


@pytest.mark.parametrize(
    "b_shape, cfg_kw, bad",
    [
        ((4, 12, 12), {}, None),
        ((4, 12, 12), dict(num_blocks=3), "not divisible"),
        ((4, 12, 12), dict(num_blocks=0), "num_blocks"),
        ((12, 12), {}, "axes"),
        ((4, 4, 4), {}, "exceeds"),
        ((4, 12, 12), dict(rho_z=0.0), "rho_z"),
        ((4, 12, 12), dict(max_it_z=0), "max_it"),
        ((4, 12, 12), dict(tol=-1.0), "tol"),
        ((4, 12, 12), "nan", "non-finite"),
    ],
)
def test_learn_validation_matches_jax(b_shape, cfg_kw, bad):
    from ccsc_code_iccv2017_tpu.config import LearnConfig as JCfg
    from ccsc_code_iccv2017_tpu.utils import validate as jvalidate
    from ccsc_code_iccv2017_torch.config import LearnConfig

    b = np.ones(b_shape, np.float32)
    if cfg_kw == "nan":
        b[0, 0, 0], cfg_kw = np.nan, {}
    cfg_kw = dict(dict(num_blocks=2), **cfg_kw)
    geom, jgeom = ProblemGeom((5, 5), 3), JGeom((5, 5), 3)
    d = np.zeros((3, 5, 5), np.float32)
    calls = (
        (lambda: jvalidate.check_learn_inputs(b, jgeom, JCfg(**cfg_kw),
                                              init_d=d)),
        (lambda: tvalidate.check_learn_inputs(b, geom, LearnConfig(**cfg_kw),
                                              init_d=d)),
    )
    for call in calls:
        if bad is None:
            call()
        else:
            with pytest.raises(ValueError, match=bad):
                call()


def test_learn_validation_refuses_unported_storage_dtype():
    from ccsc_code_iccv2017_torch.config import LearnConfig

    with pytest.raises(tvalidate.CCSCInputError, match="storage_dtype"):
        tvalidate.check_learn_config(LearnConfig(storage_dtype="float16"))
