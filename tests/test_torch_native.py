"""The port's loaders of slice 9 against the JAX package's, on the CPU:
every whitening contrast mode and every ``layout`` of ``load_images``,
``return_info``'s ``mean_image``, ``load_images_native``, and the native
preprocessing library (``data/native.py``, built from
``native/ccsc_data.cpp`` into the port's build directory) against its
numpy versions. The loaders copy the JAX numpy code, so they are held to
it exactly; the native library computes in double precision, so it is
held to numpy at the JAX package's own tolerances (tests/test_native.py:
local_cn 5e-3, the smooth fill 2e-5, zero-mean 1e-5).
"""
import os

import numpy as np
import pytest

from ccsc_code_iccv2017_tpu.data import images as jimages
from ccsc_code_iccv2017_tpu.data import whitening as jwhitening
from ccsc_code_iccv2017_torch.data import images as timages
from ccsc_code_iccv2017_torch.data import native
from ccsc_code_iccv2017_torch.data import whitening as twhitening

MODES = (["none", "local_cn"] + list(jwhitening.PER_IMAGE_MODES)
         + list(jwhitening.STACK_MODES))
LAYOUTS = ("channels_last", "reduce", "batch")


def _stack(color, n=4, side=20, seed=0):
    r = np.random.default_rng(seed)
    shape = (n, side, side + 2) + ((3,) if color else ())
    return (r.random(shape) * 255).astype(np.uint8)


def test_mode_registries_match_jax():
    assert list(twhitening.PER_IMAGE_MODES) == list(
        jwhitening.PER_IMAGE_MODES)
    assert list(twhitening.STACK_MODES) == list(jwhitening.STACK_MODES)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("color", ["gray", "rgb"])
def test_load_images_contrast_modes_match_jax(mode, color):
    x = _stack(color == "rgb")
    kw = dict(contrast_normalize=mode, color=color, zero_mean=True)
    np.testing.assert_array_equal(timages.load_images(x, **kw),
                                  jimages.load_images(x, **kw))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("color", ["gray", "rgb"])
def test_layouts_and_mean_image_match_jax(layout, color):
    x = _stack(color == "rgb", seed=1)
    kw = dict(contrast_normalize="sep_mean", color=color, layout=layout,
              return_info=True)
    got, info = timages.load_images(x, **kw)
    ref, jinfo = jimages.load_images(x, **kw)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(info["mean_image"], jinfo["mean_image"])
    # the mean image undoes the centering in every layout
    plain = timages.load_images(x, color=color, layout=layout)
    np.testing.assert_allclose(got + info["mean_image"], plain, atol=1e-5)
    _, none_info = timages.load_images(x, color=color, layout=layout,
                                       return_info=True)
    assert none_info == {}


def test_per_image_modes_of_load_image_list_match_jax():
    imgs = list(_stack(False, n=2, seed=2))
    for mode in jwhitening.PER_IMAGE_MODES:
        got = timages.load_image_list(np.stack(imgs), contrast_normalize=mode)
        ref = jimages.load_image_list(np.stack(imgs), contrast_normalize=mode)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_unknown_mode_and_layout_are_refused_like_jax():
    x = _stack(False)
    for mod in (timages, jimages):
        with pytest.raises(NotImplementedError, match="contrast mode"):
            mod.load_images(x, contrast_normalize="fancy")
        with pytest.raises(ValueError, match="layout"):
            mod.load_images(x, layout="planar")


def test_library_builds_into_the_port_build_dir():
    """The port compiles the source itself into its build directory
    (hash-named), and never runs ``make -C native`` (which the JAX
    binding does, writing native/libccsc_data.so)."""
    assert native.available(), "g++ builds the library here"
    info = native.build_info()
    assert os.path.dirname(info["path"]) == native.BUILD_DIR
    assert os.path.basename(info["path"]).startswith("libccsc_data_")
    assert native.lib_path() == info["path"]
    assert os.path.dirname(native.SOURCE) != native.BUILD_DIR
    assert not any(f.startswith("libccsc_data_")
                   for f in os.listdir(os.path.dirname(native.SOURCE)))


@pytest.mark.parametrize("shape", [(3, 24, 31), (1, 40, 40), (17, 9)])
def test_native_batches_match_numpy_and_keep_their_input(shape):
    assert native.available()
    r = np.random.default_rng(3)
    x = r.random(shape).astype(np.float32)
    m = (r.random(shape) < 0.5).astype(np.float32)
    x0, m0 = x.copy(), m.copy()
    planes = x if x.ndim == 3 else x[None]
    lcn = native.local_cn_batch(x)
    np.testing.assert_allclose(
        lcn, np.stack([timages.local_contrast_normalize(i) for i in planes]),
        atol=5e-3)
    np.testing.assert_allclose(native.smooth_fill_batch(x, m),
                               timages.smooth_fill_batch(x, m), atol=2e-5)
    axes = tuple(range(1, planes.ndim))
    np.testing.assert_allclose(native.zero_mean_batch(planes),
                               planes - planes.mean(axis=axes, keepdims=True),
                               atol=1e-5)
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(m, m0)


def test_numpy_fallback_when_the_library_is_absent(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    r = np.random.default_rng(4)
    x = r.random((2, 16, 16)).astype(np.float32)
    m = (r.random(x.shape) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(native.smooth_fill_batch(x, m),
                                  timages.smooth_fill_batch(x, m))
    np.testing.assert_array_equal(
        native.local_cn_batch(x),
        np.stack([timages.local_contrast_normalize(i) for i in x]))


@pytest.mark.parametrize("color", ["gray", "rgb"])
def test_load_images_native_matches_jax_and_numpy(color):
    x = _stack(color == "rgb", seed=5)
    kw = dict(color=color, size=(16, 16), square=True, layout="reduce")
    got = timages.load_images_native(x, "local_cn", True, **kw)
    np.testing.assert_allclose(
        got, jimages.load_images_native(x, "local_cn", True, **kw), atol=1e-6)
    np.testing.assert_allclose(
        got, timages.load_images(x, "local_cn", True, **kw), atol=5e-3)


def test_inpaint_warm_start_unchanged_by_the_native_fill(tmp_path):
    """The inpainting app's smooth_init now comes from the native
    library; its result equals the numpy fill's run."""
    from ccsc_code_iccv2017_torch.apps import inpaint_2d

    r = np.random.default_rng(6)
    data = str(tmp_path / "imgs")
    os.makedirs(data)
    from PIL import Image

    for i in range(2):
        Image.fromarray((r.random((24, 24)) * 255).astype(np.uint8)).save(
            os.path.join(data, f"{i}.png"))
    argv = ["--data", data, "--filters",
            os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "artifacts_2d",
                "learned_bank.mat"),
            "--max-it", "3", "--device", "cpu"]
    assert native.available()
    res = inpaint_2d.main(argv)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(native, "_load", lambda: None)
        ref = inpaint_2d.main(argv)
    finally:
        mp.undo()
    np.testing.assert_allclose(res.recon.numpy(), ref.recon.numpy(),
                               atol=1e-5)
    assert int(res.trace.num_iters) == int(ref.trace.num_iters)
