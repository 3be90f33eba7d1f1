"""The port's loaders and validators against the JAX package's, on the
CPU: the non-2D bank loaders on the repo's banks, ``data/volumes.py``'s
generators, ``load_image_list``/``load_images`` on each input form (a
folder, a single file, a .mat stack in either layout, an array), and
the validators' refusals on reduce geometries and 3D supports, case for
case. Every comparison is exact: the port copies this numpy code."""
import os

import numpy as np
import pytest
import scipy.io

from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.data import images as jimages
from ccsc_code_iccv2017_tpu.data import volumes as jvolumes
from ccsc_code_iccv2017_tpu.utils import io_mat as jio
from ccsc_code_iccv2017_tpu.utils import validate as jvalidate
from ccsc_code_iccv2017_torch.config import ProblemGeom
from ccsc_code_iccv2017_torch.data import images as timages
from ccsc_code_iccv2017_torch.data import volumes as tvolumes
from ccsc_code_iccv2017_torch.utils import io_mat as tio
from ccsc_code_iccv2017_torch.utils import validate as tvalidate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = os.path.join(REPO, "artifacts_family_cpu")


@pytest.mark.parametrize(
    "loader, bank, shape",
    [
        ("load_filters_hyperspectral", "bank_hs.mat", (100, 31, 11, 11)),
        ("load_filters_3d", "bank_3d.mat", (49, 11, 11, 11)),
        ("load_filters_lightfield", "bank_4d.mat", (49, 5, 5, 11, 11)),
    ],
)
def test_family_bank_loaders_match_jax(loader, bank, shape):
    path = os.path.join(FAMILY, bank)
    d = getattr(tio, loader)(path)
    assert d.shape == shape and d.dtype == np.float32
    assert d.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(d, getattr(jio, loader)(path))
    assert tio.infer_layout(d) == jio.infer_layout(d)


def test_loaders_keep_each_axis(tmp_path):
    """A bank with every axis of a different length lands each axis
    where the JAX loader puts it."""
    r = np.random.default_rng(50)
    for loader, shape in (
        ("load_filters_hyperspectral", (3, 4, 5, 6)),
        ("load_filters_3d", (3, 4, 5, 6)),
        ("load_filters_lightfield", (3, 4, 5, 7, 6)),
    ):
        path = str(tmp_path / f"{loader}.mat")
        scipy.io.savemat(path, {"d": r.normal(size=shape)})
        np.testing.assert_array_equal(getattr(tio, loader)(path),
                                      getattr(jio, loader)(path))
    for shape in ((4, 3, 3), (4, 5, 5, 5), (4, 31, 5, 5), (4, 2, 2, 5, 5)):
        d = np.zeros(shape, np.float32)
        assert tio.infer_layout(d) == jio.infer_layout(d)
    with pytest.raises(ValueError):
        tio.infer_layout(np.zeros((2, 3)))
    with pytest.raises(tvalidate.CCSCInputError, match="no variable"):
        scipy.io.savemat(str(tmp_path / "x.mat"), {"w": np.ones(3)})
        tio.load_filters_3d(str(tmp_path / "x.mat"))


@pytest.mark.parametrize(
    "gen, kw",
    [
        ("synthetic_video", dict(n=2, side=10, frames=6, seed=3)),
        ("synthetic_hyperspectral", dict(n=2, bands=7, side=12, seed=4)),
        ("synthetic_lightfield", dict(views=3, side=14, seed=5)),
    ],
)
def test_volume_generators_bitwise_equal_jax(gen, kw):
    np.testing.assert_array_equal(getattr(tvolumes, gen)(**kw),
                                  getattr(jvolumes, gen)(**kw))


def test_volume_crops_and_band_folders_match_jax(tmp_path):
    from PIL import Image

    vol = np.random.default_rng(51).normal(size=(12, 10, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tvolumes.random_volume_crops(vol, 3, (5, 4, 3), seed=2),
        jvolumes.random_volume_crops(vol, 3, (5, 4, 3), seed=2),
    )
    lf = np.random.default_rng(52).normal(size=(3, 3, 12, 11))
    np.testing.assert_array_equal(
        tvolumes.random_lightfield_patches(lf, 2, spatial=5, seed=1),
        jvolumes.random_lightfield_patches(lf, 2, spatial=5, seed=1),
    )
    r = np.random.default_rng(53)
    for i in range(6):
        Image.fromarray((r.uniform(size=(9, 7)) * 255).astype(np.uint8)).save(
            tmp_path / f"{i}.png")
    np.testing.assert_array_equal(
        tvolumes.load_hyperspectral_dir(str(tmp_path), bands=3),
        jvolumes.load_hyperspectral_dir(str(tmp_path), bands=3),
    )
    with pytest.raises(tvalidate.CCSCInputError, match="not divisible"):
        tvolumes.load_hyperspectral_dir(str(tmp_path), bands=4)


def _image_fixtures(tmp_path):
    """A folder of 3 RGB PNGs of differing sizes, one 16-bit gray PNG,
    and .mat stacks in both layouts."""
    from PIL import Image

    r = np.random.default_rng(54)
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i, shape in enumerate([(12, 9), (10, 11), (9, 9)]):
        Image.fromarray((r.uniform(size=(*shape, 3)) * 255).astype(np.uint8)
                        ).save(folder / f"{i}.png")
    single = tmp_path / "one.png"
    Image.fromarray((r.uniform(size=(8, 13)) * 65535).astype(np.uint16)
                    ).save(single)
    stack = r.uniform(size=(4, 10, 12)).astype(np.float32)
    mats = {}
    for layout, arr in (("framework", stack),
                        ("matlab", np.transpose(stack, (1, 2, 0)))):
        p = tmp_path / f"{layout}.mat"
        scipy.io.savemat(p, {"stack": arr})  # unnamed: the layout decides
        mats[layout] = str(p)
    named = tmp_path / "named"
    named.mkdir()
    scipy.io.savemat(named / "only.mat", {"b": stack})
    return str(folder), str(single), mats, str(named), stack


@pytest.mark.parametrize("color", ["gray", "rgb", "ycbcr", "hsv"])
def test_load_image_list_matches_jax(tmp_path, color):
    folder, single, mats, named, stack = _image_fixtures(tmp_path)
    cases = [
        (folder, {}),
        (folder, dict(frames=(3, -2, 1), limit=2)),
        (folder, dict(contrast_normalize="local_cn", zero_mean=True)),
        (single, {}),
        (mats["framework"], dict(mat_layout="framework")),
        (mats["matlab"], dict(mat_layout="matlab")),
        (mats["matlab"], {}),  # unnamed 3-D: MATLAB by default
        (named, dict(frames=(1, 2, "end"))),  # a single-.mat folder
        (stack, {}),
    ]
    for path, kw in cases:
        t = timages.load_image_list(path, color=color, **kw)
        j = jimages.load_image_list(path, color=color, **kw)
        assert len(t) == len(j) > 0, (path, kw)
        for a, b in zip(t, j):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("color", ["gray", "rgb"])
def test_load_images_forms_match_jax(tmp_path, color):
    folder, single, mats, named, stack = _image_fixtures(tmp_path)
    for path, kw in (
        (folder, dict(size=(8, 10))),
        (folder, dict(square=True, size=(9, 9), frames=(1, 2, "end"))),
        (single, {}),
        (mats["framework"], dict(mat_layout="framework", square=True)),
        (named, {}),
        (stack, dict(limit=3)),
    ):
        np.testing.assert_array_equal(
            timages.load_images(path, color=color, **kw),
            jimages.load_images(path, color=color, **kw),
        )
    with pytest.raises(ValueError, match="differ in size"):
        timages.load_images(folder)
    # an unknown contrast mode is refused as the JAX loader refuses it
    for mod in (timages, jimages):
        with pytest.raises(NotImplementedError, match="contrast mode 'zca'"):
            mod.load_image_list(folder, contrast_normalize="zca")


def test_mat_stack_refusals_match_jax(tmp_path):
    amb = np.zeros((5, 6, 7, 3), np.float32)  # [n,H,W,C] or [H,W,C,n]?
    scipy.io.savemat(tmp_path / "amb.mat", {"x": amb})
    nan = np.ones((2, 4, 4), np.float32)
    nan[0, 1, 1] = np.nan
    scipy.io.savemat(tmp_path / "nan.mat", {"b": nan})
    (tmp_path / "empty").mkdir()
    for path, exc in (
        (str(tmp_path / "amb.mat"), ValueError),
        (str(tmp_path / "nan.mat"), tvalidate.CCSCInputError),
        (str(tmp_path / "empty"), ValueError),
    ):
        with pytest.raises(exc):
            timages.load_image_list(path)
        with pytest.raises(ValueError):  # CCSCInputError is a ValueError
            jimages.load_image_list(path)
    assert len(timages.load_image_list(str(tmp_path / "amb.mat"),
                                       mat_layout="framework")) == 5


def _validator_cases():
    """(geometry args, data shape, filter shape, mask kind, smooth shape):
    reduce geometries and a 3D support, valid and each way wrong."""
    hs = ((3, 4), 2, (5,))
    lf = ((3, 4), 2, (2, 3))
    v3 = ((3, 4, 5), 2, ())
    return [
        ("hs ok", hs, (1, 5, 9, 8), (2, 5, 3, 4), "ones", None),
        ("hs no batch", hs, (5, 9, 8), (2, 5, 3, 4), None, None),
        ("hs wrong bands", hs, (1, 4, 9, 8), (2, 5, 3, 4), None, None),
        ("hs bands last", hs, (1, 9, 8, 5), (2, 5, 3, 4), None, None),
        ("hs filters wrong", hs, (1, 5, 9, 8), (2, 3, 4, 5), None, None),
        ("hs support > signal", hs, (1, 5, 2, 8), (2, 5, 3, 4), None, None),
        ("hs zero mask", hs, (1, 5, 9, 8), (2, 5, 3, 4), "zeros", None),
        ("hs nan mask", hs, (1, 5, 9, 8), (2, 5, 3, 4), "nan", None),
        ("hs mask shape", hs, (1, 5, 9, 8), (2, 5, 3, 4), "short", None),
        ("hs smooth shape", hs, (1, 5, 9, 8), (2, 5, 3, 4), None,
         (1, 5, 9, 7)),
        ("lf ok", lf, (2, 2, 3, 7, 6), (2, 2, 3, 3, 4), "ones",
         (2, 2, 3, 7, 6)),
        ("lf views swapped", lf, (1, 3, 2, 7, 6), (2, 2, 3, 3, 4), None,
         None),
        ("lf filters views swapped", lf, (1, 2, 3, 7, 6), (2, 3, 2, 3, 4),
         None, None),
        ("3d ok", v3, (1, 8, 9, 10), (2, 3, 4, 5), None, None),
        # a transposed axis that still covers the support passes both
        # validators: only the parity tests can see it
        ("3d time first ok", v3, (1, 10, 8, 9), (2, 3, 4, 5), None, None),
        ("3d too few frames", v3, (1, 8, 9, 4), (2, 3, 4, 5), None, None),
        ("3d filters time first", v3, (1, 8, 9, 10), (2, 5, 3, 4), None,
         None),
        ("3d 2D filters", v3, (1, 8, 9, 10), (2, 3, 4), None, None),
        ("3d empty batch", v3, (0, 8, 9, 10), (2, 3, 4, 5), None, None),
        ("3d nan data", v3, "nan", (2, 3, 4, 5), None, None),
    ]


@pytest.mark.parametrize("case", _validator_cases(), ids=lambda c: c[0])
def test_validators_refuse_what_jax_refuses(case):
    name, gargs, bshape, dshape, mask_kind, sm_shape = case
    if bshape == "nan":
        b = np.ones((1, 8, 9, 10), np.float32)
        b[0, 1, 2, 3] = np.nan
    else:
        b = np.ones(bshape, np.float32)
    d = np.ones(dshape, np.float32)
    mask = None
    if mask_kind == "ones":
        mask = np.ones_like(b)
    elif mask_kind == "zeros":
        mask = np.zeros_like(b)
    elif mask_kind == "nan":
        mask = np.ones_like(b)
        mask.flat[0] = np.nan
    elif mask_kind == "short":
        mask = np.ones(b.shape[:-1] + (b.shape[-1] - 1,), np.float32)
    sm = None if sm_shape is None else np.zeros(sm_shape, np.float32)

    def outcome(validate, geom_cls):
        try:
            validate.check_solve_data(b, d, geom_cls(*gargs), mask=mask,
                                      smooth_init=sm)
            return None
        except validate.CCSCInputError as e:
            return str(e)

    t = outcome(tvalidate, ProblemGeom)
    j = outcome(jvalidate, JGeom)
    assert (t is None) == (j is None), (t, j)
    assert (t is None) == name.endswith(" ok")
    if t is not None:
        # the same input named the same way (the port's non-finite
        # message leaves out the count, which takes a host copy)
        assert t.split()[:2] == j.split()[:2], (t, j)
        assert ("non-finite" in t) == ("non-finite" in j)
