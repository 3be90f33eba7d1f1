"""The learner apps: ``learn_3d``, ``learn_4d`` and ``learn_hyperspectral``
of the port against the JAX package's on the same arguments, at a tiny
size on the CPU, and the filter files both packages write.

torch and jax random streams differ, so each port app runs with its
learner's ``init_state`` replaced by the JAX init the JAX app draws from
``PRNGKey(--seed)`` (the port's generator is seeded with ``--seed``
too). Tolerances: objective traces rtol 1e-4, filters within 1e-4 of
their scale and reconstructions within 1e-4 of the data's (float32 FFTs,
Cholesky and sums in another order), as the learners' own parity tests
hold them; with bf16 storage 1e-2 (each step rounds the state to 8
mantissa bits).
"""
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.models import learn as jlearn
from ccsc_code_iccv2017_tpu.utils import io_mat as jio
from ccsc_code_iccv2017_torch import convert
from ccsc_code_iccv2017_torch.models import learn as tlearn
from ccsc_code_iccv2017_torch.models import learn_masked as tlm
from ccsc_code_iccv2017_torch.utils import io_mat as tio

from test_torch_learn_masked import jax_masked_state


def _jgeom(geom):
    return JGeom(tuple(geom.spatial_support), geom.num_filters,
                 tuple(geom.reduce_shape))


def _use_jax_inits(monkeypatch):
    """Make the port's learners start from the JAX init of the seed their
    generator was seeded with."""

    def consensus_init(generator, geom, fg, N, ni, dtype=torch.float32,
                       z_dtype=None, d_dtype=None):
        st = jlearn.init_state(
            jax.random.PRNGKey(generator.initial_seed()), _jgeom(geom),
            types.SimpleNamespace(spatial_shape=fg.spatial_shape), N, ni,
            jnp.float32,
            z_dtype=jnp.dtype(str(z_dtype).replace("torch.", "")),
            d_dtype=jnp.dtype(str(d_dtype).replace("torch.", "")),
        )
        return convert.learn_state_from_jax(
            {f: np.asarray(getattr(st, f)) for f in st._fields},
            generator.device,
        )

    def masked_init(generator, geom, fg, n, z_dtype=torch.float32,
                    init_d=None):
        st = jax_masked_state(
            n, (tuple(geom.spatial_support), geom.num_filters,
                tuple(geom.reduce_shape)),
            fg.spatial_shape, jax.random.PRNGKey(generator.initial_seed()),
            str(z_dtype).replace("torch.", ""),
            init_d=None if init_d is None else np.asarray(init_d.cpu()),
        )
        return convert.masked_state_from_jax(
            {f: np.asarray(getattr(st, f)) for f in st._fields},
            generator.device,
        )

    monkeypatch.setattr(tlearn, "init_state", consensus_init)
    monkeypatch.setattr(tlm, "init_state", masked_init)


def _apps(name):
    return (importlib.import_module(f"ccsc_code_iccv2017_tpu.apps.{name}"),
            importlib.import_module(f"ccsc_code_iccv2017_torch.apps.{name}"))


APP_ARGV = {
    "learn_3d": (["--synthetic", "--clips", "4", "--clip-size", "8",
                  "--clip-frames", "6", "--filters", "3", "--support", "3",
                  "--support-t", "3", "--blocks", "2", "--max-it", "2",
                  "--tol", "0"], "3d"),
    "learn_4d": (["--synthetic", "--patches", "4", "--patch-size", "10",
                  "--views", "2", "--filters", "3", "--support", "3",
                  "--blocks", "2", "--max-it", "2", "--tol", "0"],
                 "lightfield"),
    "learn_hyperspectral": (["--synthetic", "--limit", "2", "--bands", "3",
                             "--filters", "3", "--support", "3",
                             "--max-it", "2", "--tol", "0"],
                            "hyperspectral"),
}


def _close(got, ref, tol=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("extra", [[], ["--storage-dtype", "bfloat16"]],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(APP_ARGV))
def test_app_matches_the_jax_app(monkeypatch, tmp_path, name, extra):
    if extra and name == "learn_3d":
        extra = extra + ["--d-storage-dtype", "bfloat16"]
    if not extra and name == "learn_hyperspectral":
        extra = ["--carry-freq"]
    argv, layout = APP_ARGV[name]
    argv = argv + extra + ["--verbose", "none", "--seed", "3"]
    japp, tapp = _apps(name)
    jout, tout = str(tmp_path / "j.mat"), str(tmp_path / "t.mat")
    jr = japp.main(argv + ["--out", jout])
    _use_jax_inits(monkeypatch)
    tr = tapp.main(argv + ["--out", tout, "--device", "cpu"])
    tol = 1e-2 if "bfloat16" in extra else 1e-4
    for k in ("obj_vals_d", "obj_vals_z"):
        assert len(tr.trace[k]) == len(jr.trace[k])
        np.testing.assert_allclose(tr.trace[k], jr.trace[k], rtol=tol)
    _close(tr.d.numpy(), jr.d, tol)
    # the reconstructions over the data's scale: two steps of a tiny
    # problem leave Dz orders of magnitude below the data
    b = tapp.load_data(tapp.build_parser().parse_args(argv))
    Dz, jDz = tr.Dz.numpy(), np.asarray(jr.Dz)
    assert Dz.shape == jDz.shape
    assert np.abs(Dz - jDz).max() <= tol * np.abs(b).max()
    # the port's file in the reference layout, read by the JAX loaders
    load = getattr(jio, "load_filters_2d" if layout == "2d"
                   else f"load_filters_{layout}")
    np.testing.assert_array_equal(load(tout), tr.d.numpy())
    np.testing.assert_array_equal(jio.load_dz(tout, layout), tr.Dz.numpy())
    assert scipy.io.loadmat(tout)["d"].shape == scipy.io.loadmat(jout)["d"].shape


LAYOUTS = {
    "2d": ((4, 5, 5), (3, 12, 10)),
    "hyperspectral": ((4, 3, 5, 5), (2, 3, 12, 10)),
    "3d": ((4, 5, 5, 3), (2, 12, 10, 6)),
    "lightfield": ((4, 2, 3, 5, 5), (2, 2, 3, 12, 10)),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_filter_files_cross_between_the_packages(tmp_path, layout):
    r = np.random.default_rng(31)
    d_shape, dz_shape = LAYOUTS[layout]
    d = r.normal(size=d_shape).astype(np.float32)
    Dz = r.normal(size=dz_shape).astype(np.float32)
    trace = {"obj_vals_z": [3.0, 2.0], "algorithm": "masked_admm"}
    tpath, jpath = str(tmp_path / "t.mat"), str(tmp_path / "j.mat")
    tio.save_filters(tpath, torch.from_numpy(d), trace, layout=layout,
                     Dz=torch.from_numpy(Dz))
    jio.save_filters(jpath, d, trace, layout=layout, Dz=Dz)
    name = "load_filters_2d" if layout == "2d" else f"load_filters_{layout}"
    for path in (tpath, jpath):
        for mod in (tio, jio):  # port file -> JAX loader and the reverse
            np.testing.assert_array_equal(getattr(mod, name)(path), d)
            np.testing.assert_array_equal(mod.load_dz(path, layout), Dz)
    assert tio.infer_layout(d) == jio.infer_layout(d)
    np.testing.assert_array_equal(scipy.io.loadmat(tpath)["d"],
                                  scipy.io.loadmat(jpath)["d"])


@pytest.mark.parametrize("name, flags, item", [
    ("learn_3d", ["--streaming", "--mesh", "2"],
     "does not combine with --mesh"),
    ("learn_3d", ["--stream-mode", "auto", "--outer-chunk", "2"], "item 9"),
    ("learn_3d", ["--mesh", "2", "--stream-mode", "paged"],
     "requires --streaming"),
    ("learn_3d", ["--tune", "auto"], "item 9"),
    ("learn_3d", ["--outer-chunk", "2"], "item 9"),
    ("learn_3d", ["--auto-degrade"], "item 10"),
    ("learn_3d", ["--watchdog"], "item 10"),
    ("learn_4d", ["--mesh", "2", "--streaming"],
     "does not combine with --mesh"),
    ("learn_4d", ["--outer-chunk", "3"], "item 9"),
    ("learn_hyperspectral", ["--streaming", "--auto-degrade"], "item 10"),
    ("learn_hyperspectral", ["--streaming-blocks", "2", "--tune", "auto"],
     "item 9"),
    ("learn_hyperspectral", ["--tune", "sweep"], "item 9"),
    ("learn_hyperspectral", ["--auto-degrade"], "item 10"),
])
def test_refused_flags_name_their_item(name, flags, item):
    _, tapp = _apps(name)
    with pytest.raises(SystemExit, match=item):
        tapp.main(["--synthetic", *flags, "--device", "cpu"])


@pytest.mark.parametrize("name, flags, algorithm", [
    ("learn_3d", [], "consensus"),
    ("learn_4d", ["--streaming"], "consensus_streaming"),
])
def test_metrics_dir_writes_the_stream(tmp_path, name, flags, algorithm):
    """``--metrics-dir``, refused until the port wrote the stream, reaches
    the learner: one run of its algorithm, a step record per step."""
    from ccsc_code_iccv2017_torch.utils import obs

    _, tapp = _apps(name)
    m = str(tmp_path / "m")
    argv, _ = APP_ARGV[name]
    tapp.main(argv + flags + ["--metrics-dir", m, "--device", "cpu",
                              "--verbose", "none",
                              "--out", str(tmp_path / "t.mat")])
    ev = obs.read_events(m)
    assert [e["algorithm"] for e in ev if e["type"] == "run_meta"] == [
        algorithm]
    assert [e["it"] for e in ev if e["type"] == "step"] == [1, 2]
    assert [e["status"] for e in ev if e["type"] == "summary"] == ["ok"]


def test_apps_default_to_the_card():
    for name in APP_ARGV:
        _, tapp = _apps(name)
        assert tapp.build_parser().parse_args(["--synthetic"]).device == "cuda"
        if torch.cuda.is_available():
            continue
        argv, _ = APP_ARGV[name]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tapp.main(argv + ["--verbose", "none", "--out", "/nonexistent"])
