"""The four reconstruction apps of the port (Poisson deconvolution, video
deblurring, hyperspectral demosaicing, lightfield view synthesis): each
``main()`` against the JAX app's ``main()`` on the same argv, the port's
with ``--device cpu``, on tiny banks written with ``scipy.io.savemat``
in each family's MATLAB layout. Supports are non-square and filters
random, so a transposed axis shows as a wrong answer.

Tolerances as in tests/test_torch_reconstruct.py: objective and PSNR
traces rtol 1e-4, reconstructions 1e-4 of the data's scale.
"""
import importlib
import os

import numpy as np
import pytest
import scipy.io
import torch

from ccsc_code_iccv2017_tpu.apps import deblur_video as jdeblur
from ccsc_code_iccv2017_tpu.apps import demosaic_hyperspectral as jdemosaic
from ccsc_code_iccv2017_tpu.apps import poisson_2d as jpoisson
from ccsc_code_iccv2017_tpu.apps import view_synthesis as jview
from ccsc_code_iccv2017_torch.apps import deblur_video as tdeblur
from ccsc_code_iccv2017_torch.apps import demosaic_hyperspectral as tdemosaic
from ccsc_code_iccv2017_torch.apps import poisson_2d as tpoisson
from ccsc_code_iccv2017_torch.apps import view_synthesis as tview
from ccsc_code_iccv2017_torch.ops import kernels

jr = importlib.import_module("ccsc_code_iccv2017_tpu.models.reconstruct")

OBJ_RTOL = 1e-4
REC_TOL = 1e-4


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _bank(tmp_path, name, matlab_shape, seed):
    """A random bank in the MATLAB layout (filter index last), each
    filter unit-norm."""
    r = np.random.default_rng(seed)
    d = r.normal(size=matlab_shape).astype(np.float32)
    axes = tuple(range(d.ndim - 1))
    d /= np.sqrt((d**2).sum(axis=axes, keepdims=True))
    path = tmp_path / name
    scipy.io.savemat(path, {"d": d})
    return str(path)


def _assert_same(tres, jres):
    n = int(jres.trace.num_iters)
    assert int(tres.trace.num_iters) == n
    for name in ("obj_vals", "psnr_vals"):
        np.testing.assert_allclose(
            _np(getattr(tres.trace, name))[: n + 1],
            np.asarray(getattr(jres.trace, name))[: n + 1],
            rtol=OBJ_RTOL, err_msg=name,
        )
    jrec = np.asarray(jres.recon)
    assert _np(tres.recon).shape == jrec.shape
    scale = float(np.abs(jrec).max())
    err = float(np.abs(_np(tres.recon) - jrec).max())
    assert err <= REC_TOL * scale, (err, scale)


def _poisson_argv(tmp_path):
    from PIL import Image

    r = np.random.default_rng(30)
    data = tmp_path / "imgs"
    data.mkdir()
    # images of differing sizes: load_image_list keeps each as it is
    for i, shape in enumerate([(14, 17), (16, 13)]):
        Image.fromarray((r.uniform(size=shape) * 255).astype(np.uint8)).save(
            data / f"{i}.png"
        )
    bank = _bank(tmp_path, "bank2d.mat", (3, 5, 4), 31)
    # lambda_residual 200, not the app's 2e4: the Poisson prox
    # 0.5 (u - t + sqrt((u - t)^2 + 4 t I)) cancels when t =
    # lambda_residual / gamma >> u, and at 2e4 both packages sit ~2e-4
    # of max|b| from each other in float32 after 5 iterations (ROADMAP.md
    # Queue 3); at 200 they agree to ~2e-6
    return ["--data", str(data), "--filters", bank, "--max-it", "5",
            "--tol", "0", "--peak", "60", "--lambda-residual", "200"]


def test_poisson_app_matches_jax_app(tmp_path, monkeypatch, capsys):
    argv = _poisson_argv(tmp_path)
    launches = kernels.solve_z_rank1.launches
    tres = tpoisson.main(argv + ["--device", "cpu"])
    assert kernels.solve_z_rank1.launches == launches  # CPU: no kernel
    tout = capsys.readouterr().out
    jresults = []
    real = jr.reconstruct

    def capture(*a, **kw):
        jresults.append(real(*a, **kw))
        return jresults[-1]

    monkeypatch.setattr(jr, "reconstruct", capture)
    jpsnrs = jpoisson.main(argv)
    jout = capsys.readouterr().out
    assert len(tres) == len(jresults) == 2
    for t, j in zip(tres, jresults):
        assert _np(t.z).shape[1] == 5  # the appended dirac rides along
        assert float(t.recon.min()) >= 0.0
        _assert_same(t, j)
    # the same lines, the PSNRs to rounding
    assert [l.split(":")[0] for l in tout.splitlines()] == [
        l.split(":")[0] for l in jout.splitlines()]
    run = tpoisson.run(tpoisson.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    np.testing.assert_allclose(run.psnr_db, np.mean(jpsnrs), rtol=1e-4)
    assert run.iters == 10


def _deblur_argv(tmp_path):
    # MATLAB [x, y, t, k]: a 3x5x4 support, time last
    bank = _bank(tmp_path, "bank3d.mat", (3, 5, 4, 3), 32)
    return ["--synthetic", "--filters", bank, "--side", "10", "--frames",
            "8", "--max-it", "5", "--tol", "0", "--seed", "3"]


def _demosaic_argv(tmp_path):
    # MATLAB [x, y, w, k]: 5 bands over a 3x4 support
    bank = _bank(tmp_path, "bankhs.mat", (3, 4, 5, 3), 33)
    return ["--synthetic", "--filters", bank, "--max-it", "4", "--tol", "0",
            "--seed", "4"]


def _view_argv(tmp_path):
    # MATLAB [x, y, a1, a2, k]: 3x3 views over a 3x4 support
    bank = _bank(tmp_path, "bank4d.mat", (3, 4, 3, 3, 4), 34)
    return ["--synthetic", "--filters", bank, "--side", "12", "--max-it",
            "4", "--tol", "0", "--seed", "5"]


APPS = {
    "deblur": (tdeblur, jdeblur, _deblur_argv),
    "demosaic": (tdemosaic, jdemosaic, _demosaic_argv),
    "view_synthesis": (tview, jview, _view_argv),
}


@pytest.mark.parametrize("app", sorted(APPS))
def test_app_matches_jax_app(app, tmp_path, capsys):
    tapp, japp, argv_of = APPS[app]
    argv = argv_of(tmp_path)
    launches = kernels.solve_z_rank1.launches
    tres = tapp.main(argv + ["--device", "cpu"])
    assert kernels.solve_z_rank1.launches == launches
    tout = capsys.readouterr().out
    jres = japp.main(argv)
    jout = capsys.readouterr().out
    _assert_same(tres, jres)
    assert _np(tres.z).shape == np.asarray(jres.z).shape
    # the same lines; numbers agree to the printed rounding but for a
    # last-digit flip, so compare the words
    words = lambda out: [w for w in out.split() if not w[0].isdigit()]
    assert words(tout) == words(jout)


def test_demosaic_side_flag_sets_the_synthetic_cube(tmp_path):
    argv = _demosaic_argv(tmp_path) + ["--side", "20", "--device", "cpu",
                                       "--max-it", "2"]
    res = tdemosaic.main(argv)
    assert tuple(res.recon.shape) == (1, 5, 20, 20)


@pytest.mark.parametrize("app", ["poisson"] + sorted(APPS))
def test_app_defaults_to_cuda_and_refuses_unported_flags(app, tmp_path,
                                                        monkeypatch):
    if app == "poisson":
        tapp, argv = tpoisson, _poisson_argv(tmp_path)
    else:
        tapp, _, argv_of = APPS[app]
        argv = argv_of(tmp_path)
    assert tapp.build_parser().parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tapp.main(argv)
    cpu = argv + ["--device", "cpu"]
    # the flags of ROADMAP.md item 9, refused until the port ran them:
    # --tune auto against an empty store (--tune-store sets
    # CCSC_TUNE_STORE) with the float32 matmul-DFT tier
    monkeypatch.delenv("CCSC_TUNE_STORE", raising=False)
    store = str(tmp_path / "t.json")
    assert tapp.main(cpu + ["--tune", "auto", "--tune-store", store,
                            "--fft-impl", "matmul"]) is not None
    assert os.environ["CCSC_TUNE_STORE"] == store


@pytest.mark.parametrize("app", ["poisson"] + sorted(APPS))
def test_app_metrics_dir_writes_its_stream(app, tmp_path):
    """``--metrics-dir``, refused until the port wrote the stream: every
    solve of the app is a "reconstruct" run (the Poisson app solves each
    image on its own), each closing with the iterations it ran."""
    from ccsc_code_iccv2017_torch.utils import obs

    if app == "poisson":
        tapp, argv = tpoisson, _poisson_argv(tmp_path)
    else:
        tapp, _, argv_of = APPS[app]
        argv = argv_of(tmp_path)
    m = str(tmp_path / "m")
    res = tapp.main(argv + ["--device", "cpu", "--metrics-dir", m])
    results = res if isinstance(res, list) else [res]
    ev = obs.read_events(m)
    metas = [e for e in ev if e["type"] == "run_meta"]
    sums = [e for e in ev if e["type"] == "summary"]
    assert [e["algorithm"] for e in metas] == ["reconstruct"] * len(results)
    assert [e["status"] for e in sums] == ["ok"] * len(results)
    assert [e["iterations"] for e in sums] == [
        int(r.trace.num_iters) for r in results]


def test_psf_matches_jax():
    r = np.random.default_rng(35)
    img = r.uniform(size=(9, 7)).astype(np.float32)
    for src in (None, img):
        np.testing.assert_array_equal(tdeblur.build_psf(src),
                                      jdeblur.build_psf(src))


def test_mosaic_fill_and_view_helpers_match_jax():
    r = np.random.default_rng(36)
    for bands in (5, 31):
        np.testing.assert_array_equal(tdemosaic.mosaic_mask(bands, 7, 9),
                                      jdemosaic.mosaic_mask(bands, 7, 9))
    cube = r.uniform(size=(5, 12, 10)).astype(np.float32)
    mask = tdemosaic.mosaic_mask(5, 12, 10)
    np.testing.assert_array_equal(
        tdemosaic.nn_fill_smooth_init(cube * mask, mask),
        jdemosaic.nn_fill_smooth_init(cube * mask, mask),
    )
    vm = tview.border_view_mask((3, 4), (6, 5))
    np.testing.assert_array_equal(vm, jview.border_view_mask((3, 4), (6, 5)))
    lf = r.uniform(size=(3, 4, 6, 5)).astype(np.float32)
    np.testing.assert_array_equal(tview.interp_fill(lf * vm, vm),
                                  jview.interp_fill(lf * vm, vm))


def test_profile_kinds_of_the_demosaic_kernels():
    """profile_solve's by-kind split of a demosaic profile's kernel names
    (as torch.profiler reports them on the card)."""
    from ccsc_code_iccv2017_torch.profile_solve import kernel_kind

    for name, kind in (
        ("void k1_registers<13>(Args)", "K1"),
        ("void regular_fft<256u, EPT<16u>, 8u, 9u>", "cufft"),
        ("void gemv2N_kernel<int, int, float2, float2>", "cublas_cusolver"),
        ("std::enable_if<true, void>::type internal::gemvx::kernel<int>",
         "cublas_cusolver"),
        ("void at::native::elementwise_kernel<128, 2>", "other"),
    ):
        assert kernel_kind(name) == kind, name
