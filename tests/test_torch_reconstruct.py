"""The slice as a whole: the port's ``reconstruct``/``build_plan`` against
the JAX package's on the same numpy inputs, on the CPU.

Tolerances: objective traces rtol 1e-4 and reconstructions 1e-4 of the
data's scale — float32 ADMM iterates whose FFTs and sums run in another
order; the pinned golden numbers keep their own rtol 1e-3
(tests/test_golden.py). bf16 storage is held to 1e-2: each iteration
rounds z and its dual to 8 mantissa bits, so a 1e-7 difference in the
f32 value before rounding can flip one bf16 ulp (3.9e-3 relative).
"""
import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from ccsc_code_iccv2017_tpu.apps import inpaint_2d as japp
from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.config import SolveConfig as JCfg
from ccsc_code_iccv2017_tpu.data import native as jnative
from ccsc_code_iccv2017_tpu.utils import io_mat as jio
from ccsc_code_iccv2017_torch import convert
from ccsc_code_iccv2017_torch.apps import inpaint_2d as tapp
from ccsc_code_iccv2017_torch.config import ProblemGeom, SolveConfig
from ccsc_code_iccv2017_torch.models import reconstruct as tr
from ccsc_code_iccv2017_torch.ops import kernels
from ccsc_code_iccv2017_torch.utils.validate import CCSCInputError

jr = importlib.import_module("ccsc_code_iccv2017_tpu.models.reconstruct")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(REPO, "artifacts_2d", "learned_bank.mat")
OBJ_RTOL = 1e-4
REC_TOL = 1e-4


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _jax_problem(prob):
    kw = dataclasses.asdict(prob)
    kw["geom"] = JGeom(**kw["geom"])
    return jr.ReconstructionProblem(**kw)


def _both(b, d, prob, cfg_kw, **arrays):
    """Solve the same numpy inputs with JAX and with the port (CPU)."""
    jres = jr.reconstruct(
        jnp.asarray(b), jnp.asarray(d), _jax_problem(prob), JCfg(**cfg_kw),
        **{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()},
    )
    tres = tr.reconstruct(b, d, prob, SolveConfig(**cfg_kw), device="cpu",
                          **arrays)
    return jres, tres


def _assert_parity(jres, tres, b, obj_rtol=OBJ_RTOL, rec_tol=REC_TOL):
    n = int(jres.trace.num_iters)
    assert int(tres.trace.num_iters) == n
    for name in ("obj_vals", "psnr_vals"):
        np.testing.assert_allclose(
            _np(getattr(tres.trace, name))[: n + 1],
            np.asarray(getattr(jres.trace, name))[: n + 1],
            rtol=obj_rtol, err_msg=name,
        )
    scale = float(np.abs(b).max())
    err = float(np.abs(_np(tres.recon) - np.asarray(jres.recon)).max())
    assert err <= rec_tol * scale, err
    assert _np(tres.z).shape == np.asarray(jres.z).shape


def _golden_inputs():
    r = np.random.default_rng(11)
    b = r.uniform(0.1, 1.0, (2, 16, 16)).astype(np.float32)
    d = r.normal(size=(4, 5, 5)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    mask = (r.uniform(size=b.shape) > 0.5).astype(np.float32)
    return b, d, mask


GOLDEN_CFG = dict(
    lambda_residual=5.0, lambda_prior=2.0, max_it=5, tol=0.0,
    verbose="none", track_objective=True,
)


def test_golden_inpaint_matches_jax_and_pins():
    b, d, mask = _golden_inputs()
    prob = tr.ReconstructionProblem(ProblemGeom((5, 5), 4))
    jres, tres = _both(b * mask, d, prob, GOLDEN_CFG, mask=mask)
    assert int(tres.trace.num_iters) == 5
    _assert_parity(jres, tres, b)
    np.testing.assert_allclose(
        _np(tres.trace.obj_vals)[:6],
        [253.75302, 253.80643, 253.57663, 252.72368, 250.94093, 248.40901],
        rtol=1e-3,
    )
    np.testing.assert_allclose(float(tres.z.abs().sum()), 4.11126, rtol=1e-3)


def _smooth_inputs(shape=(2, 20, 18), k=6, seed=12):
    r = np.random.default_rng(seed)
    x = r.uniform(0.0, 1.0, shape).astype(np.float32)
    d = r.normal(size=(k, 5, 5)).astype(np.float32)
    d -= d.mean(axis=(1, 2), keepdims=True)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    mask = (r.uniform(size=shape) < 0.5).astype(np.float32)
    sm = jnative.smooth_fill_batch(x, mask)
    return x, d, mask, sm


@pytest.mark.parametrize("fft_pad", ["none", "fast"])
def test_masked_gaussian_smooth_init_psnr_trace(fft_pad):
    x, d, mask, sm = _smooth_inputs()
    prob = tr.ReconstructionProblem(ProblemGeom((5, 5), 6))
    cfg = dict(max_it=40, tol=3e-2, verbose="none", track_objective=True,
               track_psnr=True, fft_pad=fft_pad)
    jres, tres = _both(x * mask, d, prob, cfg, mask=mask, smooth_init=sm,
                       x_orig=x)
    assert 1 < int(jres.trace.num_iters) < 40  # the tol stop engaged
    _assert_parity(jres, tres, x)
    assert float(tres.trace.psnr_vals[1]) > 0


def test_poisson_appended_dirac_grad_reg():
    r = np.random.default_rng(13)
    counts = r.poisson(20.0, size=(2, 16, 16)).astype(np.float32)
    d = r.normal(size=(4, 5, 5)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    mask = (r.uniform(size=counts.shape) < 0.7).astype(np.float32)
    prob = tr.ReconstructionProblem(
        ProblemGeom((5, 5), 4), data_term="poisson", dirac="append",
        grad_reg_dirac=True, sparsify_dirac=False, clamp_nonneg=True,
    )
    cfg = dict(max_it=8, tol=0.0, gamma_factor=20.0, gamma_ratio=5.0,
               verbose="none", track_objective=True)
    jres, tres = _both(counts * mask, d, prob, cfg, mask=mask)
    assert _np(tres.z).shape[1] == 5  # the dirac channel rides along
    _assert_parity(jres, tres, counts)
    assert float(tres.recon.min()) >= 0.0


def test_blur_composition_prepended_dirac():
    x, d, mask, _ = _smooth_inputs(shape=(1, 16, 16), k=4, seed=14)
    psf = np.outer(np.hanning(5), np.hanning(5)).astype(np.float32)
    psf /= psf.sum()
    prob = tr.ReconstructionProblem(ProblemGeom((5, 5), 4), dirac="prepend")
    cfg = dict(max_it=6, tol=0.0, verbose="none", track_objective=True,
               track_psnr=True)
    jres, tres = _both(x * mask, d, prob, cfg, mask=mask, blur_psf=psf,
                       x_orig=x)
    _assert_parity(jres, tres, x)


def test_bfloat16_storage():
    x, d, mask, sm = _smooth_inputs(seed=15)
    prob = tr.ReconstructionProblem(ProblemGeom((5, 5), 6))
    cfg = dict(max_it=6, tol=0.0, verbose="none", track_objective=True,
               storage_dtype="bfloat16")
    jres, tres = _both(x * mask, d, prob, cfg, mask=mask, smooth_init=sm)
    assert tres.z.dtype == torch.float32
    _assert_parity(jres, tres, x, obj_rtol=1e-2, rec_tol=1e-2)


def test_jax_pallas_route_matches_port():
    """JAX with use_pallas=True (interpret-mode rank-1 kernel) and the
    port stop at the same iteration with the same trajectory."""
    x, d, mask, sm = _smooth_inputs(seed=16)
    prob = tr.ReconstructionProblem(ProblemGeom((5, 5), 6))
    cfg = dict(max_it=40, tol=3e-2, verbose="none", track_objective=True,
               use_pallas=True)
    jres, tres = _both(x * mask, d, prob, cfg, mask=mask, smooth_init=sm)
    assert 1 < int(jres.trace.num_iters) < 40
    _assert_parity(jres, tres, x)


def test_track_diagnostics_matches_jax():
    b, d, mask = _golden_inputs()
    prob = tr.ReconstructionProblem(ProblemGeom((5, 5), 4))
    cfg = dict(GOLDEN_CFG, track_diagnostics=True)
    jres, tres = _both(b * mask, d, prob, cfg, mask=mask)
    je, te = jres.trace.extras, tres.trace.extras
    np.testing.assert_allclose(float(te.obj_fid), float(je.obj_fid), rtol=OBJ_RTOL)
    np.testing.assert_allclose(float(te.obj_l1), float(je.obj_l1), rtol=OBJ_RTOL)
    assert int(te.nonfinite) == int(je.nonfinite) == 0
    assert tr.reconstruct(
        b * mask, d, prob, SolveConfig(**GOLDEN_CFG), mask=mask, device="cpu"
    ).trace.extras is None


def test_real_bank_k100():
    d = jio.load_filters_2d(BANK)
    r = np.random.default_rng(17)
    x = r.uniform(0.0, 1.0, (1, 24, 24)).astype(np.float32)
    mask = (r.uniform(size=x.shape) < 0.5).astype(np.float32)
    sm = jnative.smooth_fill_batch(x, mask)
    prob = tr.ReconstructionProblem(ProblemGeom((11, 11), 100))
    cfg = dict(max_it=3, tol=0.0, verbose="none", track_objective=True,
               track_psnr=True)
    jres, tres = _both(x * mask, d, prob, cfg, mask=mask, smooth_init=sm,
                       x_orig=x)
    _assert_parity(jres, tres, x)


def _plan_case():
    x, d, mask, sm = _smooth_inputs(seed=18)
    prob = tr.ReconstructionProblem(ProblemGeom((5, 5), 6))
    cfg = SolveConfig(max_it=5, tol=0.0, verbose="none",
                      track_objective=True)
    return x, d, mask, sm, prob, cfg


def test_plan_equals_inline():
    x, d, mask, sm, prob, cfg = _plan_case()
    plan = tr.build_plan(d, prob, cfg, x.shape[1:], device="cpu")
    kw = dict(mask=mask, smooth_init=sm, device="cpu")
    inline = tr.reconstruct(x * mask, d, prob, cfg, **kw)
    planned = tr.reconstruct(x * mask, d, prob, cfg, plan=plan, **kw)
    assert torch.equal(inline.z, planned.z)
    assert torch.equal(inline.recon, planned.recon)
    assert torch.equal(inline.trace.obj_vals, planned.trace.obj_vals)


def test_bank_digest_matches_jax():
    x, d, *_ = _plan_case()
    assert tr._bank_digest(d) == jr._bank_digest(d)
    assert tr._bank_digest(torch.from_numpy(d)) == jr._bank_digest(jnp.asarray(d))
    bank = jio.load_filters_2d(BANK)
    assert tr._bank_digest(bank) == jr._bank_digest(jnp.asarray(bank))


def test_plan_from_jax_solves_like_the_port_plan():
    x, d, mask, sm, prob, cfg = _plan_case()
    jplan = jr.build_plan(jnp.asarray(d), _jax_problem(prob),
                          JCfg(**dataclasses.asdict(cfg)), x.shape[1:])
    arrays = {
        "dhat_clean": np.asarray(jplan.dhat_clean),
        "dhat_solve": np.asarray(jplan.dhat_solve),
        "kern.dhat": np.asarray(jplan.kern.dhat),
        "kern.dinv": np.asarray(jplan.kern.dinv),
        "kern.minv_diag": np.asarray(jplan.kern.minv_diag),
    }
    meta = {
        "prob": dataclasses.asdict(jplan.prob), "fg": jplan.fg._asdict(),
        "rho": jplan.rho, "has_blur": jplan.has_blur,
        "d_digest": jplan.d_digest, "lambda_smooth": jplan.lambda_smooth,
        "herm_inv": jplan.herm_inv,
    }
    carried = convert.plan_from_jax(arrays, meta, device="cpu")
    own = tr.build_plan(
        convert.bank_from_numpy(d, device="cpu"), prob, cfg, x.shape[1:],
        device="cpu",
    )
    assert carried.prob == own.prob and carried.fg == own.fg
    assert carried.d_digest == own.d_digest
    kw = dict(mask=mask, smooth_init=sm, device="cpu")
    a = tr.reconstruct(x * mask, d, prob, cfg, plan=carried, **kw)
    b = tr.reconstruct(x * mask, d, prob, cfg, plan=own, **kw)
    scale = float(np.abs(x).max())
    assert float((a.recon - b.recon).abs().max()) <= 1e-6 * scale
    np.testing.assert_allclose(_np(a.trace.obj_vals), _np(b.trace.obj_vals),
                               rtol=1e-6)
    with pytest.raises(KeyError):
        convert.plan_from_jax({}, meta, device="cpu")


def _refusal_cases():
    geom = ProblemGeom((5, 5), 6)
    base = tr.ReconstructionProblem(geom)
    return [
        ("blur", dict(call=dict(blur_psf=np.ones((5, 5), np.float32))), "blur OTF"),
        ("prob", dict(call_prob=tr.ReconstructionProblem(geom, clamp_nonneg=True)), "plan mismatch"),
        ("shape", dict(build_spatial=(18, 18)), "plan mismatch"),
        ("fft_pad", dict(call_cfg=dict(fft_pad="pow2")), "plan mismatch"),
        ("rho", dict(call_cfg=dict(gamma_ratio=50.0)), "plan mismatch"),
        ("herm_inv", dict(call_cfg=dict(herm_inv="cholesky")), "plan mismatch"),
        ("bank", dict(call_bank_scale=2.0), "different dictionary"),
        ("filters", dict(call_bank_k=5), "filter"),
        ("device", dict(build_device="meta"), None),
        ("mesh", dict(call=dict(mesh=object())), "plan does not combine"),
    ], base


@pytest.mark.parametrize("case", range(10))
def test_plan_mismatch_refusals(case):
    cases, prob = _refusal_cases()
    name, spec, match = cases[case]
    x, d, mask, sm, _, cfg = _plan_case()
    build_spatial = spec.get("build_spatial", x.shape[1:])
    plan = tr.build_plan(d, prob, cfg, build_spatial, device="cpu")
    if name == "device":
        plan = dataclasses.replace(
            plan, dhat_clean=plan.dhat_clean.to("meta")
        )
        match = "plan lives on"
    call_cfg = dataclasses.replace(cfg, **spec.get("call_cfg", {}))
    call_prob = spec.get("call_prob", prob)
    dd = d * spec.get("call_bank_scale", 1.0)
    if "call_bank_k" in spec:
        dd = dd[: spec["call_bank_k"]]
        call_prob = tr.ReconstructionProblem(ProblemGeom((5, 5), spec["call_bank_k"]))
        plan = dataclasses.replace(plan, prob=call_prob)
    with pytest.raises(ValueError, match=match):
        tr.reconstruct(
            x * mask, dd, call_prob, call_cfg, mask=mask, plan=plan,
            device="cpu", **spec.get("call", {}),
        )


def test_grad_reg_plan_refuses_other_lambda_smooth():
    r = np.random.default_rng(19)
    b = r.poisson(10.0, size=(1, 12, 12)).astype(np.float32)
    d = r.normal(size=(3, 5, 5)).astype(np.float32)
    prob = tr.ReconstructionProblem(
        ProblemGeom((5, 5), 3), data_term="poisson", dirac="append",
        grad_reg_dirac=True,
    )
    cfg = SolveConfig(max_it=2, verbose="none")
    plan = tr.build_plan(d, prob, cfg, (12, 12), device="cpu")
    tr.reconstruct(b, d, prob, cfg, plan=plan, device="cpu")
    with pytest.raises(ValueError, match="plan mismatch"):
        tr.reconstruct(b, d, prob, dataclasses.replace(cfg, lambda_smooth=1.0),
                       plan=plan, device="cpu")


def test_input_refusals():
    b, d, mask = _golden_inputs()
    prob = tr.ReconstructionProblem(ProblemGeom((5, 5), 4))
    cfg = SolveConfig(**GOLDEN_CFG)
    bad = b.copy()
    bad[0, 0, 0] = np.nan
    with pytest.raises(CCSCInputError, match="non-finite"):
        tr.reconstruct(bad, d, prob, cfg, device="cpu")
    with pytest.raises(CCSCInputError, match="identically zero"):
        tr.reconstruct(b, d, prob, cfg, mask=np.zeros_like(b), device="cpu")
    with pytest.raises(CCSCInputError, match="non-numeric"):
        tr.reconstruct(b.astype(str), d, prob, cfg, device="cpu")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    b, d, mask = _golden_inputs()
    prob = tr.ReconstructionProblem(ProblemGeom((5, 5), 4))
    cfg = SolveConfig(**GOLDEN_CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.reconstruct(b * mask, d, prob, cfg, mask=mask)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.build_plan(d, prob, cfg, b.shape[1:])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.bank_from_numpy(d)


def test_inpaint_app_matches_jax_app(tmp_path, capsys):
    from PIL import Image

    r = np.random.default_rng(20)
    data = tmp_path / "imgs"
    data.mkdir()
    for i in range(2):
        Image.fromarray((r.uniform(size=(18, 18)) * 255).astype(np.uint8)).save(
            data / f"{i}.png"
        )
    d = r.normal(size=(4, 5, 5)).astype(np.float32)
    bank = tmp_path / "bank.mat"
    scipy.io.savemat(bank, {"d": np.transpose(d, (1, 2, 0))})
    argv = ["--data", str(data), "--filters", str(bank), "--max-it", "4",
            "--tol", "0"]
    launches = kernels.solve_z_rank1.launches
    tres = tapp.main(argv + ["--device", "cpu", "--out-dir", str(tmp_path / "out")])
    assert kernels.solve_z_rank1.launches == launches  # CPU: no kernel
    jres = japp.main(argv)
    np.testing.assert_allclose(
        _np(tres.trace.psnr_vals)[:5], np.asarray(jres.trace.psnr_vals)[:5],
        rtol=OBJ_RTOL,
    )
    assert float(np.abs(_np(tres.recon) - np.asarray(jres.recon)).max()) <= REC_TOL
    assert (tmp_path / "out" / "recon_1.png").exists()
    assert "2 images, 4 iterations" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="item 9"):
        tapp.main(argv + ["--device", "cpu", "--tune", "auto"])


def _reduce_case(reduce_shape, support, k, spatial, seed):
    """Random data with a mosaic-like mask (each pixel observes one
    reduce entry) and a smooth offset, on a non-square support."""
    r = np.random.default_rng(seed)
    W = int(np.prod(reduce_shape))
    b = r.uniform(0.1, 1.0, (1, *reduce_shape, *spatial)).astype(np.float32)
    d = r.normal(size=(k, *reduce_shape, *support)).astype(np.float32)
    d /= np.sqrt((d**2).reshape(k, -1).sum(1)).reshape(k, *(1,) * (d.ndim - 1))
    pick = r.integers(0, W, spatial)
    mask = (np.arange(W).reshape(*reduce_shape, 1, 1) == pick).astype(
        np.float32)[None]
    sm = np.full_like(b, float(b.mean()))
    return b, d, mask, sm


@pytest.mark.parametrize(
    "reduce_shape, support, k, spatial",
    [
        ((2,), (3, 4), 3, (10, 9)),  # demosaic: bands
        ((2, 3), (3, 4), 4, (9, 11)),  # view synthesis: 2x3 views
    ],
    ids=["demosaic", "view_synthesis"],
)
def test_reduce_unpadded_smooth_init_matches_jax(reduce_shape, support, k,
                                                 spatial):
    """W > 1 (the Woodbury z-solve) with pad=False and a smooth offset:
    the demosaic / view-synthesis configuration
    (tests/test_oracle_reconstruct.py::test_demosaic_reduce_unpadded_matches_oracle)."""
    b, d, mask, sm = _reduce_case(reduce_shape, support, k, spatial, 40)
    prob = tr.ReconstructionProblem(
        ProblemGeom(support, k, reduce_shape), pad=False)
    cfg = dict(lambda_residual=100.0, lambda_prior=1.0, max_it=4, tol=0.0,
               verbose="none", track_objective=True, track_psnr=True)
    jres, tres = _both(b * mask, d, prob, cfg, mask=mask, smooth_init=sm,
                       x_orig=b)
    _assert_parity(jres, tres, b)
    assert tres.recon.shape == (1, *reduce_shape, *spatial)
    assert tuple(tres.z.shape) == (1, k, *spatial)  # unpadded codes


def test_3d_deblur_prepended_dirac_matches_jax():
    """3D spatial support, a prepended dirac and a blur PSF composed into
    the solve (tests/test_matlab_anchor_deblur.py's configuration), on a
    non-cubic clip."""
    r = np.random.default_rng(41)
    x = r.uniform(0.1, 1.0, (1, 7, 6, 5)).astype(np.float32)
    mask = (r.uniform(size=x.shape) > 0.3).astype(np.float32)
    d = r.normal(size=(2, 3, 3, 3)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2, 3), keepdims=True))
    psf = r.uniform(0.1, 1.0, (3, 3, 3)).astype(np.float32)
    psf /= psf.sum()
    sm = r.uniform(0.2, 0.4, x.shape).astype(np.float32)
    prob = tr.ReconstructionProblem(ProblemGeom((3, 3, 3), 2),
                                    dirac="prepend")
    cfg = dict(lambda_residual=100.0, lambda_prior=0.5, max_it=4, tol=0.0,
               gamma_factor=500.0, gamma_ratio=1.0, verbose="none",
               track_objective=True, track_psnr=True)
    jres, tres = _both(x * mask, d, prob, cfg, mask=mask, smooth_init=sm,
                       blur_psf=psf, x_orig=x)
    _assert_parity(jres, tres, x)
    assert tuple(tres.z.shape) == (1, 3, 9, 8, 7)  # dirac first, padded
    dd = tr._add_dirac(torch.from_numpy(d), prob.geom, "prepend")
    jd = np.asarray(jr._add_dirac(jnp.asarray(d), _jax_problem(prob).geom,
                                  "prepend"))
    np.testing.assert_array_equal(dd.numpy(), jd)


def test_w_gt_1_plan_from_jax_solves_like_the_port_plan():
    """A JAX W > 1 plan carries its Woodbury inverse across
    (``kern.minv``) and solves like the port's own plan."""
    b, d, mask, sm = _reduce_case((3,), (3, 4), 4, (9, 10), 42)
    prob = tr.ReconstructionProblem(ProblemGeom((3, 4), 4, (3,)), pad=False)
    cfg = SolveConfig(lambda_residual=100.0, max_it=4, tol=0.0,
                      verbose="none", track_objective=True)
    jplan = jr.build_plan(jnp.asarray(d), _jax_problem(prob),
                          JCfg(**dataclasses.asdict(cfg)), b.shape[2:])
    assert jplan.kern.minv is not None and jplan.kern.minv_diag is None
    arrays = {
        "dhat_clean": np.asarray(jplan.dhat_clean),
        "dhat_solve": np.asarray(jplan.dhat_solve),
        "kern.dhat": np.asarray(jplan.kern.dhat),
        "kern.dinv": np.asarray(jplan.kern.dinv),
        "kern.minv": np.asarray(jplan.kern.minv),
        "kern.minv_diag": None,
    }
    meta = {
        "prob": dataclasses.asdict(jplan.prob), "fg": jplan.fg._asdict(),
        "rho": jplan.rho, "has_blur": jplan.has_blur,
        "d_digest": jplan.d_digest, "lambda_smooth": jplan.lambda_smooth,
        "herm_inv": jplan.herm_inv,
    }
    carried = convert.plan_from_jax(arrays, meta, device="cpu")
    own = tr.build_plan(d, prob, cfg, b.shape[2:], device="cpu")
    assert carried.prob == own.prob and carried.fg == own.fg
    assert tuple(carried.kern.minv.shape) == (own.fg.num_freq, 3, 3)
    kw = dict(mask=mask, smooth_init=sm, device="cpu")
    a = tr.reconstruct(b * mask, d, prob, cfg, plan=carried, **kw)
    c = tr.reconstruct(b * mask, d, prob, cfg, plan=own, **kw)
    assert float((a.recon - c.recon).abs().max()) <= 1e-6 * float(b.max())
    np.testing.assert_allclose(_np(a.trace.obj_vals), _np(c.trace.obj_vals),
                               rtol=1e-6)
    # exactly one inner factor, of the plan's own shape
    with pytest.raises(KeyError):
        convert.plan_from_jax(dict(arrays, **{"kern.minv_diag": np.ones(3)}),
                              meta, device="cpu")
    bad = dict(arrays, **{"kern.minv": arrays["kern.minv"][:, :2, :2]})
    with pytest.raises(ValueError, match="do not form a plan"):
        convert.plan_from_jax(bad, meta, device="cpu")
