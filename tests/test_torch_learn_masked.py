"""The masked-boundary learner: the port's ``models.learn_masked``
against the JAX package's, on the CPU.

The same numpy data and the JAX init (drawn as JAX's ``learn_masked``
draws it from its key; torch and jax random streams differ) go through
both packages; the port receives the state through
``convert.masked_state_from_jax`` and the ``initial_state=`` seam.
Tolerances: one outer step within 1e-4 of each state field's scale and
rtol 1e-4 on obj_d/obj_z (float32 FFTs, Cholesky and sums in another
order); a whole run, through its objective rollback, at
tests/test_oracle_masked.py's 5e-4; carry_freq against the re-transform
at tests/test_learn_masked_carry.py's 2e-5; bf16 storage at 1e-2 of the
scale (each step rounds the codes to 8 mantissa bits).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.config import LearnConfig as JCfg
from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.models import common as jcommon
from ccsc_code_iccv2017_tpu.models import learn_masked as jlm
from ccsc_code_iccv2017_tpu.ops import fourier as jfourier
from ccsc_code_iccv2017_torch import convert
from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.models import common as tcommon
from ccsc_code_iccv2017_torch.models import learn_masked as tlm
from ccsc_code_iccv2017_torch.ops import kernels

GEOMS = {"hs": ((3, 3), 3, (2,)), "2d": ((3, 3), 3, ())}
STEP_KW = dict(max_it=2, max_it_d=2, max_it_z=2, lambda_residual=1.0,
               lambda_prior=1.0, verbose="none", track_objective=True)


def _data(geom_args, n=2, side=8, seed=0):
    r = np.random.default_rng(seed)
    b = r.uniform(0.1, 1.0, (n, *geom_args[2], side, side)).astype(
        np.float32)
    sm = r.uniform(0.0, 0.2, b.shape).astype(np.float32)
    return b, sm


def jax_masked_state(n, geom_args, spatial_shape, key=None,
                     storage="float32", init_d=None):
    """The init JAX's learn_masked draws (models/learn_masked.py:635-667
    there) from ``key`` (default PRNGKey(0), as its default) for n
    images over the padded ``spatial_shape``."""
    geom = JGeom(*geom_args)
    key = jax.random.PRNGKey(0) if key is None else key
    kd, kz = jax.random.split(key)
    if init_d is None:
        d0 = jax.random.normal(
            kd, (geom.num_filters, *geom.spatial_support), jnp.float32)
        init_d = jnp.broadcast_to(
            d0.reshape(geom.num_filters, *(1,) * geom.ndim_reduce,
                       *geom.spatial_support), geom.filter_shape)
    d_full = jfourier.circ_embed(jnp.asarray(init_d), spatial_shape)
    z0 = jax.random.normal(
        kz, (n, geom.num_filters, *spatial_shape), jnp.float32
    ).astype(jnp.dtype(storage))
    x_shape = (n, *geom.reduce_shape, *spatial_shape)
    return jlm.MaskedLearnState(
        d_full, jnp.zeros(x_shape, jnp.float32), jnp.zeros_like(d_full),
        z0, jnp.zeros(x_shape, jnp.float32), jnp.zeros_like(z0),
    )


def _jax_init(b, geom_args, key=None, storage="float32"):
    spatial = JGeom(*geom_args).padded_shape(b.shape[-2:])
    return jax_masked_state(b.shape[0], geom_args, spatial, key, storage)


def _fields(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _port_state(jstate):
    return convert.masked_state_from_jax(_fields(jstate), "cpu")


def _padded(b, sm, geom_args):
    geom = JGeom(*geom_args)
    r = geom.psf_radius
    b_pad = np.array(jfourier.pad_spatial(jnp.asarray(b), r))
    M_pad = np.array(jfourier.pad_spatial(jnp.ones_like(jnp.asarray(b)), r))
    smp = np.array(jfourier.pad_spatial(jnp.asarray(sm), r,
                                        mode="symmetric"))
    return b_pad, M_pad, smp


def _close_states(port_state, jstate, tol):
    port = convert.masked_state_to_numpy(port_state)
    for f in tlm.MaskedLearnState._fields:
        ref = np.asarray(getattr(jstate, f)).astype(np.float32)
        err = float(np.abs(port[f] - ref).max())
        assert err <= tol * float(np.abs(ref).max()), (f, err)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("which", ["hs", "2d"])
def test_one_masked_step_matches_jax(which, carry):
    ga = GEOMS[which]
    b, sm = _data(ga)
    b_pad, M_pad, smp = _padded(b, sm, ga)
    kw = dict(STEP_KW, carry_freq=carry)
    jst = _jax_init(b, ga)
    fg = jcommon.FreqGeom.create(JGeom(*ga), b.shape[-2:])
    jnew, *jm = jlm._outer_step(jst, jnp.asarray(b_pad), jnp.asarray(M_pad),
                                jnp.asarray(smp), JGeom(*ga), JCfg(**kw), fg,
                                50.0, 10.0)
    tfg = tcommon.FreqGeom.create(ProblemGeom(*ga), b.shape[-2:])
    tnew, tm = tlm.outer_step(
        _port_state(jst), torch.from_numpy(b_pad), torch.from_numpy(M_pad),
        torch.from_numpy(smp), ProblemGeom(*ga), LearnConfig(**kw), tfg,
        50.0, 10.0,
    )
    _close_states(tnew, jnew, 1e-4)
    np.testing.assert_allclose(
        [float(tm.obj_d), float(tm.obj_z), float(tm.d_diff), float(tm.z_diff)],
        [float(v) for v in jm], rtol=1e-4,
    )


def _run_both(b, sm, ga, kw, key=1, storage="float32", **extra):
    jr = jlm.learn_masked(jnp.asarray(b), JGeom(*ga), JCfg(**kw),
                          smooth_init=jnp.asarray(sm),
                          key=jax.random.PRNGKey(key), **extra)
    tr = tlm.learn_masked(
        b, ProblemGeom(*ga), LearnConfig(**kw), smooth_init=sm, device="cpu",
        initial_state=_port_state(
            _jax_init(b, ga, jax.random.PRNGKey(key), storage)), **extra,
    )
    return jr, tr


# at the default gamma divisors (5000/500) 2/2 inner iterations descend
# too little per pass: the objective regresses and the rollback
# (admm_learn.m:204-213) fires after 4 adopted steps
ROLLBACK_KW = dict(max_it=10, max_it_d=2, max_it_z=2, tol=0.0,
                   verbose="none", track_objective=True)


def test_learn_masked_matches_jax_through_the_rollback():
    ga = GEOMS["hs"]
    b, sm = _data(ga, n=3, side=10, seed=5)
    jr, tr = _run_both(b, sm, ga, ROLLBACK_KW)
    steps = len(jr.trace["obj_vals_z"])
    # the rollback fired (fewer steps than max_it) at the same step
    assert 1 <= steps < ROLLBACK_KW["max_it"]
    assert len(tr.trace["obj_vals_z"]) == steps
    assert tr.trace["rolled_back_at"] == steps + 1
    for k in ("obj_vals_d", "obj_vals_z", "d_diff", "z_diff"):
        np.testing.assert_allclose(tr.trace[k], jr.trace[k], rtol=5e-4)
    for name in ("d", "Dz", "z"):
        ref = np.asarray(getattr(jr, name))
        got = getattr(tr, name).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 5e-4 * np.abs(ref).max(), name


@pytest.mark.parametrize("which", ["hs", "2d"])
def test_learn_masked_matches_jax(which):
    ga = GEOMS[which]
    b, sm = _data(ga, n=2, side=12, seed=3)
    kw = dict(max_it=4, max_it_d=5, max_it_z=5, tol=0.0, verbose="none",
              track_objective=True)
    jr, tr = _run_both(b, sm, ga, kw, gamma_div_d=50.0, gamma_div_z=10.0)
    assert "rolled_back_at" not in tr.trace
    assert len(jr.trace["obj_vals_z"]) == kw["max_it"]
    for k in ("obj_vals_d", "obj_vals_z"):
        np.testing.assert_allclose(tr.trace[k], jr.trace[k], rtol=5e-4)
    ref = np.asarray(jr.d)
    assert np.abs(tr.d.numpy() - ref).max() <= 5e-4 * np.abs(ref).max()


def test_carry_freq_matches_retransform():
    """tests/test_learn_masked_carry.py::test_carry_freq_matches_retransform
    on the port."""
    rng = np.random.default_rng(0)
    b = rng.standard_normal((2, 3, 24, 24)).astype(np.float32)
    geom = ProblemGeom((5, 5), 5, (3,))
    kw = dict(max_it=3, max_it_d=4, max_it_z=4, tol=0.0, verbose="none",
              track_objective=True)
    init = _port_state(_jax_init(b, ((5, 5), 5, (3,))))
    ref = tlm.learn_masked(b, geom, LearnConfig(**kw), device="cpu",
                           initial_state=init)
    car = tlm.learn_masked(b, geom, LearnConfig(**kw, carry_freq=True),
                           device="cpu", initial_state=init)
    np.testing.assert_allclose(car.d.numpy(), ref.d.numpy(), rtol=0,
                               atol=2e-5)
    for k in ("obj_vals_z", "obj_vals_d"):
        np.testing.assert_allclose(car.trace[k], ref.trace[k], rtol=2e-5)


@pytest.mark.parametrize("carry", [False, True])
def test_bf16_storage_matches_jax_bf16(carry):
    ga = GEOMS["hs"]
    b, sm = _data(ga)
    b_pad, M_pad, smp = _padded(b, sm, ga)
    kw = dict(STEP_KW, storage_dtype="bfloat16", carry_freq=carry)
    jst = _jax_init(b, ga, storage="bfloat16")
    fg = jcommon.FreqGeom.create(JGeom(*ga), b.shape[-2:])
    jnew, *jm = jlm._outer_step(jst, jnp.asarray(b_pad), jnp.asarray(M_pad),
                                jnp.asarray(smp), JGeom(*ga), JCfg(**kw), fg,
                                50.0, 10.0)
    tst = _port_state(jst)
    assert tst.z.dtype == torch.bfloat16 and tst.dual_z2.dtype == torch.bfloat16
    tfg = tcommon.FreqGeom.create(ProblemGeom(*ga), b.shape[-2:])
    tnew, tm = tlm.outer_step(
        tst, torch.from_numpy(b_pad), torch.from_numpy(M_pad),
        torch.from_numpy(smp), ProblemGeom(*ga), LearnConfig(**kw), tfg,
        50.0, 10.0,
    )
    assert tnew.z.dtype == torch.bfloat16 and tnew.dual_z2.dtype == torch.bfloat16
    assert tnew.dual_z1.dtype == torch.float32
    _close_states(tnew, jnew, 1e-2)
    np.testing.assert_allclose(float(tm.obj_z), float(jm[1]), rtol=1e-2)


def test_init_state_shapes_and_storage():
    ga = GEOMS["hs"]
    geom = ProblemGeom(*ga)
    fg = tcommon.FreqGeom.create(geom, (8, 8))
    st = tlm.init_state(torch.Generator().manual_seed(2), geom, fg, 2,
                        z_dtype=torch.bfloat16)
    jst = _jax_init(np.zeros((2, 2, 8, 8), np.float32), ga)
    for f in tlm.MaskedLearnState._fields:
        assert tuple(getattr(st, f).shape) == np.asarray(
            getattr(jst, f)).shape, f
    assert st.z.dtype == torch.bfloat16 and st.d_full.dtype == torch.float32
    # one spatial profile replicated across the bands
    assert torch.equal(st.d_full[:, 0], st.d_full[:, 1])
    assert torch.count_nonzero(st.dual_d1) == 0


def _port_learn(b, sm, ga, kw, jstate, **extra):
    return tlm.learn_masked(b, ProblemGeom(*ga), LearnConfig(**kw),
                            smooth_init=sm, device="cpu",
                            initial_state=_port_state(jstate),
                            gamma_div_d=50.0, gamma_div_z=10.0, **extra)


RESUME_KW = dict(max_it=4, max_it_d=3, max_it_z=3, tol=0.0, verbose="none",
                 track_objective=True)


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    ga = GEOMS["hs"]
    b, sm = _data(ga, seed=8)
    init = _jax_init(b, ga)
    full = _port_learn(b, sm, ga, RESUME_KW, init)
    assert len(full.trace["obj_vals_z"]) == RESUME_KW["max_it"]
    ck = str(tmp_path / "ck")
    _port_learn(b, sm, ga, dict(RESUME_KW, max_it=2), init,
                checkpoint_dir=ck, checkpoint_every=1)
    assert os.path.exists(os.path.join(ck, "ccsc_state.npz"))
    resumed = _port_learn(b, sm, ga, RESUME_KW, init, checkpoint_dir=ck)
    for k in ("obj_vals_d", "obj_vals_z", "d_diff", "z_diff"):
        np.testing.assert_allclose(resumed.trace[k], full.trace[k], rtol=1e-6)
    np.testing.assert_allclose(resumed.d.numpy(), full.d.numpy(), atol=1e-7)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, storage):
    ga = GEOMS["hs"]
    b, sm = _data(ga, seed=9)
    kw = dict(RESUME_KW, storage_dtype=storage)
    ck = str(tmp_path / "ck")
    jargs = (jnp.asarray(b), JGeom(*ga))
    jkw = dict(smooth_init=jnp.asarray(sm), key=jax.random.PRNGKey(4),
               gamma_div_d=50.0, gamma_div_z=10.0)
    jlm.learn_masked(*jargs, JCfg(**dict(kw, max_it=2)), checkpoint_dir=ck,
                     **jkw)
    full = jlm.learn_masked(*jargs, JCfg(**kw), **jkw)
    res = tlm.learn_masked(b, ProblemGeom(*ga), LearnConfig(**kw),
                           smooth_init=sm, device="cpu", checkpoint_dir=ck,
                           gamma_div_d=50.0, gamma_div_z=10.0)
    assert res.z.dtype == getattr(torch, storage)
    rtol = 1e-4 if storage == "float32" else 1e-2
    for k in ("obj_vals_d", "obj_vals_z"):
        np.testing.assert_allclose(res.trace[k], full.trace[k], rtol=rtol)
    # and the port's checkpoint reads back in the JAX package
    from ccsc_code_iccv2017_tpu.utils import checkpoint as jckpt

    jfields, _, jit = jckpt.load(ck)
    assert jit == kw["max_it"] and str(jfields["z"].dtype) == storage


def _poison_step(monkeypatch, at_call):
    real = tlm.outer_step
    calls = {"n": 0, "gammas": []}

    def step(state, *a, **kw):
        calls["n"] += 1
        calls["gammas"].append((a[6], a[7]))
        new, m = real(state, *a, **kw)
        if calls["n"] == at_call:
            new = new._replace(z=torch.full_like(new.z, float("nan")))
            m = m._replace(obj_z=torch.tensor(float("nan")),
                           z_diff=torch.tensor(float("nan")))
        return new, m

    monkeypatch.setattr(tlm, "outer_step", step)
    return calls


def test_non_finite_step_keeps_last_good_state(monkeypatch):
    ga = GEOMS["hs"]
    b, sm = _data(ga, seed=8)
    init = _jax_init(b, ga)
    one = _port_learn(b, sm, ga, dict(RESUME_KW, max_it=1), init)
    _poison_step(monkeypatch, at_call=2)
    res = _port_learn(b, sm, ga, RESUME_KW, init)
    assert len(res.trace["obj_vals_z"]) == 1
    assert "recoveries" not in res.trace
    assert torch.equal(res.z, one.z) and torch.equal(res.d, one.d)


def test_non_finite_step_backs_off_gammas_and_retries(monkeypatch):
    ga = GEOMS["hs"]
    b, sm = _data(ga, seed=8)
    calls = _poison_step(monkeypatch, at_call=2)
    res = _port_learn(b, sm, ga,
                      dict(RESUME_KW, max_recoveries=1, rho_backoff=0.5),
                      _jax_init(b, ga))
    assert calls["n"] == RESUME_KW["max_it"] + 1  # one retried step
    assert len(res.trace["obj_vals_z"]) == RESUME_KW["max_it"]
    (ev,) = res.trace["recoveries"]
    assert ev["iteration"] == 2 and ev["rho_scale"] == 0.5
    # the retried step and those after it run at the backed-off divisors
    assert calls["gammas"][:2] == [(50.0, 10.0)] * 2
    assert calls["gammas"][2:] == [(25.0, 5.0)] * 3
    assert all(np.isfinite(res.trace["obj_vals_z"]))


@pytest.mark.parametrize("geom_args, spatial, n, kw", [
    (((11, 11), 100, (31,)), (100, 100), 16, {}),
    (((11, 11), 100, (31,)), (100, 100), 16,
     dict(z_dtype_bytes=2, num_freq_shards=4)),
    (((5, 5), 8, ()), (30, 27), 3, {}),
])
def test_hbm_estimate_equals_jax(geom_args, spatial, n, kw):
    tfg = tcommon.FreqGeom.create(ProblemGeom(*geom_args), spatial,
                                  fft_pad="fast")
    jfg = jcommon.FreqGeom.create(JGeom(*geom_args), spatial, fft_pad="fast")
    assert tlm.hbm_estimate(ProblemGeom(*geom_args), spatial, n, **kw) == \
        jlm.hbm_estimate(JGeom(*geom_args), spatial, n, **kw)
    assert tlm.hbm_estimate(ProblemGeom(*geom_args), spatial, n, fg=tfg,
                            **kw) == \
        jlm.hbm_estimate(JGeom(*geom_args), spatial, n, fg=jfg, **kw)


def test_masked_2d_z_solve_is_k1_plain_on_the_cpu(monkeypatch):
    """At reduce_shape=() the z-solve is K1's entry point (its plain
    version on a CPU tensor); at W > 1 the Woodbury solve."""
    calls = []
    real = kernels.solve_z_rank1

    def spy(*a, **kw):
        calls.append(a[2].shape)
        return real(*a, **kw)

    monkeypatch.setattr(kernels, "solve_z_rank1", spy)
    for which, want in (("2d", 2 * 2), ("hs", 0)):
        calls.clear()
        b, sm = _data(GEOMS[which])
        _port_learn(b, sm, GEOMS[which], dict(STEP_KW),
                    _jax_init(b, GEOMS[which]))
        # max_it outer steps x max_it_z inner iterations
        assert len(calls) == want, which


def test_refusals():
    ga = GEOMS["hs"]
    b, sm = _data(ga)
    import types

    # JAX's refusal: the masked learner shards 'freq' only
    with pytest.raises(ValueError, match="expects a 1-D"):
        tlm.learn_masked(b, ProblemGeom(*ga), LearnConfig(verbose="none"),
                         device="cpu",
                         mesh=types.SimpleNamespace(axis_names=("block",)))
    with pytest.raises(ValueError, match="consensus learner"):
        tlm.learn_masked(b, ProblemGeom(*ga),
                         LearnConfig(verbose="none", compat_coding="block1"),
                         device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tlm.learn_masked(b, ProblemGeom(*ga), LearnConfig(verbose="none"))
