"""The consensus learner (slice 2): the port's ``outer_step``/``learn``
against the JAX package's from the same state, on the CPU.

The same numpy data and the JAX ``init_state`` (torch and jax random
streams differ) go through both packages; the port receives the state
through ``convert.learn_state_from_jax`` and the ``initial_state=``
seam. Tolerances: one outer step within 1e-4 of each state field's
scale and rtol 1e-4 on obj_d/obj_z (float32 FFTs, Cholesky and sums in
another order); the golden trajectory at its own rtol 1e-3
(tests/test_golden.py); fused vs composition at
tests/test_pallas_fused.py's atol 2e-5 / rtol 1e-5; bf16 storage at 1e-2
of the scale (each step rounds the state to 8 mantissa bits, so a 1e-7
difference before rounding can flip one bf16 ulp).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from ccsc_code_iccv2017_tpu.config import LearnConfig as JCfg
from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.models import common as jcommon
from ccsc_code_iccv2017_tpu.models import learn as jlearn
from ccsc_code_iccv2017_tpu.utils import io_mat as jio
from ccsc_code_iccv2017_tpu.utils import resilience as jres
from ccsc_code_iccv2017_torch import convert
from ccsc_code_iccv2017_torch.apps import learn_2d as tapp
from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.models import common as tcommon
from ccsc_code_iccv2017_torch.models import learn as tlearn
from ccsc_code_iccv2017_torch.ops import fused_z as tfz
from ccsc_code_iccv2017_torch.ops import kernels
from ccsc_code_iccv2017_torch.parallel import consensus
from ccsc_code_iccv2017_torch.utils import checkpoint as tckpt
from ccsc_code_iccv2017_torch.utils import resilience as tres

GOLDEN_KW = dict(
    max_it=4, max_it_d=3, max_it_z=3, num_blocks=2,
    rho_d=500.0, rho_z=10.0, lambda_prior=0.5,
    verbose="none", track_objective=True,
)
GEOM = ((5, 5), 6)


def _golden_data():
    return np.random.default_rng(7).normal(size=(4, 16, 16)).astype(
        np.float32
    )


def _jax_init(b, num_blocks=2, storage="float32", seed=42):
    jgeom = JGeom(*GEOM)
    fg = jcommon.FreqGeom.create(jgeom, b.shape[-2:])
    sd = jnp.dtype(storage)
    return jlearn.init_state(
        jax.random.PRNGKey(seed), jgeom, fg, num_blocks,
        b.shape[0] // num_blocks, jnp.float32, z_dtype=sd, d_dtype=sd,
    )


def _fields(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _port_state(jstate):
    return convert.learn_state_from_jax(_fields(jstate), "cpu")


def _as_f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("compat", ["consensus", "block1"])
@pytest.mark.parametrize("fused", [False, True])
def test_one_outer_step_matches_jax(fused, compat):
    b = _golden_data()
    kw = dict(GOLDEN_KW, fused_z=fused, compat_coding=compat)
    jst = _jax_init(b)
    bb = b.reshape(2, 2, 16, 16)
    fg = jcommon.FreqGeom.create(JGeom(*GEOM), (16, 16))
    jnew, jm = jlearn.outer_step(jst, jnp.asarray(bb), JGeom(*GEOM),
                                 JCfg(**kw), fg, 2)
    tfg = tcommon.FreqGeom.create(ProblemGeom(*GEOM), (16, 16))
    tnew, tm = tlearn.outer_step(_port_state(jst), torch.from_numpy(bb),
                                 ProblemGeom(*GEOM), LearnConfig(**kw), tfg, 2)
    port = convert.learn_state_to_numpy(tnew)
    for f in tlearn.LearnState._fields:
        ref = np.asarray(getattr(jnew, f))
        err = float(np.abs(port[f] - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (f, err)
    np.testing.assert_allclose(
        [float(tm.obj_d), float(tm.obj_z)],
        [float(jm.obj_d), float(jm.obj_z)], rtol=1e-4,
    )
    np.testing.assert_allclose(
        [float(tm.d_diff), float(tm.z_diff)],
        [float(jm.d_diff), float(jm.z_diff)], rtol=1e-4,
    )


def _port_learn(b, cfg_kw, jstate, **kw):
    return consensus.learn(
        b, ProblemGeom(*GEOM), LearnConfig(**cfg_kw), device="cpu",
        initial_state=_port_state(jstate), **kw,
    )


@pytest.mark.parametrize("fused", [False, True])
def test_golden_learn_trajectory_through_the_port(fused):
    """tests/test_golden.py::test_golden_learn_2d_trajectory, from the
    JAX init state (jax.random.PRNGKey(42))."""
    b = _golden_data()
    res = _port_learn(b, dict(GOLDEN_KW, fused_z=fused), _jax_init(b))
    np.testing.assert_allclose(
        res.trace["obj_vals_z"],
        [7255.2153, 3005.686, 2262.0251, 1775.2529, 1392.6475], rtol=1e-3,
    )
    np.testing.assert_allclose(
        res.trace["obj_vals_d"],
        [7255.2153, 7065.29, 2975.1284, 2257.9888, 1772.7599], rtol=1e-3,
    )
    np.testing.assert_allclose(float(res.d.abs().sum()), 22.9037, rtol=1e-3)
    assert tuple(res.d.shape) == (6, 5, 5)
    assert tuple(res.Dz.shape) == (4, 16, 16)
    assert tuple(res.z.shape) == (2, 2, 6, 20, 20)


def test_learn_matches_jax_learn():
    b = _golden_data()
    kw = dict(GOLDEN_KW, max_it=2)
    jr = jlearn.learn(jnp.asarray(b), JGeom(*GEOM), JCfg(**kw),
                      key=jax.random.PRNGKey(42))
    tr = _port_learn(b, kw, _jax_init(b))
    for k in ("obj_vals_d", "obj_vals_z"):
        np.testing.assert_allclose(tr.trace[k], jr.trace[k], rtol=1e-4)
    scale = float(np.abs(np.asarray(jr.d)).max())
    assert np.abs(tr.d.numpy() - np.asarray(jr.d)).max() <= 1e-4 * scale
    scale = float(np.abs(np.asarray(jr.Dz)).max())
    assert np.abs(tr.Dz.numpy() - np.asarray(jr.Dz)).max() <= 1e-4 * scale


def test_fused_matches_composition_in_the_port():
    """tests/test_pallas_fused.py::test_learner_fused_z_matches_composition
    on the port: the plain K2 against the FFT + rank-1 composition."""
    rng = np.random.default_rng(4)
    b = rng.standard_normal((4, 12, 12)).astype(np.float32)
    kw = dict(max_it=2, max_it_d=2, max_it_z=2, num_blocks=2,
              rho_d=500.0, rho_z=10.0, lambda_prior=0.5,
              verbose="none", track_objective=True)
    init = _jax_init(b, seed=1)
    before = (kernels.solve_z_rank1.launches, tfz.fused_z_iter.launches_a)
    r_ref = _port_learn(b, kw, init)
    r_fus = _port_learn(b, dict(kw, fused_z=True), init)
    # on the CPU neither path launches a kernel
    assert (kernels.solve_z_rank1.launches,
            tfz.fused_z_iter.launches_a) == before
    np.testing.assert_allclose(r_ref.d.numpy(), r_fus.d.numpy(), atol=2e-5)
    np.testing.assert_allclose(
        r_ref.trace["obj_vals_z"], r_fus.trace["obj_vals_z"], rtol=1e-5
    )


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_storage_matches_jax_bf16(fused):
    b = _golden_data()
    kw = dict(GOLDEN_KW, max_it=1, fused_z=fused, storage_dtype="bfloat16",
              d_storage_dtype="bfloat16")
    jst = _jax_init(b, storage="bfloat16")
    bb = b.reshape(2, 2, 16, 16)
    fg = jcommon.FreqGeom.create(JGeom(*GEOM), (16, 16))
    jnew, jm = jlearn.outer_step(jst, jnp.asarray(bb), JGeom(*GEOM),
                                 JCfg(**kw), fg, 2)
    tfg = tcommon.FreqGeom.create(ProblemGeom(*GEOM), (16, 16))
    tst = _port_state(jst)
    assert tst.z.dtype == torch.bfloat16 and tst.d_local.dtype == torch.bfloat16
    tnew, tm = tlearn.outer_step(tst, torch.from_numpy(bb), ProblemGeom(*GEOM),
                                 LearnConfig(**kw), tfg, 2)
    assert tnew.z.dtype == torch.bfloat16 and tnew.dual_z.dtype == torch.bfloat16
    assert tnew.dbar.dtype == torch.float32
    port = convert.learn_state_to_numpy(tnew)
    for f in tlearn.LearnState._fields:
        ref = _as_f32(getattr(jnew, f))
        err = float(np.abs(port[f] - ref).max())
        assert err <= 1e-2 * float(np.abs(ref).max()), (f, err)
    np.testing.assert_allclose(float(tm.obj_z), float(jm.obj_z), rtol=1e-2)


def test_bf16_state_round_trips_bit_for_bit():
    jst = _jax_init(_golden_data(), storage="bfloat16")
    tst = _port_state(jst)
    for f in ("z", "dual_z", "d_local"):
        ref = np.asarray(getattr(jst, f))
        assert np.array_equal(
            getattr(tst, f).view(torch.int16).numpy(), ref.view(np.int16)
        )


def _poison_step(monkeypatch, at_call):
    """Make the ``at_call``-th outer step (1-based) diverge: its z iterate
    turns NaN, as a blown-up inner solve would."""
    real = tlearn.outer_step
    calls = {"n": 0}

    def step(state, *a, **kw):
        calls["n"] += 1
        new, m = real(state, *a, **kw)
        if calls["n"] == at_call:
            z = torch.full_like(new.z, float("nan"))
            new = new._replace(z=z)
            m = m._replace(obj_z=torch.tensor(float("nan")),
                           z_diff=torch.tensor(float("nan")))
        return new, m

    monkeypatch.setattr(tlearn, "outer_step", step)
    return calls


def test_non_finite_step_keeps_last_good_state(monkeypatch):
    b = _golden_data()
    init = _jax_init(b)
    one = _port_learn(b, dict(GOLDEN_KW, max_it=1), init)
    _poison_step(monkeypatch, at_call=2)
    res = _port_learn(b, GOLDEN_KW, init)
    # stopped at the diverged step 2, with step 1's state
    assert len(res.trace["obj_vals_z"]) == 2
    assert "recoveries" not in res.trace
    assert torch.equal(res.z, one.z) and torch.equal(res.d, one.d)


def test_non_finite_step_backs_off_rho_and_retries(monkeypatch):
    b = _golden_data()
    calls = _poison_step(monkeypatch, at_call=2)
    res = _port_learn(b, dict(GOLDEN_KW, max_recoveries=1, rho_backoff=0.5),
                      _jax_init(b))
    assert calls["n"] == GOLDEN_KW["max_it"] + 1  # one retried step
    assert len(res.trace["obj_vals_z"]) == GOLDEN_KW["max_it"] + 1
    (ev,) = res.trace["recoveries"]
    assert ev["iteration"] == 2 and ev["rho_z"] == 5.0 and ev["rho_d"] == 250.0
    assert all(np.isfinite(res.trace["obj_vals_z"]))


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    b = _golden_data()
    init = _jax_init(b)
    full = _port_learn(b, GOLDEN_KW, init)
    ck = str(tmp_path / "ck")
    _port_learn(b, dict(GOLDEN_KW, max_it=2), init, checkpoint_dir=ck,
                checkpoint_every=1)
    assert os.path.exists(os.path.join(ck, "ccsc_state.npz"))
    resumed = _port_learn(b, GOLDEN_KW, init, checkpoint_dir=ck)
    for k in ("obj_vals_d", "obj_vals_z", "d_diff", "z_diff"):
        np.testing.assert_allclose(resumed.trace[k], full.trace[k],
                                   rtol=1e-6)
    np.testing.assert_allclose(resumed.d.numpy(), full.d.numpy(), atol=1e-7)


def test_checkpoint_refuses_another_problem(tmp_path):
    b = _golden_data()
    ck = str(tmp_path / "ck")
    _port_learn(b, dict(GOLDEN_KW, max_it=1), _jax_init(b), checkpoint_dir=ck)
    with pytest.raises(ValueError, match="different run"):
        _port_learn(b, dict(GOLDEN_KW, lambda_prior=0.25), _jax_init(b),
                    checkpoint_dir=ck)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, storage):
    b = _golden_data()
    kw = dict(GOLDEN_KW, storage_dtype=storage, d_storage_dtype=storage)
    assert tres.config_fingerprint(
        ProblemGeom(*GEOM), LearnConfig(**kw), "consensus"
    ) == jres.config_fingerprint(JGeom(*GEOM), JCfg(**kw), "consensus")
    ck = str(tmp_path / "ck")
    jlearn.learn(jnp.asarray(b), JGeom(*GEOM), JCfg(**dict(kw, max_it=2)),
                 key=jax.random.PRNGKey(42), checkpoint_dir=ck)
    full = jlearn.learn(jnp.asarray(b), JGeom(*GEOM), JCfg(**kw),
                        key=jax.random.PRNGKey(42))
    fields, trace, it = tckpt.load(ck)
    assert it == 2 and fields["z"].dtype == getattr(torch, storage)
    res = consensus.learn(b, ProblemGeom(*GEOM), LearnConfig(**kw),
                          device="cpu", checkpoint_dir=ck)
    rtol = 1e-4 if storage == "float32" else 1e-2
    np.testing.assert_allclose(res.trace["obj_vals_z"],
                               full.trace["obj_vals_z"], rtol=rtol)
    # and the port's checkpoint reads back in the JAX package
    from ccsc_code_iccv2017_tpu.utils import checkpoint as jckpt

    jfields, _, jit = jckpt.load(ck)
    assert jit == GOLDEN_KW["max_it"]
    assert str(jfields["z"].dtype) == storage


def test_fused_z_on_other_geometry_raises():
    """Nothing raises: fused_z on a W > 1 geometry takes the composition
    path, as the JAX gate does (models/learn.py:358-364 there), and
    equals fused_z=False bit for bit."""
    geom = ProblemGeom((5, 5), 4, (3,))
    fg = tcommon.FreqGeom.create(geom, (12, 12))
    st = tlearn.init_state(torch.Generator().manual_seed(0), geom, fg, 1, 2)
    b = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 2, 3, 12, 12)).astype(np.float32))
    out = [tlearn.outer_step(st, b, geom, LearnConfig(
        fused_z=fused, verbose="none", track_objective=True), fg, 1)
        for fused in (True, False)]
    for a, c in zip(out[0][0] + out[0][1], out[1][0] + out[1][1]):
        # OuterMetrics.extras is None without metrics_dir
        assert (a is None and c is None) or torch.equal(a, c)


# the 3D and 4D learners' geometries at a tiny size: (geometry args, data
# [n, *reduce, *spatial], blocks)
ND = {
    "3d": (((3, 3, 3), 3), (4, 6, 6, 5)),
    "4d": (((3, 3), 3, (2, 2)), (4, 2, 2, 8, 8)),
}


def _nd(which, seed=11):
    ga, shape = ND[which]
    b = np.random.default_rng(seed).uniform(0.1, 1.0, shape).astype(
        np.float32)
    jgeom = JGeom(*ga)
    fg = jcommon.FreqGeom.create(jgeom, shape[-jgeom.ndim_spatial:])
    jst = jlearn.init_state(jax.random.PRNGKey(5), jgeom, fg, 2,
                            shape[0] // 2)
    return ga, b, jst


@pytest.mark.parametrize("which", list(ND))
def test_one_outer_step_matches_jax_3d_4d(which):
    ga, b, jst = _nd(which)
    kw = dict(GOLDEN_KW, rho_d=5000.0, rho_z=1.0)
    bb = b.reshape(2, b.shape[0] // 2, *b.shape[1:])
    ns = len(ga[0])
    jfg = jcommon.FreqGeom.create(JGeom(*ga), b.shape[-ns:])
    jnew, jm = jlearn.outer_step(jst, jnp.asarray(bb), JGeom(*ga),
                                 JCfg(**kw), jfg, 2)
    tfg = tcommon.FreqGeom.create(ProblemGeom(*ga), b.shape[-ns:])
    tnew, tm = tlearn.outer_step(_port_state(jst), torch.from_numpy(bb),
                                 ProblemGeom(*ga), LearnConfig(**kw), tfg, 2)
    port = convert.learn_state_to_numpy(tnew)
    for f in tlearn.LearnState._fields:
        ref = np.asarray(getattr(jnew, f))
        err = float(np.abs(port[f] - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (f, err)
    np.testing.assert_allclose(
        [float(tm.obj_d), float(tm.obj_z), float(tm.d_diff),
         float(tm.z_diff)],
        [float(jm.obj_d), float(jm.obj_z), float(jm.d_diff),
         float(jm.z_diff)], rtol=1e-4,
    )


@pytest.mark.parametrize("which", list(ND))
def test_fused_z_on_3d_and_views_equals_composition(which, monkeypatch):
    """fused_z=True on a 3D (W == 1, three spatial axes) and a W > 1
    geometry learns through the composition path: the same learn as
    fused_z=False, and K2's entry point is never called."""
    ga, b, jst = _nd(which, seed=12)

    def no_k2(*a, **kw):
        raise AssertionError("K2 called outside the 2D, W == 1 learner")

    monkeypatch.setattr(tfz, "fused_z_iter", no_k2)
    kw = dict(GOLDEN_KW, max_it=2, rho_d=5000.0, rho_z=1.0)
    runs = [consensus.learn(b, ProblemGeom(*ga),
                            LearnConfig(**kw, fused_z=fused), device="cpu",
                            initial_state=_port_state(jst))
            for fused in (True, False)]
    assert runs[0].trace["obj_vals_z"] == runs[1].trace["obj_vals_z"]
    assert torch.equal(runs[0].d, runs[1].d)
    assert torch.equal(runs[0].z, runs[1].z)


def test_3d_learner_matches_matlab_transcription():
    """tests/test_matlab_anchor_3d.py on the port: the float64 MATLAB
    transcription of 3D/admm_learn_conv3D_large.m against the port's
    learner at ProblemGeom((3,3,3), k), compat_coding='block1', at that
    test's rtol 2e-3."""
    from test_matlab_anchor_3d import _problem, matlab_3d_learner

    b, d0_full, z0, r = _problem()
    N, max_it = 2, 2
    ml_d, ml_z = matlab_3d_learner(b, d0_full, z0, N, r, 1.0, 1.0, max_it,
                                   5, 5)
    H, n, k = b.shape[0], b.shape[-1], d0_full.shape[3]
    ni = n // N
    geom = ProblemGeom((3, 3, 3), k)
    fg = tcommon.FreqGeom.create(geom, (H, H, H))
    d_fw = torch.from_numpy(np.moveaxis(d0_full, -1, 0).astype(np.float32))
    z_fw = torch.from_numpy(np.transpose(z0, (4, 3, 0, 1, 2)).reshape(
        N, ni, k, *fg.spatial_shape).astype(np.float32))
    state = tlearn.LearnState(
        d_local=d_fw.expand(N, *d_fw.shape).contiguous(),
        dual_d=torch.zeros(N, *d_fw.shape), dbar=torch.zeros_like(d_fw),
        udbar=torch.zeros_like(d_fw), z=z_fw, dual_z=torch.zeros_like(z_fw),
    )
    b_blocks = torch.from_numpy(np.transpose(b, (3, 0, 1, 2)).reshape(
        N, ni, H, H, H).astype(np.float32))
    cfg = LearnConfig(
        lambda_residual=1.0, lambda_prior=1.0, max_it=max_it, tol=0.0,
        max_it_d=5, max_it_z=5, rho_d=5000.0, rho_z=1.0, num_blocks=N,
        verbose="none", track_objective=True, compat_coding="block1",
    )
    fw_d, fw_z = [], []
    for _ in range(max_it):
        state, m = tlearn.outer_step(state, b_blocks, geom, cfg, fg, N)
        fw_d.append(float(m.obj_d))
        fw_z.append(float(m.obj_z))
    np.testing.assert_allclose(fw_d, ml_d[1:], rtol=2e-3)
    np.testing.assert_allclose(fw_z, ml_z[1:], rtol=2e-3)
    assert ml_z[-1] < 0.5 * ml_z[0]


def test_init_state_shapes_and_storage():
    geom = ProblemGeom(*GEOM)
    fg = tcommon.FreqGeom.create(geom, (16, 16))
    st = tlearn.init_state(torch.Generator().manual_seed(3), geom, fg, 2, 3,
                           z_dtype=torch.bfloat16)
    jst = _jax_init(np.zeros((6, 16, 16), np.float32), num_blocks=2)
    for f in tlearn.LearnState._fields:
        assert tuple(getattr(st, f).shape) == np.asarray(
            getattr(jst, f)).shape, f
    assert st.z.dtype == torch.bfloat16 and st.d_local.dtype == torch.float32
    assert torch.count_nonzero(st.dual_z) == 0
    # every block starts from the same origin-embedded filters
    assert torch.equal(st.d_local[0], st.d_local[1])
    assert torch.equal(st.d_local[0], st.dbar)


def _fake_mesh(**shape):
    """The attributes the drivers' mesh checks read (they refuse before
    any collective, so no process group is needed)."""
    import types

    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape),
                                 device=torch.device("cpu"))


def test_learn_refuses_unported_arguments():
    b = _golden_data()
    # a mesh whose 'block' axis does not divide num_blocks=2, and one
    # with both 'freq' and 'filter' (JAX's refusals)
    for kw, exc, match in (
        (dict(mesh=_fake_mesh(block=3)), ValueError,
         "not divisible by mesh 'block' axis 3"),
        (dict(mesh=_fake_mesh(block=1, freq=1, filter=1)), ValueError,
         "cannot be combined"),
    ):
        with pytest.raises(exc, match=match):
            consensus.learn(b, ProblemGeom(*GEOM), LearnConfig(**GOLDEN_KW),
                            device="cpu", **kw)


def _write_pngs(path, n=4, side=20):
    from PIL import Image

    rng = np.random.default_rng(0)
    os.makedirs(path, exist_ok=True)
    for i in range(n):
        Image.fromarray(
            (rng.random((side, side)) * 255).astype(np.uint8)
        ).save(os.path.join(path, f"{i}.png"))


def test_cli_learns_and_saves_the_reference_layout(tmp_path):
    data = str(tmp_path / "imgs")
    _write_pngs(data)
    out = str(tmp_path / "f.mat")
    res = tapp.main([
        "--data", data, "--filters", "4", "--support", "5", "--blocks", "2",
        "--max-it", "2", "--max-it-d", "2", "--max-it-z", "2", "--fused-z",
        "--out", out, "--device", "cpu", "--verbose", "none",
    ])
    d = jio.load_filters_2d(out)
    np.testing.assert_array_equal(d, res.d.numpy())
    np.testing.assert_array_equal(jio.load_dz(out), res.Dz.numpy())
    assert scipy.io.loadmat(out)["d"].shape == (5, 5, 4)
    assert len(res.trace["obj_vals_z"]) == 3


@pytest.mark.parametrize(
    "flag, item",
    [(["--mesh", "64"], "needs 64 GPUs"),  # more ranks than GPUs on cuda
     (["--streaming", "--mesh", "2"], "does not combine with --mesh"),
     (["--stream-mode", "auto", "--mesh", "2"], "requires --streaming"),
     # --tune is accepted; the mesh refusals still hold around it
     (["--tune", "auto", "--streaming", "--mesh", "2"],
      "does not combine with --mesh")],
)
def test_cli_refuses_unported_flags(flag, item):
    with pytest.raises(SystemExit, match=item):
        tapp.main(["--data", "x", *flag])


@pytest.mark.parametrize("flag", ["--profile-dir", "--metrics-dir"])
def test_cli_accepts_telemetry_flags(tmp_path, flag):
    """``--profile-dir`` and ``--metrics-dir``, refused until the port
    captured traces and wrote the stream, each leave their files."""
    data = str(tmp_path / "imgs")
    _write_pngs(data)
    out_dir = tmp_path / "out"
    tapp.main([
        "--data", data, "--filters", "4", "--support", "5", "--blocks", "2",
        "--max-it", "2", "--max-it-d", "2", "--max-it-z", "2", "--fused-z",
        "--out", str(tmp_path / "f.mat"), "--device", "cpu",
        "--verbose", "none", flag, str(out_dir),
    ])
    names = os.listdir(out_dir)
    if flag == "--profile-dir":
        assert any(n.endswith(".pt.trace.json") for n in names), names
    else:
        assert names == ["events-p00000.jsonl"]


@pytest.mark.parametrize("flags, why", [
    (["--carry-freq"], "--carry-freq requires --masked"),
    (["--masked", "--fused-z"], "--masked does not combine with --fused-z"),
    (["--masked", "--streaming"],
     "--masked does not combine with --streaming"),
])
def test_cli_masked_refuses_like_jax(tmp_path, flags, why):
    from ccsc_code_iccv2017_tpu.apps import learn_2d as japp

    data = str(tmp_path / "imgs")
    _write_pngs(data, n=2)  # the JAX CLI loads the data first
    for app in (japp, tapp):
        with pytest.raises(SystemExit, match=why):
            app.main(["--data", data, *flags])


@pytest.mark.parametrize("extra", [[], ["--carry-freq"]])
def test_cli_masked_learns_and_matches_jax(tmp_path, monkeypatch, extra):
    """``learn_2d --masked`` routes to the masked learner at
    reduce_shape=() and matches the JAX CLI's ``--masked`` on the same
    arguments, from the JAX init of --seed."""
    from ccsc_code_iccv2017_tpu.apps import learn_2d as japp
    from ccsc_code_iccv2017_torch.models import learn_masked as tlm
    from test_torch_learn_masked import jax_masked_state

    def masked_init(generator, geom, fg, n, z_dtype=torch.float32,
                    init_d=None):
        st = jax_masked_state(n, (geom.spatial_support, geom.num_filters,
                                  ()), fg.spatial_shape,
                              jax.random.PRNGKey(generator.initial_seed()))
        return convert.masked_state_from_jax(_fields(st), generator.device)

    data = str(tmp_path / "imgs")
    _write_pngs(data, n=3)
    argv = ["--data", data, "--filters", "4", "--support", "5",
            "--max-it", "3", "--max-it-d", "3", "--max-it-z", "3",
            "--tol", "0", "--masked", "--seed", "2", "--verbose", "none",
            *extra]
    jr = japp.main(argv + ["--out", str(tmp_path / "j.mat")])
    monkeypatch.setattr(tlm, "init_state", masked_init)
    out = str(tmp_path / "t.mat")
    res = tapp.main(argv + ["--out", out, "--device", "cpu"])
    assert res.trace["algorithm"] == "masked_admm"
    for k in ("obj_vals_d", "obj_vals_z"):
        assert len(res.trace[k]) == len(jr.trace[k])
        np.testing.assert_allclose(res.trace[k], jr.trace[k], rtol=1e-4)
    scale = float(np.abs(np.asarray(jr.d)).max())
    assert np.abs(res.d.numpy() - np.asarray(jr.d)).max() <= 1e-4 * scale
    np.testing.assert_array_equal(jio.load_filters_2d(out), res.d.numpy())
