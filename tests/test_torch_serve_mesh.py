"""Mesh serving in the port (``ccsc_code_iccv2017_torch.serve`` with
``ServeConfig.mesh_shape``): one ``CodecEngine`` drives every position
of a (batch[, 'freq']) mesh from its own process, one thread per
position (``parallel.local_mesh.LocalMesh``). Here every position is the
CPU; the JAX reference engine runs its mesh on the conftest's 8 forced
host devices. The engine-level contract of tests/test_serve_mesh.py
(:126-398), held on the same seeded inputs:

- port mesh engine vs JAX mesh engine, (2,), (2, 2) and (4, 2): recon
  within REC_TOL of max|ref|, obj/PSNR traces within TRACE_RTOL, the
  same stop (tests/test_torch_serve.py's tolerances);
- port mesh engine vs port single-device engine: bitwise where every
  position keeps >= 2 slots, as JAX asserts. Bitwise holds on the 'freq'
  axis too: K1's plain version sums and multiplies each bin alone
  (ops/kernels.py), so F / nf bins give the whole spectrum's bits. With
  a lone slot a position's slot-wise solve runs FFTs of batch 1 where the
  single-device engine runs batch 2; those are held to SLOT_TOL;
- all-gathers: 0 a dispatch on a batch mesh, one an iteration on every
  position of a freq mesh;
- refusals with JAX's messages (ServeConfig, build_plan,
  reconstruct(plan=, mesh=)), STRICT and its =0 fallback, the env knob
  and the () sentinel, a failing position failing its whole dispatch,
  a barrier that times out naming its position, the bench's mesh arm;
- a W > 1 bucket (hyperspectral geometry, W=3) through the engine on one
  device and on a (2,) mesh against the JAX engine.
"""
import importlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu import config as jcfg
from ccsc_code_iccv2017_tpu.serve import CodecEngine as JEngine
from ccsc_code_iccv2017_tpu.serve import engine as jengine
from ccsc_code_iccv2017_torch import serve
from ccsc_code_iccv2017_torch.config import ProblemGeom, ServeConfig, SolveConfig
from ccsc_code_iccv2017_torch.models import reconstruct as tr
from ccsc_code_iccv2017_torch.parallel import mesh as mesh_lib
from ccsc_code_iccv2017_torch.parallel.local_mesh import (
    LocalMesh,
    MeshBarrierError,
)
from ccsc_code_iccv2017_torch.serve import bench
from ccsc_code_iccv2017_torch.serve import engine as tengine
from ccsc_code_iccv2017_torch.utils.validate import CCSCInputError

jr = importlib.import_module("ccsc_code_iccv2017_tpu.models.reconstruct")

REC_TOL = 1e-4
TRACE_RTOL = 1e-4
SLOT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    for v in ("CCSC_SERVE_MESH", "CCSC_SERVE_MESH_STRICT"):
        monkeypatch.delenv(v, raising=False)


def _bank(k=6, s=5, seed=0, bands=None):
    r = np.random.default_rng(seed)
    shape = (k, s, s) if bands is None else (k, bands, s, s)
    d = r.normal(size=shape).astype(np.float32)
    axes = tuple(range(1, d.ndim))
    d /= np.sqrt((d**2).sum(axis=axes, keepdims=True))
    return d


def _cfg_kw(**kw):
    base = dict(
        lambda_residual=5.0, lambda_prior=0.3, max_it=8, tol=1e-4,
        verbose="none", track_objective=True, track_psnr=True,
    )
    base.update(kw)
    return base


def _req(size, seed=1, keep=0.5, bands=None):
    r = np.random.default_rng(seed)
    shape = (size, size) if bands is None else (bands, size, size)
    x = r.random(shape).astype(np.float32)
    m = (r.random(shape) < keep).astype(np.float32)
    return x, m


def _geom(d):
    if d.ndim == 3:
        return ProblemGeom(d.shape[1:], d.shape[0])
    return ProblemGeom(d.shape[2:], d.shape[0], (d.shape[1],))


def _prob(d):
    return tr.ReconstructionProblem(_geom(d))


def _engine(d, cfg_kw, buckets, **kw):
    scfg = ServeConfig(buckets=buckets, max_wait_ms=kw.pop("max_wait_ms",
                                                           10_000.0),
                       verbose="none", **kw)
    return serve.CodecEngine(d, _prob(d), SolveConfig(**cfg_kw), scfg,
                             device="cpu")


def _jax_engine(d, cfg_kw, buckets, **kw):
    g = _geom(d)
    geom = jcfg.ProblemGeom(g.spatial_support, g.num_filters, g.reduce_shape)
    return JEngine(
        jnp.asarray(d), jr.ReconstructionProblem(geom),
        jcfg.SolveConfig(**cfg_kw),
        jcfg.ServeConfig(buckets=buckets, max_wait_ms=10_000.0,
                         verbose="none", **kw),
    )


def _serve_all(eng, reqs):
    futs = [eng.submit(x * m, mask=m, x_orig=x) for x, m in reqs]
    return [f.result(timeout=300) for f in futs]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-9)


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.recon, w.recon)
        for name in ("obj_vals", "psnr_vals", "diff_vals"):
            np.testing.assert_array_equal(getattr(g.trace, name),
                                          getattr(w.trace, name))
        assert int(g.trace.num_iters) == int(w.trace.num_iters)


def _assert_close_to_jax(got, want):
    for g, w in zip(got, want):
        n = int(w.trace.num_iters)
        assert int(g.trace.num_iters) == n
        assert _rel(g.recon, np.asarray(w.recon)) <= REC_TOL
        for name in ("obj_vals", "psnr_vals"):
            np.testing.assert_allclose(
                getattr(g.trace, name)[: n + 1],
                np.asarray(getattr(w.trace, name))[: n + 1],
                rtol=TRACE_RTOL, err_msg=name,
            )


# ------------------------------------------------------- exact parity


@pytest.mark.parametrize("mesh_shape", [(2,), (2, 2), (4, 2)])
def test_mesh_engine_matches_jax_mesh_engine_and_single_device(mesh_shape):
    """The contract of tests/test_serve_mesh.py:126: a bucket at >= 2
    slots a position, served from the mesh: bitwise the port's
    single-device engine (recon, every trace, the stop), within the
    serve tolerances of the JAX mesh engine on the same inputs; every
    position of a freq group runs the same iterations and one
    all-gather each."""
    d = _bank()
    cfg_kw = _cfg_kw()
    slots = 2 * mesh_shape[0]
    buckets = ((slots, (24, 24)),)
    reqs = [_req(24, seed=100 + i) for i in range(slots)]
    with _engine(d, cfg_kw, buckets, mesh_shape=()) as ref_eng:
        ref = _serve_all(ref_eng, reqs)
        assert ref_eng.devices == 1 and ref_eng.mesh_shape is None
    with _engine(d, cfg_kw, buckets, mesh_shape=mesh_shape) as eng:
        assert eng.devices == int(np.prod(mesh_shape))
        assert eng.mesh_shape == mesh_shape
        got = _serve_all(eng, reqs)
        log = eng.dispatch_log
    _assert_bitwise(got, ref)
    jeng = _jax_engine(d, cfg_kw, buckets, mesh_shape=mesh_shape)
    try:
        assert jeng.devices == eng.devices
        want = _serve_all(jeng, reqs)
    finally:
        jeng.close()
    _assert_close_to_jax(got, want)
    assert len(log) == 1
    entry = log[0]
    assert len(entry["position_iters"]) == eng.devices
    assert entry["iters"] == max(entry["position_iters"])
    if len(mesh_shape) == 2:
        # a freq group's positions hold one spectrum: one stop
        nf = mesh_shape[1]
        it = entry["position_iters"]
        for g in range(mesh_shape[0]):
            assert len(set(it[g * nf:(g + 1) * nf])) == 1, it
        assert entry["gathers"] == entry["position_iters"]
    else:
        assert entry["gathers"] == [0] * eng.devices


@pytest.mark.parametrize("mesh_shape", [(2,), (2, 2)])
def test_lone_slot_positions_hold_slot_tolerance(mesh_shape):
    """slots == batch axis leaves one slot a position: its slot-wise
    solve runs batch-1 FFTs where the single-device engine runs batch 2,
    which may round differently (JAX's batch-1 specialization, the same
    caveat in tests/test_serve_mesh.py:130). Held to SLOT_TOL and the
    same stop."""
    d = _bank()
    cfg_kw = _cfg_kw(max_it=12)
    buckets = ((2, (24, 24)),)
    reqs = [_req(24, seed=7 + i, keep=0.4 + 0.3 * i) for i in range(2)]
    with _engine(d, cfg_kw, buckets, mesh_shape=()) as ref_eng:
        ref = _serve_all(ref_eng, reqs)
    with _engine(d, cfg_kw, buckets, mesh_shape=mesh_shape) as eng:
        got = _serve_all(eng, reqs)
    for g, w in zip(got, ref):
        assert int(g.trace.num_iters) == int(w.trace.num_iters)
        assert _rel(g.recon, w.recon) <= SLOT_TOL
        np.testing.assert_allclose(g.trace.obj_vals, w.trace.obj_vals,
                                   rtol=SLOT_TOL)


def test_mesh_filler_positions_and_part_full_dispatch():
    """One request in a 4-slot bucket on (2, 2): the second batch group
    holds only filler slots (one iteration), the first runs the request;
    the result is bitwise the single-device engine's."""
    d = _bank()
    cfg_kw = _cfg_kw(max_it=10)
    buckets = ((4, (24, 24)),)
    reqs = [_req(24, seed=21)]
    with _engine(d, cfg_kw, buckets, mesh_shape=(),
                 max_wait_ms=20.0) as ref_eng:
        ref = _serve_all(ref_eng, reqs)
    with _engine(d, cfg_kw, buckets, mesh_shape=(2, 2),
                 max_wait_ms=20.0) as eng:
        got = _serve_all(eng, reqs)
        entry = eng.dispatch_log[0]
    _assert_bitwise(got, ref)
    n = int(ref[0].trace.num_iters)
    assert entry["position_iters"] == [n, n, 1, 1]
    assert entry["gathers"] == [n, n, 1, 1]


@pytest.mark.parametrize("mesh_shape", [(2,), (2, 2)])
def test_mesh_padded_bucket_matches_exact_shape_on_valid_region(mesh_shape):
    """tests/test_serve_mesh.py:173: a request smaller than its bucket
    on a mesh engine matches the exact-shape direct solve on its valid
    region to boundary tolerance."""
    d = _bank()
    cfg_kw = _cfg_kw(max_it=20)
    x, m = _req(26, seed=3)
    with _engine(d, cfg_kw, ((4, (32, 32)),), mesh_shape=mesh_shape,
                 max_wait_ms=10.0) as eng:
        res = eng.reconstruct(x * m, mask=m)
    assert res.bucket == "4@32x32"
    assert res.recon.shape == (26, 26)
    ref = tr.reconstruct((x * m)[None], d, _prob(d), SolveConfig(**cfg_kw),
                         mask=m[None], device="cpu").recon[0].numpy()
    assert _rel(res.recon, ref) < 0.05


def test_mesh_return_codes_and_diagnostics_assemble_in_slot_order():
    d = _bank()
    cfg_kw = _cfg_kw(max_it=5, track_diagnostics=True)
    buckets = ((4, (24, 24)),)
    reqs = [_req(24, seed=40 + i) for i in range(4)]
    with _engine(d, cfg_kw, buckets, mesh_shape=(),
                 return_codes=True) as ref_eng:
        ref = _serve_all(ref_eng, reqs)
    with _engine(d, cfg_kw, buckets, mesh_shape=(2, 2),
                 return_codes=True) as eng:
        got = _serve_all(eng, reqs)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.z, w.z)
        for a, b in zip(g.trace.extras, w.trace.extras):
            np.testing.assert_array_equal(a, b)


def test_mesh_hot_swap_places_the_new_bank_on_every_position():
    """publish_bank on a (2, 2) engine builds the new bank's plans on
    every position (keyed (digest, (bucket, position))): later requests
    serve the new bank bitwise as a single-device engine on it does, and
    the retired digest's plans go."""
    d0, d1 = _bank(seed=0), _bank(seed=1)
    cfg_kw = _cfg_kw(max_it=6)
    buckets = ((4, (24, 24)),)
    reqs = [_req(24, seed=70 + i) for i in range(4)]
    with _engine(d1, cfg_kw, buckets, mesh_shape=()) as ref_eng:
        ref = _serve_all(ref_eng, reqs)
    with _engine(d0, cfg_kw, buckets, mesh_shape=(2, 2)) as eng:
        old, new = eng.publish_bank(None, d1)
        assert old != new and eng.bank_digest() == new
        assert eng.plan_cache_stats()["n_plans"] == 4
        got = _serve_all(eng, reqs)
    _assert_bitwise(got, ref)


# ---------------------------------------------------------- refusals


def test_serveconfig_refuses_non_dividing_mesh_with_bucket_list():
    with pytest.raises(ValueError, match=r"divide.*\(3, \(16, 16\)\)"):
        ServeConfig(buckets=((4, (24, 24)), (3, (16, 16))),
                    mesh_shape=(2,))
    assert ServeConfig(buckets=((3, (16, 16)),), mesh_shape=()).mesh_shape \
        == ()
    with pytest.raises(ValueError, match="mesh_devices"):
        ServeConfig(buckets=((2, (16, 16)),), mesh_shape=(2,),
                    mesh_devices=(0,))
    with pytest.raises(ValueError, match="is a string"):
        ServeConfig(buckets=((2, (16, 16)),), mesh_shape="12")
    # a repeated index: two positions on one card
    assert ServeConfig(buckets=((2, (16, 16)),), mesh_shape=(2,),
                       mesh_devices=(0, 0)).mesh_devices == (0, 0)


def test_build_plan_refuses_incompatible_mesh_like_jax():
    d = _bank()
    prob = _prob(d)
    cfg = SolveConfig(**_cfg_kw())
    buckets = ((3, (16, 16)),)
    jd = jnp.asarray(d)
    jprob = jr.ReconstructionProblem(jcfg.ProblemGeom((5, 5), 6))
    jc = jcfg.SolveConfig(**_cfg_kw())
    for kw, pattern in (
        (dict(mesh_shape=(2,), slots=3, buckets=buckets),
         r"batch axis 2.*\(3, \(16, 16\)\)"),
        (dict(mesh_shape=(2, 7), slots=2), "freq axis 7"),
    ):
        with pytest.raises(ValueError, match=pattern) as te:
            tr.build_plan(d, prob, cfg, (16, 16), device="cpu", **kw)
        with pytest.raises(ValueError, match=pattern) as je:
            jr.build_plan(jd, jprob, jc, (16, 16), **kw)
        assert str(te.value) == str(je.value)
    p_mesh = tr.build_plan(d, prob, cfg, (16, 16), device="cpu",
                           mesh_shape=(2,), slots=4,
                           buckets=((4, (16, 16)),))
    p_plain = tr.build_plan(d, prob, cfg, (16, 16), device="cpu")
    assert torch.equal(p_mesh.kern.dinv, p_plain.kern.dinv)


def test_place_plan_slices_the_solve_factors_by_bin():
    """A freq position's plan: spectra replicated (shared when already
    on its device), each factor cut to its contiguous bins (trailing
    for dhat/dinv/minv_diag; leading for minv, W > 1)."""
    for d in (_bank(), _bank(k=4, bands=3)):
        plan = tr.build_plan(d, _prob(d), SolveConfig(**_cfg_kw()),
                             (12, 12), device="cpu")
        F = plan.kern.dinv.shape[-1]
        parts = [tr.place_plan(plan, "cpu", i, 2) for i in range(2)]
        for p in parts:
            assert p.dhat_clean is plan.dhat_clean
        for name in ("dhat", "dinv", "minv_diag"):
            full = getattr(plan.kern, name)
            if full is None:
                continue
            got = torch.cat([getattr(p.kern, name) for p in parts], -1)
            assert torch.equal(got, full), name
            assert all(getattr(p.kern, name).is_contiguous() for p in parts)
        if plan.kern.minv is not None:
            got = torch.cat([p.kern.minv for p in parts], 0)
            assert torch.equal(got, plan.kern.minv)
            assert parts[0].kern.minv.shape[0] == F // 2
        same = tr.place_plan(plan, "cpu")
        assert all(a is b for a, b in zip(same.kern, plan.kern))


def test_reconstruct_plan_mesh_refusal_points_at_engine_path():
    d = _bank()
    prob = _prob(d)
    cfg = SolveConfig(**_cfg_kw())
    plan = tr.build_plan(d, prob, cfg, (16, 16), device="cpu")
    x, m = _req(16)
    mesh = LocalMesh((2,), ("batch",), ["cpu", "cpu"])
    with pytest.raises(ValueError, match="mesh_shape") as te:
        tr.reconstruct(np.stack([x * m] * 2), d, prob, cfg,
                       mask=np.stack([m, m]), mesh=mesh, plan=plan,
                       device="cpu")
    assert "plan does not combine with mesh" in str(te.value)


def test_mesh_strict_refusal_names_shortage_and_nonstrict_falls_back(
    monkeypatch, capsys,
):
    """tests/test_serve_mesh.py:358, with a one-device pool: STRICT
    refuses with the shortage; CCSC_SERVE_MESH_STRICT=0 serves on one
    device and says so."""
    monkeypatch.setattr(tengine, "_device_pool",
                        lambda device: [torch.device("cpu")])
    d = _bank()
    with pytest.raises(CCSCInputError,
                       match=r"needs 64 device\(s\) but only 1"):
        _engine(d, _cfg_kw(), ((64, (16, 16)),), mesh_shape=(64,))
    monkeypatch.setenv("CCSC_SERVE_MESH_STRICT", "0")
    with _engine(d, _cfg_kw(), ((64, (16, 16)),), mesh_shape=(64,),
                 max_wait_ms=10.0) as eng:
        assert eng.devices == 1
        assert eng.mesh_shape is None
        x, m = _req(16)
        assert eng.reconstruct(x * m, mask=m).recon.shape == (16, 16)
    assert "serving single-device" in capsys.readouterr().out


def test_resolve_mesh_on_cuda_pool_without_cards(monkeypatch):
    """The card pool's resolution, with no card visible here: STRICT
    names the shortage, an out-of-range mesh_devices index refuses
    always, =0 returns the fallback note."""
    cuda = torch.device("cuda")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(CCSCInputError, match=r"needs 2 device\(s\) but "
                                             r"only 0"):
        tengine._resolve_mesh(ServeConfig(buckets=((2, (8, 8)),),
                                          mesh_shape=(2,)), cuda)
    with pytest.raises(CCSCInputError, match=r"index\(es\) \[0, 0\]"):
        tengine._resolve_mesh(ServeConfig(
            buckets=((2, (8, 8)),), mesh_shape=(2,), mesh_devices=(0, 0)),
            cuda)
    monkeypatch.setenv("CCSC_SERVE_MESH_STRICT", "0")
    mesh, shape, note = tengine._resolve_mesh(
        ServeConfig(buckets=((2, (8, 8)),), mesh_shape=(2,)), cuda)
    assert mesh is None and shape is None and "single-device" in note


def test_env_mesh_resolution_and_off_sentinel(monkeypatch):
    """tests/test_serve_mesh.py:378: CCSC_SERVE_MESH arms a
    None-mesh_shape engine; mesh_shape=() pins one device even with the
    knob set; a malformed knob refuses."""
    monkeypatch.setenv("CCSC_SERVE_MESH", "2")
    d = _bank()
    with _engine(d, _cfg_kw(max_it=4), ((2, (16, 16)),)) as eng:
        assert eng.devices == 2
        assert eng.mesh_shape == (2,)
        assert eng.position_devices == [torch.device("cpu")] * 2
    with _engine(d, _cfg_kw(max_it=4), ((2, (16, 16)),),
                 mesh_shape=()) as eng:
        assert eng.devices == 1
    monkeypatch.setenv("CCSC_SERVE_MESH", "2x")
    with pytest.raises(CCSCInputError, match="BATCHxFREQ"):
        _engine(d, _cfg_kw(max_it=4), ((2, (16, 16)),))


@pytest.mark.parametrize("spec", ["8", "4x2", "4X2", "2*2", "4x", "x2",
                                  "0", "2x2x2", "a", ""])
def test_parse_mesh_shape_matches_jax(spec):
    try:
        want = jengine.parse_mesh_shape(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            tengine.parse_mesh_shape(spec)
        assert str(te.value) == str(e)
    else:
        assert tengine.parse_mesh_shape(spec) == want


# --------------------------------------------- failures and the mesh


def test_failing_position_fails_the_whole_dispatch(monkeypatch):
    """A position that raises fails its dispatch: every request of it
    gets that exception (not its peers' barrier errors), and the engine
    serves the next dispatch."""
    d = _bank()
    real = tengine._reconstruct_impl
    armed = threading.Event()

    def flaky(*a, **kw):
        mesh = kw.get("mesh")
        if armed.is_set() and mesh is not None and mesh.position == 3:
            raise RuntimeError("position 3 failed")
        return real(*a, **kw)

    monkeypatch.setattr(tengine, "_reconstruct_impl", flaky)
    reqs = [_req(24, seed=60 + i) for i in range(4)]
    with _engine(d, _cfg_kw(max_it=6), ((4, (24, 24)),),
                 mesh_shape=(2, 2)) as eng:
        armed.set()
        futs = [eng.submit(x * m, mask=m) for x, m in reqs]
        for f in futs:
            with pytest.raises(RuntimeError, match="position 3 failed"):
                f.result(timeout=60)
        armed.clear()
        ok = _serve_all(eng, reqs)
    assert all(np.isfinite(r.recon).all() for r in ok)


def test_barrier_timeout_names_the_position():
    mesh = LocalMesh((1, 2), ("batch", "freq"), ["cpu", "cpu"],
                     timeout_s=0.2)
    err = []

    def alone():
        mesh.enter(1)
        try:
            mesh_lib.all_gather_tiled(torch.ones(2, 4), mesh, "freq")
        except MeshBarrierError as e:
            err.append(str(e))

    t = threading.Thread(target=alone)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert err and "position 1" in err[0] and "'freq'" in err[0]


def test_local_mesh_gather_fslice_and_refused_reductions():
    """fslice / all_gather_tiled on the in-process mesh, from each
    position's thread: the gather reassembles the slices in axis order;
    psum and pmax refuse."""
    mesh = LocalMesh((2, 2), ("batch", "freq"), ["cpu"] * 4)
    x = torch.arange(24, dtype=torch.float32).reshape(2, 12)
    out = [None] * 4

    def run(pos):
        mesh.enter(pos)
        part = mesh_lib.fslice(x, mesh, "freq")
        out[pos] = (part, mesh_lib.all_gather_tiled(part + 0, mesh, "freq"))

    threads = [threading.Thread(target=run, args=(p,)) for p in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    for pos, (part, full) in enumerate(out):
        f = pos % 2
        assert torch.equal(part, x[:, 6 * f:6 * f + 6])
        assert torch.equal(full, x)
    assert mesh.gathers() == [1] * 4
    mesh.enter(0)
    for fn in (mesh_lib.psum, mesh_lib.pmax):
        with pytest.raises(RuntimeError, match="reduces nothing"):
            fn(torch.ones(2), mesh, "batch")
    assert mesh_lib.psum(torch.ones(2), mesh, None).tolist() == [1.0, 1.0]


def test_freq_positions_slice_or_take_presliced_factors_bitwise():
    """``_reconstruct_impl`` on the two positions of a 'freq' group:
    with the whole plan it cuts its bins itself, with ``place_plan``'s
    slice it takes them as they are (``kern_presliced``); both give the
    bits of the solve without a mesh, and gather once an iteration."""
    d = _bank()
    cfg = SolveConfig(**_cfg_kw(max_it=6, tol=0.0))
    plan = tr.build_plan(d, _prob(d), cfg, (24, 24), device="cpu")
    (x0, m0), (x1, m1) = _req(24, seed=90), _req(24, seed=91)
    b = torch.from_numpy(np.stack([x0 * m0, x1 * m1]))
    m = torch.from_numpy(np.stack([m0, m1]))
    ref = tr._reconstruct_impl(b, None, _prob(d), cfg, m, None, None, None,
                               plan=plan, slotwise=True)
    for presliced in (False, True):
        mesh = LocalMesh((1, 2), ("batch", "freq"), ["cpu"] * 2)
        out = [None, None]

        def run(pos):
            mesh.enter(pos)
            p = tr.place_plan(plan, "cpu", pos, 2) if presliced else plan
            out[pos] = tr._reconstruct_impl(
                b, None, _prob(d), cfg, m, None, None, None, plan=p,
                slotwise=True, mesh=mesh, freq_axis_name="freq",
                kern_presliced=presliced)

        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for o in out:
            assert torch.equal(o.recon, ref.recon)
            assert torch.equal(o.trace.obj_vals, ref.trace.obj_vals)
        assert mesh.gathers() == [6, 6]


# ------------------------------------------------------ bench and W > 1


def test_bench_mesh_arm_refuses_malformed_spec_before_any_work(
    monkeypatch,
):
    def no_engine(*a, **kw):
        raise AssertionError("an engine was built before the refusal")

    monkeypatch.setattr(bench, "CodecEngine", no_engine)
    with pytest.raises(ValueError, match="BATCHxFREQ"):
        bench.main(["--device", "cpu", "--mesh", "4x"])
    monkeypatch.setenv("CCSC_SERVE_MESH", "2x0")
    with pytest.raises(ValueError, match="BATCHxFREQ"):
        bench.main(["--device", "cpu"])


def test_bench_mesh_arm_records_and_skips():
    """The arm's record on a 2x2 mesh (rates, per-position iterations
    and gathers, gather timing), and mesh_skipped for a mesh that cannot
    shard the bucket."""
    d = _bank()
    prob = _prob(d)
    cfg = SolveConfig(**_cfg_kw(max_it=4, verbose="none"))
    reqs = bench.make_requests([24] * 4 + [20], seed=3)
    looped, _ = bench.run_direct_loop(d, prob, cfg, reqs, "cpu")
    rec = bench.run_mesh_arm(d, prob, cfg, reqs, (2, 2), (2, (24, 24)),
                             "cpu", looped, 1.0)
    assert rec["mesh"] == "2x2" and rec["mesh_devices"] == 4
    assert rec["mesh_requests_per_sec"] == rec["speedup_mesh_vs_default"]
    assert rec["mesh_served_iters"][:4] == [it for _, it in looped][:4]
    assert rec["mesh_max_rel_err_vs_loop"] < 0.05
    assert rec["mesh_p50_ms"] <= rec["mesh_p90_ms"] <= rec["mesh_max_ms"]
    for its, gs in zip(rec["mesh_position_iters"], rec["mesh_gathers"]):
        assert its == gs
    timing = rec["mesh_gather_timing"]
    assert len(timing["gathers"]) == 4 and min(timing["gathers"]) >= 1
    skip = bench.run_mesh_arm(d, prob, cfg, reqs, (3,), (2, (24, 24)),
                              "cpu", looped, 1.0)
    assert "divide" in skip["mesh_skipped"]


@pytest.mark.parametrize("mesh_shape", [(), (2,)])
def test_w3_bucket_through_engine_matches_jax(mesh_shape):
    """A hyperspectral-geometry bucket (W=3 bands, k=4 5x5 filters, 24²)
    through the port's engine takes the slot-wise Woodbury z-solve: one
    device and a (2,) mesh against the JAX engine, and the mesh bitwise
    the port's single-device engine."""
    d = _bank(k=4, bands=3)
    cfg_kw = _cfg_kw(max_it=10)
    buckets = ((4, (24, 24)),)
    reqs = [_req(24, seed=80 + i, bands=3) for i in range(3)]
    with _engine(d, cfg_kw, buckets, mesh_shape=mesh_shape,
                 max_wait_ms=50.0) as eng:
        got = _serve_all(eng, reqs)
    jeng = _jax_engine(d, cfg_kw, buckets)
    try:
        want = _serve_all(jeng, reqs)
    finally:
        jeng.close()
    _assert_close_to_jax(got, want)
    assert all(g.recon.shape == (3, 24, 24) for g in got)
    if mesh_shape:
        with _engine(d, cfg_kw, buckets, mesh_shape=(),
                     max_wait_ms=50.0) as eng:
            _assert_bitwise(got, _serve_all(eng, reqs))
