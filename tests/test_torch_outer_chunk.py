"""The port's chunked learner driver (``LearnConfig.outer_chunk`` /
``donate_state``; models.learn.outer_chunk_scan,
models.learn_masked.chunk_scan, the streaming learner's chunk cadence),
mirroring the JAX package's tests/test_outer_chunk.py on the CPU:

- a chunked run is BITWISE the port's per-step run on the same inputs
  (tol 0, tol stopping inside a chunk, a NaN inside a chunk, a resume
  that starts inside a chunk), for the consensus and masked learners
  and on 2-rank gloo meshes; the streaming cadence equals per-step;
- a chunked run is within JAX's parity tolerance of JAX's chunked run
  (rtol 1e-4 on the objective traces, atol 2e-5 on the filters);
- one host read a chunk; donation never writes into the caller's
  state; the ladder's donate rung runs the donated driver.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.config import LearnConfig as JCfg
from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.models import common as jcommon
from ccsc_code_iccv2017_tpu.models import learn as jlearn
from ccsc_code_iccv2017_torch import convert
from ccsc_code_iccv2017_torch.apps import _common
from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.models import common as tcommon
from ccsc_code_iccv2017_torch.models import learn as tlearn
from ccsc_code_iccv2017_torch.models import learn_masked as tlm
from ccsc_code_iccv2017_torch.parallel import consensus, distributed
from ccsc_code_iccv2017_torch.parallel import mesh as tmesh
from ccsc_code_iccv2017_torch.parallel import streaming
from ccsc_code_iccv2017_torch.utils import faults, perfmodel

import torch_mesh_cases as cases

CFG = dict(
    max_it=6, max_it_d=3, max_it_z=3, num_blocks=2, rho_d=500.0,
    rho_z=10.0, lambda_prior=0.1, verbose="none", track_objective=True,
    tol=0.0,
)
TRACE_KEYS = ("obj_vals_d", "obj_vals_z", "d_diff", "z_diff")
GEOM = ((5, 5), 6)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for v in ("CCSC_FAULT_NAN_IT", "CCSC_HERM_INV", "CCSC_FAULT_STATE_DIR"):
        monkeypatch.delenv(v, raising=False)
    faults.reset()
    yield
    faults.reset()


def _b2d(n=8, size=16, seed=0):
    r = np.random.default_rng(seed)
    return r.normal(size=(n, size, size)).astype(np.float32)


def _learn(b, cfg, geom=GEOM, **kw):
    return consensus.learn(b, ProblemGeom(*geom), cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0), **kw)


def _assert_bitwise(ref, res):
    for k in TRACE_KEYS:
        assert res.trace[k] == ref.trace[k], k
    assert torch.equal(res.d, ref.d)
    assert torch.equal(res.z, ref.z)


@pytest.mark.parametrize(
    "chunk, donate", [(4, False), (4, True), (1, True), (3, False)])
@pytest.mark.parametrize("fused", [False, True], ids=["comp", "fused"])
def test_consensus_chunked_matches_per_step(chunk, donate, fused):
    """outer_chunk folds steps into a chunk with one read; max_it=6 with
    chunk 4 runs a partial final chunk. Donation changes no bit."""
    b = _b2d()
    ref = _learn(b, LearnConfig(**CFG, fused_z=fused))
    res = _learn(b, LearnConfig(**CFG, fused_z=fused, outer_chunk=chunk,
                                donate_state=donate))
    _assert_bitwise(ref, res)


def _jax_init(b, cfg):
    jgeom = JGeom(*GEOM)
    fg = jcommon.FreqGeom.create(jgeom, b.shape[-2:])
    nb = cfg["num_blocks"]
    st = jlearn.init_state(jax.random.PRNGKey(0), jgeom, fg, nb,
                           b.shape[0] // nb, jnp.float32)
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def test_chunked_matches_jax_chunked():
    """The port's chunked learn against JAX's chunked learn (a lax.scan)
    from JAX's init of PRNGKey(0): JAX's learner parity limits."""
    b = _b2d()
    jres = jlearn.learn(jnp.asarray(b), JGeom(*GEOM),
                        JCfg(**CFG, outer_chunk=4, donate_state=True),
                        key=jax.random.PRNGKey(0))
    tres = consensus.learn(
        b, ProblemGeom(*GEOM), LearnConfig(**CFG, outer_chunk=4,
                                           donate_state=True),
        device="cpu",
        initial_state=convert.learn_state_from_jax(_jax_init(b, CFG), "cpu"))
    assert len(tres.trace["obj_vals_z"]) == len(jres.trace["obj_vals_z"])
    for k in ("obj_vals_d", "obj_vals_z"):
        np.testing.assert_allclose(tres.trace[k], jres.trace[k], rtol=1e-4)
    np.testing.assert_allclose(tres.d.numpy(), np.asarray(jres.d), atol=2e-5)


def test_chunk_tol_early_stop_lands_on_same_iterate():
    """A tol hit inside a chunk: the converged step is adopted, the
    chunk's tail is discarded, and the run ends on the per-step run's
    iterate, bit for bit."""
    b = _b2d()
    probe = _learn(b, LearnConfig(**{**CFG, "max_it": 8}))
    dd = np.maximum(np.asarray(probe.trace["d_diff"][1:]),
                    np.asarray(probe.trace["z_diff"][1:]))
    tol = float(dd[len(dd) * 2 // 3] * 1.000001)
    kw = {**CFG, "max_it": 8, "tol": tol}
    ref = _learn(b, LearnConfig(**kw))
    assert len(ref.trace["d_diff"]) < 9, "tol never triggered"
    res = _learn(b, LearnConfig(**kw, outer_chunk=3, donate_state=True))
    _assert_bitwise(ref, res)


@pytest.mark.parametrize("recoveries", [0, 1])
def test_chunk_nan_guard_keeps_last_good_state(monkeypatch, recoveries):
    """A NaN poisoned into the second step (inside the first chunk): the
    chunk carries the last finite state, as the per-step driver keeps
    it; with a recovery the rho backoff re-runs from it. Bitwise the
    per-step run under the same fault."""
    b = _b2d(n=4, size=12, seed=1)
    geom = ((3, 3), 4)
    base = dict(max_it=4, max_it_d=1, max_it_z=1, num_blocks=2,
                rho_d=50.0, rho_z=2.0, verbose="none", track_objective=True,
                max_recoveries=recoveries)
    out = []
    for extra in ({}, dict(outer_chunk=2, donate_state=True)):
        monkeypatch.setenv("CCSC_FAULT_NAN_IT", "2")
        faults.reset()
        out.append(_learn(b, LearnConfig(**base, **extra), geom=geom))
    ref, res = out
    _assert_bitwise(ref, res)
    assert torch.isfinite(res.d).all() and torch.isfinite(res.z).all()
    if recoveries == 0:
        # the diverged iteration 2 was not adopted: obj0 + iteration 1
        assert len(res.trace["obj_vals_z"]) == 2
    else:
        assert len(res.trace["recoveries"]) == 1
        assert len(res.trace["obj_vals_z"]) == 5


def test_chunk_checkpoint_resume_mid_chunk(tmp_path):
    """A run interrupted after 3 steps (chunks of 2) resumes with chunks
    of 4 from iteration 3 (a partial first chunk) and ends bitwise the
    uninterrupted chunked run."""
    ck = str(tmp_path / "ck")
    b = _b2d(n=4, size=12, seed=1)
    geom = ((3, 3), 4)
    mk = lambda it, chunk: LearnConfig(
        max_it=it, max_it_d=2, max_it_z=2, num_blocks=2, rho_d=50.0,
        rho_z=2.0, tol=0.0, verbose="none", track_objective=True,
        outer_chunk=chunk, donate_state=True)
    full = _learn(b, mk(7, 4), geom=geom)
    _learn(b, mk(3, 2), geom=geom, checkpoint_dir=ck, checkpoint_every=2)
    resumed = _learn(b, mk(7, 4), geom=geom, checkpoint_dir=ck,
                     checkpoint_every=2)
    for k in TRACE_KEYS:
        assert resumed.trace[k] == full.trace[k]
    assert torch.equal(resumed.d, full.d)


def test_one_host_read_a_chunk(monkeypatch):
    """The chunk's trace leaves the device in ONE read (mesh.agree): two
    reads for 6 steps in chunks of 3, against six per step."""
    calls = []
    real = tmesh.agree

    def counting(values, flag, mesh):
        calls.append(tuple(values.shape))
        return real(values, flag, mesh)

    monkeypatch.setattr(tmesh, "agree", counting)
    b = _b2d()
    _learn(b, LearnConfig(**CFG))
    assert len(calls) == 6
    calls.clear()
    _learn(b, LearnConfig(**CFG, outer_chunk=3))
    # [4 metrics x 3 steps + active + adopted] each
    assert calls == [(18,), (18,)]


def test_donation_never_writes_the_callers_state():
    """A donated chunk adopts into its input's storage: the driver hands
    it a copy of ``initial_state``, never the caller's tensors; the
    direct call consumes its input."""
    b = _b2d()
    st = convert.learn_state_from_jax(_jax_init(b, CFG), "cpu")
    before = [t.clone() for t in st]
    consensus.learn(b, ProblemGeom(*GEOM),
                    LearnConfig(**CFG, outer_chunk=3, donate_state=True),
                    device="cpu", initial_state=st)
    for t, u in zip(st, before):
        assert torch.equal(t, u)
    fg = tcommon.FreqGeom.create(ProblemGeom(*GEOM), b.shape[-2:])
    state = tlearn.LearnState(*(t.clone() for t in st))
    z_in = state.z
    bb = torch.from_numpy(b).reshape(2, 4, 16, 16)
    out, tr = tlearn.outer_chunk_scan(state, bb, ProblemGeom(*GEOM),
                                      LearnConfig(**CFG), fg, 2, 2,
                                      donate=True)
    assert out.z.data_ptr() == z_in.data_ptr()  # the input's storage
    assert torch.equal(z_in, out.z)
    assert tr.active.tolist() == [True, True]


@pytest.mark.parametrize("donate", [False, True])
def test_masked_chunked_matches_per_step(donate):
    geom = ProblemGeom((3, 3), 3, reduce_shape=(2,))
    b = np.random.default_rng(0).uniform(0.1, 1.0, (2, 2, 8, 8)).astype(
        np.float32)
    mk = lambda **e: LearnConfig(max_it=5, max_it_d=2, max_it_z=2,
                                 verbose="none", tol=0.0,
                                 track_objective=True, **e)
    kw = dict(gamma_div_d=50.0, gamma_div_z=10.0, device="cpu")
    ref = tlm.learn_masked(b, geom, mk(),
                           generator=torch.Generator().manual_seed(0), **kw)
    res = tlm.learn_masked(b, geom, mk(outer_chunk=3, donate_state=donate),
                           generator=torch.Generator().manual_seed(0), **kw)
    assert len(res.trace["obj_vals_z"]) == len(ref.trace["obj_vals_z"])
    for k in TRACE_KEYS:
        assert res.trace[k] == ref.trace[k]
    assert torch.equal(res.d, ref.d)


def test_masked_chunk_rollback_matches_per_step():
    """The objective rollback at the default gamma divisors (it fires
    there, the verify notes): the chunk reverts both iterates and stops
    at the per-step run's iteration, bit for bit."""
    geom = ProblemGeom((3, 3), 3, reduce_shape=(2,))
    r = np.random.default_rng(5)
    b = r.uniform(0.1, 1.0, (3, 2, 10, 10)).astype(np.float32)
    sm = r.uniform(0.0, 0.2, b.shape).astype(np.float32)
    mk = lambda **e: LearnConfig(max_it=10, max_it_d=2, max_it_z=2,
                                 verbose="none", tol=0.0,
                                 track_objective=True, **e)
    ref = tlm.learn_masked(b, geom, mk(), smooth_init=sm, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert "rolled_back_at" in ref.trace
    for donate in (False, True):
        res = tlm.learn_masked(b, geom, mk(outer_chunk=3,
                                           donate_state=donate),
                               smooth_init=sm, device="cpu",
                               generator=torch.Generator().manual_seed(0))
        assert res.trace["rolled_back_at"] == ref.trace["rolled_back_at"]
        for k in TRACE_KEYS:
            assert res.trace[k] == ref.trace[k]
        assert torch.equal(res.d, ref.d)


def test_masked_chunk_scan_rollback_returns_prev_state():
    """JAX's test_masked_chunk_rollback_returns_prev_state on the port's
    chunk_scan: with obj_best below any reachable objective the first
    step rolls back, returning ``prev`` unchanged and flagging it."""
    geom = ProblemGeom((3, 3), 3, reduce_shape=(2,))
    b = torch.from_numpy(np.random.default_rng(0).uniform(
        0.1, 1.0, (2, 2, 8, 8)).astype(np.float32))
    cfg = LearnConfig(max_it=3, max_it_d=2, max_it_z=2, verbose="none",
                      tol=0.0, track_objective=True, outer_chunk=3)
    fg = tcommon.FreqGeom.create(geom, (8, 8))
    from ccsc_code_iccv2017_torch.ops import fourier

    b_pad = fourier.pad_spatial(b, geom.psf_radius, target=fg.spatial_shape)
    M_pad = fourier.pad_spatial(torch.ones_like(b), geom.psf_radius,
                                target=fg.spatial_shape)
    sm = torch.zeros_like(b_pad)
    state = tlm.init_state(torch.Generator().manual_seed(0), geom, fg, 2)
    prev = tlm.MaskedLearnState(*(t + 1.0 for t in state))
    for donate in (False, True):
        p_in = tlm.MaskedLearnState(*(t.clone() for t in prev))
        st, pv, best, ys = tlm.chunk_scan(
            tlm.MaskedLearnState(*(t.clone() for t in state)), p_in,
            torch.tensor(1e-30), b_pad, M_pad, sm, geom, cfg, fg, 50.0, 10.0,
            3, donate=donate)
        rolled, active = ys[6].tolist(), ys[4].tolist()
        assert rolled == [True, False, False]
        assert active == [True, False, False]
        for got, want in zip(st, prev):
            assert torch.equal(got, want)


def test_streaming_chunk_cadence_matches_per_step():
    geom = ProblemGeom((3, 3), 4)
    cfg = LearnConfig(max_it=3, max_it_d=2, max_it_z=3, num_blocks=2,
                      rho_d=50.0, rho_z=2.0, verbose="none",
                      track_objective=True)
    b = np.random.default_rng(1).normal(size=(4, 12, 12)).astype(np.float32)
    ref = streaming.learn_streaming(b, geom, cfg, device="cpu")
    for mode in ("device", "paged"):
        res = streaming.learn_streaming(
            b, geom, dataclasses.replace(cfg, outer_chunk=2), device="cpu",
            stream_mode=mode)
        assert torch.equal(res.d, ref.d)
        assert res.trace["obj_vals_z"] == ref.trace["obj_vals_z"]
        assert len(res.trace["h2d_bytes"]) == cfg.max_it


def test_streaming_chunk_tol_stop_trace_consistent_with_state():
    """Streaming has no last-good carry: a tol hit inside a chunk stops
    at the chunk's end, and the result equals a fixed-length run of the
    steps the trace covers (JAX's contract)."""
    geom = ProblemGeom((3, 3), 4)
    base = LearnConfig(max_it=6, max_it_d=2, max_it_z=3, num_blocks=2,
                       rho_d=50.0, rho_z=2.0, verbose="none",
                       track_objective=True, tol=0.0)
    b = np.random.default_rng(1).normal(size=(4, 12, 12)).astype(np.float32)
    probe = streaming.learn_streaming(b, geom, base, device="cpu")
    dd = np.maximum(np.asarray(probe.trace["d_diff"][1:]),
                    np.asarray(probe.trace["z_diff"][1:]))
    tol = float(dd[2] * 1.000001)
    res = streaming.learn_streaming(
        b, geom, dataclasses.replace(base, tol=tol, outer_chunk=2),
        device="cpu")
    n_done = len(res.trace["d_diff"]) - 1
    assert 3 <= n_done < 6 and n_done % 2 == 0
    ref = streaming.learn_streaming(
        b, geom, dataclasses.replace(base, max_it=n_done), device="cpu")
    assert torch.equal(res.d, ref.d)
    assert res.trace["obj_vals_z"] == ref.trace["obj_vals_z"]


def test_streaming_rejects_donate_state():
    b = np.zeros((2, 8, 8), np.float32)
    cfg = LearnConfig(max_it=1, num_blocks=2, verbose="none",
                      donate_state=True)
    with pytest.raises(ValueError, match="donate_state"):
        streaming.learn_streaming(b, ProblemGeom((3, 3), 2), cfg,
                                  device="cpu")


def test_ladder_donate_rung_runs_the_donated_driver(monkeypatch):
    """The ladder's donate rung (apps/_common.py): a preflight budget
    between the donated and plain estimates steps to donate_state=True
    and the run is the donated chunked driver, bitwise the plain run."""
    b = _b2d(n=4, size=12, seed=2)
    geom = ProblemGeom((3, 3), 4)
    cfg = LearnConfig(max_it=2, max_it_d=2, max_it_z=2, num_blocks=2,
                      rho_d=50.0, rho_z=2.0, tol=0.0, verbose="none",
                      track_objective=True)
    est, _ = perfmodel.inmem_learn_estimate(b.shape, geom, cfg, device="cpu")
    don, _ = perfmodel.inmem_learn_estimate(
        b.shape, geom, dataclasses.replace(cfg, donate_state=True),
        device="cpu")
    assert don < est
    monkeypatch.setenv("CCSC_INMEM_HBM_GB", str((don + 1) / 1e9))
    res = _common.dispatch_learn(b, geom, cfg, 0, "cpu", auto_degrade=True)
    assert [d["rung"] for d in res.trace["degrades"]] == ["donate"]
    monkeypatch.delenv("CCSC_INMEM_HBM_GB")
    ref = _common.dispatch_learn(b, geom, cfg, 0, "cpu")
    assert torch.equal(res.d, ref.d)
    assert res.trace["obj_vals_z"] == ref.trace["obj_vals_z"]


def test_perfmodel_donation_drops_state_output_copy():
    kw = dict(num_blocks=2, ni=4, k=8, spatial=(24, 24), num_freq=24 * 13,
              max_it_d=3, max_it_z=5)
    base = perfmodel.analytic_outer_step_cost(**kw)
    don = perfmodel.analytic_outer_step_cost(**kw, donate_state=True)
    assert don["flops"] == base["flops"]
    S = 24 * 24
    state = (2 * 2 * 4 * 8 + 2 * 2 * 8 + 2 * 8) * S * 4
    assert base["bytes"] - don["bytes"] == pytest.approx(2 * state)


MESH_CASES = {
    "block2": ("block_mesh", (2,)),
    "block1_freq2": ("block_freq_mesh", (1, 2)),
    "block1_filter2": ("block_filter_mesh", (1, 2)),
}


@pytest.fixture(scope="module")
def mesh_runs():
    """Per-step and chunked (donated, chunk 3 of 4 steps) learns on every
    learner mesh of 2 gloo ranks, and the masked learner on a 'freq'
    mesh, run once."""
    b = _b2d(n=8, size=12, seed=3)
    geom = ((3, 3), 4)
    cfg = dict(max_it=4, max_it_d=2, max_it_z=2, num_blocks=2, rho_d=500.0,
               rho_z=10.0, lambda_prior=0.1, verbose="none",
               track_objective=True, tol=0.0)
    runs = []
    for name, kind in MESH_CASES.items():
        for tag, extra in (("step", {}), ("chunk", dict(
                outer_chunk=3, donate_state=True))):
            runs.append((f"{name}_{tag}", "learn", kind,
                         dict(b=b, geom=geom, cfg=dict(cfg, **extra))))
    mgeom = ((3, 3), 3, (2,))
    mb = np.random.default_rng(0).uniform(0.1, 1.0, (2, 2, 8, 8)).astype(
        np.float32)
    minit = {f: t.numpy() for f, t in zip(
        tlm.MaskedLearnState._fields,
        tlm.init_state(torch.Generator().manual_seed(0), ProblemGeom(*mgeom),
                       tcommon.FreqGeom.create(ProblemGeom(*mgeom), (8, 8)),
                       2))}
    mcfg = dict(max_it=4, max_it_d=2, max_it_z=2, verbose="none", tol=0.0,
                track_objective=True)
    for tag, extra in (("step", {}), ("chunk", dict(outer_chunk=3))):
        runs.append((f"masked_{tag}", "masked", ("freq_mesh", (2,)),
                     dict(b=mb, geom=mgeom, cfg=dict(mcfg, **extra),
                          init=minit, gamma_div_d=50.0, gamma_div_z=10.0)))
    return distributed.launch(cases.run_cases, 2, args=(runs,),
                              device="cpu", timeout=60.0, join_timeout=240.0)


@pytest.mark.parametrize("name", list(MESH_CASES) + ["masked"])
def test_mesh_chunked_matches_per_step(mesh_runs, name):
    """On a mesh the chunk's one agreed read replaces the step's: every
    rank decides alike and the chunked run is bitwise the per-step one
    on every rank."""
    for rank in mesh_runs:
        ref, res = rank[f"{name}_step"], rank[f"{name}_chunk"]
        assert torch.equal(res["d"], ref["d"])
        for k in ("obj_vals_d", "obj_vals_z"):
            assert res["trace"][k] == ref["trace"][k]


def test_chunk_telemetry_records_each_step_after_the_read(tmp_path):
    """With metrics_dir the chunked run writes one step record a step,
    the per-step run's values, and one roofline record a chunk."""
    from ccsc_code_iccv2017_torch.utils import obs

    b = _b2d()
    recs = {}
    for tag, extra in (("step", {}), ("chunk", dict(outer_chunk=3))):
        mdir = str(tmp_path / tag)
        _learn(b, LearnConfig(**CFG, metrics_dir=mdir, **extra))
        recs[tag] = obs.read_events(mdir)
    steps = {t: [(e["it"], e["obj_z"], e["z_diff"], e["nonfinite_z"])
                 for e in r if e["type"] == "step"] for t, r in recs.items()}
    assert steps["chunk"] == steps["step"] and len(steps["step"]) == 6
    roof = [e for e in recs["chunk"] if e["type"] == "roofline"]
    assert [(e["start_it"], e["length"], e["n_adopted"]) for e in roof] == [
        (0, 3, 3), (3, 3, 3)]
