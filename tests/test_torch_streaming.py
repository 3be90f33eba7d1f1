"""The host-streaming learner (``parallel/streaming.py``) against the JAX
package's ``learn_streaming``, on the CPU, at tests/test_streaming.py's
sizes.

The port starts from the JAX ``init_state`` of the same key (torch and
jax random streams differ), handed over through
``convert.learn_state_from_jax`` and ``initial_state=``. Tolerances are
JAX's own (tests/test_streaming.py): d, z and Dz atol 2e-5 and the
objectives rtol 1e-4 against a learner that runs the same math in
another order; the placement tiers within 1e-6 of each other; bf16
storage within 1e-2 of each field's scale (each step rounds the state to
8 mantissa bits, so a 1e-7 difference before rounding can flip an ulp).
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
from ccsc_code_iccv2017_tpu.parallel import streaming as jstreaming
from ccsc_code_iccv2017_tpu.utils import faults as jfaults
from ccsc_code_iccv2017_torch import convert
from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.models import common as tcommon
from ccsc_code_iccv2017_torch.models import learn as tlearn
from ccsc_code_iccv2017_torch.parallel import consensus
from ccsc_code_iccv2017_torch.parallel import streaming
from ccsc_code_iccv2017_torch.utils import env as tenv

KW = dict(max_it=3, max_it_d=2, max_it_z=3, num_blocks=2, rho_d=50.0,
          rho_z=2.0, verbose="none", track_objective=True)
GEOM = ((3, 3), 4)
TIERS = ("device", "kern", "paged")


def _data(shape=(4, 12, 12), seed=1):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape),
                      np.float32)


def _jax_init(b, geom, kw):
    """The JAX streaming learner's init from PRNGKey(0), as numpy."""
    jgeom = JGeom(*geom)
    fg = jcommon.FreqGeom.create(jgeom, b.shape[-jgeom.ndim_spatial:],
                                 fft_pad=kw.get("fft_pad", "none"))
    N = kw["num_blocks"]
    st = jlearn.init_state(
        jax.random.PRNGKey(0), jgeom, fg, N, b.shape[0] // N, jnp.float32,
        z_dtype=jnp.dtype(kw.get("storage_dtype", "float32")),
        d_dtype=jnp.dtype(kw.get("d_storage_dtype", "float32")),
    )
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _port(b, kw, init_fields, geom=GEOM, **extra):
    return streaming.learn_streaming(
        b, ProblemGeom(*geom), LearnConfig(**kw), device="cpu",
        initial_state=convert.learn_state_from_jax(init_fields, "cpu"),
        **extra,
    )


def _jax(b, kw, geom=GEOM, **extra):
    return jstreaming.learn_streaming(b, JGeom(*geom), JCfg(**kw),
                                      key=jax.random.PRNGKey(0), **extra)


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _assert_matches_jax(res, jr, atol=2e-5, rtol=1e-4):
    for field in ("d", "z", "Dz"):
        got, ref = _f32(getattr(res, field)), _f32(getattr(jr, field))
        assert got.shape == ref.shape, field
        np.testing.assert_allclose(got, ref, atol=atol, err_msg=field)
    for k in ("obj_vals_d", "obj_vals_z"):
        assert len(res.trace[k]) == len(jr.trace[k])
        np.testing.assert_allclose(res.trace[k], jr.trace[k], rtol=rtol)
    assert res.trace["algorithm"] == jr.trace["algorithm"] == \
        "consensus_streaming"


@pytest.fixture(scope="module")
def jax_run():
    b = _data()
    return b, _jax(b, KW), _jax_init(b, GEOM, KW)


@pytest.mark.parametrize("mode", TIERS)
def test_streaming_matches_jax_streaming(jax_run, mode):
    b, jr, init = jax_run
    res = _port(b, KW, init, stream_mode=mode)
    _assert_matches_jax(res, jr)
    np.testing.assert_allclose(res.trace["z_diff"][1:], jr.trace["z_diff"][1:],
                               rtol=1e-3)
    assert res.trace["stream_mode"] == mode
    # the results live on the host, as in JAX
    assert all(t.device.type == "cpu" for t in (res.d, res.z, res.Dz))


@pytest.mark.parametrize("by", ["argument", "env"])
def test_placement_tiers_agree(jax_run, monkeypatch, by):
    b, _, init = jax_run
    runs = {}
    for mode in TIERS:
        if by == "env":
            monkeypatch.setenv("CCSC_STREAM_MODE", mode)
            runs[mode] = _port(b, KW, init)
        else:
            # the argument wins over the knob
            monkeypatch.setenv("CCSC_STREAM_MODE", "paged")
            runs[mode] = _port(b, KW, init, stream_mode=mode)
        assert runs[mode].trace["stream_mode"] == mode
    for mode in ("kern", "paged"):
        for field in ("d", "z", "Dz"):
            np.testing.assert_allclose(
                _f32(getattr(runs[mode], field)),
                _f32(getattr(runs["device"], field)), atol=1e-6)


def test_streaming_matches_the_in_memory_learner(jax_run):
    """The same problem through the port's in-memory consensus learner
    (fused_z=False, the composition the streaming learner runs)."""
    b, _, init = jax_run
    res = _port(b, KW, init)
    mem = consensus.learn(
        b, ProblemGeom(*GEOM), LearnConfig(**KW), device="cpu",
        initial_state=convert.learn_state_from_jax(init, "cpu"),
    )
    for field in ("d", "z", "Dz"):
        np.testing.assert_allclose(_f32(getattr(res, field)),
                                   _f32(getattr(mem, field)), atol=2e-5)
    # the in-memory trace starts at the initial objective, the streamed
    # one at 0.0 (as in JAX); the steps agree
    for k in ("obj_vals_d", "obj_vals_z"):
        np.testing.assert_allclose(res.trace[k][1:], mem.trace[k][1:],
                                   rtol=1e-4)


def test_reduce_geometry_matches_jax():
    """W > 1 (two wavelengths): the Woodbury z-solve inside a block."""
    geom = ((3, 3), 3, (2,))
    kw = dict(max_it=2, max_it_d=1, max_it_z=2, num_blocks=2, rho_d=50.0,
              rho_z=2.0, verbose="none", track_objective=True)
    b = _data((4, 2, 10, 10), seed=2)
    jr = _jax(b, kw, geom=geom)
    res = _port(b, kw, _jax_init(b, geom, kw), geom=geom,
                stream_mode="paged")
    _assert_matches_jax(res, jr)


def _close_at_bf16(res, ref):
    for field in ("d", "z", "Dz"):
        got, want = _f32(getattr(res, field)), _f32(getattr(ref, field))
        assert got.shape == want.shape, field
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max(), field
    np.testing.assert_allclose(res.trace["obj_vals_z"][1:],
                               ref.trace["obj_vals_z"][1:], rtol=1e-2)


def test_bf16_storage_and_fft_pad_match_jax():
    kw = dict(KW, fft_pad="pow2", storage_dtype="bfloat16")
    b = _data()
    jr = _jax(b, kw)
    res = _port(b, kw, _jax_init(b, GEOM, kw), stream_mode="kern")
    assert res.z.dtype == torch.bfloat16
    _close_at_bf16(res, jr)


def test_bf16_dictionary_storage_matches_the_in_memory_learner():
    """d_storage_dtype=bfloat16: the JAX streaming learner cannot run it
    (its consensus sum stays bf16 and reaches a bf16 FFT), so the port
    is held to its own in-memory learner; the consensus sums run in
    float32 over the rounded block filters."""
    kw = dict(KW, d_storage_dtype="bfloat16")
    b = _data()
    init = _jax_init(b, GEOM, kw)
    res = _port(b, kw, init, stream_mode="paged")
    mem = consensus.learn(
        b, ProblemGeom(*GEOM), LearnConfig(**kw), device="cpu",
        initial_state=convert.learn_state_from_jax(init, "cpu"),
    )
    _close_at_bf16(res, mem)


def test_auto_selects_each_tier_by_the_byte_budget(jax_run, monkeypatch):
    """placement_bytes is the JAX formula (streaming.py:399-412); a
    budget just above each threshold selects that tier."""
    b, _, init = jax_run
    geom, cfg = ProblemGeom(*GEOM), LearnConfig(**KW)
    fg = tcommon.FreqGeom.create(geom, (12, 12))
    N, ni, K, F, S = 2, 2, 4, fg.num_freq, 14 * 14
    sizes = streaming.placement_bytes(b.shape, geom, cfg, fg)
    assert sizes == {
        "kern": N * 8 * (ni * K + ni * ni) * F,
        "bhat": N * ni * 1 * F * 8,
        "state": 2 * N * ni * K * S * 4 + 2 * N * K * S * 4 + b.nbytes,
        "temp": 5 * ni * K * F * 8,
    }
    resident = sizes["kern"] + sizes["bhat"] + sizes["temp"]
    monkeypatch.delenv("CCSC_STREAM_MODE", raising=False)
    for budget, want in ((resident + sizes["state"], "device"),
                         (resident + sizes["state"] - 1, "kern"),
                         (resident, "kern"), (resident - 1, "paged")):
        assert streaming.select_tier(sizes, budget) == want
        monkeypatch.setenv("CCSC_STREAM_RESIDENT_GB", repr(budget / 1e9))
        res = _port(b, dict(KW, max_it=1), init, stream_mode="auto")
        assert res.trace["stream_mode"] == want
    # the default budget: 10 GB, the JAX default
    monkeypatch.delenv("CCSC_STREAM_RESIDENT_GB")
    assert tenv.env_float("CCSC_STREAM_RESIDENT_GB") == 10.0
    assert tenv.env_str("CCSC_STREAM_MODE") == "auto"
    with pytest.raises(ValueError, match="stream mode"):
        streaming.select_tier(sizes, 1e10, "fast")


@pytest.mark.parametrize("geom, shape, blocks, tier", [
    (((11, 11, 11), 49), (64, 50, 50, 50), 8, "kern"),  # the 3D learner
    (((11, 11), 100), (800, 100, 100), 8, "paged"),  # the 2D north star
    (((11, 11), 100, (31,)), (16, 31, 100, 100), 4, "device"),  # HS
])
def test_default_budget_tiers_of_the_full_width_learners(geom, shape, blocks,
                                                         tier):
    """JAX's 10 GB default at the protocols' widths (bytes only)."""
    g = ProblemGeom(*geom)
    fg = tcommon.FreqGeom.create(g, shape[-g.ndim_spatial:])
    sizes = streaming.placement_bytes(shape, g,
                                      LearnConfig(num_blocks=blocks), fg)
    assert streaming.select_tier(sizes, 10e9) == tier


def test_jax_streaming_checkpoint_resumes_in_the_port(tmp_path, jax_run):
    b, jr, init = jax_run
    ck = str(tmp_path / "ck")
    _jax(b, dict(KW, max_it=2), checkpoint_dir=ck, checkpoint_every=1)
    # the port resumes at iteration 2 (its init is not read) and ends
    # where the uninterrupted JAX run does
    res = _port(b, KW, {k: np.zeros_like(v) for k, v in init.items()},
                checkpoint_dir=ck, stream_mode="paged")
    _assert_matches_jax(res, jr)


def test_checkpoint_resume_equals_uninterrupted(tmp_path, jax_run):
    b, _, init = jax_run
    full = _port(b, KW, init)
    ck = str(tmp_path / "ck")
    _port(b, dict(KW, max_it=2), init, checkpoint_dir=ck,
          checkpoint_every=1, stream_mode="device")
    res = _port(b, KW, init, checkpoint_dir=ck, stream_mode="kern")
    for field in ("d", "z", "Dz"):
        np.testing.assert_allclose(_f32(getattr(res, field)),
                                   _f32(getattr(full, field)), atol=1e-6)
    assert res.trace["obj_vals_z"] == pytest.approx(full.trace["obj_vals_z"],
                                                    rel=1e-6)


def _poison_z_block(monkeypatch, at_call):
    """The ``at_call``-th block z-pass (1-based) returns NaN codes, as a
    blown-up inner solve would (JAX's CCSC_FAULT_NAN_IT poisons block 0
    of the step it names)."""
    real = tlearn.f_z_block
    calls = {"n": 0}

    def f_z_block(*a, **kw):
        calls["n"] += 1
        z, dual = real(*a, **kw)
        if calls["n"] == at_call:
            z = torch.full_like(z, float("nan"))
        return z, dual

    monkeypatch.setattr(tlearn, "f_z_block", f_z_block)


@pytest.mark.parametrize("mode", TIERS)
def test_nan_recovery_restores_the_last_good_state(jax_run, monkeypatch,
                                                   tmp_path, mode):
    """Step 2's block 0 diverges; with max_recoveries=1 the state of step
    1 is restored and step 2 replayed at the backed-off rho, as the JAX
    learner does under CCSC_FAULT_NAN_IT=2. A snapshot that aliased a
    tensor written in place would replay from the poisoned state."""
    b, _, init = jax_run
    kw = dict(KW, max_recoveries=1)
    monkeypatch.setenv("CCSC_FAULT_NAN_IT", "2")
    monkeypatch.setenv("CCSC_FAULT_STATE_DIR", str(tmp_path))
    jfaults.reset()
    try:
        jr = _jax(b, kw)
    finally:
        jfaults.reset()
    _poison_z_block(monkeypatch, at_call=3)  # step 2, block 0
    res = _port(b, kw, init, stream_mode=mode)
    assert res.trace["recoveries"] == jr.trace["recoveries"]
    _assert_matches_jax(res, jr)


def test_nan_without_recovery_stops_after_the_last_good_step(jax_run,
                                                             monkeypatch):
    b, _, init = jax_run
    _poison_z_block(monkeypatch, at_call=3)
    res = _port(b, KW, init, stream_mode="paged")
    assert res.trace["diverged_at"] == 2
    assert len(res.trace["obj_vals_z"]) == 2  # the init entry and step 1
    assert "recoveries" not in res.trace


def test_refusals_name_their_reason_or_item():
    b = np.zeros((2, 8, 8), np.float32)
    geom = ProblemGeom((3, 3), 2)
    base = LearnConfig(max_it=1, num_blocks=2, verbose="none")
    with pytest.raises(ValueError, match="compat_coding"):
        streaming.learn_streaming(
            b, geom, dataclasses.replace(base, compat_coding="block1"),
            device="cpu")
    # the config refuses these first; the streaming learner holds its
    # own line too (its chunk cadence is a separate item); the watchdog
    # runs since the robustness slice
    for field, value, match in (
        ("donate_state", True, "donate_state"),
        ("outer_chunk", 2, "item 9"),
        ("watchdog", True, None),
    ):
        if match is None:
            cfg = dataclasses.replace(base, **{field: value})
            res = streaming.learn_streaming(b + 1.0, geom, cfg, device="cpu")
            assert res.trace["algorithm"] == "consensus_streaming"
            continue
        with pytest.raises((ValueError, NotImplementedError), match=match):
            dataclasses.replace(base, **{field: value})
        cfg = dataclasses.replace(base)
        object.__setattr__(cfg, field, value)
        with pytest.raises((ValueError, NotImplementedError), match=match):
            streaming.learn_streaming(b, geom, cfg, device="cpu")


def test_default_device_is_the_card():
    b = np.zeros((2, 8, 8), np.float32)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        streaming.learn_streaming(b, ProblemGeom((3, 3), 2),
                                  LearnConfig(max_it=1, num_blocks=2))


def test_default_init_is_drawn_on_the_host_from_seed_0():
    b = _data()
    cfg = LearnConfig(**dict(KW, max_it=1))
    geom = ProblemGeom(*GEOM)
    a = streaming.learn_streaming(b, geom, cfg, device="cpu")
    fg = tcommon.FreqGeom.create(geom, (12, 12))
    init = tlearn.init_state(torch.Generator().manual_seed(0), geom, fg, 2, 2)
    c = streaming.learn_streaming(b, geom, cfg, device="cpu",
                                  initial_state=init)
    assert torch.equal(a.z, c.z) and torch.equal(a.d, c.d)


def test_preemption_checkpoints_and_the_resume_finishes_the_run(
        jax_run, monkeypatch, tmp_path):
    """A SIGTERM during step 1 checkpoints at the step boundary and
    exits; the resumed run ends where the uninterrupted one does."""
    from ccsc_code_iccv2017_torch.utils import resilience

    class Signalled(resilience.GracefulShutdown):
        def __enter__(self):
            self.requested, self.signum = True, 15
            return self

    b, _, init = jax_run
    full = _port(b, KW, init)
    ck = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        m.setattr(resilience, "GracefulShutdown", Signalled)
        cut = _port(b, KW, init, checkpoint_dir=ck, stream_mode="paged")
    assert cut.trace["preemptions"] == [1]
    assert len(cut.trace["obj_vals_z"]) == 2
    res = _port(b, KW, init, checkpoint_dir=ck)
    assert res.trace["preemptions"] == [1]
    for field in ("d", "z", "Dz"):
        np.testing.assert_allclose(_f32(getattr(res, field)),
                                   _f32(getattr(full, field)), atol=1e-6)
