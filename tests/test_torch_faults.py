"""Chaos faults (``utils/faults.py``) and their seams in the port's
learners and checkpoint, against the JAX package's ``utils.faults`` and
learners on the CPU.

The port's ``faults`` is a copy: the same env knobs give the same fire
decisions, markers (``fault-fired-<name>.json``) and records. Its seams
are JAX's: the NaN poison inside the step of ``CCSC_FAULT_NAN_IT`` (on
the device, a ``torch.where`` on a flag), the checkpoint crash between
the payload and the commit, SIGTERM at the boundary after a step. The
learners start from the JAX ``init_state`` (``convert``,
``initial_state=``) and are held to the learners' own parity tolerances:
objective traces rtol 1e-4, filters within 1e-4 of their scale.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.config import LearnConfig as JCfg
from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.models import learn as jlearn
from ccsc_code_iccv2017_tpu.models import learn_masked as jlm
from ccsc_code_iccv2017_tpu.utils import faults as jfaults
from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.models import learn_masked as tlm
from ccsc_code_iccv2017_torch.parallel import consensus
from ccsc_code_iccv2017_torch.utils import checkpoint as ckpt
from ccsc_code_iccv2017_torch.utils import faults, obs

import test_torch_learn as tl
import test_torch_learn_masked as tlmt
import test_torch_streaming as tst

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_FAULT_ENV = (
    "CCSC_FAULT_NAN_IT", "CCSC_FAULT_CKPT_SAVE", "CCSC_FAULT_SIGTERM_IT",
    "CCSC_FAULT_HANG_IT", "CCSC_FAULT_HANG_S", "CCSC_FAULT_STATE_DIR",
    "CCSC_FAULT_ENGINE_KILL_REQ", "CCSC_FAULT_ENGINE_HANG_REQ",
    "CCSC_FAULT_ENGINE_HANG_S", "CCSC_FAULT_ENGINE_KILL_REPLICA",
    "CCSC_FAULT_ENGINE_HANG_REPLICA", "CCSC_FAULT_ENGINE_SLOW_REQ",
    "CCSC_FAULT_ENGINE_SLOW_S", "CCSC_FAULT_ENGINE_SLOW_REPLICA",
    "CCSC_FAULT_CTRL_SENSOR_BLACKOUT", "CCSC_FAULT_CTRL_BLACKOUT_S",
    "CCSC_FAULT_CTRL_ACT_HANG", "CCSC_FAULT_CTRL_ACT_HANG_S",
    "CCSC_FAULT_CTRL_CRASH_SCALE",
)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for v in _FAULT_ENV:
        monkeypatch.delenv(v, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _decisions(mod):
    """Every fault point of ``mod`` queried in one fixed order (no point
    that sleeps or signals: HANG_S and the engine sleeps are 0)."""
    out = [("nan", mod.nan_iteration())]
    mod.consume_nan()
    out.append(("nan_after", mod.nan_iteration()))
    mod.hang_tick(0)
    for r in (0, 1, 2):
        for seq in (1, 2, 3):
            out.append(("kill", r, seq, mod.engine_kill_request(r, seq)))
            out.append(("hang", r, seq, mod.engine_hang_request(r, seq)))
            out.append(("slow", r, seq, mod.engine_slow_request(r, seq)))
    for tick in (1, 2, 3):
        out.append(("blackout", tick, mod.ctrl_sensor_blackout(tick)))
    out += [("act", mod.ctrl_actuator_hang()) for _ in range(3)]
    out += [("crash", mod.ctrl_crash_mid_scale()) for _ in range(2)]
    return out


@pytest.mark.parametrize("env", [
    {},
    {"CCSC_FAULT_NAN_IT": "3", "CCSC_FAULT_ENGINE_KILL_REQ": "2"},
    {"CCSC_FAULT_ENGINE_KILL_REQ": "1",
     "CCSC_FAULT_ENGINE_KILL_REPLICA": "0,2",
     "CCSC_FAULT_ENGINE_HANG_REQ": "2", "CCSC_FAULT_ENGINE_HANG_S": "0",
     "CCSC_FAULT_ENGINE_HANG_REPLICA": "1"},
    {"CCSC_FAULT_ENGINE_SLOW_REQ": "2", "CCSC_FAULT_ENGINE_SLOW_S": "0",
     "CCSC_FAULT_ENGINE_SLOW_REPLICA": "bogus"},
    {"CCSC_FAULT_CTRL_SENSOR_BLACKOUT": "2",
     "CCSC_FAULT_CTRL_BLACKOUT_S": "60", "CCSC_FAULT_CTRL_ACT_HANG": "2",
     "CCSC_FAULT_CTRL_ACT_HANG_S": "0", "CCSC_FAULT_CTRL_CRASH_SCALE": "1"},
    {"CCSC_FAULT_NAN_IT": "x", "CCSC_FAULT_HANG_IT": "1",
     "CCSC_FAULT_HANG_S": "0"},
], ids=["unarmed", "nan+kill", "replica-lists", "slow+malformed-list",
        "control-plane", "malformed-int"])
def test_same_env_gives_the_same_fire_decisions(monkeypatch, tmp_path, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = {}
    for name, mod in (("port", faults), ("jax", jfaults)):
        # each package its own marker dir: the decisions, not the files,
        # are compared
        monkeypatch.setenv("CCSC_FAULT_STATE_DIR", str(tmp_path / name))
        got[name] = _decisions(mod)
        got[name + "_markers"] = sorted(os.listdir(tmp_path / name)) \
            if (tmp_path / name).exists() else []
    assert got["port"] == got["jax"]
    assert got["port_markers"] == got["jax_markers"]


def test_fire_once_survives_a_process_restart(monkeypatch, tmp_path):
    """A marker written by one process keeps the fault consumed in the
    next (the supervisor's restart), in either package."""
    state = str(tmp_path)
    env = dict(os.environ, CCSC_FAULT_NAN_IT="2", CCSC_FAULT_STATE_DIR=state,
               PYTHONPATH=REPO)
    code = ("from ccsc_code_iccv2017_torch.utils import faults; "
            "assert faults.nan_iteration() == 2; faults.consume_nan(); "
            "print('consumed')")
    proc = subprocess.run([sys.executable, "-c", code], env=env, timeout=120,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    with open(os.path.join(state, "fault-fired-nan.json")) as f:
        assert json.load(f)["fault"] == "nan"
    monkeypatch.setenv("CCSC_FAULT_NAN_IT", "2")
    monkeypatch.setenv("CCSC_FAULT_STATE_DIR", state)
    assert faults.nan_iteration() is None
    assert jfaults.nan_iteration() is None  # JAX reads the port's marker
    # without the marker dir the consumption is process-local
    monkeypatch.setenv("CCSC_FAULT_STATE_DIR", str(tmp_path / "other"))
    faults.reset()
    assert faults.nan_iteration() == 2


def test_fired_faults_are_recorded_in_the_stream(monkeypatch, tmp_path):
    """With no state dir the markers go beside the run's stream, with a
    ``fault_fired`` record in it, as in JAX."""
    mdir = str(tmp_path / "m")
    monkeypatch.setenv("CCSC_FAULT_SIGTERM_IT", "5")
    run = obs.start_run(mdir, algorithm="consensus", verbose="none",
                        device="cpu")
    try:
        monkeypatch.setenv("CCSC_FAULT_HANG_IT", "1")
        monkeypatch.setenv("CCSC_FAULT_HANG_S", "0")
        faults.hang_tick(1)
        faults.hang_tick(2)  # fire-once
    finally:
        run.close()
    fired = [e for e in obs.read_events(mdir) if e["type"] == "fault_fired"]
    assert [(e["fault"], e["iteration"], e["sleep_s"]) for e in fired] == [
        ("hang", 1, 0.0)]
    assert os.path.exists(os.path.join(mdir, "fault-fired-hang.json"))


def test_checkpoint_save_crash_keeps_the_previous_snapshot(monkeypatch,
                                                           tmp_path):
    b = tl._golden_data()
    init = tl._port_state(tl._jax_init(b))
    ck = str(tmp_path / "ck")
    ckpt.save(ck, init, {"obj_vals_z": [1.0]}, 1, fingerprint="f")
    monkeypatch.setenv("CCSC_FAULT_CKPT_SAVE", "1")
    moved = init._replace(z=init.z + 1.0)
    with pytest.raises(faults.InjectedFault):
        ckpt.save(ck, moved, {"obj_vals_z": [2.0]}, 2, fingerprint="f")
    # the previous generation is intact and no temporary file is left
    fields, trace, it = ckpt.load(ck, expect_fingerprint="f")
    assert it == 1 and trace == {"obj_vals_z": [1.0]}
    assert torch.equal(fields["z"], init.z)
    assert not [n for n in os.listdir(ck) if n.endswith(".tmp")]
    # the fault fired once: the next save commits
    ckpt.save(ck, moved, {"obj_vals_z": [2.0]}, 2, fingerprint="f")
    fields, _, it = ckpt.load(ck, expect_fingerprint="f")
    assert it == 2 and torch.equal(fields["z"], moved.z)


def _consensus_both(kw):
    b = tl._golden_data()
    jr = jlearn.learn(jnp.asarray(b), JGeom(*tl.GEOM), JCfg(**kw),
                      key=jax.random.PRNGKey(42))
    tr = tl._port_learn(b, kw, tl._jax_init(b))
    return jr, tr


def _masked_both(kw):
    ga = tlmt.GEOMS["hs"]
    b, sm = tlmt._data(ga)
    return tlmt._run_both(b, sm, ga, kw, gamma_div_d=50.0, gamma_div_z=10.0)


def _streaming_both(kw):
    b = tst._data()
    init = tst._jax_init(b, tst.GEOM, kw)
    return tst._jax(b, kw), tst._port(b, kw, init, stream_mode="paged")


def _assert_close(tr, jr):
    for k in ("obj_vals_d", "obj_vals_z"):
        np.testing.assert_allclose(tr.trace[k], jr.trace[k], rtol=1e-4)
    ref = np.asarray(jr.d)
    got = tr.d.float().numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("learner", ["consensus", "masked", "streaming"])
def test_nan_recovery_matches_jax(monkeypatch, learner):
    """``CCSC_FAULT_NAN_IT=2`` with one recovery: the port's learners
    poison the same step, back off rho the same way (JAX's
    ``trace['recoveries']``) and land within the learners' tolerances."""
    monkeypatch.setenv("CCSC_FAULT_NAN_IT", "2")
    if learner == "consensus":
        kw = dict(tl.GOLDEN_KW, max_it=3, max_recoveries=1)
        jr, tr = _consensus_both(kw)
    elif learner == "masked":
        kw = dict(tlmt.STEP_KW, max_it=3, max_recoveries=1, tol=0.0)
        jr, tr = _masked_both(kw)
    else:
        kw = dict(tst.KW, max_recoveries=1)
        jr, tr = _streaming_both(kw)
    assert jr.trace["recoveries"], "the JAX learner did not recover"
    assert tr.trace["recoveries"] == jr.trace["recoveries"]
    assert faults.nan_iteration() is None  # consumed
    _assert_close(tr, jr)


@pytest.mark.parametrize("learner", ["consensus", "masked", "streaming"])
def test_sigterm_checkpoints_and_the_resume_equals_the_uninterrupted_run(
        monkeypatch, tmp_path, learner):
    """``CCSC_FAULT_SIGTERM_IT=1``: the step-1 boundary raises SIGTERM,
    the learner checkpoints iteration 1 and stops (JAX's
    ``trace['preemptions']``); the resume (the fault consumed) ends where
    the uninterrupted run ends."""
    ck = str(tmp_path / "ck")
    if learner == "consensus":
        kw = dict(tl.GOLDEN_KW, max_it=3)
        b = tl._golden_data()
        init = tl._jax_init(b)

        def run(**extra):
            return tl._port_learn(b, kw, init, **extra)

        def jrun(**extra):
            return jlearn.learn(jnp.asarray(b), JGeom(*tl.GEOM), JCfg(**kw),
                                key=jax.random.PRNGKey(42), **extra)
    elif learner == "masked":
        kw = dict(tlmt.STEP_KW, max_it=3, tol=0.0)
        ga = tlmt.GEOMS["hs"]
        b, sm = tlmt._data(ga)
        init = tlmt._jax_init(b, ga, jax.random.PRNGKey(1))

        def run(**extra):
            return tlmt._port_learn(b, sm, ga, kw, init, **extra)

        def jrun(**extra):
            return jlm.learn_masked(
                jnp.asarray(b), JGeom(*ga), JCfg(**kw),
                smooth_init=jnp.asarray(sm), key=jax.random.PRNGKey(1),
                gamma_div_d=50.0, gamma_div_z=10.0, **extra)
    else:
        kw = dict(tst.KW)
        b = tst._data()
        init = tst._jax_init(b, tst.GEOM, kw)

        def run(**extra):
            return tst._port(b, kw, init, stream_mode="paged", **extra)

        def jrun(**extra):
            return tst._jax(b, kw, **extra)

    full = run()
    monkeypatch.setenv("CCSC_FAULT_SIGTERM_IT", "1")
    # a marker dir each: the packages write the same marker name
    monkeypatch.setenv("CCSC_FAULT_STATE_DIR", str(tmp_path / "jstate"))
    jpre = jrun(checkpoint_dir=str(tmp_path / "jck"), checkpoint_every=10)
    monkeypatch.setenv("CCSC_FAULT_STATE_DIR", str(tmp_path / "state"))
    pre = run(checkpoint_dir=ck, checkpoint_every=10)
    assert pre.trace["preemptions"] == jpre.trace["preemptions"] == [1]
    assert len(pre.trace["obj_vals_z"]) == len(jpre.trace["obj_vals_z"])
    assert ckpt.load(ck)[2] == 1
    resumed = run(checkpoint_dir=ck)  # the marker keeps SIGTERM consumed
    assert "preemptions" in resumed.trace  # carried by the checkpoint
    for k in ("obj_vals_d", "obj_vals_z", "d_diff", "z_diff"):
        np.testing.assert_allclose(resumed.trace[k], full.trace[k],
                                   rtol=1e-6)
    np.testing.assert_allclose(resumed.d.float().numpy(),
                               full.d.float().numpy(), atol=1e-7)
