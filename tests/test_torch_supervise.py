"""The run supervisor (``ccsc_code_iccv2017_torch.supervise``, the port
of the JAX package's ``scripts/supervise.py``) on the CPU: a SIGTERM
restart and a watchdog hang-abort restart of the port's learner each end
where the unfaulted run ends; a poison run exits 2 with its diagnosis;
the stall kill; multi-child mode; and the same judgments, traces and
exit codes as the JAX supervisor on the same streams."""
import json
import os
import sys
import time

import numpy as np
import pytest

from ccsc_code_iccv2017_torch import supervise
from ccsc_code_iccv2017_torch.utils import checkpoint as ckpt
from ccsc_code_iccv2017_torch.utils import obs, watchdog

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import supervise as jsupervise  # noqa: E402

sys.path.pop(0)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for v in ("CCSC_FAULT_SIGTERM_IT", "CCSC_FAULT_HANG_IT",
              "CCSC_FAULT_HANG_S", "CCSC_FAULT_STATE_DIR",
              "CCSC_WATCHDOG_ACTION", "CCSC_WATCHDOG_MIN_S",
              "CCSC_WATCHDOG_COMPILE_S"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("PYTHONPATH", REPO)


WORKER = """
import numpy as np
from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.parallel import consensus
b = np.random.default_rng(1).standard_normal((4, 12, 12)).astype(np.float32)
cfg = LearnConfig(max_it=4, max_it_d=2, max_it_z=2, num_blocks=2,
                  rho_d=50.0, rho_z=2.0, tol=0.0, verbose="none",
                  track_objective=True, watchdog={watchdog!r},
                  metrics_dir={mdir!r})
consensus.learn(b, ProblemGeom((3, 3), 4), cfg, device="cpu",
                checkpoint_dir={ck!r}, checkpoint_every=1)
"""


def _worker(tmp_path, ck, mdir, watchdog_on=False):
    w = tmp_path / "worker.py"
    w.write_text(WORKER.format(watchdog=watchdog_on, mdir=mdir, ck=ck))
    return str(w)


def _supervised(ck, mdir, worker, *extra):
    rc = supervise.main(["--checkpoint-dir", ck, "--metrics-dir", mdir,
                         "--max-restarts", "3", "--backoff", "0", *extra,
                         "--", sys.executable, worker])
    with open(os.path.join(mdir, "supervisor_trace.json")) as f:
        return rc, json.load(f)


def _unfaulted(tmp_path):
    ck, m = str(tmp_path / "full"), str(tmp_path / "full_m")
    exec(compile(WORKER.format(watchdog=False, mdir=m, ck=ck), "w", "exec"),
         {})
    return ck


def _assert_same_state(dir_a, dir_b):
    fa, ta, ia = ckpt.load(dir_a)
    fb, tb, ib = ckpt.load(dir_b)
    assert ia == ib == 4
    for k in fa:  # the duals too
        np.testing.assert_array_equal(fa[k].numpy(), fb[k].numpy(),
                                      err_msg=k)
    for k in ("obj_vals_d", "obj_vals_z", "d_diff", "z_diff"):
        assert ta[k] == tb[k]


def test_sigterm_restart_matches_the_unfaulted_run(monkeypatch, tmp_path):
    """SIGTERM at step 2: the attempt checkpoints and exits 0 with a
    preemption record; the supervisor resumes it (the fault stays
    consumed through its marker) and the final state is the unfaulted
    run's."""
    full = _unfaulted(tmp_path)
    ck, m = str(tmp_path / "ck"), str(tmp_path / "m")
    monkeypatch.setenv("CCSC_FAULT_SIGTERM_IT", "2")
    rc, trace = _supervised(ck, m, _worker(tmp_path, ck, m))
    assert rc == supervise.EXIT_OK, trace
    assert [a["reason"] for a in trace["attempts"]] == ["preempted",
                                                         "completed"]
    assert trace["outcome"] == "completed" and trace["resumes"] == 1
    _assert_same_state(full, ck)
    assert os.path.exists(os.path.join(m, "fault-fired-sigterm.json"))
    fired = [e["fault"] for e in obs.read_events(m)
             if e["type"] == "fault_fired"]
    assert fired == ["sigterm"]


def test_hang_abort_restart_matches_the_unfaulted_run(monkeypatch,
                                                      tmp_path):
    """A hang inside the step-2 fence: the watchdog aborts with 87, the
    supervisor restarts from the step-1 checkpoint, the hang does not
    re-fire, and the final state is the unfaulted run's."""
    full = _unfaulted(tmp_path)
    ck, m = str(tmp_path / "ck"), str(tmp_path / "m")
    monkeypatch.setenv("CCSC_FAULT_HANG_IT", "2")
    monkeypatch.setenv("CCSC_FAULT_HANG_S", "3600")
    # a floor far above a step of this size, even on a loaded host
    monkeypatch.setenv("CCSC_WATCHDOG_MIN_S", "4")
    monkeypatch.setenv("CCSC_WATCHDOG_COMPILE_S", "60")
    rc, trace = _supervised(ck, m, _worker(tmp_path, ck, m, True))
    assert rc == supervise.EXIT_OK, trace
    assert [a["reason"] for a in trace["attempts"]] == ["stall_abort",
                                                         "completed"]
    assert trace["attempts"][0]["rc"] == watchdog.EXIT_STALL
    assert trace["attempts"][1]["checkpoint_at_start"]
    _assert_same_state(full, ck)
    events = obs.read_events(m)
    assert [e["label"] for e in events if e["type"] == "stall"] == [
        "ccsc_outer_1"]
    assert [e["fault"] for e in events if e["type"] == "fault_fired"] == [
        "hang"]


def test_poison_run_exits_2_with_its_diagnosis(tmp_path, capsys):
    rc = supervise.main([
        "--checkpoint-dir", str(tmp_path / "ck"),
        "--metrics-dir", str(tmp_path / "m"), "--max-restarts", "5",
        "--backoff", "0", "--",
        sys.executable, "-c", "import sys; print('dying in setup'); "
        "sys.exit(1)"])
    assert rc == supervise.EXIT_POISON == jsupervise.EXIT_POISON == 2
    with open(tmp_path / "m" / "supervisor_trace.json") as f:
        trace = json.load(f)
    assert trace["outcome"] == "poison"
    assert [a["reason"] for a in trace["attempts"]] == ["crash", "crash"]
    out = capsys.readouterr().out
    assert "POISON RUN" in out and "dying in setup" in out


def test_stall_kill(tmp_path):
    """A child that is alive but writes nothing for --stall-timeout is
    killed as hung; two such deaths before a checkpoint are a poison
    run."""
    t0 = time.monotonic()
    rc = supervise.main([
        "--checkpoint-dir", str(tmp_path / "ck"),
        "--metrics-dir", str(tmp_path / "m"), "--max-restarts", "4",
        "--backoff", "0", "--stall-timeout", "2", "--",
        sys.executable, "-c", "import time; time.sleep(600)"])
    assert rc == supervise.EXIT_POISON
    with open(tmp_path / "m" / "supervisor_trace.json") as f:
        trace = json.load(f)
    assert [a["reason"] for a in trace["attempts"]] == ["hang", "hang"]
    assert time.monotonic() - t0 < 60  # killed, not slept out


def test_multi_child_all_complete(tmp_path):
    m = str(tmp_path / "m")
    rc = supervise.main(["--metrics-dir", m, "--backoff", "0",
                         "--child", f"{sys.executable} -c pass",
                         "--child", f"{sys.executable} -c pass"])
    assert rc == 0
    for i in range(2):
        with open(os.path.join(m, f"child-{i:02d}",
                               "supervisor_trace.json")) as f:
            tr = json.load(f)
        assert (tr["outcome"], tr["label"]) == ("completed", f"child-{i:02d}")


def test_multi_child_sibling_failure_stops_the_others(tmp_path):
    m = str(tmp_path / "m")
    t0 = time.monotonic()
    rc = supervise.main([
        "--metrics-dir", m, "--max-restarts", "0", "--backoff", "0",
        "--trace", str(tmp_path / "fleet.json"),
        "--child", f"{sys.executable} -c 'import time; time.sleep(120)'",
        "--child", f"{sys.executable} -c 'raise SystemExit(1)'"])
    assert rc == supervise.EXIT_EXHAUSTED == 3
    assert time.monotonic() - t0 < 60
    with open(tmp_path / "fleet.json") as f:
        fleet = json.load(f)
    assert fleet["rc"] == 3
    assert {c["label"]: c["outcome"] for c in fleet["children"]} == {
        "child-00": "stopped", "child-01": "exhausted"}


@pytest.mark.parametrize("argv", [
    ["--metrics-dir", "a", "--metrics-dir", "b", "--metrics-dir", "c",
     "--child", "x", "--child", "y"],
    ["--child", "x", "--", "y"],
    [],
], ids=["dir-pairing", "child-and-command", "no-command"])
def test_usage_errors_exit_4_as_jax(tmp_path, argv):
    argv = [str(tmp_path / a) if a in "abc" else a for a in argv]
    assert supervise.main(argv) == jsupervise.main(argv) == 4


def _write(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def test_judgments_equal_jax(tmp_path, monkeypatch):
    """Per-dir preemption, the incremental tail, the progress stamp (one
    level of subdirs), dir pairing and the federate export, on the same
    streams, as the JAX supervisor judges them."""
    a, b = tmp_path / "r0", tmp_path / "r1"
    t0 = time.time()
    _write(str(a / "events-p00000.jsonl"),
           [{"t": t0, "type": "run_meta"},
            {"t": t0 + 1, "type": "preemption", "iteration": 2}])
    _write(str(b / "events-p00000.jsonl"),
           [{"t": t0 + 5, "type": "run_meta"}, {"t": t0 + 6, "type": "step"}])
    for dirs in ([str(a), str(b)], [str(b)], [str(a)]):
        assert supervise._attempt_preempted(dirs) == \
            jsupervise._attempt_preempted(dirs)
        assert supervise._PreemptionTail(dirs).preempted() == \
            jsupervise._PreemptionTail(dirs).preempted()
    assert supervise._attempt_preempted([str(a), str(b)]) is True
    assert supervise._progress_stamp([str(tmp_path)]) == \
        jsupervise._progress_stamp([str(tmp_path)])
    for dirs, n in (([], 2), (["p"], 3), (["x", "y"], 2)):
        assert supervise._pair_dirs(dirs, n, "--f") == \
            jsupervise._pair_dirs(dirs, n, "--f")
    # --federate exports the queue dir to every child, as in JAX
    out = str(tmp_path / "env.txt")
    rc = supervise.main([
        "--metrics-dir", str(tmp_path / "fm"), "--federate", "QDIR",
        "--backoff", "0", "--", sys.executable, "-c",
        "import os; open(%r, 'w').write(os.environ['CCSC_DQUEUE_DIR'] + "
        "'|' + os.environ['CCSC_FAULT_STATE_DIR'])" % out])
    assert rc == 0
    with open(out) as f:
        assert f.read() == "QDIR|" + str(tmp_path / "fm")
