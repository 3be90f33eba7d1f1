"""The port's deterministic traffic replay
(``ccsc_code_iccv2017_torch.serve.replay``) and its perf-gate CLI
(``ccsc_code_iccv2017_torch.analysis.perf_gate``) held to the JAX
package's ``serve.replay`` and ``scripts/perf_gate.py``, on the CPU:

- ``generate_diurnal`` with one seed writes the same capture in both
  packages: byte-identical payloads and the same records apart from
  the recorder's random session id;
- a capture of a port fleet replayed through a fresh port fleet is
  bit-identical request for request, in open loop at max speed and in
  closed loop, with zero lost; the replay CLI does the same;
- the ``replay_summary`` record and the ``kind=replay`` ledger record
  carry the JAX package's keys;
- the perf gate returns the JAX gate's exit codes on the same ledger
  files (no history, young history, pass, regression, a bad record).

The bank is k=4 3x3, the bucket 2 slots of 12x12, max_it 3.
"""
import json
import os
import sys

import numpy as np
import pytest

from ccsc_code_iccv2017_torch.analysis import ledger as tledger
from ccsc_code_iccv2017_torch.analysis import perf_gate as tgate
from ccsc_code_iccv2017_torch.serve import capture as tcap
from ccsc_code_iccv2017_torch.serve import replay as treplay
from ccsc_code_iccv2017_torch.utils import obs as tobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bank(k=4, sup=3, seed=0):
    r = np.random.default_rng(seed)
    d = r.normal(size=(k, sup, sup)).astype(np.float32)
    d /= np.sqrt((d**2).sum(axis=(1, 2), keepdims=True))
    return d


def _fleet(pkg, tmp, cap_dir=None, replicas=2, metrics_sub="metrics"):
    """A fleet of either package: ``pkg`` is 'torch' or 'jax'."""
    import importlib

    root = ("ccsc_code_iccv2017_torch" if pkg == "torch"
            else "ccsc_code_iccv2017_tpu")
    config = importlib.import_module(root + ".config")
    recon = importlib.import_module(root + ".models.reconstruct")
    serve = importlib.import_module(root + ".serve")
    geom = config.ProblemGeom((3, 3), 4)
    cfg = config.SolveConfig(
        lambda_residual=5.0, lambda_prior=0.3, max_it=3, tol=0.0,
        verbose="none", track_psnr=True, track_objective=True,
    )
    scfg = config.ServeConfig(buckets=((2, (12, 12)),), max_wait_ms=2.0,
                              verbose="none")
    # the JAX fleet writes no stream: its run's compile monitor would
    # outlive it in this process and count later tests' XLA compiles
    fcfg = config.FleetConfig(
        replicas=replicas,
        metrics_dir=(os.path.join(tmp, metrics_sub) if pkg == "torch"
                     else None),
        capture_dir=cap_dir, min_queue_depth=64, restart_backoff_s=0.05,
        verbose="none",
    )
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return serve.ServeFleet(_bank(), recon.ReconstructionProblem(geom),
                            cfg, scfg, fcfg, **kw)


def _capture(pkg, tmp, n=6, seed=0):
    cap_dir = os.path.join(tmp, f"capture-{pkg}")
    fleet = _fleet(pkg, tmp, cap_dir=cap_dir, metrics_sub=f"m-{pkg}")
    r = np.random.default_rng(seed)
    futs = []
    for i in range(n):
        x = r.random((12, 12)).astype(np.float32)
        m = (r.random((12, 12)) < 0.5).astype(np.float32)
        futs.append(fleet.submit(x * m, mask=m, x_orig=x, key=f"q{i}"))
    for f in futs:
        f.result(timeout=180)
    fleet.close()
    return cap_dir


def _files(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_diurnal_capture_matches_jax(tmp_path):
    from ccsc_code_iccv2017_tpu.serve.replay import (
        generate_diurnal as jgen,
    )

    kw = dict(n_requests=12, duration_s=30.0, spatial=(8, 8), seed=3)
    jd = jgen(str(tmp_path / "j"), **kw)
    td = treplay.generate_diurnal(str(tmp_path / "t"), **kw)
    jf, tf = _files(jd), _files(td)
    assert sorted(tf) == sorted(jf)
    for name in jf:
        if name == "meta.json":
            continue  # carries the wall clock of the two runs
        if name.endswith(".jsonl"):
            # the same records apart from the recorder's random
            # session id (two JAX runs differ there too)
            def recs(raw):
                return [{k: v for k, v in json.loads(ln).items()
                         if k != "session"}
                        for ln in raw.decode().splitlines()]

            assert recs(tf[name]) == recs(jf[name]), name
        else:
            assert tf[name] == jf[name], name  # payload bytes
    jm, tm = (json.loads(x["meta.json"]) for x in (jf, tf))
    assert sorted(tm) == sorted(jm)
    assert {k: tm[k] for k in ("synthetic", "seed", "amp", "keep",
                                "duration_s")} == {
        k: jm[k] for k in ("synthetic", "seed", "amp", "keep",
                           "duration_s")}
    w = tcap.read_workload(td)
    ts = [r["t_rel"] for r in w]
    assert len(w) == 12 and ts == sorted(ts)
    gaps = np.diff(ts)
    assert gaps[len(gaps) // 2] < gaps[0]  # peak gap < trough gap


@pytest.mark.parametrize("mode, speed", [("open", 0.0), ("closed", 1.0)],
                         ids=["open_max_speed", "closed_loop"])
def test_port_capture_replays_bit_identical(tmp_path, mode, speed):
    tmp = str(tmp_path)
    cap_dir = _capture("torch", tmp)
    w = tcap.read_workload(cap_dir)
    assert len(w) == 6 and all(r["outcome"] for r in w)
    fresh = _fleet("torch", tmp, metrics_sub="replay-fleet")
    try:
        rep = treplay.ReplayDriver(
            cap_dir, metrics_dir=os.path.join(tmp, "replay-m")
        ).replay(fresh, speed=speed, mode=mode)
    finally:
        fresh.close()
    assert rep["n_replayed"] == 6 and rep["n_lost"] == 0
    assert rep["n_mismatched"] == 0 and rep["n_exact"] == 6 and rep["ok"]
    evs = tobs.read_events(os.path.join(tmp, "replay-m"))
    assert [e["status"] for e in evs if e["type"] == "replay_request"] \
        == ["match_exact"] * 6


def test_replay_records_carry_jax_keys(tmp_path, monkeypatch):
    """The port's replay_summary event and kind=replay ledger record
    have the JAX package's keys; both gates judge the port's ledger
    alike."""
    from ccsc_code_iccv2017_tpu.analysis import ledger as jledger
    from ccsc_code_iccv2017_tpu.serve.replay import ReplayDriver as JDriver
    from ccsc_code_iccv2017_tpu.utils import obs as jobs

    tmp = str(tmp_path)
    out = {}
    for pkg, driver, obs_mod, led_mod in (
            ("jax", JDriver, jobs, jledger),
            ("torch", treplay.ReplayDriver, tobs, tledger)):
        ledger_path = os.path.join(tmp, f"ledger-{pkg}.jsonl")
        monkeypatch.setenv("CCSC_PERF_LEDGER", ledger_path)
        cap_dir = _capture(pkg, tmp)
        fresh = _fleet(pkg, tmp, metrics_sub=f"replay-fleet-{pkg}")
        mdir = os.path.join(tmp, f"replay-m-{pkg}")
        try:
            rep = driver(cap_dir, metrics_dir=mdir).replay(
                fresh, speed=0.0, mode="open")
        finally:
            fresh.close()
        assert rep["n_exact"] == 6 and rep["ok"]
        (summary,) = [e for e in obs_mod.read_events(mdir)
                      if e["type"] == "replay_summary"]
        (lrec,) = [r for r in led_mod.Ledger(ledger_path).read()
                   if r["kind"] == "replay"]
        out[pkg] = (rep, summary, lrec, ledger_path)
    jrep, jsum, jrec, _ = out["jax"]
    trep, tsum, trec, tpath = out["torch"]
    assert sorted(trep) == sorted(jrep)
    drop = {"run_id", "host", "process_index", "pid"}
    assert sorted(set(tsum) - drop) == sorted(set(jsum) - drop)
    assert sorted(trec) == sorted(jrec)
    assert trec["unit"] == jrec["unit"] == "requests/sec"
    assert trec["workload"] == jrec["workload"]
    assert trec["shape_key"] == jrec["shape_key"]
    assert trec["knobs"] == jrec["knobs"]
    assert trec["source"] == "serve.replay" and trec["chip"] == "cpu"
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import perf_gate as jgate
    finally:
        sys.path.pop(0)
    assert jgate.main(["--ledger", tpath]) == 0
    assert tgate.main(["--ledger", tpath]) == 0


def _rec(value, **kw):
    base = dict(chip="h100", kind="replay", value=value,
                unit="requests/sec", workload="solve_2d_k4_s3",
                shape_key="k4|s3x3|12x12", knobs={"mode": "open"},
                source="serve.replay")
    base.update(kw)
    return tledger.normalize_record(**base)


def _ledger(path, values, **kw):
    led = tledger.Ledger(str(path))
    for v in values:
        led.append(_rec(v, **kw))
    return str(path)


@pytest.mark.parametrize("case", [
    "no_history", "young_history", "steady", "regression",
    "regression_other_kind", "list", "bad_record", "seed_from",
])
def test_perf_gate_exit_codes_match_jax(tmp_path, case, capsys):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import perf_gate as jgate
    finally:
        sys.path.pop(0)
    p = tmp_path / "ledger.jsonl"
    argv = ["--ledger", str(p)]
    if case == "young_history":
        _ledger(p, [10.0, 9.0])
    elif case == "steady":
        _ledger(p, [10.0, 10.1, 9.9, 10.05, 9.95])
    elif case == "regression":
        _ledger(p, [10.0, 10.1, 9.9, 10.05, 1.0])
        argv += ["--kind", "replay"]
    elif case == "regression_other_kind":
        _ledger(p, [10.0, 10.1, 9.9, 10.05, 1.0])
        argv += ["--kind", "serve"]
    elif case == "list":
        _ledger(p, [10.0, 10.1, 9.9])
        argv += ["--list", "--json"]
    elif case == "bad_record":
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"kind": "replay", "value": 1.0}))
        argv += ["--record", str(bad)]
    elif case == "seed_from":
        argv += ["--seed-from", str(tmp_path / "none.json")]
    if case == "seed_from":
        # the port refuses to seed from the JAX package's bench rounds
        assert tgate.main(argv) == 2
        return
    rj = jgate.main(argv)
    jout = capsys.readouterr().out
    rt = tgate.main(argv)
    tout = capsys.readouterr().out
    assert rt == rj
    assert {"no_history": 0, "young_history": 0, "steady": 0,
            "regression": 1, "regression_other_kind": 0, "list": 0,
            "bad_record": 2}[case] == rt
    if case == "list":
        assert json.loads(tout) == json.loads(jout)
    elif case != "bad_record":
        assert tout.splitlines()[-1].split(" (")[0] == \
            jout.splitlines()[-1].split(" (")[0]


def test_replay_cli_generates_and_replays(tmp_path, capsys):
    tmp = str(tmp_path)
    out = os.path.join(tmp, "diurnal")
    assert treplay.main(["--generate-diurnal", out, "--requests", "4",
                         "--duration", "1", "--side", "12"]) == 0
    assert len(tcap.read_workload(out)) == 4
    cap_dir = _capture("torch", tmp, n=4, seed=5)
    rc = treplay.main([cap_dir, "--max-speed", "--replicas", "1",
                       "--device", "cpu", "--json"])
    text = capsys.readouterr().out
    rep = json.loads(text[text.index("{"):])
    assert rc == 0 and rep["n_exact"] == 4 and rep["n_lost"] == 0
    assert treplay.build_parser().parse_args([]).device == "cuda"
