"""Every cell run end to end on the CPU at a tiny size (the harness's look
for a card skipped): the reference agrees with the port; a cell, a
configuration, a traffic mix and a metric are added by files alone; and
``correct`` comes out false for the control and for the timed path
broken underneath, once for each fault a cell can have."""
from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from conftest import load, write
from portbench import run
from portbench.reference import consensus as ref_consensus
from portbench.reference import fourier, inpaint

SEED = 2 ** 31 + 11
SERVE = ("serve-inpaint256-poisson", "serve-inpaint256-one-client")
LEARN = "learn2d-northstar"


def _run(root, cell, seed=SEED, trace=False, **kw):
    if cell == LEARN:
        kw.setdefault("max_steps", 3)
    return run.run_cell(cell, seed, 1.5, trace, root=root, device="cpu",
                        t_start=time.perf_counter(), **kw)


def test_reference_solve_agrees_with_the_port():
    from ccsc_code_iccv2017_torch.config import ProblemGeom, SolveConfig
    from ccsc_code_iccv2017_torch.models.reconstruct import (
        ReconstructionProblem, reconstruct)
    from portbench import inputs

    cfg = load("portbench/configs/inpaint2d-k100-256.json")
    d = inputs.bank(dict(cfg, num_filters=8))
    q = inputs.inpaint_requests(5, 2, 32, torch.device("cpu"))
    params = dict(cfg["solve"], max_it=30)
    for j in range(2):
        ref, it = inpaint.solve(*(torch.from_numpy(q[k][j]) for k in
                                  ("b", "mask", "smooth_init")),
                                torch.from_numpy(d), params)
        res = reconstruct(
            q["b"][j][None], d, ReconstructionProblem(ProblemGeom((11, 11),
                                                                  8)),
            SolveConfig(**params), mask=q["mask"][j][None],
            smooth_init=q["smooth_init"][j][None], device="cpu")
        assert int(res.trace.num_iters) == it
        gap = (res.recon[0].double() - ref).abs().max() / ref.abs().max()
        assert gap < 1e-5


def test_reference_learner_agrees_with_the_port():
    from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
    from ccsc_code_iccv2017_torch.models.learn import LearnState
    from ccsc_code_iccv2017_torch.parallel import consensus

    cfg = load("portbench/configs/learn2d-k100-8x100.json")
    # 16 filters: with 8, ten d-iterations at rho_d 5000 shrink the
    # dictionary until every code is zero within a step, and the codes'
    # relative change is then a ratio of round-off on both sides
    L, ni, H, K = 2, 3, 20, 16
    S = H + 10
    g = torch.Generator().manual_seed(0)
    b = torch.randn(L * ni, H, H, generator=g)
    d0 = torch.randn(K, 11, 11, generator=g)
    z0 = torch.randn(L, ni, K, S, S, generator=g)
    d_full = fourier.embed(d0, (S, S))
    zd = torch.zeros(L, K, S, S)
    res = consensus.learn(
        b.numpy(), ProblemGeom((11, 11), K),
        LearnConfig(num_blocks=L, max_it=3, tol=0.0, **cfg["learn"]),
        device="cpu", initial_state=LearnState(
            d_full.expand(L, K, S, S).contiguous(), zd, d_full,
            torch.zeros(K, S, S), z0, torch.zeros_like(z0)))
    st = ref_consensus.State(*(t.double() for t in (
        d_full.expand(L, K, S, S), zd, d_full, torch.zeros(K, S, S), z0,
        torch.zeros_like(z0))))
    for i in range(1, 4):
        st, m = ref_consensus.outer_step(
            st, b.double().reshape(L, ni, H, H), cfg["learn"])
        for key, name in (("obj_vals_d", "obj_d"), ("obj_vals_z", "obj_z"),
                          ("d_diff", "d_diff"), ("z_diff", "z_diff")):
            assert res.trace[key][i] == pytest.approx(m[name], rel=1e-5)


@pytest.mark.parametrize("cell", SERVE + (LEARN,))
def test_cell_runs_correct(tiny_root, cell):
    r = _run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2


def test_traced_run_reports_per_layer_metrics(tiny_root):
    r = _run(tiny_root, "serve-inpaint256-one-client", trace=True)
    assert r["correct"]
    assert {"engine.queue_wait_ms.one", "solve.ms_per_iter.one"} <= set(
        r["metrics"])
    assert "setup_s" not in r["metrics"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "window_s" in r["device"] and "busy_s" in r["device"]


def test_same_seed_same_inputs():
    from portbench import inputs

    a = inputs.inpaint_requests(SEED, 3, 32, torch.device("cpu"))
    b = inputs.inpaint_requests(SEED, 3, 32, torch.device("cpu"))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    t1 = inputs.training_images(SEED, 2, 20, torch.device("cpu"))
    t2 = inputs.training_images(SEED, 2, 20, torch.device("cpu"))
    assert torch.equal(t1, t2)


def test_cells_configs_traffic_and_metrics_are_added_by_files(tiny_root):
    """A throwaway configuration, traffic mix, metric and cell, written
    as files and entries only: the harness finds and runs them."""
    bench = load("BENCHMARK.json")
    cfg = load("portbench/configs/inpaint2d-k100-256.json")
    cfg.update(name="inpaint2d-k8-24", num_filters=8, side=24,
               solve=dict(cfg["solve"], max_it=10),
               serve={"slots": 3, "max_wait_ms": 1.0},
               check=dict(cfg["check"], sample=2))
    write(tiny_root, "portbench/configs/inpaint2d-k8-24.json", cfg)
    write(tiny_root, "portbench/traffic/two-clients.json",
          {"driver": "closed_loop", "clients": 2, "pool": 5})
    mdir = os.path.join(tiny_root, "portbench", "metrics")
    os.makedirs(mdir)
    with open(os.path.join(mdir, "engine.requests_done.two.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.completed()))\n")
    bench["configs"].append({"name": "inpaint2d-k8-24", "source": "https://x",
                             "file": "portbench/configs/inpaint2d-k8-24.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "serve-two", "config":
                               "inpaint2d-k8-24", "traffic": "two-clients",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][1]["workloads"].append("serve-two")
    bench["per_layer"].append({"name": "engine.requests_done.two",
                               "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "latency_p50_ms",
                               "workloads": ["serve-two"]})
    write(tiny_root, "BENCHMARK.json", bench)
    r = _run(tiny_root, "serve-two")
    assert r["correct"] and set(r["metrics"]) == {"latency_p50_ms", "setup_s"}
    r = _run(tiny_root, "serve-two", trace=True)
    assert r["metrics"]["engine.requests_done.two"]["value"] == r["attempted"]


@pytest.mark.parametrize("cell", (SERVE[1], LEARN))
def test_control_is_not_correct(tiny_root, cell):
    """The program's bf16 code storage, the path a later change would be
    tempted by, fails the limits."""
    for seed in (1, 2, 3):
        r = _run(tiny_root, cell, seed=seed, control=True)
        assert not r["correct"], r["checks"]


def _fault_answer_altered(monkeypatch):
    from ccsc_code_iccv2017_torch.serve.engine import CodecEngine

    real = CodecEngine._readback

    def altered(self, out, cfg, has_x):
        host = real(self, out, cfg, has_x)
        host["recon"][:, ..., 7, 7] += 0.1
        return host
    monkeypatch.setattr(CodecEngine, "_readback", altered)


def _fault_solve_state_unchanged(monkeypatch):
    from ccsc_code_iccv2017_torch.ops import freq_solvers

    monkeypatch.setattr(freq_solvers, "solve_z",
                        lambda kern, xi1, xi2, rho, **kw: xi2 * 0)


def _fault_step_state_unchanged(monkeypatch):
    from ccsc_code_iccv2017_torch.parallel import consensus

    real = consensus.learn_mod.outer_step

    def unchanged(state, *a, **kw):
        _, m = real(state, *a, **kw)
        return state, m
    monkeypatch.setattr(consensus.learn_mod, "outer_step", unchanged)


def _fault_half_batch(monkeypatch):
    from ccsc_code_iccv2017_torch.parallel import consensus

    real = consensus.learn_mod.outer_step

    def half(state, b_blocks, *a, **kw):
        kept = b_blocks.clone()
        kept[:, kept.shape[1] // 2:] = 0  # half of each block's images
        return real(state, kept, *a, **kw)
    monkeypatch.setattr(consensus.learn_mod, "outer_step", half)


@pytest.mark.parametrize("cell,fault", [
    (SERVE[0], _fault_answer_altered),
    (SERVE[1], _fault_answer_altered),
    (SERVE[1], _fault_solve_state_unchanged),
    (LEARN, _fault_step_state_unchanged),
    (LEARN, _fault_half_batch),
], ids=["poisson-answer", "one-answer", "one-state", "learn-state",
        "learn-half"])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                          fault):
    fault(monkeypatch)
    r = _run(tiny_root, cell)
    assert not r["correct"], r["checks"]
