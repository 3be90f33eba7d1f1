"""The consensus learner on a mesh from each rank's own state, the mesh's
span and counters, the sharded float64 reference of the benchmark, and
the benchmark cell ``learn2d-weak-mesh4`` at a tiny cut.

One module-scoped ``parallel.distributed.launch`` of 4 gloo ranks runs
every rank-side case (``mesh_local_cases.run_cases``); the cell runs in
a process of its own, through ``portbench.run.run_cell`` on the CPU.
Limits: the JAX mesh tests' (traces rtol 1e-5, filters atol 2e-5)
against the one-device learn from the global state; 1e-12 between the
sharded reference and the whole one, both float64.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_torch import convert
from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.parallel import consensus, distributed
from portbench.reference import consensus as ref_consensus

import mesh_local_cases as cases

TESTS = os.path.dirname(os.path.abspath(__file__))
CFG = dict(max_it=3, max_it_d=3, max_it_z=3, rho_d=500.0, rho_z=10.0,
           lambda_prior=0.1, verbose="none", track_objective=True)
TRACE_RTOL, D_ATOL, REF_REL = 1e-5, 2e-5, 1e-12
TRACE_KEYS = ("obj_vals_d", "obj_vals_z", "d_diff", "z_diff")

# name: (geom, num_blocks, mesh constructor and arguments, init_d)
LOCAL_CASES = {
    "block4_n8": (((5, 5), 4), 8, ("block_mesh", (4,)), False),
    "block4_n4_init_d": (((5, 5), 8), 4, ("block_mesh", (4,)), True),
    "block2_filter2": (((5, 5), 8), 2, ("block_filter_mesh", (2, 2)), False),
}


def _data(n=8, size=16, seed=0):
    return np.random.default_rng(seed).normal(size=(n, size, size)).astype(
        np.float32)


def _global_state(geom, num_blocks, n, size, seed=1):
    """A global LearnState as numpy fields: randn filters embedded at the
    origin and randn codes (zero duals)."""
    g = torch.Generator().manual_seed(seed)
    (s, _), K = geom
    S = size + s - 1
    d_full = torch.zeros(K, S, S)
    d_full[:, :s, :s] = torch.randn(K, s, s, generator=g)
    d_full = torch.roll(d_full, (-(s // 2), -(s // 2)), (1, 2))
    z = torch.randn(num_blocks, n // num_blocks, K, S, S, generator=g)
    st = dict(d_local=d_full.expand(num_blocks, K, S, S), dual_d=torch.zeros(
        num_blocks, K, S, S), dbar=d_full, udbar=torch.zeros(K, S, S), z=z,
        dual_z=torch.zeros_like(z))
    return {k: np.ascontiguousarray(v.numpy()) for k, v in st.items()}


def _learn_spec(name):
    geom, nb, _, with_init_d = LOCAL_CASES[name]
    b = _data()
    spec = dict(b=b, geom=geom, cfg=dict(CFG, num_blocks=nb),
                init=_global_state(geom, nb, b.shape[0], b.shape[-1]))
    if with_init_d:
        spec["init_d"] = np.random.default_rng(5).normal(
            size=(geom[1], *geom[0])).astype(np.float32)
    return spec


def _ref_spec():
    b = _data(n=8, size=12)
    st = _global_state(((5, 5), 6), 4, 8, 12)
    return dict(b=b.reshape(4, 2, 12, 12).astype(np.float64),
                state={k: v.astype(np.float64) for k, v in st.items()},
                p=dict(lambda_residual=1.0, lambda_prior=1.0, max_it_d=4,
                       max_it_z=4, rho_d=500.0, rho_z=1.0),
                num_blocks=4, steps=2)


@pytest.fixture(scope="module")
def ranks():
    runs = [(name, "learn_local", LOCAL_CASES[name][2], _learn_spec(name))
            for name in LOCAL_CASES]
    runs.append(("span", "span", ("block_mesh", (4,)), None))
    runs.append(("sharded_ref", "sharded_ref", ("block_mesh", (4,)),
                 _ref_spec()))
    return distributed.launch(cases.run_cases, 4, args=(runs,),
                              device="cpu", timeout=60.0, join_timeout=240.0)


def _one_device(name):
    spec = _learn_spec(name)
    return consensus.learn(
        spec["b"], ProblemGeom(*spec["geom"]), LearnConfig(**spec["cfg"]),
        device="cpu", init_d=spec.get("init_d"),
        initial_state=convert.learn_state_from_jax(spec["init"], "cpu"))


@pytest.mark.parametrize("name", list(LOCAL_CASES))
def test_rank_local_state_matches_one_device_global(ranks, name):
    ref = _one_device(name)
    geom, nb, (_, shape), _ = LOCAL_CASES[name]
    for r in range(4):
        got = ranks[r][name]
        for k in TRACE_KEYS:
            np.testing.assert_allclose(got["trace"][k], ref.trace[k],
                                       rtol=TRACE_RTOL, err_msg=k)
        np.testing.assert_allclose(got["d"].numpy(), ref.d.numpy(),
                                   atol=D_ATOL)
        # this rank's blocks and filters, never the global count
        nk = shape[1] if len(shape) > 1 else 1
        assert got["local_z_shape"][:3] == (nb // shape[0], 8 // nb,
                                            geom[1] // nk)


def test_a_state_of_neither_shape_is_refused():
    """A state whose shapes are not the problem's is refused."""
    spec = _learn_spec("block4_n8")
    st = convert.learn_state_from_jax(spec["init"], "cpu")
    bad = st._replace(z=st.z[:, :, :1])
    with pytest.raises(ValueError, match="do not match"):
        consensus.learn(spec["b"], ProblemGeom(*spec["geom"]),
                        LearnConfig(**spec["cfg"]), device="cpu",
                        initial_state=bad)


def test_counters_equal_the_steps_psums(ranks):
    """Per step on block_mesh(4): max_it_d consensus all-reduces of the
    stacked sums [2, K, S, S]; the objective's two terms after each pass,
    the codes' two change sums in one, and the agree (four metrics and
    the stop flag); the objective before the first step and after the
    last add one call each."""
    geom, nb, _, _ = LOCAL_CASES["block4_n8"]
    (s, _), K = geom
    S = 16 + s - 1
    steps, it_d = CFG["max_it"], CFG["max_it_d"]
    per_step = it_d * 2 * K * S * S * 4 + 4 * 4 + 2 * 4 + 5 * 4
    for r in range(4):
        got = ranks[r]["block4_n8"]
        assert got["trace"]["wire_bytes"] == [per_step] * steps
        assert got["calls"] == {"consensus": it_d * steps,
                                "block": 6 * steps + 2}
        assert got["wire_bytes"] == {
            "consensus": it_d * steps * 2 * K * S * S * 4,
            "block": steps * (4 * 4 + 2 * 4 + 5 * 4) + 2 * 4}
        # the device time is the card's alone
        assert "allreduce_ms" not in got["trace"]


def test_allreduce_span_in_a_cpu_trace(ranks):
    assert "ccsc.mesh.allreduce" in ranks[0]["span"]


def test_sharded_reference_equals_the_whole(ranks):
    spec = _ref_spec()
    st = ref_consensus.State(*(torch.from_numpy(spec["state"][f])
                               for f in ref_consensus.State._fields))
    b = torch.from_numpy(spec["b"])
    for i in range(spec["steps"]):
        st, m = ref_consensus.outer_step(st, b, spec["p"])
        for r in range(4):
            got = ranks[r]["sharded_ref"]["metrics"][i]
            for k, v in m.items():
                assert got[k] == pytest.approx(v, rel=REF_REL), (r, i, k)
    z = torch.cat([ranks[r]["sharded_ref"]["z"] for r in range(4)])
    scale = st.z.abs().max()
    assert float((z - st.z).abs().max() / scale) < REF_REL
    for r in range(4):
        dbar = ranks[r]["sharded_ref"]["dbar"]
        assert float((dbar - st.dbar).abs().max()
                     / st.dbar.abs().max()) < REF_REL


@pytest.fixture(scope="module")
def cell_runs(tmp_path_factory):
    """The tiny cell's runs, in a process without JAX: {name: result}."""
    root = str(tmp_path_factory.mktemp("mesh_cell"))
    code = ("import sys; sys.path[:0] = [%r, %r]; import mesh_local_cases "
            "as m; m.main(%r)" % (TESTS, cases.REPO, root))
    env = {k: v for k, v in os.environ.items() if not k.startswith("CCSC_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=cases.REPO,
                         capture_output=True, text=True, timeout=400, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    return {x["name"]: x["result"] for x in lines}


def test_cell_at_a_tiny_cut_is_correct(cell_runs):
    r = cell_runs["sound"]
    assert r["correct"], r["checks"]
    assert r["attempted"] == 3 and r["failed"] == 0
    assert r["device"]["count"] == 4
    assert {"learn_steps_per_s", "setup_s"} <= set(r["metrics"])


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_cell_control_is_not_correct(cell_runs, seed):
    r = cell_runs[f"control{seed}"]
    assert not r["correct"], r["checks"]


def test_cell_with_a_rank_left_out_of_the_consensus_is_not_correct(
        cell_runs):
    r = cell_runs["left_out"]
    assert not r["correct"], r["checks"]
