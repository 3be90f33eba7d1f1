"""The port's consensus learner on meshes of four gloo ranks against the
JAX package's meshes on the 8-device CPU platform (tests/conftest.py)
and against the port's one-device learner, on the same numpy data and
the JAX ``init_state`` handed over through ``convert.py``.

The port runs SPMD: one module-scoped ``parallel.distributed.launch`` of
4 ranks (one thread each, a 60 s group timeout and a join deadline, so a
hang fails these tests and never the suite) runs every case's port side
(``torch_mesh_cases.run_cases``); the tests compare. Limits: the JAX
package's mesh tests (tests/test_learn.py): filters and Dz atol 2e-5,
objective traces rtol 1e-4; the gathered codes 2e-5 of max(1, max|z|).
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
from ccsc_code_iccv2017_tpu.models import learn as jlearn
from ccsc_code_iccv2017_tpu.parallel import mesh as jmesh
from ccsc_code_iccv2017_torch.parallel import distributed

import torch_mesh_cases as cases

CFG = dict(max_it=4, max_it_d=3, max_it_z=3, rho_d=500.0, rho_z=10.0,
           lambda_prior=0.1, verbose="none", track_objective=True)
D_ATOL, TRACE_RTOL = 2e-5, 1e-4


def _toy_data(n=8, size=20, seed=0):
    """Images built from a few sparse spikes blurred by random 3x3 edge
    filters (tests/test_learn.py's toy data)."""
    from scipy.signal import convolve2d

    r = np.random.default_rng(seed)
    imgs = []
    for _ in range(n):
        x = np.zeros((size, size), np.float32)
        for _ in range(6):
            i, j = r.integers(2, size - 2, 2)
            x[i, j] = r.normal()
        f = r.normal(size=(3, 3)).astype(np.float32)
        imgs.append(convolve2d(x, f, mode="same"))
    return np.stack(imgs).astype(np.float32)


def _reduce_data():
    return np.random.default_rng(3).normal(size=(4, 2, 12, 12)).astype(
        np.float32)


def _jax_init(b, geom, num_blocks):
    jg = JGeom(*geom)
    fg = jcommon.FreqGeom.create(jg, b.shape[-2:])
    st = jlearn.init_state(jax.random.PRNGKey(0), jg, fg, num_blocks,
                           b.shape[0] // num_blocks, jnp.float32,
                           z_dtype=jnp.float32, d_dtype=jnp.float32)
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


# name: (data, geom, num_blocks, extra cfg, port mesh, JAX mesh constructor)
LEARN_CASES = {
    "block4_n4": (_toy_data, ((5, 5), 8), 4, {},
                  ("block_mesh", (4,)), lambda: jmesh.block_mesh(4)),
    "block4_n8": (_toy_data, ((5, 5), 4), 8, {},
                  ("block_mesh", (4,)), lambda: jmesh.block_mesh(4)),
    # K2's plain version on each rank's 2 blocks (JAX's fused mesh path
    # has no replication rule for pallas_call; its composition is the
    # reference)
    "block4_n8_fused": (_toy_data, ((5, 5), 4), 8, {"fused_z": True},
                        ("block_mesh", (4,)), lambda: jmesh.block_mesh(4)),
    "block2_freq2": (_toy_data, ((5, 5), 8), 2, {},
                     ("block_freq_mesh", (2, 2)),
                     lambda: jmesh.block_freq_mesh(2, 2)),
    "block2_filter2": (_toy_data, ((5, 5), 8), 2, {},
                       ("block_filter_mesh", (2, 2)),
                       lambda: jmesh.block_filter_mesh(2, 2)),
    "filter_reduce": (_reduce_data, ((3, 3), 4, (2,)), 2, {},
                      ("block_filter_mesh", (2, 2)),
                      lambda: jmesh.block_filter_mesh(2, 2)),
    "block1": (_toy_data, ((5, 5), 8), 4, {"compat_coding": "block1"},
               ("block_mesh", (4,)), lambda: jmesh.block_mesh(4)),
}


def _spec(name):
    data, geom, nb, extra, _, _ = LEARN_CASES[name]
    b = data()
    return dict(b=b, geom=geom, cfg=dict(CFG, num_blocks=nb, **extra),
                init=_jax_init(b, geom, nb))


@pytest.fixture(scope="module")
def stream_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_stream"))


@pytest.fixture(scope="module")
def port_runs(stream_dir):
    """Every case's port side, run once on 4 gloo ranks: per rank
    {case: result}."""
    runs = [(name, "learn", LEARN_CASES[name][4], _spec(name))
            for name in LEARN_CASES]
    nan = _spec("block4_n8")
    nan["cfg"].update(max_recoveries=1, max_it=3)
    nan["poison_rank"] = 1
    runs.append(("nan_backoff", "nan_backoff", ("block_mesh", (4,)), nan))
    streamed = _spec("block4_n8")
    streamed["cfg"].update(metrics_dir=stream_dir, max_it=2)
    runs.append(("streamed", "learn", ("block_mesh", (4,)), streamed))
    return distributed.launch(cases.run_cases, 4, args=(runs,),
                              device="cpu", timeout=60.0,
                              join_timeout=240.0)


def _one_device(name):
    return cases.RUNNERS["learn"](_spec(name), None)


def _jax_mesh(name):
    data, geom, nb, extra, _, jm = LEARN_CASES[name]
    extra = {k: v for k, v in extra.items() if k != "fused_z"}
    return jlearn.learn(jnp.asarray(data()), JGeom(*geom),
                        JCfg(num_blocks=nb, **CFG, **extra), mesh=jm())


def _close_traces(got, ref, keys=("obj_vals_d", "obj_vals_z")):
    for k in keys:
        assert len(got[k]) == len(ref[k]), k
        np.testing.assert_allclose(got[k], ref[k], rtol=TRACE_RTOL)


@pytest.mark.parametrize("name", list(LEARN_CASES))
def test_mesh_learn_matches_jax_mesh_and_one_device(port_runs, name):
    got = port_runs[0][name]
    jr = _jax_mesh(name)
    np.testing.assert_allclose(got["d"].numpy(), np.asarray(jr.d),
                               atol=D_ATOL)
    _close_traces(got["trace"], jr.trace)
    np.testing.assert_allclose(got["Dz"].numpy(), np.asarray(jr.Dz),
                               atol=D_ATOL)
    one = _one_device(name)
    np.testing.assert_allclose(got["d"].numpy(), one["d"].numpy(),
                               atol=D_ATOL)
    _close_traces(got["trace"], one["trace"])
    z = one["z"].numpy()
    assert got["z"].shape == z.shape
    assert np.abs(got["z"].numpy() - z).max() <= D_ATOL * max(
        1.0, np.abs(z).max())
    # d and the trace are replicated: every rank returns the same
    for r in port_runs[1:]:
        assert torch.equal(r[name]["d"], got["d"])
        assert r[name]["trace"]["obj_vals_z"] == got["trace"]["obj_vals_z"]


def test_ranks_hold_their_shard(port_runs):
    # block_mesh(4), N=8: two blocks a rank; block x filter (2, 2): one
    # block and 4 of the 8 filters a rank
    assert port_runs[2]["block4_n8"]["local_z_shape"][0] == 2
    assert port_runs[3]["block2_filter2"]["local_z_shape"][:3] == (1, 4, 4)
    # the gathered views exist on rank 0 only
    assert port_runs[1]["block4_n8"]["z"] is None
    assert port_runs[0]["block4_n8"]["z"].shape[0] == 8


def test_one_ranks_non_finite_step_backs_every_rank_off(port_runs):
    """Rank 1's codes go NaN in step 2: the metrics are reduced over the
    mesh, so every rank sees it, keeps its last good state, backs rho off
    together and finishes the run; no rank waits alone in a collective."""
    runs = [r["nan_backoff"] for r in port_runs]
    rec = runs[0]["trace"]["recoveries"]
    assert len(rec) == 1 and rec[0]["iteration"] == 2
    for r in runs[1:]:
        assert r["trace"]["recoveries"] == rec
        assert torch.equal(r["d"], runs[0]["d"])
        assert r["trace"]["obj_vals_z"] == runs[0]["trace"]["obj_vals_z"]
    assert len(runs[0]["trace"]["obj_vals_z"]) == 1 + 3
    assert torch.isfinite(runs[0]["z"]).all()
    assert torch.isfinite(runs[0]["d"]).all()


def test_each_rank_writes_its_own_stream(port_runs, stream_dir):
    """``metrics_dir`` on block_mesh(4): one ``events-pNNNNN.jsonl`` a
    rank, NNNNN its torch.distributed rank; the telemetry scalars are
    reduced over the mesh, so every rank records the same steps, and the
    trajectory is the untraced run's."""
    from ccsc_code_iccv2017_torch.utils import obs

    assert sorted(os.listdir(stream_dir)) == [
        f"events-p{r:05d}.jsonl" for r in range(4)]
    steps = []
    for r in range(4):
        ev = obs.read_events(os.path.join(stream_dir,
                                          f"events-p{r:05d}.jsonl"))
        meta = [e for e in ev if e["type"] == "run_meta"]
        assert len(meta) == 1 and meta[0]["process_index"] == r
        assert meta[0]["process_count"] == 4
        assert meta[0]["mesh_shape"] == {"block": 4}
        assert {e["host"] for e in ev} == {r}
        steps.append([{k: e[k] for k in ("it", "obj_z", "obj_fid", "obj_l1",
                                         "consensus_dis", "nonfinite_z")}
                      for e in ev if e["type"] == "step"])
        assert [e["status"] for e in ev if e["type"] == "summary"] == ["ok"]
    assert [s["it"] for s in steps[0]] == [1, 2]
    assert all(s == steps[0] for s in steps[1:])
    plain = port_runs[0]["block4_n8"]["trace"]["obj_vals_z"][:3]
    assert port_runs[0]["streamed"]["trace"]["obj_vals_z"] == plain
