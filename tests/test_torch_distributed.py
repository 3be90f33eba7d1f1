"""The port's process groups (parallel/distributed.py), the sharded
reconstruct and the 'freq'-sharded masked learner on gloo ranks, against
the JAX package's meshes on the 8-device CPU platform
(tests/conftest.py) and the port's one-device calls, on the same numpy
inputs (tests/test_distributed.py, tests/test_reconstruct.py:257-380,
tests/test_learn.py's masked case).

One module-scoped launch of 4 ranks runs the mesh cases' port side, one
of 2 ranks the plumbing and the two-process learn; every group has a 60 s
timeout and ``launch`` a join deadline, so a hang fails a test and never
the suite. Limits are the JAX tests': reconstructions atol 1e-6 (1e-5
with early stop or a 'freq' axis), traces rtol 1e-5 (1e-4 with 'freq');
learners' filters 2e-5, traces rtol 1e-4.
"""
import importlib
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccsc_code_iccv2017_tpu.config import LearnConfig as JCfg
from ccsc_code_iccv2017_tpu.config import ProblemGeom as JGeom
from ccsc_code_iccv2017_tpu.config import SolveConfig as JSolve
from ccsc_code_iccv2017_tpu.models import learn as jlearn
from ccsc_code_iccv2017_tpu.models import learn_masked as jlm
from ccsc_code_iccv2017_tpu.parallel import mesh as jmesh
from ccsc_code_iccv2017_tpu.utils import checkpoint as jckpt
from ccsc_code_iccv2017_torch.config import ProblemGeom, SolveConfig
from ccsc_code_iccv2017_torch.models import reconstruct as trec
from ccsc_code_iccv2017_torch.parallel import distributed
from ccsc_code_iccv2017_torch.parallel import mesh as tmesh

import torch_mesh_cases as cases
from test_torch_learn_masked import jax_masked_state
from test_torch_mesh import CFG, _jax_init, _toy_data

jrec = importlib.import_module("ccsc_code_iccv2017_tpu.models.reconstruct")


def _toy_dictionary():
    r = np.random.default_rng(5)
    d = r.normal(size=(8, 5, 5)).astype(np.float32)
    d -= d.mean(axis=(1, 2), keepdims=True)
    return d / np.sqrt((d ** 2).sum(axis=(1, 2), keepdims=True))


def _recon_inputs(kind):
    from scipy.ndimage import gaussian_filter

    r = np.random.default_rng({"plain": 0, "early": 1, "freq": 2}[kind])
    if kind == "early":  # two smooth images, two hard noise images
        xs = np.stack(
            [gaussian_filter(r.normal(size=(24, 24)), 4.0) for _ in range(2)]
            + [r.normal(size=(24, 24)) for _ in range(2)])
    else:
        xs = np.stack([gaussian_filter(r.normal(size=(24, 24)), 2.0)
                       for _ in range(4)])
    xs = ((xs - xs.min()) / (xs.max() - xs.min())).astype(np.float32)
    mask = (r.random(xs.shape) < (0.6 if kind == "early" else 0.5)).astype(
        np.float32)
    cfg = dict(lambda_residual=5.0, lambda_prior=0.3,
               max_it={"plain": 8, "early": 30, "freq": 6}[kind],
               tol=6e-2 if kind == "early" else 0.0)
    return dict(x=xs, mask=mask, d=_toy_dictionary(), geom=((5, 5), 8),
                cfg=cfg, x_orig=None if kind == "early" else xs)


# name: (inputs, port mesh, JAX mesh constructor)
RECON_CASES = {
    "batch4": ("plain", ("block_mesh", (4,)), lambda: jmesh.block_mesh(4)),
    "batch4_early_stop": ("early", ("block_mesh", (4,)),
                          lambda: jmesh.block_mesh(4)),
    "batch2_freq2": ("freq", ("make_mesh", ((2, 2), ("batch", "freq"))),
                     lambda: jax.make_mesh((2, 2), ("batch", "freq"),
                                           devices=jax.devices()[:4])),
}

MASKED_GEOM = ((3, 3), 3, (2,))
MASKED_KW = dict(gamma_div_d=50.0, gamma_div_z=10.0)
MASKED_CFG = dict(max_it=2, max_it_d=2, max_it_z=2, verbose="none",
                  lambda_residual=1.0, lambda_prior=1.0,
                  track_objective=True)
RESUME_KW = dict(CFG, num_blocks=4)
RESUME_GEOM = ((5, 5), 8)


def _masked_data():
    # padded 8+2 -> 10x10 rfft = (10, 6) -> F=60, divisible by 4
    return np.random.default_rng(0).uniform(0.1, 1.0, (2, 2, 8, 8)).astype(
        np.float32)


def _masked_spec():
    b = _masked_data()
    st = jax_masked_state(2, MASKED_GEOM, (10, 10))
    return dict(b=b, geom=MASKED_GEOM, cfg=MASKED_CFG,
                init={f: np.asarray(getattr(st, f)) for f in st._fields},
                **MASKED_KW)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX mesh checkpoint of the first 2 of 4 steps."""
    ck = str(tmp_path_factory.mktemp("jax_ck"))
    jlearn.learn(jnp.asarray(_toy_data()), JGeom(*RESUME_GEOM),
                 JCfg(**dict(RESUME_KW, max_it=2)),
                 mesh=jmesh.block_mesh(4), checkpoint_dir=ck,
                 checkpoint_every=1)
    return ck


@pytest.fixture(scope="module")
def port_runs(jax_checkpoint, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("port_ck") / "ck")
    shutil.copytree(jax_checkpoint, ck)
    runs = [(name, "recon", kind, _recon_inputs(inp))
            for name, (inp, kind, _) in RECON_CASES.items()]
    runs.append(("masked_freq4", "masked", ("freq_mesh", (4,)),
                 _masked_spec()))
    b = _toy_data()
    runs.append(("resume", "learn", ("block_mesh", (4,)), dict(
        b=b, geom=RESUME_GEOM, cfg=RESUME_KW,
        init=_jax_init(b, RESUME_GEOM, 4), checkpoint_dir=ck,
        checkpoint_every=1)))
    out = distributed.launch(cases.run_cases, 4, args=(runs,), device="cpu",
                             timeout=60.0, join_timeout=240.0)
    return out, ck


@pytest.mark.parametrize("name", list(RECON_CASES))
def test_sharded_reconstruct_matches_jax_and_one_device(port_runs, name):
    inp, _, jm = RECON_CASES[name]
    spec = _recon_inputs(inp)
    got = port_runs[0][0][name]
    jr = jrec.reconstruct(
        jnp.asarray(spec["x"] * spec["mask"]), spec["d"],
        jrec.ReconstructionProblem(JGeom(*spec["geom"])),
        JSolve(**spec["cfg"]), mask=jnp.asarray(spec["mask"]),
        x_orig=None if spec["x_orig"] is None else jnp.asarray(spec["x_orig"]),
        mesh=jm(),
    )
    one = cases.RUNNERS["recon"](spec, None)
    atol = 1e-6 if name == "batch4" else 1e-5
    rtol = 1e-4 if "freq" in name else 1e-5
    for ref_recon, ref_obj, ref_it in (
        (np.asarray(jr.recon), np.asarray(jr.trace.obj_vals),
         int(jr.trace.num_iters)),
        (one["recon"].numpy(), one["obj"].numpy(), one["iters"]),
    ):
        assert got["iters"] == ref_it
        np.testing.assert_allclose(got["recon"].numpy(), ref_recon,
                                   atol=atol)
        np.testing.assert_allclose(got["obj"].numpy(), ref_obj, rtol=rtol)
    if spec["x_orig"] is not None:  # PSNR is global (pmean'd mse)
        np.testing.assert_allclose(got["psnr"].numpy(),
                                   np.asarray(jr.trace.psnr_vals), rtol=rtol)
    if name == "batch4_early_stop":
        assert 0 < got["iters"] < spec["cfg"]["max_it"]
    # every rank stopped at the same iteration, on its own requests
    for r in port_runs[0]:
        assert r[name]["iters"] == got["iters"]
        assert r[name]["local_n"] == (1 if name.startswith("batch4") else 2)


def test_masked_freq_mesh_matches_jax_and_one_device(port_runs):
    got = port_runs[0][0]["masked_freq4"]
    b = _masked_data()
    jr = jlm.learn_masked(jnp.asarray(b), JGeom(*MASKED_GEOM),
                          JCfg(**MASKED_CFG), mesh=jmesh.freq_mesh(4),
                          key=jax.random.PRNGKey(0), **MASKED_KW)
    one = cases.RUNNERS["masked"](_masked_spec(), None)
    for ref_d, ref_tr in ((np.asarray(jr.d), jr.trace),
                          (one["d"].numpy(), one["trace"])):
        np.testing.assert_allclose(got["d"].numpy(), ref_d, atol=2e-5)
        np.testing.assert_allclose(got["trace"]["obj_vals_z"],
                                   ref_tr["obj_vals_z"], rtol=1e-4)
    # state and result replicated on every rank
    for r in port_runs[0][1:]:
        assert torch.equal(r["masked_freq4"]["d"], got["d"])


def test_jax_mesh_checkpoint_resumes_on_a_port_mesh(port_runs):
    """A JAX block_mesh(4) checkpoint of steps 1-2 resumes on the port's
    block_mesh(4) (each rank keeps its blocks) and lands where the
    uninterrupted JAX mesh run does; the port's checkpoint, written by
    rank 0 from the gathered state, reads back in the JAX package."""
    runs, ck = port_runs
    got = runs[0]["resume"]
    full = jlearn.learn(jnp.asarray(_toy_data()), JGeom(*RESUME_GEOM),
                        JCfg(**RESUME_KW), mesh=jmesh.block_mesh(4))
    np.testing.assert_allclose(got["d"].numpy(), np.asarray(full.d),
                               atol=2e-5)
    np.testing.assert_allclose(got["trace"]["obj_vals_z"],
                               full.trace["obj_vals_z"], rtol=1e-4)
    fields, _, it = jckpt.load(ck)
    assert it == RESUME_KW["max_it"]
    assert fields["z"].shape == (4, 2, 8, 24, 24)
    np.testing.assert_allclose(np.asarray(fields["z"]),
                               got["z"].numpy(), atol=0)


@pytest.fixture(scope="module")
def two_ranks():
    b = _toy_data()
    spec = dict(b=b, geom=((3, 3), 4), cfg=dict(
        max_it=2, max_it_d=2, max_it_z=2, num_blocks=4, rho_d=50.0,
        rho_z=2.0, verbose="none", track_objective=True),
        init=_jax_init(b, ((3, 3), 4), 4))
    learn = distributed.launch(
        cases.run_cases, 2,
        args=([("learn", "learn", ("multihost_block_mesh", ()), spec),
               ("local", "learn", ("multihost_block_mesh", ()),
                dict(spec, local_blocks=True))],),
        device="cpu", timeout=60.0, join_timeout=120.0)
    info = distributed.launch(cases.ring_info, 2, device="cpu",
                              timeout=60.0, join_timeout=120.0)
    return spec, learn, info


def test_two_process_learn_matches_single(two_ranks):
    spec, learn, _ = two_ranks
    one = cases.RUNNERS["learn"](spec, None)
    jr = jlearn.learn(jnp.asarray(spec["b"]), JGeom(*spec["geom"]),
                      JCfg(**spec["cfg"]))
    got = learn[0]["learn"]
    for ref_d, ref_obj in ((one["d"].numpy(), one["trace"]["obj_vals_z"]),
                           (np.asarray(jr.d), jr.trace["obj_vals_z"])):
        np.testing.assert_allclose(got["d"].numpy(), ref_d, atol=2e-5)
        np.testing.assert_allclose(got["trace"]["obj_vals_z"], ref_obj,
                                   rtol=1e-4)
    assert got["local_z_shape"][0] == 2  # 4 blocks over 2 processes
    # each process fed only its own blocks (global_block_array): the same
    # run
    local = learn[0]["local"]
    assert torch.equal(local["d"], got["d"])
    assert local["trace"]["obj_vals_z"] == got["trace"]["obj_vals_z"]


def test_rank_plumbing(two_ranks):
    _, _, info = two_ranks
    for r, i in enumerate(info):
        assert i["world"] == 2
        assert i["slice"] == i["mesh_slice"] == slice(4 * r, 4 * r + 4)
        assert i["global_shape"] == (4, 3, 4)
        assert torch.equal(i["local"], torch.full((2, 3, 4), float(r)))
        assert torch.equal(i["psum"], torch.full((2, 3), 3.0))
        assert torch.equal(i["complex_psum"],
                           torch.complex(torch.full((2, 3), 3.0),
                                         torch.full((2, 3), -3.0)))
        assert torch.equal(i["gathered"], torch.cat(
            [torch.full((2, 3), 1.0), torch.full((2, 3), 2.0)], dim=-1))
        assert i["multihost"] == (("block", 2),)
        assert torch.equal(i["shard"][0], torch.arange(2.0) + 2 * r)
        assert torch.equal(i["shard"][1], torch.arange(4.0) + 4 * r)
    assert torch.equal(info[0]["to_rank0"], torch.cat(
        [torch.full((2, 3), 1.0), torch.full((2, 3), 2.0)], dim=0))
    assert info[1]["to_rank0"] is None


def test_process_block_slice_single_process_and_mesh():
    assert distributed.process_block_slice(8) == slice(0, 8)
    fake = types.SimpleNamespace(shape={"block": 4},
                                 axis_index=lambda axis: 1)
    assert distributed.process_block_slice(8, fake) == slice(2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.process_block_slice(6, fake)


def _stub_init(monkeypatch, failures):
    calls = []
    sleeps = []

    def fake(**kw):
        calls.append(kw)
        if len(calls) <= len(failures):
            raise failures[len(calls) - 1]

    monkeypatch.setattr(distributed, "_init_group", fake)
    monkeypatch.setattr(distributed.time, "sleep", sleeps.append)
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setattr(distributed, "_rank_device", None)
    return calls, sleeps


def test_initialize_retries_with_backoff(monkeypatch):
    calls, sleeps = _stub_init(
        monkeypatch, [RuntimeError("refused"), RuntimeError("refused")])
    monkeypatch.setenv("CCSC_DIST_CONNECT_BACKOFF", "0.5")
    distributed.initialize("127.0.0.1:1", 2, 1, device="cpu")
    assert len(calls) == 3 and sleeps == [0.5, 1.0]
    assert calls[-1]["init_method"] == "tcp://127.0.0.1:1"
    assert calls[-1]["backend"] == "gloo" and calls[-1]["rank"] == 1
    assert distributed.rank_device() == torch.device("cpu")
    # initialized: a second call is a no-op
    distributed.initialize("127.0.0.1:1", 2, 1, device="cpu")
    assert len(calls) == 3


def test_initialize_gives_up_after_the_retries(monkeypatch):
    calls, sleeps = _stub_init(monkeypatch, [RuntimeError("down")] * 5)
    with pytest.raises(RuntimeError, match="down"):
        distributed.initialize("127.0.0.1:1", 2, 0, connect_retries=2,
                               connect_backoff=1.0, device="cpu")
    assert len(calls) == 3 and sleeps == [1.0, 2.0]


def test_initialize_fails_fast_on_misconfiguration(monkeypatch):
    calls, sleeps = _stub_init(monkeypatch, [ValueError("bad rank")])
    with pytest.raises(ValueError, match="bad rank"):
        distributed.initialize("127.0.0.1:1", 2, 5, device="cpu")
    assert len(calls) == 1 and sleeps == []


def test_more_ranks_than_gpus_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 GPUs, but 1 are visible"):
        distributed.launch(cases.ring_info, 2, device="cuda")
    calls, _ = _stub_init(monkeypatch, [])
    with pytest.raises(ValueError, match="2 ranks on cuda needs a GPU"):
        distributed.initialize("127.0.0.1:1", 2, 1, device="cuda")
    assert calls == []  # refused before any connection
    # never put on gloo or the CPU unasked: a mesh needs its ranks
    with pytest.raises(RuntimeError, match="needs 4 processes"):
        tmesh.block_mesh(4)


def test_reconstruct_mesh_refusals():
    spec = _recon_inputs("plain")
    args = (spec["x"], spec["d"],
            trec.ReconstructionProblem(ProblemGeom(*spec["geom"])),
            SolveConfig(**spec["cfg"]))
    cpu = torch.device("cpu")
    for mesh, match in (
        (types.SimpleNamespace(axis_names=("batch",), shape={"batch": 3},
                               device=cpu), "not divisible by mesh axis"),
        (types.SimpleNamespace(axis_names=("batch", "filter"),
                               shape={"batch": 2, "filter": 2}, device=cpu),
         "second mesh axis must be 'freq'"),
    ):
        with pytest.raises(ValueError, match=match):
            trec.reconstruct(*args, device="cpu", mesh=mesh)
