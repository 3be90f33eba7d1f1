"""Rank-side cases of ``test_torch_mesh_local_state.py``, run inside
ranks started by ``parallel.distributed.launch`` (gloo on the CPU), and
the benchmark cell ``learn2d-weak-mesh4`` at a tiny cut through
``portbench.run.run_cell`` in a process of its own (``main``: the
harness refuses a process that loaded JAX, as the test runner has). No
JAX here. Not a test module (pytest collects ``test_*.py`` only).
"""
import json
import os
import sys
import time

import numpy as np
import torch

from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.models import learn as tlearn
from ccsc_code_iccv2017_torch.parallel import consensus, distributed
from ccsc_code_iccv2017_torch.parallel import mesh as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench.reference import consensus_sharded  # noqa: E402
from portbench.reference.consensus import State  # noqa: E402

CELL = "learn2d-weak-mesh4"
CONFIG = "learn2d-k100-32x100-mesh4"
# 16 filters on 4 blocks of 2 images of 20 x 20, one block a rank
TINY = dict(num_filters=16, blocks=4, ni=2, side=20)


def local_state(state: dict, mesh, num_blocks: int) -> tlearn.LearnState:
    """This rank's shard of a global state (numpy fields), cut here: its
    blocks of the block-local fields and, under 'filter', its filters."""
    mine = distributed.process_block_slice(num_blocks, mesh)
    nk = mesh.shape.get("filter", 1)
    kf = mesh.axis_index("filter") if nk > 1 else 0

    def cut(x, kdim):
        k = x.shape[kdim] // nk
        return np.take(x, range(kf * k, (kf + 1) * k), axis=kdim)

    out = {}
    for f, x in state.items():
        if f in ("dbar", "udbar"):
            out[f] = cut(x, 0)
        else:
            out[f] = cut(x[mine], 1 if f in ("d_local", "dual_d") else 2)
    return tlearn.LearnState(**{f: torch.from_numpy(np.ascontiguousarray(
        out[f])) for f in tlearn.LearnState._fields})


def _refuse(*_a, **_k):
    raise AssertionError("a global-sized state on the rank-local path")


def _learn_local(spec, mesh):
    """The learn from this rank's blocks and its state alone; neither
    the global init nor the global state's sharding may run."""
    nb = spec["cfg"]["num_blocks"]
    b = spec["b"]
    blocks = b.reshape(nb, b.shape[0] // nb, *b.shape[1:])
    gb = distributed.global_block_array(
        blocks[distributed.process_block_slice(nb, mesh)], mesh)
    real = (tlearn.init_state, consensus._shard_state)
    tlearn.init_state = consensus._shard_state = _refuse
    try:
        res = consensus.learn(
            gb, ProblemGeom(*spec["geom"]), LearnConfig(**spec["cfg"]),
            device="cpu", mesh=mesh, init_d=spec.get("init_d"),
            initial_state=local_state(spec["init"], mesh, nb))
    finally:
        tlearn.init_state, consensus._shard_state = real
    return dict(d=res.d, trace=res.trace, local_z_shape=tuple(res.z.shape),
                calls=dict(mesh.calls), wire_bytes=dict(mesh.wire_bytes))


def _span(spec, mesh):
    """The names of the events a CPU profiler records on rank 0 around
    one tagged psum (every rank runs the psum)."""
    x = torch.ones(3)
    if mesh.rank != 0:
        M.psum(x, mesh, "block", tag="consensus")
        return []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        M.psum(x, mesh, "block", tag="consensus")
    return sorted({e.name for e in prof.events()})


def _sharded_ref(spec, mesh):
    """``steps`` steps of the sharded float64 reference from this rank's
    shard of the global state: each step's metrics, and the last
    state's dbar and this rank's codes."""
    nb = spec["num_blocks"]
    mine = distributed.process_block_slice(nb, mesh)
    g = {k: torch.from_numpy(v) for k, v in spec["state"].items()}
    st = State(g["d_local"][mine], g["dual_d"][mine], g["dbar"], g["udbar"],
               g["z"][mine], g["dual_z"][mine])
    b = torch.from_numpy(spec["b"])[mine]
    metrics = []
    for _ in range(spec["steps"]):
        st, m = consensus_sharded.outer_step(st, b, spec["p"], nb)
        metrics.append(m)
    return dict(metrics=metrics, dbar=st.dbar, z=st.z)


RUNNERS = {"learn_local": _learn_local, "span": _span,
           "sharded_ref": _sharded_ref}


def run_cases(rank, runs):
    """Each (name, kind, mesh constructor and arguments, spec) on its own
    mesh; {name: result}."""
    out = {}
    for name, kind, (ctor, args), spec in runs:
        out[name] = RUNNERS[kind](spec, getattr(M, ctor)(*args))
    return out


# ---- the benchmark cell, in a process without JAX ----------------------


def leave_out_rank3(rank):
    """Fault: rank 3's blocks are left out of every consensus sum (its
    contribution zeroed before the all-reduce)."""
    if rank != 3:
        return
    real = M.psum

    def psum(x, mesh, axis, tag=None):
        if tag == "consensus":
            x = torch.zeros_like(x)
        return real(x, mesh, axis, tag=tag)

    M.psum = psum


def tiny_root(root: str) -> str:
    """A checkout-shaped directory whose BENCHMARK.json and configuration
    files are the real ones, the cell's configuration cut to ``TINY``."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for rel, obj in [("BENCHMARK.json", bench)] + [
            (c["file"], None) for c in bench["configs"]]:
        if obj is None:
            with open(os.path.join(REPO, rel)) as f:
                obj = json.load(f)
            if obj["name"] == CONFIG:
                obj.update(TINY)
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f)
    return root


def main(root: str) -> None:
    """The tiny cell: sound, under the bf16 control at three seeds and
    with rank 3 left out of the consensus; one JSON line each."""
    from portbench import run
    from portbench.systems import learn_consensus_mesh as system

    tiny_root(root)
    seed = 2 ** 31 + 11
    runs = [("sound", seed, {})]
    runs += [(f"control{s}", s, {"control": True}) for s in (1, 2, 3)]
    runs += [("left_out", seed, {"hook": leave_out_rank3})]
    for name, s, kw in runs:
        system.RANK_HOOK = kw.pop("hook", None)
        r = run.run_cell(CELL, s, 1.5, False, root=root, device="cpu",
                         max_steps=3, t_start=time.perf_counter(), **kw)
        print(json.dumps({"name": name, "result": r}), flush=True)
