"""The port side of the mesh tests, run inside ranks started by
``parallel.distributed.launch`` (gloo on the CPU). No JAX here: the
ranks import only torch and the port; the JAX inits and data arrive as
numpy arrays. Not a test module (pytest collects ``test_*.py`` only).
"""
import numpy as np
import torch

from ccsc_code_iccv2017_torch import convert
from ccsc_code_iccv2017_torch.config import LearnConfig, ProblemGeom
from ccsc_code_iccv2017_torch.config import SolveConfig
from ccsc_code_iccv2017_torch.models import learn as tlearn
from ccsc_code_iccv2017_torch.models import learn_masked as tlm
from ccsc_code_iccv2017_torch.models import reconstruct as trec
from ccsc_code_iccv2017_torch.parallel import consensus, distributed
from ccsc_code_iccv2017_torch.parallel import mesh as M


def build_mesh(kind):
    """``kind``: (constructor name, its arguments)."""
    name, args = kind
    if name == "multihost_block_mesh":
        return distributed.multihost_block_mesh(*args)
    return getattr(M, name)(*args)


def _learn(spec, mesh):
    init = spec.get("init")
    b = spec["b"]
    if spec.get("local_blocks"):
        # this rank's blocks only, as a process that loads its own slice
        nb = spec["cfg"]["num_blocks"]
        blocks = b.reshape(nb, b.shape[0] // nb, *b.shape[1:])
        b = distributed.global_block_array(
            blocks[distributed.process_block_slice(nb, mesh)], mesh)
    res = consensus.learn(
        b, ProblemGeom(*spec["geom"]), LearnConfig(**spec["cfg"]),
        device="cpu", mesh=mesh,
        initial_state=None if init is None
        else convert.learn_state_from_jax(init, "cpu"),
        generator=torch.Generator().manual_seed(spec.get("seed", 0)),
        checkpoint_dir=spec.get("checkpoint_dir"),
        checkpoint_every=spec.get("checkpoint_every", 5),
    )
    kdims = {"block": 0}
    if mesh is not None and "filter" in mesh.shape:
        kdims["filter"] = 2
    z = M.gather(res.z, mesh, kdims) if mesh is not None else res.z
    Dz = M.gather_blocks(res.Dz, mesh) if mesh is not None else res.Dz
    return dict(d=res.d, trace=res.trace, z=z, Dz=Dz,
                local_z_shape=tuple(res.z.shape))


def _masked(spec, mesh):
    res = tlm.learn_masked(
        spec["b"], ProblemGeom(*spec["geom"]), LearnConfig(**spec["cfg"]),
        device="cpu", mesh=mesh,
        initial_state=convert.masked_state_from_jax(spec["init"], "cpu"),
        gamma_div_d=spec["gamma_div_d"], gamma_div_z=spec["gamma_div_z"],
    )
    return dict(d=res.d, trace=res.trace, Dz=res.Dz)


def _recon(spec, mesh):
    res = trec.reconstruct(
        spec["x"] * spec["mask"], spec["d"],
        trec.ReconstructionProblem(ProblemGeom(*spec["geom"])),
        SolveConfig(**spec["cfg"]), mask=spec["mask"],
        x_orig=spec.get("x_orig"), device="cpu", mesh=mesh,
    )
    recon = M.gather_blocks(res.recon, mesh) if mesh is not None else res.recon
    return dict(recon=recon, obj=res.trace.obj_vals,
                psnr=res.trace.psnr_vals, iters=int(res.trace.num_iters),
                local_n=int(res.recon.shape[0]))


def _nan_backoff(spec, mesh):
    """One rank's z-pass goes non-finite at the second step: every rank
    must take the same recovery and go on."""
    real = tlearn.f_z_block
    calls = [0]

    def poisoned(*a, **k):
        z, dz = real(*a, **k)
        calls[0] += 1
        if mesh.rank == spec["poison_rank"] and calls[0] == 2:
            z = torch.full_like(z, float("nan"))
        return z, dz

    tlearn.f_z_block = poisoned
    try:
        out = _learn(spec, mesh)
    finally:
        tlearn.f_z_block = real
    return out


RUNNERS = {"learn": _learn, "masked": _masked, "recon": _recon,
           "nan_backoff": _nan_backoff}


def run_cases(rank, cases):
    """Every case on this rank: {name: result}. A case's mesh is built
    on every rank in the same order (its groups are collective)."""
    out = {}
    for name, runner, kind, spec in cases:
        mesh = build_mesh(kind) if kind is not None else None
        out[name] = RUNNERS[runner](spec, mesh)
    return out


def ring_info(rank):
    """The plumbing of a two-rank group: block slices, a global block
    array, and one psum / all-gather / gather of known values."""
    mesh = M.block_mesh()
    x = torch.full((2, 3), float(rank + 1))
    ga = distributed.global_block_array(np.full((2, 3, 4), rank, np.float32),
                                        mesh)
    return dict(
        world=mesh.size,
        slice=distributed.process_block_slice(8),
        mesh_slice=distributed.process_block_slice(8, mesh),
        global_shape=ga.global_shape, local=ga.local,
        psum=M.psum(x, mesh, "block"),
        gathered=M.all_gather_tiled(x, mesh, "block", dim=-1),
        complex_psum=M.psum(torch.complex(x, -x), mesh, "block"),
        to_rank0=M.gather_blocks(x, mesh),
        multihost=tuple(distributed.multihost_block_mesh().shape.items()),
        shard=M.shard_blocks((torch.arange(4.0), torch.arange(8.0)), mesh),
    )


def run_apps(rank, jobs):
    """Learner CLIs' ``main`` with ``--mesh``, inside this group (each
    joins it and learns on block_mesh(N)); the learner's init replaced
    by the given global state. -> rank 0's results (None elsewhere)."""
    import importlib

    real = tlearn.init_state
    out = []
    for module, argv, init in jobs:
        tlearn.init_state = (
            lambda generator, *a, _init=init, **k:
            convert.learn_state_from_jax(_init, generator.device))
        try:
            out.append(importlib.import_module(module).main(argv))
        finally:
            tlearn.init_state = real
    return out
