"""Consensus dictionary learning, single device (torch port of
``ccsc_code_iccv2017_tpu.models.learn``).

The block-consensus ADMM of 2D/admm_learn_conv2D_large_dzParallel.m:

outer iteration i (dzParallel.m:90-194):
  d-pass  — per-block code Grams (:96-100), then max_it_d consensus
            iterations: global kernel prox on Dbar+Udbar (:107),
            per-block dual update + Woodbury solve (:110-113), consensus
            average (:115-121).
  z-pass  — filter spectra (:142-144), then max_it_z per-block
            sparse-coding iterations: soft-threshold prox, dual update,
            Sherman-Morrison solve (:150-158). With ``cfg.fused_z`` on
            a 2D, W == 1 geometry each iteration is the two
            hand-written kernels K2a/K2b (ops.fused_z); otherwise the
            composition of torch.fft, the z-solve (K1,
            ops.kernels.solve_z_rank1, for W == 1; the Woodbury solve
            for W > 1) and elementwise torch.

The L consensus blocks of one device ride a leading axis and every
per-block solve is batched over it (JAX vmaps); the consensus average is
a mean over that axis. The steps are written once, as the per-block
pieces ``f_bhat`` … ``f_dz_block``, which the host-streaming learner
(parallel.streaming) calls one block at a time.

On a mesh (parallel.mesh, one process per rank) each rank runs the same
step on its L = N / nb blocks: the consensus mean is one all-reduce over
'block' per d-iteration, a 'freq' axis splits the per-frequency solves
(``fslice`` before each solve, ``all_gather_tiled`` after it), and a
'filter' axis splits the k axis of the filters and codes, with one psum
per k-sum. :func:`outer_chunk_scan` runs ``cfg.outer_chunk`` steps with
one host read a chunk (the chunked driver). With ``cfg.metrics_dir`` the
step also computes the telemetry
scalars (:class:`ObsExtras`), which ride the step's one host read. The
JAX package's documented
divergences from the reference (coding against the projected consensus
dictionary, the objective over all blocks, independent per-block z
inits) hold here too.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import LearnConfig, ProblemGeom
from ..ops import fourier, freq_solvers, fused_z, proxes
from ..parallel import mesh as mesh_lib
from ..utils import profiling
from . import common


class LearnState(NamedTuple):
    """Learner state on one device (one rank of a mesh). Block-local
    fields carry a leading block axis [L, ...]; the consensus fields
    dbar/udbar do not. Under a 'filter' mesh axis every field holds this
    rank's K / nk filters."""

    d_local: torch.Tensor  # [L, k, *reduce, *spatial] full-domain filters
    dual_d: torch.Tensor  # [L, k, *reduce, *spatial]
    dbar: torch.Tensor  # [k, *reduce, *spatial] consensus average
    udbar: torch.Tensor  # [k, *reduce, *spatial] consensus dual average
    z: torch.Tensor  # [L, ni, k, *spatial] block-local codes
    dual_z: torch.Tensor  # [L, ni, k, *spatial]


class ObsExtras(NamedTuple):
    """Telemetry scalars of a step (``cfg.with_obs_metrics``, utils.obs),
    0-d float32 tensors computed next to the metrics, so they leave the
    card in the step's one host read:

    - ``obj_fid`` / ``obj_l1``: the z-pass objective split into its
      data-fidelity and sparsity terms (0 when the objective is not
      tracked, as obj_z);
    - ``consensus_dis``: RMS consensus disagreement of the per-block
      dictionaries, sqrt(mean_i ||d_i - dbar||^2) / ||dbar||;
    - ``nonfinite_z``: the count of non-finite entries of the new codes.
    """

    obj_fid: torch.Tensor
    obj_l1: torch.Tensor
    consensus_dis: torch.Tensor
    nonfinite_z: torch.Tensor


class OuterMetrics(NamedTuple):
    """0-d float32 tensors on the state's device (read by the driver in
    one host sync per step)."""

    obj_d: torch.Tensor  # global objective after the d-pass
    obj_z: torch.Tensor  # global objective after the z-pass
    d_diff: torch.Tensor  # rel change of the consensus dictionary
    z_diff: torch.Tensor  # rel change of codes (global norm)
    # telemetry scalars, None unless cfg.with_obs_metrics
    extras: Optional[ObsExtras] = None


class ChunkTrace(NamedTuple):
    """Per-step records of one chunk (models.learn.outer_chunk_scan),
    each stacked on the device with a leading [chunk] axis.

    ``active``: the step attempted an iteration (False once the chunk
    has stopped). ``adopted``: its iterate was finite and became the
    state; only these steps append trace entries in the driver. An
    active step that is not adopted is the non-finite divergence the
    per-step driver guards (its metrics are reported, the carried state
    is the last good one)."""

    metrics: OuterMetrics
    active: torch.Tensor
    adopted: torch.Tensor


def init_state(
    generator: torch.Generator,
    geom: ProblemGeom,
    fg: common.FreqGeom,
    num_blocks: int,
    ni: int,
    dtype=torch.float32,
    z_dtype=None,
    d_dtype=None,
) -> LearnState:
    """Random init matching the reference's shapes: randn filters
    embedded at the origin (dzParallel.m:38-42), randn codes (:44-47),
    zero duals (:79-86), drawn from ``generator`` on its device. Inits
    are drawn in ``dtype`` then rounded to the storage dtypes
    ``z_dtype`` / ``d_dtype`` (LearnConfig.storage_dtype /
    d_storage_dtype); dbar/udbar stay ``dtype``. torch and jax random
    streams differ: parity tests pass the JAX init through
    ``convert.learn_state_from_jax``."""
    dev = generator.device
    d0 = torch.randn(geom.filter_shape, generator=generator, dtype=dtype,
                     device=dev)
    d_full = fourier.circ_embed(d0, fg.spatial_shape)
    d_locals = d_full.expand(num_blocks, *d_full.shape).to(
        d_dtype or dtype
    ).contiguous()
    z0 = torch.randn(
        (num_blocks, ni, geom.num_filters, *fg.spatial_shape),
        generator=generator, dtype=dtype, device=dev,
    ).to(z_dtype or dtype)
    return LearnState(
        d_locals,
        torch.zeros_like(d_locals),
        d_full,
        torch.zeros_like(d_full),
        z0,
        torch.zeros_like(z0),
    )


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def mesh_axes(mesh) -> Tuple[Optional[str], Optional[str], Optional[str]]:
    """The (block, freq, filter) axis names of a learner mesh, None where
    the mesh (or None) has no such axis."""
    if mesh is None:
        return None, None, None
    return tuple(a if a in mesh.shape else None
                 for a in ("block", "freq", "filter"))


def _flat_blocks(x: torch.Tensor) -> torch.Tensor:
    """[L, ni, ...] -> [L*ni, ...] (a view of a contiguous tensor)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def z_iter_composition(z, dual_z, bhat, zkern, rho, theta, fg, mesh=None,
                       freq_axis=None, filter_axis=None):
    """One z iteration as the composition (models/learn.py:366-383 of
    the JAX package): prox + dual update, torch.fft, the rank-1 solve
    (K1 on the card), inverse FFT. z, dual_z: [M, k, *sp] in their
    storage dtype; bhat [M, W, F] (this rank's frequency slice under a
    'freq' axis, as zkern). -> (z', dual') in the storage dtype.
    """
    sd = z.dtype
    z, dual_z = _f32(z), _f32(dual_z)
    u2 = proxes.soft_threshold(z + dual_z, theta)
    dual_z = dual_z + (z - u2)
    xi2_hat = mesh_lib.fslice(common.codes_to_freq(u2 - dual_z, fg), mesh,
                              freq_axis)
    zhat_new = mesh_lib.all_gather_tiled(
        freq_solvers.solve_z(zkern, bhat, xi2_hat, rho, mesh=mesh,
                             axis_name=filter_axis),
        mesh, freq_axis,
    )
    return common.codes_from_freq(zhat_new, fg).to(sd), dual_z.to(sd)


def z_iter_fused(z, dual_z, bhat, zkern, rho, theta, fg):
    """The same iteration as the two kernels K2a/K2b (ops.fused_z):
    only the z/dual state travels through device memory."""
    Sy, Sx = fg.spatial_shape
    Fx = Sx // 2 + 1
    K = z.shape[1]
    return fused_z.fused_z_iter(
        z, dual_z, bhat.reshape(-1, Sy, Fx),
        zkern.dhat.reshape(K, Sy, Fx), zkern.minv_diag.reshape(Sy, Fx),
        rho, theta,
    )


# ---- per-block pieces ------------------------------------------------
# The steps of one consensus block, as plain functions on tensors: the
# streaming learner (parallel.streaming) calls them block by block, and
# outer_step calls the same functions on all of a device's blocks at
# once (a leading block axis broadcasts through each of them). They are
# the counterparts of the JAX package's parallel/streaming.py
# ``_jit_pieces``; ``cfg`` is read at each call, so a rho backoff takes
# effect at the next one.


def f_bhat(b_nn: torch.Tensor, geom: ProblemGeom,
           fg: common.FreqGeom) -> torch.Tensor:
    """Data spectra [M, W, F] of unpadded data [M, *reduce, *data_sp]."""
    return common.data_to_freq(
        fourier.pad_spatial(b_nn, geom.psf_radius, target=fg.spatial_shape),
        fg,
    )


def f_dkern(z_nn: torch.Tensor, bhat_nn: torch.Tensor, cfg: LearnConfig,
            fg: common.FreqGeom, mesh=None, freq_axis=None,
            filter_axis=None) -> freq_solvers.DSolveKernel:
    """The d-pass kernel of codes z_nn [..., ni, k, *sp] (any storage
    dtype) against their data spectra bhat_nn [..., ni, W, F]: the code
    spectra, the Woodbury inner inverse and the hoisted Z^H b, constant
    over the max_it_d inner iterations (this rank's frequency slice
    under a 'freq' axis; the code Gram psummed over 'filter')."""
    lead = z_nn.shape[: z_nn.ndim - len(fg.spatial_shape) - 1]
    zhat = common.codes_to_freq(
        _f32(z_nn).reshape(-1, *z_nn.shape[len(lead):]), fg
    )
    zhat = zhat.reshape(*lead, *zhat.shape[1:])  # [..., ni, K, F]
    return freq_solvers.precompute_d_kernel(
        mesh_lib.fslice(zhat, mesh, freq_axis), cfg.rho_d,
        b_hat=mesh_lib.fslice(bhat_nn, mesh, freq_axis), mesh=mesh,
        axis_name=filter_axis,
    )


def f_prox(dbar: torch.Tensor, udbar: torch.Tensor, geom: ProblemGeom,
           fg: common.FreqGeom) -> torch.Tensor:
    """The global kernel prox of the consensus (dzParallel.m:107)."""
    return proxes.kernel_constraint_proj(
        dbar + udbar, geom.spatial_support, fg.spatial_shape
    )


def f_d_block(kern: freq_solvers.DSolveKernel, d_local: torch.Tensor,
              dual_d: torch.Tensor, u: torch.Tensor, cfg: LearnConfig,
              fg: common.FreqGeom, mesh=None, freq_axis=None,
              filter_axis=None):
    """One inner d-iteration of a block (dzParallel.m:110-113): the dual
    step towards the prox ``u`` and the Woodbury solve. d_local, dual_d
    [..., k, *reduce, *sp] in their storage dtype -> (d_new, dual) in
    float32; the caller rounds them to storage."""
    dual_f = _f32(dual_d) + (_f32(d_local) - u)
    xi_hat = mesh_lib.fslice(common.full_filters_to_freq(u - dual_f, fg),
                             mesh, freq_axis)
    dhat = mesh_lib.all_gather_tiled(
        freq_solvers.solve_d(kern, None, xi_hat, cfg.rho_d, mesh=mesh,
                             axis_name=filter_axis),
        mesh, freq_axis,
    )
    return _filters_from_freq(dhat, fg), dual_f


def f_full_dhat(d_proj: torch.Tensor, fg: common.FreqGeom) -> torch.Tensor:
    """Spectra [K, W, F] of the coding dictionary."""
    return common.full_filters_to_freq(d_proj, fg)


def f_z_block(z, dual_z, bhat, zkern, cfg: LearnConfig, fg: common.FreqGeom,
              z_iter=z_iter_composition):
    """A block's whole z inner loop (dzParallel.m:150-158): max_it_z
    iterations of ``z_iter``. The composition's z-solve is K1 for W == 1
    and the Woodbury solve for W > 1; the streaming learner takes it
    always (it never runs K2, as in JAX). z, dual_z: [M, k, *sp] in
    their storage dtype; bhat [M, W, F]."""
    theta = cfg.lambda_prior / cfg.rho_z
    for _ in range(cfg.max_it_z):
        z, dual_z = z_iter(z, dual_z, bhat, zkern, cfg.rho_z, theta, fg)
    return z, dual_z


def _recon(z_nn: torch.Tensor, dhat: torch.Tensor, fg: common.FreqGeom,
           mesh=None, filter_axis=None):
    """(codes in float32, full-domain reconstruction D z; its filter sum
    psummed over ``filter_axis``)."""
    zf = _f32(z_nn)
    return zf, common.recon_from_freq(dhat, common.codes_to_freq(zf, fg), fg,
                                      mesh, filter_axis)


def _objective(zf, Dz, b_nn, geom: ProblemGeom, cfg: LearnConfig):
    return common.data_fidelity(
        Dz, b_nn, geom.psf_radius, cfg.lambda_residual
    ) + common.l1_penalty(zf, cfg.lambda_prior)


def f_obj_parts(z_nn, b_nn, dhat, geom: ProblemGeom, cfg: LearnConfig,
                fg: common.FreqGeom):
    """(data fidelity, sparsity) of codes z_nn [M, k, *sp] against
    unpadded data b_nn [M, *reduce, *data_sp] (0-d float32 each); their
    sum is :func:`f_obj_block`."""
    zf, Dz = _recon(z_nn, dhat, fg)
    return (common.data_fidelity(Dz, b_nn, geom.psf_radius,
                                 cfg.lambda_residual),
            common.l1_penalty(zf, cfg.lambda_prior))


def f_obj_block(z_nn, b_nn, dhat, geom: ProblemGeom, cfg: LearnConfig,
                fg: common.FreqGeom) -> torch.Tensor:
    """The objective of codes z_nn [M, k, *sp] against unpadded data
    b_nn [M, *reduce, *data_sp] (0-d float32)."""
    fid, l1 = f_obj_parts(z_nn, b_nn, dhat, geom, cfg, fg)
    return fid + l1


def f_dz_block(z_nn, dhat, geom: ProblemGeom,
               fg: common.FreqGeom, data_sp) -> torch.Tensor:
    """The reconstruction of codes z_nn, cropped to the data's extent
    [M, *reduce, *data_sp]."""
    return fourier.crop_spatial(_recon(z_nn, dhat, fg)[1], geom.psf_radius,
                                data_sp)


def z_diff_sums(z_new: torch.Tensor, z_old: torch.Tensor):
    """(sum of squared change, sum of squares of z_new) in float32: the
    parts of the codes' rel change, summed over blocks."""
    zn = _f32(z_new)
    return torch.sum((zn - _f32(z_old)) ** 2), torch.sum(zn * zn)


def fused_z_ok(cfg: LearnConfig, fg: common.FreqGeom, mesh,
               device: torch.device) -> bool:
    """Whether a z-pass runs the fused kernels K2a/K2b. The JAX gate
    (models/learn.py:358-364 there): ``cfg.fused_z`` on the 2D, W == 1
    learner with neither a 'freq' nor a 'filter' axis; plus, on the
    card, the plane must fit K2's shared memory (``ops.fused_z.fits``;
    square planes up to 168²), a shape test made before any launch.
    Every other case takes the composition, whose W == 1 z-solve is K1
    (a 3D learner, a plane above K2's limit; the plain body under
    'filter') and W > 1 the Woodbury solve. On the CPU K2's plain
    version takes any plane, as JAX's fused path does."""
    _, ax_f, ax_k = mesh_axes(mesh)
    return (
        cfg.fused_z and fg.reduce_size == 1 and len(fg.spatial_shape) == 2
        and ax_f is None and ax_k is None
        and (device.type != "cuda" or fused_z.fits(*fg.spatial_shape))
    )


def fused_z_note(cfg: LearnConfig, fg: common.FreqGeom, mesh,
                 device: torch.device) -> Optional[str]:
    """The console note for a ``fused_z`` run whose plane K2 cannot
    hold on the card (the gate sends its z-passes to the composition);
    None otherwise."""
    if not cfg.fused_z or fused_z_ok(cfg, fg, mesh, device):
        return None
    if not fused_z_ok(cfg, fg, mesh, torch.device("cpu")):
        return None  # not a K2 geometry at all: JAX's gate, no note
    Sy, Sx = fg.spatial_shape
    return (f"fused_z: a {Sy}x{Sx} plane exceeds K2's shared memory "
            f"({max(fused_z.smem_bytes(Sy, Sx, b) for b in (False, True))}"
            f" > {fused_z._MAX_SMEM} bytes a block); the z-passes run the "
            "composition (cuFFT + K1)")


def outer_step(
    state: LearnState,
    b_blocks: torch.Tensor,
    geom: ProblemGeom,
    cfg: LearnConfig,
    fg: common.FreqGeom,
    num_blocks: int,
    on_phase: Optional[Callable[[str], None]] = None,
    mesh=None,
    poison: Optional[torch.Tensor] = None,
) -> Tuple[LearnState, OuterMetrics]:
    """One outer consensus iteration over this device's L blocks.

    b_blocks: [L, ni, *reduce, *data_spatial] (unpadded), on the state's
    device. ``num_blocks`` is the global block count N (= L on one
    device). ``on_phase`` (optional) is called with "step_start",
    "d_start", "gram_end" (the code Grams and their inverses built),
    "d_end", "z_start" and "z_end" at the phase boundaries — the driver
    records CUDA events there to time the passes apart.

    ``mesh``: this rank's parallel.mesh.Mesh (axes 'block' and at most
    one of 'freq' / 'filter'); L = N / nb and the state holds this
    rank's shard. Every metric comes back reduced over the mesh, the
    same on every rank.

    ``poison`` (chaos testing only, utils.faults): a 0-d bool tensor on
    the state's device; where true, the z iterate is NaN after the
    z-pass (a ``torch.where`` on the card, no host read), so z_diff and
    obj_z go non-finite exactly as on a real blow-up. None (the
    default) launches nothing.
    """
    mark = on_phase or (lambda _name: None)
    mark("step_start")
    ax_b, ax_f, ax_k = mesh_axes(mesh)
    if ax_f is not None and ax_k is not None:
        raise ValueError(
            "freq and filter tensor parallelism cannot be combined"
        )
    # every axis a global scalar crosses (objective, z_diff)
    global_axes = tuple(a for a in (ax_b, ax_k) if a is not None) or None
    sh = dict(mesh=mesh, freq_axis=ax_f, filter_axis=ax_k)
    L, ni = b_blocks.shape[0], b_blocks.shape[1]
    bhat = f_bhat(_flat_blocks(b_blocks), geom, fg)  # [L*ni, W, F]
    bhat_blocks = bhat.reshape(L, ni, *bhat.shape[1:])

    def objective_parts(z, dhat):
        """(fidelity, sparsity); their sum is the objective."""
        if not cfg.with_objective:
            # the reference evaluates it only when monitoring wants it
            zero = torch.zeros((), dtype=torch.float32, device=z.device)
            return zero, zero
        if mesh is None:
            return f_obj_parts(_flat_blocks(z), _flat_blocks(b_blocks), dhat,
                               geom, cfg, fg)
        zf, Dz = _recon(_flat_blocks(z), dhat, fg, mesh, ax_k)
        fid = common.data_fidelity(Dz, _flat_blocks(b_blocks),
                                   geom.psf_radius, cfg.lambda_residual)
        # fid is replicated over 'filter' after Dz's psum; the l1 term is
        # k-local and reduces over block AND filter
        return mesh_lib.psum(fid, mesh, ax_b), mesh_lib.psum(
            common.l1_penalty(zf, cfg.lambda_prior), mesh, global_axes)

    def objective(z, dhat):
        fid, l1 = objective_parts(z, dhat)
        return fid + l1

    # ---------------- d-pass (dzParallel.m:95-135) -------------------
    mark("d_start")
    with profiling.annotate("ccsc.learn.gram"):
        dkern = f_dkern(state.z, bhat_blocks, cfg, fg, **sh)  # [L, ...]
    mark("gram_end")
    dsd = state.d_local.dtype  # d-state storage (d_storage_dtype)
    d_local, dual_d = state.d_local, state.dual_d
    dbar, udbar = state.dbar, state.udbar
    for _ in range(cfg.max_it_d):
        u = f_prox(dbar, udbar, geom, fg)  # global prox (dzParallel.m:107)
        d_new, dual_f = f_d_block(dkern, d_local, dual_d, u, cfg, fg, **sh)
        if ax_b is None:
            dbar = torch.sum(d_new, 0) / num_blocks  # consensus (:115-121)
            udbar = torch.sum(dual_f, 0) / num_blocks
        else:
            # the consensus all-reduce: both sums in one collective
            sums = mesh_lib.psum(
                torch.stack([torch.sum(d_new, 0), torch.sum(dual_f, 0)]),
                mesh, ax_b, tag="consensus",
            ) / num_blocks
            dbar, udbar = sums[0], sums[1]
        d_local, dual_d = d_new.to(dsd), dual_f.to(dsd)
    del dkern
    d_diff = common.rel_change(dbar, state.dbar, mesh=mesh, axis=ax_k)

    # the coding dictionary: the projected consensus average (default),
    # or block 1's unprojected local iterate (the reference's exact
    # semantic, dzParallel.m:143)
    if cfg.compat_coding == "block1":
        d_code = _f32(d_local[0])
        if ax_b is not None:
            # global block 1 lives on rank 0 of the block axis
            if mesh.axis_index(ax_b) != 0:
                d_code = torch.zeros_like(d_code)
            d_code = mesh_lib.psum(d_code, mesh, ax_b)
    elif cfg.compat_coding == "consensus":
        d_code = f_prox(dbar, udbar, geom, fg)
    else:
        raise ValueError(f"unknown compat_coding {cfg.compat_coding!r}")
    dhat_z = f_full_dhat(d_code, fg)
    mark("d_end")
    obj_d = objective(state.z, dhat_z)

    # ---------------- z-pass (dzParallel.m:140-172) ------------------
    mark("z_start")
    zkern = freq_solvers.precompute_z_kernel(
        mesh_lib.fslice(dhat_z, mesh, ax_f), cfg.rho_z, mesh=mesh,
        axis_name=ax_k,
    )
    if fused_z_ok(cfg, fg, mesh, b_blocks.device):
        z_iter = z_iter_fused
    elif mesh is None:
        z_iter = z_iter_composition
    else:
        z_iter = functools.partial(z_iter_composition, **sh)
    z, dual_z = f_z_block(
        _flat_blocks(state.z), _flat_blocks(state.dual_z),
        mesh_lib.fslice(bhat, mesh, ax_f), zkern, cfg, fg, z_iter=z_iter,
    )
    z = z.reshape(state.z.shape)
    dual_z = dual_z.reshape(state.dual_z.shape)
    if poison is not None:
        # chaos injection: NaN the iterate so every downstream metric
        # goes non-finite exactly like a real blow-up
        z = torch.where(poison, torch.full_like(z, float("nan")), z)
    mark("z_end")
    num, den = z_diff_sums(z, state.z)
    if mesh is not None:
        num, den = mesh_lib.psum(torch.stack([num, den]), mesh, global_axes)
    z_diff = torch.sqrt(num) / torch.clamp(torch.sqrt(den), min=1e-30)
    fid_z, l1_z = objective_parts(z, dhat_z)
    obj_z = fid_z + l1_z

    extras = None
    if cfg.with_obs_metrics:
        # telemetry scalars beside the metrics: they leave the card in
        # the same host read, never a fresh one (utils.obs)
        extras = obs_extras(z, d_local, dbar, fid_z, l1_z, num_blocks,
                            mesh=mesh, global_axes=global_axes, ax_k=ax_k)

    new_state = LearnState(d_local, dual_d, dbar, udbar, z, dual_z)
    return new_state, OuterMetrics(obj_d, obj_z, d_diff, z_diff, extras)


def adopt_state(adopted: torch.Tensor, new, old, donate: bool):
    """``new`` where the 0-d bool ``adopted`` holds, else ``old``, field
    by field (a NamedTuple of tensors), as the device select of
    ``torch.where`` (a true select is bitwise ``new``). The select is
    written into ``old``'s storage with ``donate`` (the input state's
    buffers carry the chunk, as a donated state does in JAX), else into
    ``new``'s, so no third state is allocated either way. A field whose
    ``new`` is ``old`` itself is kept as it is."""
    out = []
    for n, o in zip(new, old):
        if n is o:
            out.append(o)
        else:
            out.append(torch.where(adopted, n, o, out=o if donate else n))
    return type(old)(*out)


def outer_chunk_scan(
    state: LearnState,
    b_blocks: torch.Tensor,
    geom: ProblemGeom,
    cfg: LearnConfig,
    fg: common.FreqGeom,
    num_blocks: int,
    chunk: int,
    mesh=None,
    poison_at: Optional[int] = None,
    donate: bool = False,
) -> Tuple[LearnState, ChunkTrace]:
    """``chunk`` outer consensus iterations with no host read between
    them (the JAX package's lax.scan of models/learn.py:446-526 as
    ``chunk`` calls of :func:`outer_step`). The carry is (state, done),
    both on the device; each step keeps the per-step driver's contract
    at chunk granularity:

    - a non-finite step is not adopted (the carry keeps the last finite
      state) and ``done`` latches;
    - a converged step (both diffs below ``cfg.tol``) is adopted, then
      ``done`` latches, so the chunked run lands on the per-step run's
      iterate;
    - steps after ``done`` still run and their results are discarded
      (``active`` False), as in JAX: at most one chunk's tail at the end
      of a run.

    Adoption is a device select (:func:`adopt_state`): bitwise the step's
    own output, so a chunked run equals the per-step run bit for bit.
    ``donate`` writes each adopted step into ``state``'s own storage:
    the caller's input state is consumed (it must rebind to the
    output), and peak memory stays one state below the undonated
    chunk's. ``poison_at`` (chaos, utils.faults): the 0-based step of
    the chunk whose z iterate is NaN-poisoned. Returns (state,
    ChunkTrace); the caller reads the trace once a chunk."""
    dev = b_blocks.device
    done = torch.zeros((), dtype=torch.bool, device=dev)
    recs, actives, adopts = [], [], []
    st = state
    for j in range(chunk):
        poison = (torch.ones((), dtype=torch.bool, device=dev)
                  if poison_at == j else None)
        new, m = outer_step(st, b_blocks, geom, cfg, fg, num_blocks,
                            mesh=mesh, poison=poison)
        finite = torch.all(torch.isfinite(
            torch.stack([m.obj_d, m.obj_z, m.d_diff, m.z_diff])))
        active = torch.logical_not(done)
        adopted = torch.logical_and(active, finite)
        st = adopt_state(adopted, new, st, donate)
        del new
        converged = torch.logical_and(m.d_diff < cfg.tol, m.z_diff < cfg.tol)
        done = torch.logical_or(done, torch.logical_and(
            active, torch.logical_or(torch.logical_not(finite), converged)))
        recs.append(m)
        actives.append(active)
        adopts.append(adopted)
    metrics = OuterMetrics(
        *(torch.stack([getattr(m, f) for m in recs])
          for f in ("obj_d", "obj_z", "d_diff", "z_diff")),
        None if recs[0].extras is None else ObsExtras(
            *(torch.stack([m.extras[i] for m in recs]) for i in range(4))),
    )
    return st, ChunkTrace(metrics, torch.stack(actives),
                          torch.stack(adopts))


def obs_extras(z, d_local, dbar, fid_z, l1_z, num_blocks: int,
               mesh=None, global_axes=None, ax_k=None) -> ObsExtras:
    """The step's :class:`ObsExtras` from its new codes ``z``, the
    per-block dictionaries ``d_local`` and their consensus ``dbar``, and
    the z-pass objective's two terms: a pass over z and one over its
    non-finite mask (the count), and one over ``d_local``. On a mesh the sums reduce over the
    step's global axes (``dbar``'s norm over 'filter' alone)."""
    nonfinite_z = mesh_lib.psum(
        torch.sum(~torch.isfinite(_f32(z))).to(torch.float32), mesh,
        global_axes)
    dn = _f32(d_local) - dbar[None]
    cons_num = mesh_lib.psum(torch.sum(dn * dn), mesh, global_axes)
    cons_den = mesh_lib.psum(torch.sum(dbar * dbar), mesh, ax_k)
    consensus_dis = torch.sqrt(cons_num / num_blocks) / torch.clamp(
        torch.sqrt(cons_den), min=1e-30)
    return ObsExtras(fid_z, l1_z, consensus_dis, nonfinite_z)


def eval_block(
    state: LearnState,
    b_blocks: torch.Tensor,
    geom: ProblemGeom,
    cfg: LearnConfig,
    fg: common.FreqGeom,
    with_outputs: bool = True,
    mesh=None,
):
    """(global objective, support filters, cropped per-block Dz
    [L, ni, *reduce, *data_spatial] or None). Sequential over blocks, as
    in JAX: only one block's code spectra exist at a time. On a
    ``mesh`` the objective is reduced over it, the filters are the whole
    bank on every rank (gathered over 'filter') and Dz holds this rank's
    blocks."""
    ax_b, _, ax_k = mesh_axes(mesh)
    d_proj = f_prox(state.dbar, state.udbar, geom, fg)
    dhat = f_full_dhat(d_proj, fg)
    data_sp = b_blocks.shape[-geom.ndim_spatial:]
    zero = torch.zeros((), dtype=torch.float32, device=b_blocks.device)
    obj, l1 = zero, zero
    Dz_blocks = []
    for zl, bl in zip(state.z, b_blocks):
        zf, Dz = _recon(zl, dhat, fg, mesh, ax_k)  # z may be stored bf16
        if ax_k is None:
            obj = obj + _objective(zf, Dz, bl, geom, cfg)
        else:  # fid replicated over 'filter', l1 k-local
            obj = obj + common.data_fidelity(
                Dz, bl, geom.psf_radius, cfg.lambda_residual)
            l1 = l1 + common.l1_penalty(zf, cfg.lambda_prior)
        if with_outputs:
            Dz_blocks.append(
                fourier.crop_spatial(Dz, geom.psf_radius, data_sp)
            )
    Dz_all = torch.stack(Dz_blocks) if with_outputs else None
    if mesh is not None:
        obj = mesh_lib.psum(obj, mesh, ax_b)
        if ax_k is not None:
            obj = obj + mesh_lib.psum(l1, mesh, (ax_b, ax_k))
    d_sup = mesh_lib.all_gather_tiled(extract_filters(d_proj, geom), mesh,
                                      ax_k, dim=0)
    return obj, d_sup, Dz_all


def _filters_from_freq(dhat: torch.Tensor, fg: common.FreqGeom) -> torch.Tensor:
    """dhat [..., K, W, F] -> full-domain real filters
    [..., k, *reduce, *spatial]."""
    dh = dhat.reshape(*dhat.shape[:-2], *fg.reduce_shape, *fg.freq_shape)
    return fourier.irfftn_spatial(dh, fg.spatial_shape, impl=fg.fft_impl)


def extract_filters(dbar_proj: torch.Tensor, geom: ProblemGeom) -> torch.Tensor:
    """Full-domain consensus filters -> support-domain [k,*reduce,*support]
    (the final circshift+crop, dzParallel.m:202-203)."""
    return fourier.circ_extract(dbar_proj, geom.spatial_support)


class LearnResult(NamedTuple):
    d: torch.Tensor  # [k, *reduce, *support] learned filters
    z: torch.Tensor  # [N, ni, k, *spatial] final codes (block-major)
    Dz: torch.Tensor  # [n, *reduce, *data_spatial] reconstructions
    trace: dict


def learn(b, geom: ProblemGeom, cfg: LearnConfig, **kwargs) -> LearnResult:
    """Learn a filter bank from data b [n, *reduce, *data_spatial]; see
    :func:`ccsc_code_iccv2017_torch.parallel.consensus.learn` for the
    keywords (``device``, ``generator``, ``checkpoint_dir``,
    ``init_d``, ``initial_state``, ...)."""
    from ..parallel import consensus

    return consensus.learn(b, geom, cfg, **kwargs)
