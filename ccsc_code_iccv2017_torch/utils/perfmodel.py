"""Utilization estimation: achieved FLOP/s and memory GB/s vs the card's
datasheet peaks (torch port of the parts of
``ccsc_code_iccv2017_tpu.utils.perfmodel`` the run telemetry reads:
``detect_chip``, ``analytic_outer_step_cost``, ``inmem_learn_estimate``
(with the auto-degrade ladder's budget), ``bound_iters_per_sec``, ``serving_bound`` and ``utilization``).

``analytic_outer_step_cost`` is a copy: a closed-form count of the CCSC
outer step (FFTs, Grams, Cholesky, per-frequency solves, proxes) from
its shapes. The roofline it feeds (utils.obs ``roofline`` records)
divides by the H100 SXM5 datasheet peaks. Every FLOP the port runs is
float32 (K1 and K2 on the CUDA cores, float32 cuFFT, float32 einsums
with TF32 off), so :func:`bound_iters_per_sec` divides by the
non-tensor FP32 peak, where the JAX package divides by the bf16 MXU
peak; ``mfu`` keeps its JAX meaning, the fraction of the dense bf16
tensor-core peak.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

# Datasheet peaks per card. "h100": NVIDIA H100 Tensor Core GPU
# datasheet, SXM5 80GB column (dense, without sparsity): 989.4 TFLOP/s
# bf16 tensor core, 66.9 TFLOP/s FP32 (CUDA cores), 3.35 TB/s HBM3.
# "cpu": nominal figures so a CPU run still emits the fields (~1
# TFLOP/s, ~50 GB/s), labeled by the chip field and comparable to
# nothing on the card.
CHIP_PEAKS: Dict[str, Dict[str, float]] = {
    "h100": {"flops_bf16": 989.4e12, "flops_f32": 66.9e12,
             "hbm_gbps": 3.35e12},
    "cpu": {"flops_bf16": 1e12, "flops_f32": 1e12, "hbm_gbps": 50e9},
}


def detect_chip(device=None) -> str:
    """The roofline row of the run's device: ``"cpu"`` for a CPU run (a
    CPU run must never be scored against the card's roofline),
    ``"h100"`` for an H100 with HBM3 memory, and ``"<name>->h100"`` for
    any other card (scored against the H100 row, labeled as such).
    ``device`` None: cuda:0 when a card is visible, else the CPU."""
    import torch

    dev = (torch.device("cuda" if torch.cuda.is_available() else "cpu")
           if device is None else torch.device(device))
    if dev.type != "cuda":
        return "cpu"
    try:
        name = torch.cuda.get_device_name(dev)
    except (RuntimeError, AssertionError):
        return "unknown-gpu->h100"
    if "H100" in name and "HBM3" in name:
        return "h100"
    return f"{name}->h100"


def _peaks(chip: str) -> Dict[str, float]:
    return CHIP_PEAKS.get(chip.split("->")[-1], CHIP_PEAKS["h100"])


def _fft_flops(spatial: tuple, batch: int, fft_impl: str = "xla") -> float:
    """Real-FFT cost over the trailing spatial dims for ``batch``
    independent transforms. 'xla': 2.5 * S * log2(S) real flops each
    (the standard split-radix estimate, halved for rfft). 'matmul': one
    [*, side] x [side, ~side/2] complex matmul per axis — ~4 * S *
    sum(sides) real flops."""
    S = math.prod(spatial)
    if fft_impl.startswith("matmul"):  # 'matmul' and 'matmul_bf16'
        return 4.0 * S * sum(spatial) * batch
    return 2.5 * S * max(math.log2(S), 1.0) * batch


def analytic_outer_step_cost(
    *,
    num_blocks: int,
    ni: int,
    k: int,
    spatial: tuple,
    num_freq: int,
    max_it_d: int,
    max_it_z: int,
    reduce_size: int = 1,
    dtype_bytes: int = 4,
    fft_impl: str = "xla",
    fused_z: bool = False,
    state_dtype_bytes: Optional[int] = None,
    d_state_dtype_bytes: Optional[int] = None,
    donate_state: bool = False,
) -> Dict[str, float]:
    """Closed-form FLOP / memory-byte count of ONE consensus outer step
    (models.learn.outer_step): the d-pass code-Gram + Cholesky +
    max_it_d Woodbury solves, and max_it_z z-pass Sherman-Morrison
    solves, plus every FFT boundary in between. Complex MAC = 8 real
    flops; Cholesky of the 2m x 2m real embedding = (2m)^3 / 3 plus two
    triangular solves ~ (2m)^3.

    Byte counts are the minimal memory traffic of each stage (inputs
    read once + outputs written once per fused stage) — a lower bound
    that makes the reported bandwidth fraction an upper bound on
    headroom. A copy of the JAX package's count (the fused z-iteration
    terms describe K2's two passes as well)."""
    N, W, F = num_blocks, reduce_size, num_freq
    S = math.prod(spatial)
    n_imgs = N * ni
    cplx = 2 * dtype_bytes

    flops = 0.0
    # initial code spectra zhat: rfft over all codes
    flops += _fft_flops(spatial, n_imgs * k, fft_impl)
    # code Gram G_f = Z_f Z_f^H per block: F * ni^2 * k complex MACs
    flops += 8.0 * N * F * ni * ni * k
    # Cholesky of [F, 2ni, 2ni] + 2 triangular solves per block
    m2 = 2 * ni
    flops += N * F * (m2**3 / 3.0 + m2**3)
    # Z^H b hoisted out of the d-iterations
    flops += 8.0 * N * F * k * ni * W
    for _ in range(max_it_d):
        # filter FFT fwd+inv: N*k transforms each way
        flops += 2 * _fft_flops(spatial, N * k * W, fft_impl)
        # solve_d einsums: t, s-apply, final — 8F(2 k ni W + ni^2 W)/blk
        flops += 8.0 * N * F * (2 * k * ni * W + ni * ni * W)
    # z-pass filter spectra + per-iteration solves
    flops += _fft_flops(spatial, k * W, fft_impl)
    for _ in range(max_it_z):
        if fused_z:
            # fused kernel: pass B recomputes the forward spectra, so 3
            # transform-equivalents at matmul cost; prox runs twice
            flops += 3 * _fft_flops(spatial, n_imgs * k, "matmul")
            flops += 8.0 * 3 * n_imgs * k * F * W
            flops += 12.0 * n_imgs * k * S
        else:
            # codes FFT fwd+inv
            flops += 2 * _fft_flops(spatial, n_imgs * k, fft_impl)
            # scalar-path Sherman-Morrison: 3 einsums of k MACs per (n, f)
            flops += 8.0 * 3 * n_imgs * k * F * W
            # soft-threshold + dual updates: ~6 elementwise ops
            flops += 6.0 * n_imgs * k * S

    # spectra are always complex64; the spatial-domain z and d states
    # carry their LearnConfig storage dtypes
    z_bytes = n_imgs * k * S * (state_dtype_bytes or dtype_bytes)
    zh_bytes = n_imgs * k * F * cplx  # code spectra
    bytes_ = 0.0
    bytes_ += z_bytes + zh_bytes  # initial zhat
    bytes_ += N * F * (2 * ni) ** 2 * dtype_bytes * 2  # Gram + inverse
    for _ in range(max_it_d):
        bytes_ += 4 * N * k * W * S * (d_state_dtype_bytes or dtype_bytes)
        bytes_ += 2 * N * k * W * F * cplx  # filter spectra r/w
        bytes_ += N * F * ni * ni * cplx  # ginv read
    for _ in range(max_it_z):
        if fused_z:
            # pass A reads z+dual and writes dual'+t; pass B re-reads
            # z+dual (+s) and writes z' — six z-sized transfers
            bytes_ += 6 * z_bytes
            bytes_ += 2 * n_imgs * F * 8  # t/s re+im f32 buffers
        else:
            bytes_ += 4 * z_bytes  # z, dual, u2, xi2
            bytes_ += 3 * zh_bytes  # spectra through the solve
    if not donate_state:
        # one extra read+write of the full ADMM state per outer step
        # (the JAX program's output materialization; the port's eager
        # step also writes a fresh state)
        db = d_state_dtype_bytes or dtype_bytes
        state_out = (
            2 * z_bytes  # z + dual_z
            + 2 * N * k * W * S * db  # d_local + dual_d
            + 2 * k * W * S * dtype_bytes  # dbar + udbar
        )
        bytes_ += 2 * state_out
    return {"flops": flops, "bytes": bytes_}


def inmem_learn_estimate(b_shape, geom, cfg, device=None):
    """Pre-flight byte estimate of the in-memory consensus learner's
    peak working set, and the device budget to compare it against:
    ``(est_bytes, budget_bytes)``, as the JAX function returns. The
    estimate: ~5 live full-batch complex code spectra inside the z
    iteration plus the z / dual state (and, without
    ``cfg.donate_state``, one more copy of the output state).

    The budget is ``CCSC_INMEM_HBM_GB`` when set. Unset, it is the
    learner ``device``'s free bytes (``torch.cuda.mem_get_info``; None:
    cuda:0 when a card is visible), where JAX keeps its 14 GB default
    of a 16 GB TPU; on the CPU it is infinite, so the auto-degrade
    ladder's preflight never fires there and only its runtime rung
    applies."""
    import torch

    from ..models.common import FreqGeom

    fg_est = FreqGeom.create(
        geom, tuple(b_shape[-geom.ndim_spatial:]),
        fft_pad=cfg.fft_pad, fft_impl=cfg.fft_impl,
    )
    n = b_shape[0]
    k = geom.num_filters
    S = math.prod(fg_est.spatial_shape)
    zb = getattr(torch, cfg.storage_dtype).itemsize
    est = 5 * n * k * fg_est.num_freq * 8 + 2 * n * k * S * zb
    if not cfg.donate_state:
        db = getattr(torch, cfg.d_storage_dtype).itemsize
        W = geom.reduce_size
        N = cfg.num_blocks
        est += (
            2 * n * k * S * zb  # z + dual_z output copies
            + 2 * N * k * W * S * db  # d_local + dual_d
            + 2 * k * W * S * 4  # dbar + udbar (f32)
        )
    from . import env as _env

    gb = _env.env_float("CCSC_INMEM_HBM_GB")
    if gb is not None:
        return est, gb * 1e9
    dev = (torch.device("cuda" if torch.cuda.is_available() else "cpu")
           if device is None else torch.device(device))
    if dev.type != "cuda":
        return est, math.inf
    return est, float(torch.cuda.mem_get_info(dev)[0])


def bound_iters_per_sec(
    cost: Dict[str, float], chip: Optional[str] = None
) -> float:
    """Roofline upper bound on outer iterations/sec for this cost on
    this chip: the tighter of the memory-traffic bound (bytes / peak
    bandwidth) and the compute bound (flops / the float32 peak, the
    type every FLOP of the port runs in)."""
    peaks = _peaks(chip or detect_chip())
    t_flops = cost["flops"] / peaks["flops_f32"]
    t_bytes = cost["bytes"] / peaks["hbm_gbps"]
    t = max(t_flops, t_bytes)
    return 1.0 / t if t > 0 else float("inf")


def serving_bound(
    iters_per_sec: float,
    iters_per_request: float,
    slots: int,
    occupancy: float = 1.0,
) -> Dict[str, float]:
    """Requests/sec bound of one serving bucket (serve.CodecEngine): a
    dispatch advances all its occupied slots together, so at a measured
    per-iteration rate of the batched bucket solve the ceiling is
    ``iters_per_sec * slots * occupancy / iters_per_request`` (a copy of
    the JAX package's)."""
    if iters_per_request <= 0 or slots < 1:
        return {"requests_per_sec": 0.0}
    rps = iters_per_sec * slots * max(0.0, min(occupancy, 1.0))
    return {
        "requests_per_sec": rps / iters_per_request,
        "iters_per_sec": iters_per_sec,
        "slots": slots,
        "occupancy": occupancy,
        "iters_per_request": iters_per_request,
    }


def utilization(
    cost: Dict[str, float], steps_per_sec: float, chip: Optional[str] = None
) -> Dict[str, float]:
    """Achieved FLOP/s / GB/s and their fractions of the card's peaks
    (``mfu_vs_bf16_peak`` against the dense bf16 tensor-core peak, as in
    the JAX package). An unknown chip is scored against the H100 row and
    labeled ``<chip>->h100``."""
    chip = chip or detect_chip()
    if chip.split("->")[-1] not in CHIP_PEAKS:
        chip = f"{chip}->h100"
    peaks = _peaks(chip)
    fps = cost["flops"] * steps_per_sec
    bps = cost["bytes"] * steps_per_sec
    return {
        "chip": chip,
        "flops_per_step": cost["flops"],
        "bytes_per_step": cost["bytes"],
        "achieved_tflops": fps / 1e12,
        "achieved_gbps": bps / 1e9,
        "mfu_vs_bf16_peak": fps / peaks["flops_bf16"],
        "hbm_frac": bps / peaks["hbm_gbps"],
    }
