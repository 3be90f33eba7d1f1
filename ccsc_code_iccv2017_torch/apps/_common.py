"""The flags the reconstruction apps share (the port's counterpart of the
JAX package's ``apps/_dispatch.py`` argument helpers), and what an app's
``run`` returns.

Every flag of the JAX CLIs parses here with the same name, choices and
default; a non-default value of a feature the port has not ported yet
is refused where the config reads it (``config.SolveConfig`` for
``--fft-impl``, ``--tune`` and ``--metrics-dir``) or by
:func:`refuse_unported` (``--tune-store``), naming the ROADMAP.md item
that ports it.
"""
from __future__ import annotations

import argparse
from typing import Any, NamedTuple


def add_perf_args(parser: argparse.ArgumentParser, fft_pad: bool = True) -> None:
    """``--fft-pad`` (not for the unpadded problems, where a rounded-up
    FFT domain would change the problem), ``--fft-impl``, ``--tune`` and
    ``--tune-store``."""
    if fft_pad:
        parser.add_argument(
            "--fft-pad", default="none", choices=["none", "pow2", "fast"],
            help="round the FFT domain up to a fast size",
        )
    parser.add_argument(
        "--fft-impl", default="xla",
        choices=["xla", "matmul", "matmul_high", "matmul_bf16"],
        help="FFT strategy; the port runs 'xla' (torch.fft) only",
    )
    parser.add_argument(
        "--tune", default="off", choices=["off", "auto", "sweep"],
        help="knob autotuning; the port runs 'off' only",
    )
    parser.add_argument(
        "--tune-store", default=None, metavar="PATH",
        help="tuned-knob store path (autotuning is not ported yet)",
    )


def add_obs_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--metrics-dir", default=None,
        help="telemetry stream directory (telemetry is not ported yet)",
    )


def add_mat_layout_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--mat-layout", choices=["matlab", "framework"], default=None,
        help="layout of an unnamed .mat image stack: matlab [H,W(,C),n] "
        "or framework [n,H,W(,C)]",
    )


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to solve on (default cuda; 'cpu' for tests)",
    )


def refuse_unported(args: argparse.Namespace) -> None:
    if getattr(args, "tune_store", None) is not None:
        raise NotImplementedError(
            "--tune-store: knob autotuning is not ported yet "
            "(ROADMAP.md Queue 1 item 9)"
        )


class AppRun(NamedTuple):
    """What an app's ``run`` returns: the solve's result (a list of them
    for the Poisson app, one per image), the app's quality number and
    its baseline as the app prints them, and the iterations run (summed
    over the Poisson app's images)."""

    result: Any
    psnr_db: float
    baseline_psnr_db: float
    iters: int
