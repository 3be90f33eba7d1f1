"""Served-result quality: the valid-region PSNR (a copy of
``ccsc_code_iccv2017_tpu.serve.quality.valid_region_psnr``; the rest of
that module, the quality observatory, is ROADMAP.md Queue 1 item 11)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def valid_region_psnr(
    rec: np.ndarray, ref: np.ndarray, radius: Tuple[int, ...]
) -> float:
    """PSNR of the cropped (request-shaped) reconstruction against its
    ground truth, with the same psf-radius border crop as common.psnr —
    the in-solve trace averages over the whole bucket canvas, which
    dilutes the MSE of a padded request with unconstrained pad pixels.
    The same computation as the JAX package's, so both engines quote
    one number for one reconstruction."""
    rec = np.asarray(rec)
    ref = np.asarray(ref)
    nd = len(radius)
    sl = tuple(
        slice(r, s - r) for r, s in zip(radius, rec.shape[-nd:])
    )
    sl = (Ellipsis, *sl)
    mse = float(np.mean((rec[sl] - ref[sl]) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))
