"""Hyperspectral / video / lightfield data preparation (a jax-free copy of
``ccsc_code_iccv2017_tpu.data.volumes``; the generators draw the same
numbers from the same seed).

Rebuilds of the reference's higher-dimensional loaders:
- hyperspectral grouping: every ``bands`` consecutive grayscale files
  form one [w, H, W] cube (image_helpers/CreateImages_Robin.m:182-191).
- video extraction: mp4 -> resized grayscale frame stack
  (3D/extractMovie.m:33-57) with optional per-frame local contrast
  normalization (3D/extractContrastNormalizatonMovie.m:23-30 — whose
  `local_cn` helper is missing in the reference; ours is the real one).
- random volume / lightfield patch extraction for training
  (3D/learn_kernels_3D.m:35-44 random 50^3 crops;
  4D/Datasets_lf/learn_kernels_4D_extract_patches.m:41-53 random
  50x50x5x5 sub-lightfields).

All outputs use the framework layouts (config.ProblemGeom): video
[n, X, Y, T] (all spatial/FFT dims), hyperspectral [n, W, X, Y],
lightfield [n, A1, A2, X, Y].
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .images import _list_image_files, local_contrast_normalize, to_gray


def load_hyperspectral_dir(
    path: str, bands: int = 31, limit: Optional[int] = None
) -> np.ndarray:
    """Folder of grayscale band images -> [n, bands, H, W]
    (CreateImages_Robin.m:182-191 grouping)."""
    from PIL import Image

    from ..utils.validate import CCSCInputError

    files = _list_image_files(path)
    if not files:
        raise CCSCInputError(
            f"no band images found in {path} — expected a folder of "
            f"grayscale files, every {bands} consecutive files one cube"
        )
    if len(files) % bands:
        raise CCSCInputError(
            f"{len(files)} files in {path} not divisible by "
            f"bands={bands} — each cube needs exactly {bands} "
            "consecutive band images"
        )
    cubes = []
    for i in range(0, len(files), bands):
        cube = np.stack(
            [to_gray(np.asarray(Image.open(f))) for f in files[i : i + bands]]
        )
        cubes.append(cube.astype(np.float32))
        if limit and len(cubes) >= limit:
            break
    return np.stack(cubes)


def extract_movie(
    path: str,
    side: int = 100,
    max_frames: Optional[int] = None,
    contrast_normalize: bool = False,
) -> np.ndarray:
    """mp4/avi -> [X, Y, T] grayscale stack (extractMovie.m:33-57),
    optionally local-CN per frame (extractContrastNormalizatonMovie.m).
    """
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        g = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32) / 255.0
        g = cv2.resize(g, (side, side), interpolation=cv2.INTER_AREA)
        if contrast_normalize:
            g = local_contrast_normalize(g)
        frames.append(g)
        if max_frames and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames, axis=-1)  # [X, Y, T]


def random_volume_crops(
    vol: np.ndarray,
    n: int,
    size: Sequence[int],
    seed: int = 0,
) -> np.ndarray:
    """[X, Y, T] -> [n, sx, sy, st] random crops
    (learn_kernels_3D.m:35-44)."""
    r = np.random.default_rng(seed)
    out = np.empty((n, *size), vol.dtype)
    for i in range(n):
        offs = [r.integers(0, d - s + 1) for d, s in zip(vol.shape, size)]
        out[i] = vol[tuple(slice(o, o + s) for o, s in zip(offs, size))]
    return out


def random_lightfield_patches(
    lf: np.ndarray,
    n: int,
    spatial: int = 50,
    seed: int = 0,
) -> np.ndarray:
    """Full lightfield [A1, A2, X, Y] -> [n, A1, A2, s, s] random
    spatial patches (learn_kernels_4D_extract_patches.m:41-53)."""
    r = np.random.default_rng(seed)
    a1, a2, X, Y = lf.shape
    out = np.empty((n, a1, a2, spatial, spatial), lf.dtype)
    for i in range(n):
        x = r.integers(0, X - spatial + 1)
        y = r.integers(0, Y - spatial + 1)
        out[i] = lf[:, :, x : x + spatial, y : y + spatial]
    return out


# ----------------------------------------------------------------------
# Synthetic demo data — the reference's large blobs (training_data.mat,
# full_movie.mat, food_localCN_bis3_8x8.mat, test_data.mat) are absent
# (`.MISSING_LARGE_BLOBS`, SURVEY.md section 5); these generators let
# every app run end-to-end without them.
# ----------------------------------------------------------------------


def synthetic_hyperspectral(
    n: int = 4, bands: int = 31, side: int = 48, seed: int = 0
) -> np.ndarray:
    """[n, bands, side, side]: random smooth spatial fields x smooth
    spectral response curves + band-limited noise."""
    from scipy.ndimage import gaussian_filter

    r = np.random.default_rng(seed)
    cubes = []
    for _ in range(n):
        fields = np.stack(
            [gaussian_filter(r.normal(size=(side, side)), s) for s in (1.5, 3, 6)]
        )
        curves = np.abs(
            np.stack([gaussian_filter(r.normal(size=bands), 3) for _ in range(3)])
        )
        cube = np.einsum("mxy,mw->wxy", fields, curves)
        cube += 0.02 * r.normal(size=cube.shape)
        cube -= cube.min()
        cube /= max(cube.max(), 1e-9)
        cubes.append(cube.astype(np.float32))
    return np.stack(cubes)


def synthetic_video(
    n: int = 8, side: int = 32, frames: int = 16, seed: int = 0
) -> np.ndarray:
    """[n, side, side, frames]: smooth blobs drifting with constant
    velocity — gives the 3D learner spatio-temporal structure."""
    from scipy.ndimage import gaussian_filter

    r = np.random.default_rng(seed)
    margin = 2 * frames  # enough room for |v| <= 2 px/frame
    clips = []
    for _ in range(n):
        base = gaussian_filter(
            r.normal(size=(side + 2 * margin, side + 2 * margin)), 2.0
        )
        vx, vy = r.integers(-2, 3, 2)
        clip = np.stack(
            [
                base[
                    margin + vx * t : margin + vx * t + side,
                    margin + vy * t : margin + vy * t + side,
                ]
                for t in range(frames)
            ],
            axis=-1,
        )
        clips.append(clip.astype(np.float32))
    out = np.stack(clips)
    out -= out.mean()
    return out / max(np.abs(out).max(), 1e-9)


def synthetic_lightfield(
    views: int = 5, side: int = 64, seed: int = 0
) -> np.ndarray:
    """[views, views, side, side]: textured plane with per-view
    disparity shift — the structure view synthesis exploits."""
    from scipy.ndimage import gaussian_filter, shift as nd_shift

    r = np.random.default_rng(seed)
    tex = gaussian_filter(r.normal(size=(side + 16, side + 16)), 1.2)
    lf = np.empty((views, views, side, side), np.float32)
    c = views // 2
    for u in range(views):
        for v in range(views):
            sh = nd_shift(tex, ((u - c) * 0.8, (v - c) * 0.8), order=1)
            lf[u, v] = sh[8 : 8 + side, 8 : 8 + side]
    lf -= lf.min()
    return lf / max(lf.max(), 1e-9)
