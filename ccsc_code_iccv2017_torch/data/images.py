"""Image loading, contrast normalization and the smooth-fill warm start
for the 2D slices (a jax-free copy of the grayscale folder path of
``ccsc_code_iccv2017_tpu.data.images``, its ``local_cn`` mode, and the
numpy branch of ``data.native.smooth_fill_batch``; the port does not
load the native preprocessing library)."""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".ppm", ".pgm")


def gaussian_kernel(size: int = 13, sigma: float = 3 * 1.591) -> np.ndarray:
    """MATLAB fspecial('gaussian',[13 13],3*1.591) — the smoothing
    kernel of the reference's local_cn mode and the smooth fill."""
    r = (size - 1) / 2
    y, x = np.mgrid[-r : r + 1, -r : r + 1]
    k = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float64)


def rconv2(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """'same' 2-D convolution with reflected-edge padding
    (image_helpers/rconv2.m)."""
    from scipy.signal import convolve2d

    ry, rx = k.shape[0] // 2, k.shape[1] // 2
    xp = np.pad(x, ((ry, ry), (rx, rx)), mode="symmetric")
    return convolve2d(xp, k, mode="valid")


def local_contrast_normalize(img: np.ndarray) -> np.ndarray:
    """The reference's 'local_cn' mode (CreateImages.m:299-370):
    subtract a local Gaussian mean and divide by a local std that is
    floored at its own median (median of nonzeros if the median is 0).
    """
    k = gaussian_kernel()
    dim = img.astype(np.float64)
    lmn = rconv2(dim, k)
    lmnsq = rconv2(dim * dim, k)
    lvar = np.maximum(lmnsq - lmn * lmn, 0.0)
    lstd = np.sqrt(lvar)
    th = np.median(lstd)
    if th == 0:
        nz = lstd[lstd > 0]
        th = np.median(nz) if nz.size else 0.0
    lstd = np.maximum(lstd, th)
    lstd[lstd == 0] = np.finfo(np.float64).eps
    return ((dim - lmn) / lstd).astype(np.float32)


def smooth_fill_batch(
    imgs: np.ndarray,
    mask: np.ndarray,
    ksize: int = 13,
    sigma: float = 3 * 1.591,
) -> np.ndarray:
    """Normalized-convolution Gaussian fill G*(b.m)/max(G*m, 1e-6) of
    [n, H, W] (or one [H, W]) masked images — the reconstruction apps'
    smooth_init warm start."""
    imgs = np.ascontiguousarray(imgs, np.float32)
    mask = np.ascontiguousarray(mask, np.float32)
    if imgs.shape != mask.shape:
        raise ValueError(f"shape mismatch {imgs.shape} vs {mask.shape}")
    if imgs.ndim == 2:
        return smooth_fill_batch(imgs[None], mask[None], ksize, sigma)[0]
    k = gaussian_kernel(ksize, sigma)
    return np.stack(
        [
            (rconv2(b * m, k) / np.maximum(rconv2(m, k), 1e-6)).astype(
                np.float32
            )
            for b, m in zip(imgs, mask)
        ]
    )


def smooth_noise_images(
    rng: np.random.Generator, n: int, size: int, sigma: float = 3.0
) -> np.ndarray:
    """[n, size, size] float32 images in [0, 1]: white noise from ``rng``
    smoothed by a periodic Gaussian of width ``sigma`` and rescaled per
    image — synthetic stand-ins for natural images where none ship with
    the repo (the reference's test JPGs)."""
    from scipy.ndimage import gaussian_filter

    out = []
    for _ in range(n):
        x = gaussian_filter(rng.normal(size=(size, size)), sigma, mode="wrap")
        out.append(((x - x.min()) / (x.max() - x.min())).astype(np.float32))
    return np.stack(out)


def _int_scale(dtype) -> float:
    return float(np.iinfo(dtype).max)


def to_gray(img: np.ndarray) -> np.ndarray:
    """rgb2gray with MATLAB's ITU-R 601 weights, output in [0, 1]."""
    is_int = np.issubdtype(img.dtype, np.integer)
    if img.ndim == 3 and img.shape[-1] == 2:  # gray + alpha (PIL 'LA')
        img = img[..., 0]
    if img.ndim == 2:
        g = img.astype(np.float32)
    else:
        w = np.array([0.2989, 0.5870, 0.1140], np.float32)
        g = img[..., :3].astype(np.float32) @ w
    if is_int:
        g = g / _int_scale(img.dtype)
    return g


def _list_image_files(path: str) -> List[str]:
    files = [
        f for f in sorted(os.listdir(path)) if f.lower().endswith(IMG_EXTS)
    ]

    # numeric-aware sort so 2.jpg < 10.jpg, like MATLAB dir listings
    def keyf(f):
        stem = os.path.splitext(f)[0]
        return (0, int(stem)) if stem.isdigit() else (1, stem)

    files.sort(key=keyf)
    return [os.path.join(path, f) for f in files]


def _resize(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    from PIL import Image

    return np.asarray(
        Image.fromarray(img).resize((size[1], size[0]), Image.BILINEAR)
    )


def load_images(
    path: str,
    contrast_normalize: str = "none",
    zero_mean: bool = False,
    square: bool = False,
    limit: Optional[int] = None,
    size: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """A folder of images -> [n, H, W] float32 grayscale (CreateImages.m
    with color 'gray'). Per image, in the JAX loader's order: to gray
    in [0, 1], ``contrast_normalize`` ('none' or 'local_cn'), then
    ``zero_mean``; then ``size`` resizes and ``square`` center-crops to
    the smaller side. Other input forms (.mat stacks, single files,
    color) and contrast modes come with later slices."""
    from PIL import Image

    if not os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is not a directory: the port loads image folders "
            "only (.mat stacks and single files come with a later slice)"
        )
    if contrast_normalize not in ("none", "local_cn"):
        raise NotImplementedError(
            f"contrast mode {contrast_normalize!r} is not ported yet "
            "(the port runs 'none' and 'local_cn')"
        )
    files = _list_image_files(path)[: limit if limit else None]
    if not files:
        raise ValueError(f"no images in {path}")
    imgs = []
    for f in files:
        img = to_gray(np.asarray(Image.open(f)))
        if contrast_normalize == "local_cn":
            img = local_contrast_normalize(img)
        if zero_mean:
            img = img - img.mean()
        imgs.append(img.astype(np.float32))
    if size is not None:
        imgs = [_resize(i, size) for i in imgs]
    if square:
        def crop(i):
            s = min(i.shape[:2])
            y0, x0 = (i.shape[0] - s) // 2, (i.shape[1] - s) // 2
            return i[y0 : y0 + s, x0 : x0 + s]

        imgs = [crop(i) for i in imgs]
    shapes = {i.shape for i in imgs}
    if len(shapes) > 1:
        raise ValueError(
            f"images differ in size {shapes}; pass size= to resize them"
        )
    return np.stack(imgs).astype(np.float32)
