"""Whitening and contrast-normalization modes (a copy of
``ccsc_code_iccv2017_tpu.data.whitening``, which is pure numpy).

The reference's preprocessing family inside
image_helpers/CreateImages.m:291-646 and
image_helpers/contrast_normalization/: laplacian_cn, box_cn, PCA/ZCA
whitening (image- and patch-based), 1/f Fourier whitening with its
inverse, and sep_mean. Each is a numpy function over [n, H, W] stacks,
reached from data.images.load_images by its ``contrast_normalize`` mode
name (``PER_IMAGE_MODES`` per image, ``STACK_MODES`` on the stack).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .images import gaussian_kernel, rconv2


def laplacian_cn(img: np.ndarray) -> np.ndarray:
    """Laplacian edge filtering (CreateImages.m:371-387, the 'CVPR 2010
    method'): convolve with a 3x3 Laplacian, reflect boundaries."""
    k = np.array(
        [[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]], np.float64
    )
    return rconv2(img.astype(np.float64), k).astype(np.float32)


def box_cn(img: np.ndarray, size: int = 13) -> np.ndarray:
    """local_cn with a box (mean) kernel instead of a Gaussian
    (CreateImages.m:388-399)."""
    k = np.ones((size, size), np.float64) / (size * size)
    dim = img.astype(np.float64)
    lmn = rconv2(dim, k)
    lvar = np.maximum(rconv2(dim * dim, k) - lmn * lmn, 0.0)
    lstd = np.sqrt(lvar)
    th = np.median(lstd)
    if th == 0:
        nz = lstd[lstd > 0]
        th = np.median(nz) if nz.size else 0.0
    lstd = np.maximum(lstd, th)
    lstd[lstd == 0] = np.finfo(np.float64).eps
    return ((dim - lmn) / lstd).astype(np.float32)


def sep_mean(stack: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Subtract the dataset mean image (CreateImages.m:640-646).
    Returns (centered stack, mean image)."""
    mu = stack.mean(axis=0)
    return (stack - mu).astype(np.float32), mu.astype(np.float32)


def _flatten_images(stack: np.ndarray) -> np.ndarray:
    return stack.reshape(stack.shape[0], -1)


def pca_whiten_images(
    stack: np.ndarray, eps: float = 1e-5, keep: Optional[int] = None
) -> np.ndarray:
    """Whole-image PCA whitening (CreateImages.m:400-438): eigendecompose
    the image-vector covariance, rescale by 1/sqrt(eig + eps)."""
    X = _flatten_images(stack).astype(np.float64)
    X = X - X.mean(axis=0)
    # n << pixels: use the Gram trick through SVD over images
    U, S, Vt = np.linalg.svd(X, full_matrices=False)
    if keep:
        U, S, Vt = U[:, :keep], S[:keep], Vt[:keep]
    n = X.shape[0]
    scale = 1.0 / np.sqrt(S**2 / n + eps)
    Xw = (U * (S * scale)) @ Vt
    return Xw.reshape(stack.shape).astype(np.float32)


def zca_whiten_images(stack: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Whole-image ZCA whitening (CreateImages.m:439-475): PCA whitening
    rotated back into pixel space (W = V diag(1/sqrt(e+eps)) V^T)."""
    X = _flatten_images(stack).astype(np.float64)
    mu = X.mean(axis=0)
    X = X - mu
    U, S, Vt = np.linalg.svd(X, full_matrices=False)
    n = X.shape[0]
    scale = 1.0 / np.sqrt(S**2 / n + eps)
    Xw = (U * (S * scale)) @ Vt  # == X V diag(scale) V^T
    return Xw.reshape(stack.shape).astype(np.float32)


def zca_conv_filters(
    stack: np.ndarray,
    patch: int = 9,
    eps: float = 1e-2,
    num_patches: int = 20000,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Derive convolutional whitening AND dewhitening kernels from
    patch-level ZCA — the intent of
    contrast_normalization/region_zca.m (a dev scratch upstream with
    missing helpers, SURVEY.md section 2.3 #18): estimate the patch
    covariance C from random patches; the center rows of C^{-1/2}
    (whitening) and C^{+1/2} (dewhitening) are the shift-invariant
    filter approximations of the two transforms."""
    r = np.random.default_rng(seed)
    n, H, W = stack.shape
    ps = []
    for _ in range(num_patches):
        i = r.integers(0, n)
        y = r.integers(0, H - patch + 1)
        x = r.integers(0, W - patch + 1)
        ps.append(stack[i, y : y + patch, x : x + patch].ravel())
    P = np.stack(ps).astype(np.float64)
    P -= P.mean(axis=0)
    C = P.T @ P / P.shape[0]
    e, V = np.linalg.eigh(C)
    e = np.maximum(e, 0) + eps
    Wz = V @ np.diag(1.0 / np.sqrt(e)) @ V.T
    Dz = V @ np.diag(np.sqrt(e)) @ V.T
    center = (patch * patch) // 2
    wk = Wz[center].reshape(patch, patch)[::-1, ::-1]
    dk = Dz[center].reshape(patch, patch)[::-1, ::-1]
    return wk, dk


def zca_whiten_patches(
    stack: np.ndarray,
    patch: int = 9,
    eps: float = 1e-2,
    num_patches: int = 20000,
    seed: int = 0,
) -> np.ndarray:
    """Patch-based ZCA whitening applied as a convolution
    (CreateImages.m:476-589 / region_zca.m intent): apply the
    zca_conv_filters whitening kernel with reflected boundaries."""
    kern, _ = zca_conv_filters(stack, patch, eps, num_patches, seed)
    out = np.stack([rconv2(im.astype(np.float64), kern) for im in stack])
    return out.astype(np.float32)


def zca_conv_dewhiten(
    stack: np.ndarray, dewhiten_kernel: np.ndarray
) -> np.ndarray:
    """Apply the dewhitening kernel from zca_conv_filters (the inverse
    conv transform region_zca.m derives)."""
    out = np.stack(
        [rconv2(im.astype(np.float64), dewhiten_kernel) for im in stack]
    )
    return out.astype(np.float32)


def inv_f_whiten_filter(
    shape: Tuple[int, int], f0_frac: float = 0.4
) -> np.ndarray:
    """The rho*exp(-(rho/f0)^4) Fourier whitening filter of
    contrast_normalization/inv_f_whiten.m:67-83 (fftshifted layout)."""
    H, W = shape
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.fftfreq(W)[None, :]
    rho = np.sqrt(fy * fy + fx * fx)
    f0 = f0_frac * 0.5  # fraction of Nyquist
    return (rho * np.exp(-((rho / f0) ** 4))).astype(np.float64)


def inv_f_whiten(img: np.ndarray, f0_frac: float = 0.4) -> np.ndarray:
    """1/f whitening: multiply the spectrum by rho*exp(-(rho/f0)^4)
    (inv_f_whiten.m)."""
    filt = inv_f_whiten_filter(img.shape, f0_frac)
    return np.real(np.fft.ifft2(np.fft.fft2(img) * filt)).astype(np.float32)


def inv_f_dewhiten(img: np.ndarray, f0_frac: float = 0.4) -> np.ndarray:
    """Inverse of inv_f_whiten (inv_f_dewhiten.m:42-53): divide the
    spectrum by the same filter, zeroing the DC bin it cannot carry."""
    filt = inv_f_whiten_filter(img.shape, f0_frac)
    # zero out bins the forward filter attenuated below float precision
    # instead of amplifying their rounding noise
    thresh = filt.max() * 1e-6
    inv = np.where(filt > thresh, 1.0 / np.maximum(filt, thresh), 0.0)
    return np.real(np.fft.ifft2(np.fft.fft2(img) * inv)).astype(np.float32)


# mode registry used by data.images.load_images
PER_IMAGE_MODES = {
    "laplacian_cn": laplacian_cn,
    "box_cn": box_cn,
    "inv_f_whitening": inv_f_whiten,
}
STACK_MODES = {
    "PCA_whitening": pca_whiten_images,
    "ZCA_image_whitening": zca_whiten_images,
    "ZCA_patch_whitening": zca_whiten_patches,
    # sep_mean returns (centered stack, mean image); the mean is kept
    # for later re-addition (CreateImages.m:640-646) and surfaced via
    # load_images(return_info=True).
    "sep_mean": sep_mean,
}
