"""Image loading, contrast normalization and the smooth-fill warm start
(a jax-free copy of ``ccsc_code_iccv2017_tpu.data.images``: the four
input forms of the reference's CreateImages.m (a folder, a .mat stack,
a single file, an in-memory array), its color modes and frame strides,
every contrast mode ('none', 'local_cn' and the whitening family of
data.whitening), the channel layouts and ``return_info``,
``load_images_native`` (the native preprocessing library, data.native),
and ``smooth_fill_batch``, the numpy version of
``data.native.smooth_fill_batch``).
"""
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


def _to_unit_rgb(img: np.ndarray) -> np.ndarray:
    """integer/float image -> float32 RGB in [0, 1]. Gray and gray+alpha
    inputs are replicated to 3 channels; RGBA drops alpha; integer
    dtypes are scaled by their full-scale value."""
    if img.ndim == 3 and img.shape[-1] == 2:  # gray + alpha (PIL 'LA')
        img = img[..., 0]
    rgb = img[..., :3] if img.ndim == 3 else np.stack([img] * 3, -1)
    rgb = rgb.astype(np.float32)
    if np.issubdtype(img.dtype, np.integer):
        rgb = rgb / _int_scale(img.dtype)
    return rgb


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """MATLAB rgb2ycbcr on [0,1] floats: ITU-R 601 full-to-studio-swing
    matrix, output still scaled to [0,1]."""
    m = np.array(
        [
            [65.481, 128.553, 24.966],
            [-37.797, -74.203, 112.0],
            [112.0, -93.786, -18.214],
        ],
        np.float32,
    )
    off = np.array([16.0, 128.0, 128.0], np.float32)
    return (rgb @ m.T + off) / 255.0


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """MATLAB rgb2hsv on [0,1] floats: the standard colorsys.rgb_to_hsv
    formula, vectorized."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = rgb.max(-1)
    c = v - rgb.min(-1)
    s = np.where(v > 0, c / np.maximum(v, 1e-30), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        hr = np.where(c > 0, ((g - b) / np.maximum(c, 1e-30)) % 6.0, 0.0)
        hg = np.where(c > 0, (b - r) / np.maximum(c, 1e-30) + 2.0, 0.0)
        hb = np.where(c > 0, (r - g) / np.maximum(c, 1e-30) + 4.0, 0.0)
    h = np.where(v == r, hr, np.where(v == g, hg, hb)) / 6.0
    return np.stack([h, s, v], -1).astype(np.float32)


def convert_color(img: np.ndarray, color: str) -> np.ndarray:
    """CreateImages.m's color dispatch: 'gray' -> [H,W],
    'rgb'/'ycbcr'/'hsv' -> [H,W,3] float32 in [0,1]-scale."""
    if color == "gray":
        return to_gray(img)
    if color == "rgb":
        return _to_unit_rgb(img)
    if color == "ycbcr":
        return rgb_to_ycbcr(_to_unit_rgb(img))
    if color == "hsv":
        return rgb_to_hsv(_to_unit_rgb(img))
    raise NotImplementedError(f"color mode {color!r}")


def _per_channel(fn, img: np.ndarray) -> np.ndarray:
    """Apply a [H,W]->[H,W] transform per color channel."""
    if img.ndim == 2:
        return fn(img)
    return np.stack([fn(img[..., c]) for c in range(img.shape[-1])], -1)


def select_frames(
    items: Sequence, frames: Optional[Sequence] = None
) -> list:
    """The reference's image_frames={A,B,C} stride selection: MATLAB
    `A:B:C`, 1-based inclusive; C may be the string 'end'."""
    if frames is None:
        return list(items)
    start, step, stop = frames
    n = len(items)

    def resolve(v):
        return n if isinstance(v, str) and v == "end" else int(v)

    start, stop, step = resolve(start), resolve(stop), int(step)
    if step == 0:
        raise ValueError("frame stride B must be nonzero")
    if step > 0:
        idx = range(start - 1, min(stop, n), step)
    else:  # MATLAB 7:-2:1 -> items 7,5,3,1 (inclusive of the stop)
        idx = range(min(start, n) - 1, stop - 2, step)
    return [items[i] for i in idx if 0 <= i < n]


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


def _mat_image_stack(
    path: str, layout: Optional[str] = None
) -> List[np.ndarray]:
    """A .mat file holding an image stack -> list of [H, W(, C)] arrays.

    Prefers the variable names the reference looks for (``images``,
    ``original_images``, ``I``; ``b`` in the framework's layout), else
    takes the largest array in the file. An explicit ``layout`` wins;
    else the MATLAB names are image-major-last ([H, W, n] /
    [H, W, C, n]) and ``b`` is batch-leading ([n, H, W] / [n, H, W, C]).
    Unnamed arrays default to MATLAB layout; an unnamed 4-D array whose
    shape fits both ([?, ?, C, n] with a (1,3)-sized trailing axis but a
    non-(1,3) third axis) raises rather than guesses."""
    from ..utils.io_mat import _loadmat
    from ..utils.validate import CCSCInputError

    d = {
        k: np.asarray(v)
        for k, v in _loadmat(path).items()
        if not k.startswith("__") and np.asarray(v).ndim >= 2
    }
    if not d:
        raise CCSCInputError(f"no image array found in {path}")
    named = None
    for name in ("images", "original_images", "I", "b"):
        if name in d:
            arr = d[name]
            named = "framework" if name == "b" else "matlab"
            break
    else:
        arr = max(d.values(), key=lambda a: a.size)
    arr = np.asarray(arr)
    if layout is None:
        layout = named
    if layout is None:
        if (
            arr.ndim == 4
            and arr.shape[-1] in (1, 3)
            and arr.shape[2] not in (1, 3)
        ):
            raise ValueError(
                f"ambiguous unnamed 4-D stack of shape {arr.shape} in "
                f"{path}: could be framework [n, H, W, C] or MATLAB "
                f"[H, W, C, n] with {arr.shape[-1]} images. Pass "
                "mat_layout='framework'/'matlab' or name the variable "
                "'images' (MATLAB) / 'b' (framework)."
            )
        layout = "matlab"
    # a .mat stack can hold NaN: refuse it here, naming the file
    if np.issubdtype(arr.dtype, np.floating):
        bad = int(np.count_nonzero(~np.isfinite(arr)))
        if bad:
            raise CCSCInputError(
                f".mat image stack {path} contains {bad} non-finite "
                "value(s) (NaN/Inf) — clean the export; non-finite "
                "data silently diverges the solvers"
            )
    return array_image_stack(arr, layout=layout)


def array_image_stack(
    arr: np.ndarray, layout: str = "framework"
) -> List[np.ndarray]:
    """Array -> list of [H, W(, C)] images. layout='framework':
    [n, H, W] or [n, H, W, C]; layout='matlab': [H, W, n] or
    [H, W, C, n]. A singleton C axis is squeezed."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        return [arr]
    if layout == "matlab":
        if arr.ndim == 3:
            return [arr[..., i] for i in range(arr.shape[-1])]
        if arr.ndim == 4:
            return [
                np.squeeze(arr[..., i], -1)
                if arr.shape[2] == 1
                else arr[..., i]
                for i in range(arr.shape[-1])
            ]
    elif layout == "framework":
        if arr.ndim == 3:
            return list(arr)
        if arr.ndim == 4:
            return [
                np.squeeze(a, -1) if arr.shape[-1] == 1 else a
                for a in arr
            ]
    else:
        raise ValueError(f"unknown array layout {layout!r}")
    raise ValueError(f"cannot interpret image array of shape {arr.shape}")


def load_image_list(
    path,
    contrast_normalize: str = "none",
    zero_mean: bool = False,
    color: str = "gray",
    limit: Optional[int] = None,
    frames: Optional[Sequence] = None,
    mat_layout: Optional[str] = None,
) -> List[np.ndarray]:
    """Load images as a list of [H, W] (gray) or [H, W, 3]
    (rgb/ycbcr/hsv) float32 arrays — the CreateImagesList.m variant, for
    images of differing sizes (the Poisson app reads it). ``frames`` is
    the reference's {A,B,C} stride over the sorted file list.

    ``path`` may be a directory of images; a directory holding a single
    .mat stack; a .mat file; a single image file; or an in-memory array
    (see array_image_stack for its layouts). Contrast modes: 'none',
    'local_cn', data.whitening's PER_IMAGE_MODES here per image, and its
    STACK_MODES, which load_images applies to the assembled stack.
    """
    from PIL import Image

    if isinstance(path, np.ndarray):
        raws = select_frames(array_image_stack(path), frames)
    elif os.path.isfile(path):
        if path.lower().endswith(".mat"):
            raws = select_frames(
                _mat_image_stack(path, layout=mat_layout), frames
            )
        else:
            raws = select_frames([np.asarray(Image.open(path))], frames)
    else:
        listing = _list_image_files(path)
        if len(listing) == 0:
            mats = [
                os.path.join(path, f)
                for f in sorted(os.listdir(path))
                if f.lower().endswith(".mat")
            ]
            if len(mats) != 1:
                raise ValueError(
                    f"no images and no single .mat stack in {path}"
                )
            raws = select_frames(
                _mat_image_stack(mats[0], layout=mat_layout), frames
            )
        else:
            files = select_frames(listing, frames)
            # decode only what the limit keeps
            files = files[: limit if limit else None]
            raws = [np.asarray(Image.open(f)) for f in files]
    out = []
    for raw in raws[: limit if limit else None]:
        img = convert_color(raw, color)
        if contrast_normalize == "local_cn":
            img = _per_channel(local_contrast_normalize, img)
        elif contrast_normalize != "none":
            from . import whitening

            if contrast_normalize in whitening.PER_IMAGE_MODES:
                img = _per_channel(
                    whitening.PER_IMAGE_MODES[contrast_normalize], img
                )
            elif contrast_normalize not in whitening.STACK_MODES:
                raise NotImplementedError(
                    f"contrast mode {contrast_normalize!r}"
                )
        if zero_mean:
            img = img - img.mean()
        out.append(img.astype(np.float32))
    return out


def _resize(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    from PIL import Image

    def one(ch):
        return np.asarray(
            Image.fromarray(ch).resize((size[1], size[0]), Image.BILINEAR)
        )

    return _per_channel(one, img)


def channels_to_reduce(stack: np.ndarray) -> np.ndarray:
    """[n, H, W, C] -> [n, C, H, W]: color channels as the model's
    reduce axis (b = [n, *reduce, *spatial], config.ProblemGeom) so a
    color stack feeds learn()/reconstruct() with
    ProblemGeom(support, k, reduce_shape=(C,)) — channels share one
    code map the way wavelengths do (2-3D admm_learn.m:13-16)."""
    return np.moveaxis(stack, -1, 1)


def channels_to_batch(stack: np.ndarray) -> np.ndarray:
    """[n, H, W, C] -> [n*C, H, W]: each channel coded independently,
    the reference's per-channel driver loop
    (reconstruct_subsampling_lightfield.m:25 loops rgb)."""
    return np.moveaxis(stack, -1, 1).reshape(-1, *stack.shape[1:-1])


def load_images(
    path,
    contrast_normalize: str = "none",
    zero_mean: bool = False,
    color: str = "gray",
    square: bool = False,
    limit: Optional[int] = None,
    size: Optional[Sequence[int]] = None,
    frames: Optional[Sequence] = None,
    mat_layout: Optional[str] = None,
    layout: str = "channels_last",
    return_info: bool = False,
):
    """CreateImages.m: a folder, .mat stack, single image or in-memory
    array (``load_image_list``) -> [n, H, W] float32 (gray) or, for the
    color modes, a stack whose channel placement ``layout`` picks:

    - 'channels_last': [n, H, W, 3];
    - 'reduce':        [n, 3, H, W] (gray: [n, 1, H, W]), the model
      layout b = [n, *reduce, *spatial] for
      ProblemGeom(support, k, reduce_shape=(3,));
    - 'batch':         [n*3, H, W], channels coded independently.

    Per image, in the JAX loader's order: color conversion, a per-image
    ``contrast_normalize`` mode, ``zero_mean``; then ``size`` resizes,
    ``square`` center-crops to the smaller side, and a stack mode of
    data.whitening whitens the stack (each color channel's apart).

    ``return_info`` returns ``(stack, info)``; ``info['mean_image']``,
    oriented like the stack, is the dataset mean that ``sep_mean``
    removed (CreateImages.m:640-646): ``stack + mean_image`` undoes it.
    """
    imgs = load_image_list(
        path, contrast_normalize, zero_mean, color, limit, frames,
        mat_layout=mat_layout,
    )
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
            f"images differ in size {shapes}; use load_image_list or "
            "pass size= to resize them"
        )
    stack = np.stack(imgs).astype(np.float32)
    from . import whitening

    info = {}
    if contrast_normalize in whitening.STACK_MODES:
        mode = whitening.STACK_MODES[contrast_normalize]
        if stack.ndim == 4:  # color: whiten each channel's stack
            outs = [mode(stack[..., c]) for c in range(stack.shape[-1])]
            if isinstance(outs[0], tuple):  # (stack, aux) modes
                stack = np.stack([o[0] for o in outs], -1)
                info["mean_image"] = np.stack([o[1] for o in outs], -1)
            else:
                stack = np.stack(outs, -1)
        else:
            out = mode(stack)
            if isinstance(out, tuple):
                stack, info["mean_image"] = out
            else:
                stack = out
    out = _apply_layout(stack, layout)
    if "mean_image" in info:
        info["mean_image"] = _mean_to_layout(
            info["mean_image"], layout, stack.shape[0]
        )
    return (out, info) if return_info else out


def _mean_to_layout(mu: np.ndarray, layout: str, n: int) -> np.ndarray:
    """Orient the sep_mean mean image to match _apply_layout's stack so
    ``stack + mean_image`` undoes the centering in every layout."""
    if mu.ndim == 2:  # gray [H, W] broadcasts against every layout
        return mu
    if layout == "reduce":
        return np.moveaxis(mu, -1, 0)  # [C, H, W] vs stack [n, C, H, W]
    if layout == "batch":
        # stack is [n*C, H, W] with channel fastest (channels_to_batch):
        # repeat the per-channel means n times in the same order
        return np.tile(np.moveaxis(mu, -1, 0), (n, 1, 1))
    return mu  # channels_last [H, W, C]


def _apply_layout(stack: np.ndarray, layout: str) -> np.ndarray:
    if layout not in ("channels_last", "reduce", "batch"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "reduce":
        # gray gets a singleton reduce axis so the shape contract
        # [n, *reduce, *spatial] holds for every color mode
        return (
            stack[:, None] if stack.ndim == 3 else channels_to_reduce(stack)
        )
    if layout == "batch" and stack.ndim == 4:
        return channels_to_batch(stack)
    return stack


def load_images_native(
    path: str,
    contrast_normalize: str = "none",
    zero_mean: bool = False,
    **kwargs,
) -> np.ndarray:
    """load_images with the native preprocessing library (data.native):
    images are loaded raw, then local_cn and zero-mean run natively over
    a thread pool, in the numpy path's order (contrast at the original
    resolution, then resize, square crop and layout); the results agree
    with load_images' within float32 rounding. Contrast modes: 'none'
    and 'local_cn'. Falls back to numpy when the library is
    unavailable."""
    from . import native

    # Match load_images' pipeline order exactly: CN (original
    # resolution) -> resize -> square crop -> layout. size/square are
    # deferred so CN sees the same pixels as the numpy path.
    layout = kwargs.pop("layout", "channels_last")
    size = kwargs.pop("size", None)
    square = kwargs.pop("square", False)
    # none/local_cn produce no undo state: info is always empty here
    return_info = kwargs.pop("return_info", False)
    stack = load_images(path, "none", False, **kwargs)
    is_color = stack.ndim == 4
    # the kernel consumes [*, H, W] planes: fold color into the batch
    planes = (
        np.ascontiguousarray(np.moveaxis(stack, -1, 1)).reshape(
            -1, *stack.shape[1:3]
        )
        if is_color
        else stack
    )
    if contrast_normalize == "local_cn":
        planes = native.local_cn_batch(planes)
    elif contrast_normalize != "none":
        raise NotImplementedError(
            f"native path supports none/local_cn, got {contrast_normalize!r}"
        )
    if zero_mean:
        planes = native.zero_mean_batch(planes)
    if is_color:
        stack = np.moveaxis(
            planes.reshape(stack.shape[0], stack.shape[-1], *stack.shape[1:3]),
            1,
            -1,
        )
    else:
        stack = planes
    if size is not None:
        stack = np.stack([_resize(i, size) for i in stack])
    if square:
        s = min(stack.shape[1:3])
        y0 = (stack.shape[1] - s) // 2
        x0 = (stack.shape[2] - s) // 2
        stack = stack[:, y0 : y0 + s, x0 : x0 + s]
    out = _apply_layout(stack.astype(np.float32), layout)
    return (out, {}) if return_info else out
