"""Inputs made from ``--seed``, on the device, in a few large calls.

The same seed gives the same bank cut, images, masks, warm starts and
initial state; the harness hands the same tensors (or their host
copies) to the program and to the reference. The recipes are those of
the program's ``serve/bench.py::make_requests`` (Gaussian-smoothed
noise in [0, 1], a 50% mask, the smooth fill) and
``parallel/mesh_check.py::training_images`` (the same noise, local
contrast normalisation, zero mean), written here in torch so that a
later change to the program cannot move the yardstick.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from .reference import fourier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# purposes of the generators drawn from one seed
_IMAGES, _MASKS, _INIT, _ORDER = range(4)


def generator(seed: int, purpose: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one purpose of one seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + purpose) % (2 ** 63))


def rng(seed: int, purpose: int = _ORDER) -> np.random.Generator:
    """A host generator for orders and arrival gaps."""
    return np.random.default_rng([int(seed) % (2 ** 63), purpose])


def bank(config: dict) -> np.ndarray:
    """The configuration's filter bank [K, s, s] float32: the first
    ``num_filters`` filters of its .mat file (MATLAB layout [s, s, k])."""
    import scipy.io

    d = scipy.io.loadmat(os.path.join(REPO, config["bank"]))["d"]
    d = np.ascontiguousarray(np.transpose(d, (2, 0, 1)), np.float32)
    return d[: config["num_filters"]]


def smooth_noise(gen: torch.Generator, n: int, side: int,
                 sigma: float = 3.0) -> torch.Tensor:
    """[n, side, side] float32 in [0, 1]: white noise smoothed by a
    periodic Gaussian of width ``sigma`` (truncated at 4 sigma, as
    scipy's gaussian_filter), rescaled per image."""
    dev = gen.device
    x = torch.randn((n, side, side), generator=gen, device=dev,
                    dtype=torch.float64)
    r = int(4 * sigma + 0.5)
    t = torch.arange(-r, r + 1, device=dev, dtype=torch.float64)
    k = torch.exp(-t * t / (2 * sigma * sigma))
    k = k / k.sum()
    x = F.pad(x[:, None], (r, r, 0, 0), mode="circular")
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    x = F.pad(x, (0, 0, r, r), mode="circular")
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))[:, 0]
    lo = x.amin((1, 2), keepdim=True)
    hi = x.amax((1, 2), keepdim=True)
    return ((x - lo) / (hi - lo)).to(torch.float32)


def smooth_fill(b: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The apps' warm start: the normalised convolution
    G*(b m) / max(G*m, 1e-6), G the 13 x 13 Gaussian of width 3 * 1.591
    with reflected edges (smooth_fill_batch)."""
    g = fourier.gaussian(13, 3 * 1.591, torch.float64, b.device)
    num = fourier.rconv2((b * m).double(), g)
    den = torch.clamp(fourier.rconv2(m.double(), g), min=1e-6)
    return (num / den).to(torch.float32)


def inpaint_requests(seed: int, n: int, side: int, device) -> dict:
    """``n`` distinct inpainting requests of side x side as host arrays:
    ``b`` (the masked image), ``mask`` (50% observed) and
    ``smooth_init``."""
    x = smooth_noise(generator(seed, _IMAGES, device), n, side)
    m = (torch.rand(x.shape, generator=generator(seed, _MASKS, device),
                    device=device) < 0.5).to(torch.float32)
    b = x * m
    sm = smooth_fill(b, m)
    return {k: v.cpu().numpy() for k, v in
            (("b", b), ("mask", m), ("smooth_init", sm))}


def training_images(seed: int, n: int, side: int, device) -> torch.Tensor:
    """[n, side, side] float32 training images: smooth noise, the
    reference's local contrast normalisation (CreateImages.m:299-370:
    subtract a local Gaussian mean, divide by the local std floored at
    its median) and zero mean, on ``device``."""
    x = smooth_noise(generator(seed, _IMAGES, device), n, side).double()
    g = fourier.gaussian(13, 3 * 1.591, torch.float64, device)
    mean = fourier.rconv2(x, g)
    std = torch.sqrt(torch.clamp(fourier.rconv2(x * x, g) - mean * mean,
                                 min=0.0))
    floor = std.reshape(n, -1).median(1).values.reshape(n, 1, 1)
    std = torch.maximum(std, floor)
    y = (x - mean) / torch.clamp(std, min=torch.finfo(torch.float64).eps)
    y = y - y.mean((1, 2), keepdim=True)
    return y.to(torch.float32)


def learn_init(seed: int, k: int, s: int, blocks: int, ni: int, size: int,
               device):
    """The learner's random start (dzParallel.m:38-47): randn filters
    [k, s, s] and randn codes [blocks, ni, k, size, size], float32."""
    gen = generator(seed, _INIT, device)
    d0 = torch.randn((k, s, s), generator=gen, device=device)
    z0 = torch.randn((blocks, ni, k, size, size), generator=gen,
                     device=device)
    return d0, z0


def poisson_gaps(seed: int, n: int, seconds: float) -> np.ndarray:
    """``n`` inter-arrival gaps summing to ``seconds``: the n
    mid-quantiles of an exponential law, in an order drawn from the
    seed. Every seed offers the same set of gaps, so seeds differ in
    order, not in load."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps *= seconds / gaps.sum()
    return rng(seed).permutation(gaps)


def window_count(rate: float, seconds: float) -> int:
    """Arrivals an open loop offers in a window."""
    return max(1, int(math.floor(rate * seconds + 0.5)))
