"""Typed configuration of the PyTorch/CUDA port.

A jax-free copy of ``ccsc_code_iccv2017_tpu.config``'s ``ProblemGeom``,
``GEOM_2D`` and ``SolveConfig``: every field, name and default is
identical (tests/test_torch_config.py holds the two side by side), so a
configuration reads the same in both packages. The port implements the
single-device 2D reconstruction solve; the fields it does not implement
yet refuse a non-default value with ``NotImplementedError`` naming the
ROADMAP.md item that ports them, instead of being silently ignored.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ProblemGeom:
    """Geometry of one CCSC problem family, dimension-generic.

    - ``spatial_support``: spatial filter support over which the FFT is
      taken, e.g. (11, 11) for 2D.
    - ``reduce_shape``: extra filter/data dims shared by one code map
      (wavelengths, angular views). Empty for 2D/3D.
    - ``num_filters``: k, the filter-bank size.

    Canonical layouts (batch leading, FFT axes trailing):

    ==========  =========================================
    data b      [n, *reduce, *spatial]
    filters d   [k, *reduce, *spatial_support]
    codes z     [n, k, *spatial_padded]
    Dz          [n, *reduce, *spatial_padded]
    ==========  =========================================
    """

    spatial_support: Tuple[int, ...]
    num_filters: int
    reduce_shape: Tuple[int, ...] = ()

    @property
    def ndim_spatial(self) -> int:
        return len(self.spatial_support)

    @property
    def ndim_reduce(self) -> int:
        return len(self.reduce_shape)

    @property
    def reduce_size(self) -> int:
        return math.prod(self.reduce_shape) if self.reduce_shape else 1

    @property
    def psf_radius(self) -> Tuple[int, ...]:
        # floor(psf_s/2) per spatial dim
        return tuple(s // 2 for s in self.spatial_support)

    def padded_shape(self, data_spatial: Tuple[int, ...]) -> Tuple[int, ...]:
        """Spatial shape after symmetric zero padding by psf_radius."""
        return tuple(
            s + 2 * r for s, r in zip(data_spatial, self.psf_radius)
        )

    @property
    def filter_shape(self) -> Tuple[int, ...]:
        return (self.num_filters, *self.reduce_shape, *self.spatial_support)


GEOM_2D = lambda k=100, s=11: ProblemGeom((s, s), k)


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Hyperparameters of the reconstruction (coding) solve.

    ``gamma_factor``/``gamma_ratio`` encode the per-app gamma heuristic
    ``g = factor * lambda_prior / max(b); gamma = [g/ratio, g]``
    (inpainting 60/100). See the JAX package's ``SolveConfig`` for the
    full story of each field; the notes here cover what differs in the
    port.

    ``use_pallas`` is kept for name parity and is not read: on a CUDA
    tensor the W == 1 z-solve always runs the hand-written rank-1 kernel
    (ops.kernels.solve_z_rank1). ``herm_inv`` only affects W > 1
    problems, which this slice does not solve.
    """

    lambda_residual: float = 5.0
    lambda_prior: float = 2.0
    max_it: int = 100
    tol: float = 1e-3
    gamma_factor: float = 60.0
    gamma_ratio: float = 100.0
    scale_rho_by_reduce: bool = False
    lambda_smooth: float = 0.5
    dtype: str = "float32"
    verbose: str = "brief"
    track_objective: Optional[bool] = None
    track_psnr: Optional[bool] = None
    use_pallas: bool = False
    fft_pad: str = "none"
    fft_impl: str = "xla"
    storage_dtype: str = "float32"
    herm_inv: Optional[str] = None
    metrics_dir: Optional[str] = None
    tune: str = "off"
    track_diagnostics: bool = False

    def __post_init__(self):
        if self.tune not in ("off", "auto", "sweep"):
            raise ValueError(
                f"tune must be 'off' | 'auto' | 'sweep', got "
                f"{self.tune!r}"
            )
        if self.storage_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"storage_dtype must be 'float32' | 'bfloat16', got "
                f"{self.storage_dtype!r}"
            )
        if self.herm_inv not in (None, "cholesky", "schur", "newton"):
            raise ValueError(
                f"herm_inv must be None | 'cholesky' | 'schur' | "
                f"'newton', got {self.herm_inv!r}"
            )
        if self.tune != "off":
            raise NotImplementedError(
                f"tune={self.tune!r}: knob autotuning is not ported yet "
                "(ROADMAP.md Queue 1 item 9); use tune='off'"
            )
        if self.metrics_dir is not None:
            raise NotImplementedError(
                "metrics_dir: run telemetry is not ported yet "
                "(ROADMAP.md Queue 1 item 10); leave it None"
            )
        if self.fft_impl != "xla":
            raise NotImplementedError(
                f"fft_impl={self.fft_impl!r}: the matmul-DFT tiers are "
                "not ported yet (ROADMAP.md Queue 1 item 9); the port "
                "runs torch.fft ('xla')"
            )

    @property
    def with_objective(self) -> bool:
        if self.track_objective is None:
            return self.verbose != "none"
        return self.track_objective

    @property
    def with_psnr(self) -> bool:
        if self.track_psnr is None:
            return self.verbose != "none"
        return self.track_psnr
