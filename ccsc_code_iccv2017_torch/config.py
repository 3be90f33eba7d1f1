"""Typed configuration of the PyTorch/CUDA port.

A jax-free copy of ``ccsc_code_iccv2017_tpu.config``'s ``ProblemGeom``,
``GEOM_2D``, ``LearnConfig``, ``SolveConfig`` and ``ServeConfig``: every
field, name and default is identical (tests/test_torch_config.py holds
the two side by side), so a configuration reads the same in both
packages. The port implements the reconstruction solves, the
consensus, masked and streaming learners, the serving engine and their
run telemetry (``metrics_dir``, the SLO targets, ``verbose='all'``
figures); the fields it does not implement yet refuse a non-default
value with ``NotImplementedError`` naming the ROADMAP.md item that ports
them, instead of being silently ignored.
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


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({where})")


@dataclasses.dataclass(frozen=True)
class LearnConfig:
    """Hyperparameters of the consensus dictionary learner.

    Defaults follow 2D/learn_kernels_2D_large.m:15-24 and the rho
    constants of admm_learn_conv2D_large_dzParallel.m (rho_d=5000,
    rho_z=1). See the JAX package's ``LearnConfig`` for the full story
    of each field; the notes here cover what differs in the port.

    - ``fused_z``: on a CUDA tensor the z inner iteration runs the two
      hand-written kernels K2a/K2b (ops.fused_z); on a CPU tensor their
      plain version. Only the 2D, W == 1 learner takes it; every other
      geometry takes the composition path, as in JAX.
    - ``fused_z_precision``: all three tiers run K2's float32 body (full
      f32 on the CUDA cores), which meets the bounds JAX sets for
      ``"high"`` and ``"default"`` a fortiori. K2 is not bound by its
      operations on the card, so a cheaper tier would buy nothing.
    - ``carry_freq``: the masked learner (models.learn_masked) carries
      the spectrum across its inner iterations; the consensus learner
      does not read it, as in JAX.
    - ``use_pallas`` is kept for name parity and is not read: on a CUDA
      tensor the composition path's z-solve always runs K1.
    - ``storage_dtype`` / ``d_storage_dtype``: ``float32`` or
      ``bfloat16`` (f32 math, rounded store, as in JAX).
    - ``metrics_dir``: the run's telemetry stream (utils.obs);
      ``verbose='all'`` also writes per-iteration figures as PNG files
      (utils.display).
    - ``watchdog`` / ``watchdog_slack``: the dispatch-fence watchdog
      (utils.watchdog) around each step's one host read; its deadline
      comes from the H100 row of the roofline on the card.
    """

    lambda_residual: float = 1.0
    lambda_prior: float = 1.0
    max_it: int = 20
    tol: float = 1e-3
    max_it_d: int = 5
    max_it_z: int = 10
    rho_d: float = 5000.0
    rho_z: float = 1.0
    num_blocks: int = 1
    dtype: str = "float32"
    verbose: str = "brief"  # 'none' | 'brief' | 'all'
    track_objective: Optional[bool] = None
    compat_coding: str = "consensus"
    use_pallas: bool = False
    fused_z: bool = False
    fused_z_precision: str = "highest"
    fft_pad: str = "none"
    storage_dtype: str = "float32"
    d_storage_dtype: str = "float32"
    fft_impl: str = "xla"
    outer_chunk: int = 1
    donate_state: bool = False
    max_recoveries: int = 0
    rho_backoff: float = 0.5
    metrics_dir: Optional[str] = None
    watchdog: bool = False
    watchdog_slack: float = 20.0
    carry_freq: bool = False
    tune: str = "off"

    @property
    def with_objective(self) -> bool:
        if self.track_objective is None:
            return self.verbose != "none"
        return self.track_objective

    @property
    def with_obs_metrics(self) -> bool:
        """True when the step computes the telemetry scalars
        (models.learn.ObsExtras): only with ``metrics_dir`` set, so an
        un-instrumented run computes exactly what it did before."""
        return self.metrics_dir is not None

    def __post_init__(self):
        # the JAX package's own validation, identical messages
        if self.outer_chunk < 1:
            raise ValueError(
                f"outer_chunk must be >= 1, got {self.outer_chunk}"
            )
        if self.max_recoveries < 0:
            raise ValueError(
                f"max_recoveries must be >= 0, got {self.max_recoveries}"
            )
        if not (0.0 < self.rho_backoff <= 1.0):
            raise ValueError(
                f"rho_backoff must be in (0, 1], got {self.rho_backoff}"
            )
        if self.watchdog_slack <= 0:
            raise ValueError(
                f"watchdog_slack must be > 0, got {self.watchdog_slack}"
            )
        if self.tune not in ("off", "auto", "sweep"):
            raise ValueError(
                f"tune must be 'off' | 'auto' | 'sweep', got "
                f"{self.tune!r}"
            )
        if self.fused_z_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"fused_z_precision must be 'highest' | 'high' | "
                f"'default', got {self.fused_z_precision!r}"
            )
        # what the port does not implement yet
        item9 = "ROADMAP.md Queue 1 item 9"
        if self.outer_chunk > 1 or self.donate_state:
            raise _not_ported(
                "outer_chunk > 1 / donate_state (the chunked driver)", item9
            )
        if self.fft_impl != "xla":
            raise _not_ported(
                f"fft_impl={self.fft_impl!r} (the matmul-DFT tiers)", item9
            )
        if self.tune != "off":
            raise _not_ported(f"tune={self.tune!r} (knob autotuning)", item9)

    @property
    def chunked_driver(self) -> bool:
        """True when the driver must route through the chunked step —
        never in the port, which refuses outer_chunk > 1 and
        donate_state above."""
        return self.outer_chunk > 1 or self.donate_state


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
    (ops.kernels.solve_z_rank1). ``herm_inv`` selects the W > 1
    problems' Gram inverse; the port runs 'cholesky' (None) only.
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


# ServeConfig fields of later ROADMAP.md Queue 1 items: (field, the
# values that ask for what the port does, the item that ports the rest)
_SERVE_DEFERRED = (
    ("tune", ("off",), 9), ("tune_store", (None,), 9),
    ("pipeline_depth", (None, 1), 9),
    ("compile_cache", (None,), 11), ("artifact_store", (None, ""), 11),
    ("replica_id", (None,), 11), ("staged_warmup", (None, False), 11),
    ("warm_order", (None,), 11), ("warm_rank_capture", (None, ""), 11),
)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Configuration of the reconstruction serving engine
    (serve.CodecEngine): the shape-bucket table, the micro-batch flush
    and what a result carries. Every field, name and default is the JAX
    package's (tests/test_torch_config.py holds them side by side; see
    its ``ServeConfig`` for each field's story).

    ``buckets`` is ``((slots, spatial_shape), ...)``: a request is padded
    (mask-excluded) up to the smallest bucket that fits, and up to
    ``slots`` requests ride one dispatch of that bucket. The port serves
    ``buckets``, ``max_wait_ms``, ``return_codes``, ``verbose``,
    ``aot_warmup`` (one short warm dispatch per bucket at construction,
    which builds the kernels and the cuFFT plans), ``mesh_shape``,
    ``mesh_devices``, ``metrics_dir`` (the engine's telemetry stream),
    the SLO fields (``slo_p50_ms``, ``slo_p99_ms``, ``slo_check_s``,
    ``slo_profile_dir``: serve.slo) and ``capture_dir`` (workload
    capture of a standalone engine: serve.capture; None falls back to
    ``CCSC_CAPTURE_DIR``, "" is off); every other field refuses a value
    other than its default with ``NotImplementedError`` naming the
    ROADMAP.md item that ports it.

    ``mesh_shape`` ``(batch,)`` or ``(batch, freq)`` serves every bucket
    from a mesh of devices driven by the engine's one process (None:
    the ``CCSC_SERVE_MESH`` env knob, else one device; ``()``: one
    device regardless of the knob): each bucket's slots split over the
    batch axis, and each slot's per-frequency z-solves over 'freq'.
    ``mesh_devices`` names the card index of each mesh position in
    row-major order (batch outer); an index may repeat, so
    ``mesh_devices=(0, 0)`` runs two positions on one card. Every
    bucket's slots must divide by the batch axis.
    """

    buckets: Tuple[Tuple[int, Tuple[int, ...]], ...]
    max_wait_ms: float = 5.0
    compile_cache: Optional[str] = None
    aot_warmup: bool = True
    return_codes: bool = False
    metrics_dir: Optional[str] = None
    verbose: str = "brief"
    tune: str = "off"
    tune_store: Optional[str] = None
    replica_id: Optional[int] = None
    slo_p50_ms: Optional[float] = None
    slo_p99_ms: Optional[float] = None
    slo_check_s: Optional[float] = None
    slo_profile_dir: Optional[str] = None
    capture_dir: Optional[str] = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_devices: Optional[Tuple[int, ...]] = None
    artifact_store: Optional[str] = None
    staged_warmup: Optional[bool] = None
    warm_order: Optional[Tuple[str, ...]] = None
    warm_rank_capture: Optional[str] = None
    pipeline_depth: Optional[int] = None

    def __post_init__(self):
        # the JAX package's checks and normalization, verbatim
        for fname in ("slo_p50_ms", "slo_p99_ms", "slo_check_s"):
            v = getattr(self, fname)
            if v is not None and v <= 0:
                raise ValueError(
                    f"{fname} must be > 0 when set, got {v}"
                )
        if self.tune not in ("off", "auto", "sweep"):
            raise ValueError(
                f"tune must be 'off' | 'auto' | 'sweep', got "
                f"{self.tune!r}"
            )
        if self.replica_id is not None and int(self.replica_id) < 0:
            raise ValueError(
                f"replica_id must be >= 0, got {self.replica_id}"
            )
        if (
            self.pipeline_depth is not None
            and int(self.pipeline_depth) < 1
        ):
            raise ValueError(
                f"pipeline_depth must be >= 1 when set, got "
                f"{self.pipeline_depth}"
            )
        if not self.buckets:
            raise ValueError("ServeConfig.buckets must be non-empty")
        norm = []
        for entry in self.buckets:
            try:
                slots, spatial = entry
                spatial = tuple(int(s) for s in spatial)
                slots = int(slots)
            except (TypeError, ValueError):
                raise ValueError(
                    f"bucket {entry!r} is not (slots, spatial_shape)"
                )
            if slots < 1 or any(s < 1 for s in spatial):
                raise ValueError(
                    f"bucket {entry!r}: slots and spatial dims must be "
                    ">= 1"
                )
            norm.append((slots, spatial))
        ndims = {len(sp) for _, sp in norm}
        if len(ndims) > 1:
            raise ValueError(
                f"buckets mix spatial ranks {sorted(ndims)} — one "
                "engine serves one problem family"
            )
        # sorted by volume, so picking a bucket is "first that fits"
        object.__setattr__(
            self,
            "buckets",
            tuple(sorted(norm, key=lambda e: math.prod(e[1]))),
        )
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}"
            )
        if self.warm_order is not None:
            if isinstance(self.warm_order, str):
                raise ValueError(
                    f"warm_order {self.warm_order!r} is a string — "
                    "pass a tuple of bucket labels like "
                    "('8@32x32', '4@16x16')"
                )
            object.__setattr__(
                self,
                "warm_order",
                tuple(str(n) for n in self.warm_order),
            )
        if self.mesh_shape is not None:
            if isinstance(self.mesh_shape, str):
                raise ValueError(
                    f"mesh_shape {self.mesh_shape!r} is a string — "
                    "pass a tuple of axis sizes (e.g. (4, 2)); spec "
                    "strings like '4x2' belong to --mesh / "
                    "CCSC_SERVE_MESH"
                )
            try:
                mesh = tuple(int(a) for a in self.mesh_shape)
            except (TypeError, ValueError):
                raise ValueError(
                    f"mesh_shape {self.mesh_shape!r} is not a tuple "
                    "of axis sizes"
                )
            if mesh == ():
                # () = explicitly single-device
                object.__setattr__(self, "mesh_shape", ())
                if self.mesh_devices is not None:
                    raise ValueError(
                        "mesh_devices without a mesh is meaningless"
                    )
            else:
                if not 1 <= len(mesh) <= 2 or any(
                    a < 1 for a in mesh
                ):
                    raise ValueError(
                        f"mesh_shape must be (batch,) or "
                        f"(batch, freq) with positive axes, got "
                        f"{mesh}"
                    )
                object.__setattr__(self, "mesh_shape", mesh)
                bad = [
                    (s, sp) for s, sp in self.buckets if s % mesh[0]
                ]
                if bad:
                    raise ValueError(
                        f"mesh batch axis {mesh[0]} must divide "
                        f"every bucket's slots; offending buckets "
                        f"{bad} of {list(self.buckets)} — resize the "
                        "buckets or the mesh"
                    )
                if self.mesh_devices is not None:
                    devs = tuple(int(i) for i in self.mesh_devices)
                    if len(devs) != math.prod(mesh) or any(
                        i < 0 for i in devs
                    ):
                        raise ValueError(
                            f"mesh_devices needs {math.prod(mesh)} "
                            f"non-negative device indices for mesh "
                            f"{mesh}, got {devs}"
                        )
                    object.__setattr__(self, "mesh_devices", devs)
        elif self.mesh_devices is not None:
            raise ValueError(
                "mesh_devices without mesh_shape is meaningless"
            )
        # what the port does not serve yet
        for name, served, item in _SERVE_DEFERRED:
            if getattr(self, name) not in served:
                raise _not_ported(
                    f"ServeConfig.{name}={getattr(self, name)!r}",
                    f"ROADMAP.md Queue 1 item {item}",
                )
