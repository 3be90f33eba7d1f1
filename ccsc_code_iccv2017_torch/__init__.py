"""ccsc_code_iccv2017_torch — the PyTorch/CUDA port of the CCSC framework
for one NVIDIA Hopper GPU (H100, sm_90a).

It mirrors the module paths and public names of the JAX package
``ccsc_code_iccv2017_tpu`` (the reference it is tested against) and
imports nothing of it. It runs, on one device, the 2D reconstruction
solve (``models.reconstruct``) with the W == 1 rank-1 z-solve in a CUDA
kernel written by hand (``ops.kernels``, ``csrc/solve_z_rank1.cu``), the
2D consensus learner (``parallel.consensus``) with its fused z-iteration
in CUDA (``ops.fused_z``), the serving engine and fleet (``serve``) and
the fleet's capacity controller, configured by :class:`ControllerConfig`.
"""
from .config import GEOM_2D, ControllerConfig, ProblemGeom, SolveConfig

__all__ = ["GEOM_2D", "ControllerConfig", "ProblemGeom", "SolveConfig"]
