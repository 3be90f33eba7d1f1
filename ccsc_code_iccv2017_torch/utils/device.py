"""Device selection for the port's entry points.

The counterpart of ``ccsc_code_iccv2017_tpu.utils.platform``: every
entry point (``build_plan``, ``reconstruct``, the apps' ``main``) takes
``device=`` (default ``"cuda"``) and resolves it here. A CUDA request on
a machine without a card raises instead of silently running on the
CPU; the CPU tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on; raises when CUDA is
    asked for and absent.

    Also pins full-float32 matmuls and convolutions: the JAX CPU
    reference is full f32, and TF32 (cuDNN's default for convolutions)
    keeps only about three decimal digits.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available "
            "— run on a machine with an NVIDIA card, or pass "
            "device='cpu' explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    if dev.type == "cuda" and dev.index is None:
        # pin the index so tensors' devices compare equal to it
        dev = torch.device("cuda", torch.cuda.current_device())
    # full f32, no TF32 anywhere: parity with the f32 JAX reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def device_report(device: Union[str, torch.device] = "cuda") -> dict:
    """Name, compute capability and SM count of a CUDA device (the
    port targets sm_90, capability (9, 0)); a CPU device reports its
    type only."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"type": "cpu"}
    props = torch.cuda.get_device_properties(dev)
    return {
        "type": "cuda",
        "name": props.name,
        "capability": (props.major, props.minor),
        "sm_count": props.multi_processor_count,
        "total_memory_bytes": props.total_memory,
    }
