"""Device selection for the port's entry points.

The counterpart of ``ccsc_code_iccv2017_tpu.utils.platform``: every
entry point (``build_plan``, ``reconstruct``, the apps' ``main``) takes
``device=`` (default ``"cuda"``) and resolves it here. A CUDA request on
a machine without a card raises instead of silently running on the
CPU; the CPU tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import statistics
from typing import Callable, Optional, Union

import torch

# the stream's sleep before each timed call: ~1 ms at the H100's ~1.98 GHz
SLEEP_CYCLES = 2_000_000


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


def device_time_ms(fn: Callable[[], object], reps: int = 30, warmup: int = 5,
                   before: Optional[Callable[[], object]] = None) -> float:
    """Median device time in ms of one call of ``fn`` on the current CUDA
    stream (CUDA events), after ``warmup`` calls; each timed call follows
    ``before`` (if given, untimed) and a sleep of the stream, so the host
    has enqueued the call by the time the start event runs and the time
    is the device's alone, not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


class PhaseTimer:
    """CUDA events at a learner step's phase boundaries (d_start,
    d_end, z_start, z_end; and where the driver marks them step_start,
    gram_end, step_end): the phases' device-stream times of a step, read
    after the step's metrics sync. A no-op off the card."""

    def __init__(self, device: torch.device):
        self.enabled = device.type == "cuda"
        self.events = {}

    def __call__(self, name: str) -> None:
        if self.enabled:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[name] = ev

    def read(self):
        """(d_pass_ms, z_pass_ms, gram_ms, step_ms) of the last step, or
        None: gram_ms from d_start to gram_end, step_ms from step_start
        to step_end, each None where its marks were not recorded."""
        if not self.enabled:
            return None
        e = self.events

        def ms(a, b):
            return e[a].elapsed_time(e[b]) if a in e and b in e else None

        return (ms("d_start", "d_end"), ms("z_start", "z_end"),
                ms("d_start", "gram_end"), ms("step_start", "step_end"))
