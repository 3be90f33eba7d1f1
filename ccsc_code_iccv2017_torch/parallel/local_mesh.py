"""An in-process device mesh: one process, one thread per position (the
serving engine's mesh, ROADMAP.md Queue 1 item 8d).

The JAX serving engine runs a bucket's program on a device mesh from one
controller (``shard_map`` over a (batch[, 'freq']) mesh). The port's
engine does the same from one process: a *position* is one entry of the
mesh, a device (``cuda:i``, several positions may share one card, or
the CPU) driven by its own worker thread on its own CUDA stream. Every
position runs the same solve loop on its shard (``models.reconstruct.
_reconstruct_impl``), so :class:`LocalMesh` answers the calls that loop
makes of a mesh, for the calling thread's position:

- ``shape`` / ``axis_names`` / :meth:`axis_index`: as
  ``parallel.mesh.Mesh``, so ``parallel.mesh.fslice`` slices this
  position's bins;
- :meth:`all_gather_tiled` (reached through
  ``parallel.mesh.all_gather_tiled``): each position of an axis group
  deposits its slice and records an event on its stream, the group
  meets at a barrier, and each position then copies its peers' slices
  to its own device (a peer copy between cards; the tensor itself when
  two positions share one) after its streams wait on their events.
  Deposits alternate between two buffers by the parity of the gather,
  so one barrier a gather suffices: a position deposits into a buffer
  again only after every peer has passed the next barrier, by which
  point each has queued its copies of the old one;
- ``psum`` / ``pmax`` refuse (``parallel.mesh`` raises for an in-process
  mesh): a served slot reduces nothing across slots.

A barrier that is not met within the timeout (``parallel.distributed.
group_timeout``, 300 s by default), or one that a failing position
broke (:meth:`abort`), raises :class:`MeshBarrierError` naming the
position, so a dispatch fails instead of hanging. The mesh counts the
gathers of each position (the analog of the JAX package's
``analysis/comms.py`` count of collectives in a bucket program).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch


class MeshBarrierError(RuntimeError):
    """A position's collective could not complete: a peer failed first
    (the barrier was aborted) or did not arrive within the timeout."""


class _Group:
    """The exchange of one axis group: its barrier and two deposit
    buffers (by the parity of the gather), one slot per member."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.buffers = [[None] * n, [None] * n]


class LocalMesh:
    """Named axes over positions driven by threads of this process.

    ``shape`` / ``axis_names``: the axis sizes and names, positions in
    row-major order (the last axis innermost: position = i0 * n1 + i1).
    ``devices``: one device per position (repeats allowed). A worker
    thread takes a position with :meth:`enter`; every per-position
    query below answers for the calling thread's position.
    ``timeout_s``: how long a barrier waits for its peers.
    """

    in_process = True

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence, timeout_s: Optional[float] = None):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} vs axis names {names}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axes must be >= 1, got {shape}")
        self.size = math.prod(shape)
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != self.size:
            raise ValueError(
                f"{len(self.devices)} devices for a mesh of {self.size} "
                "positions"
            )
        if timeout_s is None:
            from .distributed import group_timeout

            timeout_s = group_timeout().total_seconds()
        self.timeout_s = float(timeout_s)
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.mesh_shape = shape
        self._local = threading.local()
        self._gathers = [0] * self.size
        # gather timing (time_collectives): per position (start, end)
        # CUDA events on its stream, or host times on the CPU
        self.time_collectives = False
        self._timings: List[list] = [[] for _ in range(self.size)]
        self.reset()

    def __repr__(self) -> str:
        return (f"LocalMesh({self.shape}, devices="
                f"{[str(d) for d in self.devices]})")

    # -- positions ------------------------------------------------------
    def enter(self, position: int) -> None:
        """Make the calling thread mesh position ``position``."""
        if not 0 <= position < self.size:
            raise ValueError(f"position {position} of a mesh of {self.size}")
        self._local.position = int(position)

    @property
    def position(self) -> int:
        pos = getattr(self._local, "position", None)
        if pos is None:
            raise RuntimeError(
                "this thread holds no position of the in-process mesh "
                "(LocalMesh.enter)"
            )
        return pos

    def coords_of(self, position: int) -> Tuple[int, ...]:
        out = []
        for s in reversed(self.mesh_shape):
            out.append(position % s)
            position //= s
        return tuple(reversed(out))

    def axis_index(self, axis: str) -> int:
        """The calling thread's coordinate on ``axis``."""
        return self.coords_of(self.position)[self.axis_names.index(axis)]

    def group_members(self, axis: str, position: int) -> List[int]:
        """The positions of ``position``'s group on ``axis``, in axis
        order."""
        i = self.axis_names.index(axis)
        c = list(self.coords_of(position))
        out = []
        for a in range(self.mesh_shape[i]):
            c[i] = a
            r = 0
            for ci, s in zip(c, self.mesh_shape):
                r = r * s + ci
            out.append(r)
        return out

    # -- dispatch lifecycle ---------------------------------------------
    def reset(self) -> None:
        """Fresh barriers, buffers and gather counts; called between
        dispatches, while no position is inside a collective."""
        self._groups: Dict[Tuple[str, int], _Group] = {}
        for axis in self.axis_names:
            for pos in range(self.size):
                members = self.group_members(axis, pos)
                key = (axis, members[0])
                if key not in self._groups:
                    self._groups[key] = _Group(len(members))
        self._gathers = [0] * self.size

    def abort(self) -> None:
        """Break every barrier: the positions waiting at one, and those
        that reach one later in this dispatch, raise
        :class:`MeshBarrierError` at once (a failing position calls this
        so its peers do not wait out the timeout)."""
        for g in self._groups.values():
            g.barrier.abort()

    def gathers(self) -> List[int]:
        """All-gathers each position has made since the last reset."""
        return list(self._gathers)

    def collective_ms(self, clear: bool = True) -> List[List[float]]:
        """Per position, the ms of each all-gather recorded while
        ``time_collectives`` was set: CUDA events on the position's
        stream (read after a synchronize; they hold the wait for the
        slowest peer and the copies), host time on the CPU."""
        out = []
        for recs in self._timings:
            ms = []
            for a, b in recs:
                if isinstance(a, float):
                    ms.append((b - a) * 1e3)
                else:
                    b.synchronize()
                    ms.append(a.elapsed_time(b))
            out.append(ms)
        if clear:
            self._timings = [[] for _ in range(self.size)]
        return out

    # -- collectives ----------------------------------------------------
    def all_gather_tiled(self, x: torch.Tensor, axis: str,
                         dim: int = -1) -> torch.Tensor:
        """Every member's slice of ``x`` on ``axis``, concatenated along
        ``dim`` in axis order, on the calling position's device and
        current stream."""
        pos = self.position
        members = self.group_members(axis, pos)
        group = self._groups[(axis, members[0])]
        j = members.index(pos)
        buf = group.buffers[self._gathers[pos] % 2]
        event = start = None
        if x.is_cuda:
            stream = torch.cuda.current_stream(x.device)
            if self.time_collectives:
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            event = torch.cuda.Event()
            event.record(stream)
        elif self.time_collectives:
            start = time.perf_counter()
        buf[j] = (x, event)
        self._gathers[pos] += 1
        try:
            group.barrier.wait(self.timeout_s)
        except threading.BrokenBarrierError:
            raise MeshBarrierError(
                f"mesh position {pos} ({self.devices[pos]}): the {axis!r} "
                f"all-gather #{self._gathers[pos]} was not met by its group "
                f"{members} (a peer failed, or did not arrive within "
                f"{self.timeout_s:g} s)"
            ) from None
        parts = []
        for i, member in enumerate(members):
            if i == j:
                parts.append(x)
                continue
            y, ev = buf[i]
            if y.is_cuda:
                # the copy runs on the source card's current stream of
                # this thread (a peer copy between cards), or this
                # position's own stream when the cards are one; it waits
                # for the peer's solve, and the allocator keeps the
                # peer's tensor until the copy is done
                src = torch.cuda.current_stream(y.device)
                src.wait_event(ev)
                y.record_stream(src)
                y = y.to(x.device, non_blocking=True)
            parts.append(y)
        out = torch.cat(parts, dim=dim)
        if start is not None:
            if x.is_cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(x.device))
            else:
                end = time.perf_counter()
            self._timings[pos].append((start, end))
        return out
