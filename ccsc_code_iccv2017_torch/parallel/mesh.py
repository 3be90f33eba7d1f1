"""Device meshes on ``torch.distributed`` process groups (torch port of
``ccsc_code_iccv2017_tpu.parallel.mesh``).

The JAX package runs a mesh from one controller: a single process
drives every device through ``shard_map``, and ``lax.psum`` /
``lax.all_gather`` name a mesh axis. The port runs SPMD, the PyTorch
idiom: one process per rank, a process group per mesh axis, and every
rank runs the same Python loop on its own shard. A :class:`Mesh` names
the axes ('block', 'freq', 'filter' or any other) over the ranks of the
default process group in row-major order (rank = i0 * n1 + i1, the last
axis innermost), the device order ``jax.make_mesh`` gives the JAX
meshes, so per-block fields land on the same rank in both packages.

The collectives take the mesh and an axis name (or a tuple of them, or
None) and are the identity without a mesh or an axis, so a step written
once runs on one device and on a mesh:

- :func:`psum` / :func:`pmax`: ``lax.psum`` / ``lax.pmax``, an
  ``all_reduce`` over the axis's group;
- :func:`all_gather_tiled`: ``lax.all_gather(..., tiled=True)``;
- :func:`fslice`: this rank's slice of an axis (``lax.axis_index`` +
  ``dynamic_slice_in_dim``), made contiguous once;
- :func:`gather`, :func:`gather_blocks`: the global view of sharded
  fields, assembled on one rank only.

Everything a rank reduces is float32 or complex64 (complex tensors
travel as their real view); a ``gloo`` group stages CUDA tensors
through the host. Each all-reduce runs inside the span
``ccsc.mesh.allreduce`` (its tag the argument; utils.profiling), and a
:class:`Mesh` counts, always, the collectives it ran and the bytes it
handed to them, per tag (``Mesh.calls``, ``Mesh.wire_bytes``).

The serving engine's mesh is in-process instead (``parallel.local_mesh.
LocalMesh``: one thread per position, no process group): ``fslice`` and
``all_gather_tiled`` take it as they take a :class:`Mesh`, and ``psum``
/ ``pmax`` refuse it, since a served slot reduces nothing across slots.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..utils import profiling

AxisSpec = Union[None, str, Tuple[str, ...]]

_WIRE_DTYPES = (torch.float32, torch.complex64)


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` / ``axis_names``: the axis sizes and names (row-major rank
    order). Without a process group a mesh of one rank starts its own
    (``parallel.distributed.initialize_single``); a larger one needs its
    ranks started first (``parallel.distributed.launch``, or
    ``torchrun`` and ``parallel.distributed.initialize``).

    ``devices``: optional per-rank devices, one per rank; rank r runs on
    ``devices[r]``. By default a rank runs on the device its process
    group was started for (``cuda:local_rank`` with NCCL, the CPU with
    ``gloo``). An NCCL mesh needs one GPU per rank. The one exception,
    for a one-card smoke run of the sharded math, is a group started
    with ``backend="gloo"`` (``parallel.distributed.launch``) whose
    ``devices`` repeat one card: its collectives stage through the host.
    Each axis group this mesh creates has the world group's timeout.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices=None):
        from . import distributed
        from ..utils.device import resolve_device

        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} vs axis names {names}")
        size = math.prod(shape)
        if not dist.is_initialized():
            if size != 1:
                raise RuntimeError(
                    f"a mesh of {size} ranks needs {size} processes in one "
                    "process group: start them with "
                    "parallel.distributed.launch (or torchrun and "
                    "parallel.distributed.initialize)"
                )
            distributed.initialize_single(
                device=devices[0] if devices else "cuda")
        world = dist.get_world_size()
        if world != size:
            raise ValueError(
                f"mesh {dict(zip(names, shape))} has {size} ranks but the "
                f"process group has {world}"
            )
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if len(devices) != size:
                raise ValueError(
                    f"{len(devices)} devices for a mesh of {size} ranks"
                )
            device = devices[self.rank]
            if self.backend == "nccl" and len(set(map(str, devices))) < size:
                raise ValueError(
                    "an NCCL mesh needs one GPU per rank, got devices "
                    f"{[str(d) for d in devices]}"
                )
        else:
            device = distributed.rank_device()
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError(f"an NCCL mesh runs on CUDA devices, not {device}")
        self.device = resolve_device(device)
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.size = size
        self.coords = _unravel(self.rank, shape)
        self._groups: Dict[str, object] = {}
        for i, name in enumerate(names):
            if len(names) == 1:
                self._groups[name] = None  # the world group
                continue
            # every rank creates every group of this axis, in one order
            others = [s for j, s in enumerate(shape) if j != i]
            for rest in _product(others):
                ranks = []
                for a in range(shape[i]):
                    c = list(rest)
                    c.insert(i, a)
                    ranks.append(_ravel(c, shape))
                g = dist.new_group(ranks, timeout=distributed.group_timeout())
                if self.rank in ranks:
                    self._groups[name] = g
        # collective timing (time_collectives): per-axis (start, end)
        self.time_collectives = False
        self._timings: Dict[str, list] = {}
        # always on: collectives run and bytes handed to them, per tag
        self.calls: Dict[str, int] = {}
        self.wire_bytes: Dict[str, int] = {}
        # (start, end) CUDA events of the collectives since record_step
        self._step_events: Optional[list] = None

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend!r})")

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of ``axis`` that holds this rank (None is the
        world group, the one axis of a 1-D mesh)."""
        return self._groups[axis]

    def collective_ms(self, clear: bool = True) -> Dict[str, list]:
        """Per-axis times (ms) of the collectives recorded since the last
        call while ``time_collectives`` was set: CUDA events on the card
        (read after a synchronize), host time otherwise."""
        out = {}
        for axis, recs in self._timings.items():
            ms = []
            for a, b in recs:
                if isinstance(a, float):
                    ms.append((b - a) * 1e3)
                else:
                    b.synchronize()
                    ms.append(a.elapsed_time(b))
            out[axis] = ms
        if clear:
            self._timings = {}
        return out

    def record_step(self) -> None:
        """Start recording CUDA events around every collective, for
        :meth:`step_ms` (a no-op off the card). No host read."""
        if self.device.type == "cuda":
            self._step_events = []

    def step_ms(self) -> Optional[float]:
        """The summed device time (ms, the current stream's) of the
        collectives since :meth:`record_step`, the wait on peers
        included, and stop recording; None off the card. Call it after
        a host read that follows them on the stream (an event the
        stream has not reached has no time yet)."""
        ev, self._step_events = self._step_events, None
        if ev is None:
            return None
        return sum(a.elapsed_time(b) for a, b in ev)


def _product(sizes):
    if not sizes:
        yield ()
        return
    for a in range(sizes[0]):
        for rest in _product(sizes[1:]):
            yield (a, *rest)


def _ravel(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def _unravel(rank: int, shape) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """A :class:`Mesh` of any shape and axis names (``jax.make_mesh``)."""
    return Mesh(shape, axis_names, devices=devices)


def _world(num: Optional[int]) -> int:
    if num is not None:
        return int(num)
    return dist.get_world_size() if dist.is_initialized() else 1


def block_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the 'block' (consensus / data-parallel) axis; the
    default size is the world's."""
    return Mesh((_world(num_devices),), ("block",), devices=devices)


def block_filter_mesh(num_block: int, num_filter: int,
                      devices=None) -> Mesh:
    """2-D mesh ('block', 'filter'): consensus data parallelism x
    filter-bank (k) tensor parallelism; 'filter' innermost."""
    return Mesh((num_block, num_filter), ("block", "filter"),
                devices=devices)


def block_freq_mesh(num_block: int, num_freq: int, devices=None) -> Mesh:
    """2-D mesh ('block', 'freq'): consensus data parallelism x
    frequency-axis tensor parallelism; 'freq' innermost, so its
    per-iteration all-gathers stay among neighbouring ranks."""
    return Mesh((num_block, num_freq), ("block", "freq"), devices=devices)


def freq_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the 'freq' (frequency tensor-parallel) axis, for
    solvers whose batch is small and whose spectrum is large (the masked
    hyperspectral learner)."""
    return Mesh((_world(num_devices),), ("freq",), devices=devices)


def shard_blocks(tree, mesh: Mesh, axis: str = "block"):
    """This rank's slice of the leading axis of every tensor in ``tree``
    (a tensor, or a tuple / NamedTuple / list of them): the port's
    placement ``P('block')``."""
    def one(x):
        return fslice(x, mesh, axis, dim=0)

    if torch.is_tensor(tree):
        return one(tree)
    vals = [one(x) for x in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


# ---- collectives ----------------------------------------------------


def _axes(mesh: Optional[Mesh], axis: AxisSpec) -> Tuple[str, ...]:
    if mesh is None or axis is None:
        return ()
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return tuple(a for a in names if a is not None)


def _to_wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A fresh contiguous buffer of ``x`` for a collective: the real view
    of a complex tensor, on the host for a gloo group."""
    if x.dtype not in _WIRE_DTYPES:
        raise TypeError(
            f"collectives run on float32 / complex64, got {x.dtype}: cast "
            "the state up first"
        )
    buf = torch.view_as_real(x) if x.is_complex() else x
    if mesh.backend == "gloo" and buf.is_cuda:
        return buf.cpu()
    return buf.clone(memory_format=torch.contiguous_format)


def _from_wire(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    out = buf.to(like.device).contiguous()
    return torch.view_as_complex(out) if like.is_complex() else out


def _timed(mesh: Mesh, axis_key: str, fn, calls: int, nbytes: int):
    """Run the collective(s) ``fn``: count them under ``axis_key`` and
    time them where ``time_collectives`` or :meth:`Mesh.record_step`
    asks."""
    mesh.calls[axis_key] = mesh.calls.get(axis_key, 0) + calls
    mesh.wire_bytes[axis_key] = (mesh.wire_bytes.get(axis_key, 0)
                                 + calls * nbytes)
    step = mesh._step_events
    if not mesh.time_collectives and step is None:
        return fn()
    if mesh.device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        if step is not None:
            step.append((a, b))
    else:
        a = time.perf_counter()
        out = fn()
        b = time.perf_counter()
    if mesh.time_collectives:
        mesh._timings.setdefault(axis_key, []).append((a, b))
    return out


def _all_reduce(x, mesh: Mesh, names, op, tag=None):
    if getattr(mesh, "in_process", False):
        raise RuntimeError(
            f"a reduction over {names} on the in-process serving mesh: "
            "a served slot reduces nothing across slots (pass "
            "axis_name=None for the batch axis)"
        )
    buf = _to_wire(x, mesh)
    if set(names) == set(mesh.axis_names):
        groups = [None]  # every axis: the world group
    else:
        groups = [mesh.group(n) for n in dict.fromkeys(names)]

    def run():
        for g in groups:
            dist.all_reduce(buf, op=op, group=g)

    key = tag or "+".join(names)
    with profiling.annotate("ccsc.mesh.allreduce", key):
        _timed(mesh, key, run, len(groups), buf.numel() * buf.element_size())
    return _from_wire(buf, x)


def psum(x: torch.Tensor, mesh: Optional[Mesh], axis: AxisSpec,
         tag: Optional[str] = None):
    """Sum over a mesh axis, a tuple of axes, or None (the identity, as
    without a mesh): ``lax.psum``. ``tag`` names the call in
    ``Mesh.collective_ms``, the counters and the span (default: the
    axes)."""
    names = _axes(mesh, axis)
    if not names:
        return x
    return _all_reduce(x, mesh, names, dist.ReduceOp.SUM, tag)


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank of the mesh reaches this point before any leaves it."""
    if mesh is not None:
        psum(torch.zeros(1, device=mesh.device), mesh, mesh.axis_names)


def pmax(x: torch.Tensor, mesh: Optional[Mesh], axis: AxisSpec):
    """Maximum over a mesh axis (``lax.pmax``); real tensors only."""
    names = _axes(mesh, axis)
    if not names:
        return x
    if x.is_complex():
        raise TypeError("pmax of a complex tensor")
    return _all_reduce(x, mesh, names, dist.ReduceOp.MAX)


def fslice(x: torch.Tensor, mesh: Optional[Mesh], axis: Optional[str],
           dim: int = -1) -> torch.Tensor:
    """This rank's contiguous slice of dimension ``dim`` over ``axis``
    (``axis_index`` + ``dynamic_slice_in_dim``); the identity without a
    mesh or an axis."""
    if mesh is None or axis is None:
        return x
    n = mesh.shape[axis]
    size = x.shape[dim]
    if size % n:
        raise ValueError(
            f"dimension {dim} of size {size} does not split over mesh "
            f"axis {axis!r} of {n}"
        )
    m = size // n
    return x.narrow(dim, mesh.axis_index(axis) * m, m).contiguous()


def _gather_into(out: torch.Tensor, buf: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, buf, group=group)


def all_gather_tiled(x: torch.Tensor, mesh: Optional[Mesh],
                     axis: Optional[str], dim: int = -1) -> torch.Tensor:
    """The slices of ``x`` of every rank on ``axis``, concatenated along
    ``dim`` in axis order (``lax.all_gather(..., tiled=True)``); the
    identity without a mesh or an axis."""
    if mesh is None or axis is None:
        return x
    if getattr(mesh, "in_process", False):
        return mesh.all_gather_tiled(x, axis, dim)
    n = mesh.shape[axis]
    d = dim % x.ndim
    buf = _to_wire(x, mesh)
    out = torch.empty((n * buf.shape[0], *buf.shape[1:]), dtype=buf.dtype,
                      device=buf.device)
    _timed(mesh, axis, lambda: _gather_into(out, buf, mesh.group(axis)), 1,
           buf.numel() * buf.element_size())
    out = out.reshape(n, *buf.shape).movedim(0, d)
    out = out.reshape(*x.shape[:d], n * x.shape[d], *buf.shape[d + 1:])
    return _from_wire(out, x)


def gather(x: torch.Tensor, mesh: Optional[Mesh], dims: Dict[str, int],
           dst: int = 0) -> Optional[torch.Tensor]:
    """The global view of a sharded tensor, assembled on rank ``dst``
    only (None on every other rank): the shards of each axis in
    ``dims`` are concatenated along its dimension, an axis not in
    ``dims`` holds replicas (its index 0 is kept). Every rank must call
    it. Without a mesh, ``x`` itself."""
    if mesh is None:
        return x
    buf = _to_wire(x, mesh)
    parts = ([torch.empty_like(buf) for _ in range(mesh.size)]
             if mesh.rank == dst else None)
    dist.gather(buf, parts, dst=dst)
    if parts is None:
        return None
    shape = tuple(mesh.shape.values())

    def assemble(level, prefix):
        if level == len(shape):
            return parts[_ravel(prefix, shape)]
        axis = mesh.axis_names[level]
        if axis not in dims:
            return assemble(level + 1, prefix + (0,))
        return torch.cat(
            [assemble(level + 1, prefix + (a,)) for a in range(shape[level])],
            dim=dims[axis] % x.ndim,
        )

    return _from_wire(assemble(0, ()), x)


def gather_blocks(x: torch.Tensor, mesh: Optional[Mesh], dst: int = 0):
    """A block- (or batch-) sharded tensor's global view on rank ``dst``
    (None elsewhere): the shards of the 'block' axis (else of the mesh's
    first axis) concatenated along the leading dimension."""
    if mesh is None:
        return x
    axis = "block" if "block" in mesh.shape else mesh.axis_names[0]
    return gather(x, mesh, {axis: 0}, dst=dst)


def agree(values: torch.Tensor, flag: bool, mesh: Optional[Mesh]):
    """One collective for a step's host-side decisions: every rank gets
    rank 0's ``values`` (a float32 vector) and whether any rank raised
    ``flag`` (a shutdown request). -> (list of floats, bool)."""
    if mesh is None:
        return values.tolist(), bool(flag)
    v = values.to(torch.float32).reshape(-1)
    if mesh.rank != 0:
        v = torch.zeros_like(v)
    f = torch.tensor([1.0 if flag else 0.0], device=v.device)
    out = psum(torch.cat([v, f]), mesh, mesh.axis_names).tolist()
    return out[:-1], out[-1] > 0
