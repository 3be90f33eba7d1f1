"""Multi-process execution on ``torch.distributed`` (torch port of
``ccsc_code_iccv2017_tpu.parallel.distributed``).

The port runs a mesh SPMD: one process per rank, one device per process
(rank r on ``cuda:r`` with NCCL; the CPU with ``gloo`` when the caller
asks for the CPU). This module starts and joins those processes:

- :func:`initialize` joins (or, as rank 0, hosts) the process group at a
  ``tcp://`` coordinator, with the JAX package's connect retries and
  backoff and its fail-fast on a misconfiguration; under ``torchrun``
  (RANK / WORLD_SIZE set) it joins the group the launcher describes.
- :func:`launch` starts N ranks (the ``spawn`` start method, never
  ``fork``), runs one function on each and returns what each returned;
  a failed rank or a deadline kills them all, so a hung collective
  fails the caller instead of hanging it.
- :func:`multihost_block_mesh`, :func:`process_block_slice` and
  :func:`global_block_array` keep the JAX names: the mesh over the
  world, this rank's slice of the blocks, and a rank's shard beside the
  global shape (no process ever assembles the whole data).

A mesh of more ranks than visible GPUs is refused; it is never put on
``gloo`` or on the CPU unasked.
"""
from __future__ import annotations

import atexit
import datetime
import logging
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

_log = logging.getLogger(__name__)

_initialized = False
_rank_device: Optional[torch.device] = None
_timeout: Optional[datetime.timedelta] = None

# the process group's default timeout, seconds
DEFAULT_TIMEOUT_S = 300.0


def rank_device() -> torch.device:
    """The device this rank runs on: the one :func:`initialize` bound
    (the CPU outside a process group)."""
    return _rank_device if _rank_device is not None else torch.device("cpu")


def _choose(device, backend: Optional[str], local_rank: int, world: int):
    """(this rank's device, the backend) for a group of ``world`` ranks;
    refuses more ranks than visible GPUs and NCCL off the card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        backend = backend or "nccl"
        if dev.index is None:
            n = torch.cuda.device_count()
            if local_rank >= n:
                raise ValueError(
                    f"a mesh of {world} ranks on cuda needs a GPU per rank, "
                    f"but {n} GPUs are visible (rank {local_rank} has none); "
                    "pass device='cpu' to run the ranks on the CPU"
                )
            dev = torch.device("cuda", local_rank)
    elif dev.type == "cpu":
        backend = backend or "gloo"
        if backend == "nccl":
            raise ValueError("the NCCL backend runs on CUDA devices only")
    else:
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev, backend


def _init_group(**kwargs) -> None:
    """``torch.distributed.init_process_group`` (the one seam the retry
    tests stub)."""
    dist.init_process_group(**kwargs)


def group_timeout() -> datetime.timedelta:
    """The timeout of this process's group, which every sub-group a mesh
    creates takes too."""
    return _timeout or datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def _select(dev: torch.device) -> None:
    """Make ``dev`` this process's current card before its group starts
    (NCCL binds its communicators to the current device)."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)


def _bind(dev: torch.device, timeout: datetime.timedelta) -> None:
    global _initialized, _rank_device, _timeout
    _rank_device = dev
    _timeout = timeout
    _initialized = True
    atexit.register(shutdown)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    connect_retries: Optional[int] = None,
    connect_backoff: Optional[float] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, with rank 0 hosting the store at
    ``coordinator_address`` ("host:port"). A no-op when this process is
    in a group already.

    ``device``: "cuda" (default: rank r binds ``cuda:r`` and the backend
    is NCCL; more ranks than GPUs is refused) or "cpu" (``gloo``); an
    explicit ``backend`` overrides the choice (``"gloo"`` with
    ``device="cuda:0"`` puts every rank on one card, the smoke seam of
    :class:`~.mesh.Mesh`). ``timeout``: seconds for every collective of
    the group (default 300).

    Without an address and a count, a ``torchrun`` environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT) is joined; with neither
    the process stays single-process and says so.

    Explicit-coordinator connections are retried with exponential
    backoff: ``connect_retries`` (default env CCSC_DIST_CONNECT_RETRIES,
    else 5) extra attempts, ``connect_backoff`` (default env
    CCSC_DIST_CONNECT_BACKOFF, else 1.0) seconds before the first retry,
    doubling, capped at 30 s. A ValueError or TypeError (a bad rank, a
    malformed address) is a misconfiguration and is raised at once.
    """
    if _initialized or dist.is_initialized():
        return
    td = datetime.timedelta(seconds=timeout or DEFAULT_TIMEOUT_S)
    if coordinator_address is None and num_processes is None:
        env = os.environ
        if "RANK" in env and "WORLD_SIZE" in env:
            world = int(env["WORLD_SIZE"])
            local = int(env.get("LOCAL_RANK", env["RANK"]))
            dev, backend = _choose(device, backend, local, world)
            _select(dev)
            _init_group(backend=backend, init_method="env://", timeout=td)
            _bind(dev, td)
            return
        _log.info("no coordinator and no launcher environment; running "
                  "single-process")
        return
    from ..utils import env as _env

    if connect_retries is None:
        connect_retries = _env.env_int("CCSC_DIST_CONNECT_RETRIES")
    if connect_backoff is None:
        connect_backoff = _env.env_float("CCSC_DIST_CONNECT_BACKOFF")
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs num_processes and process_id "
                         "with a coordinator address")
    dev, backend = _choose(device, backend, int(process_id),
                           int(num_processes))
    _select(dev)
    for attempt in range(connect_retries + 1):
        try:
            _init_group(
                backend=backend, init_method=f"tcp://{coordinator_address}",
                world_size=int(num_processes), rank=int(process_id),
                timeout=td,
            )
            break
        except (ValueError, TypeError):
            # deterministic misconfiguration: retrying cannot fix it
            raise
        except Exception as e:
            if attempt >= connect_retries:
                raise
            delay = min(connect_backoff * (2.0 ** attempt), 30.0)
            _log.warning(
                "init_process_group(%s) failed (%s); retry %d/%d in %.1fs",
                coordinator_address, e, attempt + 1, connect_retries, delay,
            )
            time.sleep(delay)
    _bind(dev, td)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def initialize_single(device="cuda") -> None:
    """A process group of this process alone (a mesh of one rank), at a
    free local port: NCCL on "cuda", gloo on "cpu"."""
    initialize(f"127.0.0.1:{_free_port()}", 1, 0, connect_retries=0,
               device=device)


def shutdown() -> None:
    """Leave the process group (idempotent); NCCL can hang the
    interpreter's exit when a group is left open."""
    global _initialized, _rank_device, _timeout
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
    _rank_device = _timeout = None


def _to_host(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _rank_main(fn, rank, world, port, device, backend, timeout, threads,
               args, q):
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(f"127.0.0.1:{port}", world, rank, device=device,
                   backend=backend, timeout=timeout)
        out = fn(rank, *args)
        q.put((rank, True, pickle.dumps(_to_host(out))))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        try:
            shutdown()
        except Exception:
            pass


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(5)


def launch(
    fn: Callable[..., Any],
    world_size: int,
    args: Sequence = (),
    *,
    device="cuda",
    backend: Optional[str] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
    join_timeout: Optional[float] = None,
    threads: Optional[int] = 1,
) -> list:
    """Run ``fn(rank, *args)`` on ``world_size`` new processes joined in
    one process group and return their results, rank-ordered (tensors
    moved to the host). ``fn`` and ``args`` must pickle: a module-level
    function. Processes start with ``spawn``.

    ``device``/``backend``: as :func:`initialize`; on "cuda" the ranks
    need ``world_size`` GPUs and the call is refused before anything
    starts otherwise. ``timeout``: the group's collective timeout,
    seconds. ``join_timeout``: the deadline for the whole run (default
    2 x timeout); at it, or as soon as a rank fails, every rank is
    killed and the call raises. ``threads``: torch's intra-op threads
    in each rank (None leaves torch's default).
    """
    import multiprocessing as mp

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if world_size > n:
            raise ValueError(
                f"a mesh of {world_size} ranks on cuda needs {world_size} "
                f"GPUs, but {n} are visible; pass device='cpu' to run the "
                "ranks on the CPU"
            )
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(fn, r, world_size, port, str(device), backend, timeout,
                  threads, tuple(args), q),
            name=f"ccsc-rank-{r}",
        )
        for r in range(world_size)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + (join_timeout or 2 * timeout)
    results = {}
    try:
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size} ranks did not finish within "
                    f"{join_timeout or 2 * timeout:.0f} s; ranks "
                    f"{sorted(set(range(world_size)) - set(results))} "
                    "still running"
                )
            try:
                rank, ok, payload = q.get(timeout=min(1.0, left))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in results and p.exitcode not in (None, 0):
                        raise RuntimeError(
                            f"rank {r} exited with code {p.exitcode} "
                            "without a result"
                        )
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            results[rank] = pickle.loads(payload)
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        _kill(procs)
    return [results[r] for r in range(world_size)]


def multihost_block_mesh(freq_shards: int = 1):
    """The ('block'[, 'freq']) mesh over every rank of the process
    group. 'freq' is the inner axis; ``freq_shards`` must divide the
    ranks of one host (LOCAL_WORLD_SIZE under torchrun, else the
    world)."""
    from . import mesh as mesh_lib

    world = dist.get_world_size() if dist.is_initialized() else 1
    if freq_shards > 1:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if per_host % freq_shards:
            raise ValueError(
                f"freq_shards={freq_shards} does not divide the per-host "
                f"rank count {per_host}"
            )
        return mesh_lib.block_freq_mesh(world // freq_shards, freq_shards)
    return mesh_lib.block_mesh(world)


def process_block_slice(num_blocks: int, mesh=None) -> slice:
    """Which consensus blocks THIS rank should load: its slice of the
    mesh's 'block' axis (of the world without a mesh; everything in a
    single process)."""
    if mesh is not None:
        nb, i = mesh.shape.get("block", 1), (
            mesh.axis_index("block") if "block" in mesh.shape else 0)
    elif dist.is_initialized():
        nb, i = dist.get_world_size(), dist.get_rank()
    else:
        nb, i = 1, 0
    if num_blocks % nb:
        raise ValueError(
            f"num_blocks={num_blocks} not divisible by process count {nb}"
        )
    per = num_blocks // nb
    return slice(i * per, (i + 1) * per)


class GlobalBlockArray(NamedTuple):
    """A block-sharded array as the port holds it: this rank's blocks on
    its device and the global shape. ``parallel.consensus.learn`` takes
    it in place of the whole data."""

    local: torch.Tensor  # [L, ni, *rest], this rank's blocks
    global_shape: tuple  # (N, ni, *rest)


def global_block_array(local_blocks, mesh) -> GlobalBlockArray:
    """This rank's consensus blocks [L, ...] (its
    :func:`process_block_slice` of the dataset) as a globally
    block-sharded array [L * nb, ...] over ``mesh``, without any process
    holding the whole."""
    t = torch.as_tensor(local_blocks).to(mesh.device, torch.float32)
    nb = mesh.shape.get("block", 1)
    return GlobalBlockArray(t.contiguous(),
                            (t.shape[0] * nb, *t.shape[1:]))
