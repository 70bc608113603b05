"""Multi-process execution: the process group, a ("hosts", "chips") mesh,
host-local data — the port of ``hikari_tpu.parallel.multihost`` on
``torch.distributed``.

* ``initialize`` — ``torch.distributed.init_process_group`` with one rank
  per device: NCCL when every rank has a GPU of its own, gloo on the CPU.
  Ranks that share one GPU pass ``backend="gloo"`` (NCCL refuses two ranks
  on one device); the backend is never switched in silence.
* ``run_ranks`` — spawn a group of ranks on this machine, run a function
  on each and return each rank's result (the tests, ``chip_smoke.py`` and
  ``bench_scaling`` use it).
* ``host_mesh`` — a ("hosts", "chips") mesh: the hosts by the ranks on
  each. Pixel rows shard over both axes together, so most stencil halos
  stay between ranks of one host.
* ``host_local_state`` / ``host_local_image`` — each rank allocates or
  loads only its own rows; no rank holds a full-resolution leaf.
* ``make_multihost_train_step`` — the sharded train step over the host
  mesh; the gradients of the replicated scene leaves are summed over all
  ranks.

Each rank builds its own copy of the scene (the same deterministic host
compile), as each host of the JAX package does.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

from hikari_tpu_torch.config import RenderSettings
from hikari_tpu_torch.utils import map_tensors, resolve_device

HOST_AXES = ("hosts", "chips")

_device: torch.device | None = None


def rank_device() -> torch.device:
    """The device this rank renders on (set by ``initialize``)."""
    if _device is None:
        raise RuntimeError("torch.distributed is not initialized: call multihost.initialize")
    return _device


def initialize(backend=None, init_method=None, world_size=None, rank=None, device=None) -> str:
    """Join the process group; returns the backend. ``world_size`` and
    ``rank`` default to ``$WORLD_SIZE`` and ``$RANK``, ``init_method`` to
    ``env://``. ``device``: "cpu", "cuda" (rank r on card r modulo the
    cards: its own card when there are enough) or one card for every rank,
    e.g. "cuda:0"; the CUDA card unless the caller names another."""
    global _device
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if backend is None:
        if dev.type != "cuda":
            backend = "gloo"
        elif device is not None and torch.device(device).index is not None and world_size > 1:
            raise ValueError(f"{world_size} ranks share {dev}: NCCL takes one rank a GPU, "
                             "pass backend='gloo'")
        elif world_size > torch.cuda.device_count():
            raise ValueError(f"{world_size} ranks on {torch.cuda.device_count()} GPUs: NCCL "
                             "takes one rank a GPU, pass backend='gloo'")
        else:
            backend = "nccl"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _device = dev
    return backend


def _rank_main(rank, fn, world_size, backend, device, workdir, threads, args):
    torch.set_num_threads(threads)
    initialize(backend, f"file://{os.path.join(workdir, 'rendezvous')}", world_size, rank, device)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(workdir, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, backend: str, device, *args, threads: int = 1):
    """Run ``fn(rank, *args)`` on ``world_size`` spawned ranks that have
    joined one process group (``backend``, each rank on ``device`` as
    ``initialize`` reads it); returns the ranks' results in rank order
    (``torch.save``d, so tensors come back on the CPU). ``fn`` must be a
    module-level function. The rendezvous is a file in a temporary
    directory (no TCP port); each rank runs ``threads`` CPU threads. A rank
    that raises fails the call with its traceback, and the other ranks are
    stopped."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="hikari_ranks_") as workdir:
        mp.start_processes(_rank_main, args=(fn, world_size, backend, device, workdir, threads,
                                             args),
                           nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(workdir, f"result{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world_size)]


def host_mesh(axes: tuple = HOST_AXES, ranks_per_host: int | None = None):
    """The ("hosts", "chips") mesh over every rank: ``ranks_per_host``
    (default ``$LOCAL_WORLD_SIZE``, else all) consecutive ranks a host."""
    from hikari_tpu_torch.parallel.sharding import Mesh

    world = dist.get_world_size()
    per = ranks_per_host or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per:
        raise ValueError(f"{world} ranks do not split into hosts of {per}")
    return Mesh([[h * per + c for c in range(per)] for h in range(world // per)], axes)


def row_sharding(mesh):
    """Rows split over every axis of ``mesh`` together (JAX
    ``P(("hosts", "chips"), ...)``)."""
    from hikari_tpu_torch.parallel.sharding import Placement

    return Placement(mesh, tuple(mesh.axis_names))


def replicated(mesh):
    from hikari_tpu_torch.parallel.sharding import Placement

    return Placement(mesh)


def host_local_image(mesh, full_shape, fill_fn):
    """This rank's rows of an image of ``full_shape``, row-sharded over
    every mesh axis: ``fill_fn(row_lo, row_hi) -> (rows, ...)`` is called
    for this rank's rows only (host-local data loading)."""
    block = row_sharding(mesh).block()
    lo = block.origin(full_shape[:2])[0]
    hi = lo + block.size(full_shape[:2])[0]
    local = torch.as_tensor(fill_fn(lo, hi))
    if local.shape[0] != hi - lo:
        raise ValueError(f"fill_fn gave {local.shape[0]} rows for [{lo}, {hi})")
    return local.to(mesh.device)


def host_local_state(settings: RenderSettings, mesh):
    """The cross-frame state of this rank's rows only, every image-shaped
    leaf row-sharded over every mesh axis: no rank allocates a
    full-resolution leaf."""
    from hikari_tpu_torch.render.pipeline import initial_state

    return initial_state(settings, mesh.device, block=row_sharding(mesh).block())


def replicate_host_local(tree, mesh):
    """Each rank's own copy of a host-compiled scene or camera, on its
    device (identical by construction: every rank runs the same compile)."""
    return map_tensors(lambda x: x.to(mesh.device), tree)


def make_multihost_train_step(settings: RenderSettings, mesh):
    """The sharded train step over ``mesh`` with the rows split over every
    axis (hosts and chips): the kernel tracer backends run under
    ``trace.shard_tracing`` over both axes, and the gradients of the
    replicated scene leaves are summed over all ranks."""
    from hikari_tpu_torch.parallel.sharding import make_train_step

    return make_train_step(settings, sharded=True, mesh=mesh, axis=None)
