"""Distributed execution on ``torch.distributed``: pixel-tile data
parallelism over a mesh of ranks — the port of
``hikari_tpu.parallel.sharding``, with the unsharded train step
(``render_loss``, ``DIFF_LEAVES``, ``make_train_step``).

One process (rank) per device. A ``Mesh`` lays the ranks of the default
process group out on named axes and holds a process group for every axis
and tuple of axes. As in the JAX package:

* the pixel grid (G-buffer, reservoirs, channel outputs, every post-chain
  image) shards by rows over a mesh axis (or over rows and columns of a
  2D tile mesh): each rank holds its block only, between frames too;
* the scene and the camera replicate on every rank;
* the gradients of the replicated scene leaves are summed over the ranks.

Where the JAX package leaves the rest to GSPMD, the port runs each pass on
its block (``utils.block``) and moves other ranks' pixels only through
``parallel/halo.Transport``: halos where the reach is fixed, all-gathers
where it is not (``render/pipeline.py`` says which pass takes which).

A collective carries autograd where an activation crosses ranks
(``torch.distributed.nn.functional.all_gather``); the loss and the
gradients of the replicated leaves are ``all_reduce``d with ``SUM``.
"""

from __future__ import annotations

import dataclasses
import itertools
from contextlib import contextmanager
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from hikari_tpu_torch.config import RenderSettings
from hikari_tpu_torch.render.pipeline import image_size, render_frame
from hikari_tpu_torch.utils import map_tensors
from hikari_tpu_torch.utils.block import Block, rendering

DIFF_LEAVES = (
    "mat_base_color",
    "mat_emissive",
    "mat_perceptual_roughness",
    "mat_metallic",
    "mat_reflectance",
    "sun_color",
    "ambient_color",
    "tri_world",
)


class Mesh:
    """Ranks of the default process group on named axes (JAX ``Mesh``):
    ``ranks`` is an int array, ascending in row-major order, one axis per
    name. Building one is collective: every rank of the default group
    builds the same mesh, in the same order as its other meshes, since it
    creates the mesh's process groups (``dist.new_group``)."""

    def __init__(self, ranks, axis_names, device=None):
        from hikari_tpu_torch.parallel import multihost

        grid = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d ranks for the axes {axis_names}")
        flat = grid.ravel().tolist()
        if flat != sorted(set(flat)):
            raise ValueError(f"mesh ranks must ascend in row-major order: {flat}")
        self.ranks = grid
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))
        self.size = grid.size
        self.device = torch.device(device) if device is not None else multihost.rank_device()
        me = dist.get_rank()
        where = np.argwhere(grid == me)
        self.coords = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups = {}
        dims = range(grid.ndim)
        for r in range(1, grid.ndim + 1):
            for axes in itertools.combinations(dims, r):
                others = [d for d in dims if d not in axes]
                lines = np.transpose(grid, others + list(axes)).reshape(
                    -1, int(np.prod([grid.shape[d] for d in axes])))
                for members in lines.tolist():
                    group = dist.new_group(members)
                    if me in members:
                        self._groups[tuple(axis_names[d] for d in axes)] = group

    def _dims(self, axes):
        axes = tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} of the mesh {self.axis_names}")
        dims = [self.axis_names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"axes {axes} out of the mesh's order {self.axis_names}")
        return dims

    def group(self, axes):
        """The process group of this rank's line along ``axes``."""
        axes = tuple(axes)
        self._dims(axes)
        if self.coords is None:
            raise ValueError(f"rank {dist.get_rank()} is not in this mesh")
        return self._groups[axes]

    def index(self, axes):
        """(k, n): this rank's position along ``axes`` taken together
        (row-major) and their size; (0, 1) for no axes."""
        dims = self._dims(axes)
        n = int(np.prod([self.ranks.shape[d] for d in dims])) if dims else 1
        if not dims:
            return 0, 1
        k = int(np.ravel_multi_index([self.coords[d] for d in dims],
                                     [self.ranks.shape[d] for d in dims]))
        return k, n


def make_mesh(ranks=None, axis: str = "tiles", device=None) -> Mesh:
    """A 1D mesh of ``ranks`` (default: every rank of the default group)."""
    ranks = list(range(dist.get_world_size())) if ranks is None else sorted(ranks)
    return Mesh(ranks, (axis,), device)


def make_mesh_2d(shape, ranks=None, axes=("ty", "tx"), device=None) -> Mesh:
    """2D tile mesh: image rows shard over ``ty`` and columns over ``tx``
    (square screen tiles keep the stencils' halos compact both ways)."""
    ranks = list(range(dist.get_world_size())) if ranks is None else sorted(ranks)
    return Mesh(np.array(ranks[: shape[0] * shape[1]]).reshape(shape), axes, device)


def _axes(mesh: Mesh, axis) -> tuple:
    if axis is None:
        return mesh.axis_names
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclass(frozen=True)
class Placement:
    """Where image-shaped leaves live on a mesh (JAX ``NamedSharding``):
    rows split over the ``rows`` axes, columns over the ``cols`` axes,
    each rank holding its block; replicated with neither."""

    mesh: Mesh
    rows: tuple = ()
    cols: tuple = ()

    def parts(self):
        (ky, ny), (kx, nx) = self.mesh.index(self.rows), self.mesh.index(self.cols)
        return ky, ny, kx, nx

    def block(self) -> Block:
        """This rank's block, with the transport between the blocks."""
        from hikari_tpu_torch.parallel.halo import Transport

        ky, ny, kx, nx = self.parts()
        return Block(ky, ny, kx, nx, Transport(self) if ny * nx > 1 else None)

    def place(self, x):
        """This rank's block of a whole leaf ``x`` (ndim >= 2, its rows and
        columns dividing into the blocks), else ``x`` (replicated), on the
        mesh's device."""
        x = x.to(self.mesh.device)
        ky, ny, kx, nx = self.parts()
        if x.ndim >= 2 and x.shape[0] % ny == 0 and x.shape[1] % nx == 0:
            x = Block(ky, ny, kx, nx).take(x)
        return x.contiguous()


def frame_placement(mesh: Mesh, axis="tiles", cols=None) -> Placement:
    """The placement of a sharded frame's images: rows over ``axis`` (a
    name, a tuple, or None for every mesh axis), columns over ``cols``."""
    return Placement(mesh, _axes(mesh, axis), () if cols is None else _axes(mesh, cols))


def shard_state_2d(state, mesh: Mesh, axes=("ty", "tx")):
    """Each image-shaped leaf as this rank's (row, column) tile; the
    other leaves replicated."""
    return map_tensors(Placement(mesh, (axes[0],), (axes[1],)).place, state)


def shard_state(state, mesh: Mesh, axis: str = "tiles"):
    """Each image-shaped leaf (ndim >= 2, rows divisible by the mesh's
    size) as this rank's row block; the other leaves replicated."""
    rows = Placement(mesh, (axis,))

    def place(x):
        if x.ndim >= 2 and x.shape[0] % mesh.size == 0:
            return rows.place(x)
        return x.to(mesh.device)

    return map_tensors(place, state)


def replicate(tree, mesh: Mesh):
    """Every tensor of ``tree`` on the mesh's device, equal on every rank:
    the mesh's first rank broadcasts its own."""
    group = mesh.group(mesh.axis_names)
    src = int(mesh.ranks.flat[0])

    def bcast(x):
        x = x.to(mesh.device).contiguous().clone()
        dist.broadcast(x, src=src, group=group)
        return x

    return map_tensors(bcast, tree)


def _xla_tracer(settings: RenderSettings) -> RenderSettings:
    """The JAX package's rewrite for a sharded step without a mesh in hand
    (``tracer="auto"`` -> ``"auto_xla"``). The port dispatches both alike
    (``trace/api.trace_rays``): the kernel searches run on any rank's rays."""
    if settings.tracer != "auto":
        return settings
    return dataclasses.replace(settings, tracer="auto_xla")


def _check_frame(settings: RenderSettings, placement: Placement) -> None:
    """The sizes a sharded frame splits: every image into equal blocks,
    and at an integer upscale ratio the output rows R times the render
    rows, so that a block's deferred texels stay in its block."""
    _, ny, _, nx = placement.parts()
    block = Block(0, ny, 0, nx)
    rh, rw = settings.render_size
    for size in (settings.render_size, settings.output_size, image_size(settings),
                 (2 * rh, 2 * rw)):
        block.size(size)
    ratio = settings.upscale_ratio
    if float(ratio).is_integer() and settings.output_size != (int(ratio) * rh, int(ratio) * rw):
        raise ValueError(
            f"a sharded frame needs the output size {settings.output_size} to be "
            f"{int(ratio)} x the render size {settings.render_size}"
        )


def _sharded_frame(settings, mesh, axis, cols, manual_halo_denoise):
    """(placement, block, denoise_fn, context) of the sharded step."""
    from hikari_tpu_torch.parallel.halo import denoise_channel_sharded
    from hikari_tpu_torch.trace.api import shard_tracing

    placement = frame_placement(mesh, axis, cols)
    _check_frame(settings, placement)
    block = placement.block()
    denoise_fn = None
    if manual_halo_denoise:
        denoise_fn = partial(denoise_channel_sharded, mesh=mesh, axis_name=placement.rows,
                             cols=placement.cols or None)

    @contextmanager
    def context():
        with rendering(block), shard_tracing(mesh, placement.rows + placement.cols):
            yield

    return placement, block, denoise_fn, context


def make_sharded_render(
    settings: RenderSettings,
    mesh: Mesh,
    axis="tiles",
    manual_halo_denoise: bool = False,
    cols=None,
):
    """The sharded render step ``step(scene, camera, state_local) ->
    (out_local, new_state_local)``: the state and the outputs are this
    rank's blocks (``shard_state``, ``shard_state_2d``,
    ``multihost.host_local_state``), rows split over ``axis`` (a name, a
    tuple, or None for every mesh axis) and columns over ``cols``; the
    scene and the camera are replicated. Every rank calls the step
    together.

    Each pass runs on the rank's block; its ``trace_rays`` calls trace the
    block's rays only (under ``trace.shard_tracing``, whose kernel
    backends take the already sharded rays as they are).
    ``manual_halo_denoise`` swaps the denoiser for
    ``parallel/halo.denoise_channel_sharded``: halo exchanges of exactly
    ``step`` rows a side a level instead of all-gathers. Both give the
    unsharded frame's image."""
    _, _, denoise_fn, context = _sharded_frame(settings, mesh, axis, cols, manual_halo_denoise)

    def step(scene, camera, state):
        with context():
            return render_frame(scene, camera, state, settings, denoise_fn=denoise_fn)

    return step


def render_loss(scene, camera, state, target, settings: RenderSettings):
    """Pixel L2 loss of the frame's image against ``target`` (h, w, 3).
    Returns (loss, (RenderOutputs, FrameState))."""
    out, new_state = render_frame(scene, camera, state, settings)
    diff = out.image[..., :3] - target
    return torch.mean(diff * diff), (out, new_state)


def _leaf_params(scene):
    return {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in DIFF_LEAVES}


def make_train_step(
    settings: RenderSettings,
    sharded: bool = False,
    mesh: Mesh | None = None,
    axis="tiles",
    cols=None,
    manual_halo_denoise: bool = False,
):
    """``train_step(scene, camera, state, target) -> (loss, grads, out,
    new_state)``: ``grads`` maps each name of ``DIFF_LEAVES`` to the
    gradient of the loss with respect to that scene field (zeros for a
    field no path reads, as ``jax.grad`` gives). ``loss``, ``out`` and
    ``new_state`` carry no graph.

    With a ``mesh`` the step is sharded as ``make_sharded_render`` is: the
    state, ``out`` and ``new_state`` are this rank's blocks, ``target``
    the block's rows (or the whole image, of which the step takes the
    block). Each rank's loss is its own pixels' squared error over the
    whole image's count; the loss and the gradients returned are the
    global ones, summed over the ranks (``all_reduce``), equal on every
    rank. ``sharded=True`` without a mesh is the JAX package's GSPMD step
    over whatever placement its inputs have: here, one rank's unsharded
    step, with ``_xla_tracer``'s settings."""
    if mesh is None:
        if sharded:
            settings = _xla_tracer(settings)
        return _unsharded_step(settings)

    placement, block, denoise_fn, context = _sharded_frame(settings, mesh, axis, cols,
                                                           manual_halo_denoise)

    def train_step(scene, camera, state, target):
        params = _leaf_params(scene)
        leaves = [params[k] for k in DIFF_LEAVES]
        with context(), torch.enable_grad():
            out, new_state = render_frame(dataclasses.replace(scene, **params), camera, state,
                                          settings, denoise_fn=denoise_fn)
            image = out.image[..., :3]
            if target.shape[:2] != image.shape[:2]:
                target = block.take(target)
            diff = image - target.to(image.device)
            local = (diff * diff).sum() / (diff.numel() * block.ny * block.nx)
            grads = torch.autograd.grad(local, leaves, materialize_grads=True)
            flat = block.sum(torch.cat([g.reshape(-1) for g in grads]))
            loss = block.sum(local.detach())
        sizes = [g.numel() for g in grads]
        grads = [f.reshape(g.shape) for f, g in zip(flat.split(sizes), grads)]
        out, new_state = map_tensors(torch.Tensor.detach, (out, new_state))
        return loss, dict(zip(DIFF_LEAVES, grads)), out, new_state

    return train_step


def _unsharded_step(settings: RenderSettings):
    def train_step(scene, camera, state, target):
        params = _leaf_params(scene)
        leaves = [params[k] for k in DIFF_LEAVES]
        with torch.enable_grad():
            loss, (out, new_state) = render_loss(
                dataclasses.replace(scene, **params), camera, state, target, settings
            )
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        out, new_state = map_tensors(torch.Tensor.detach, (out, new_state))
        return loss.detach(), dict(zip(DIFF_LEAVES, grads)), out, new_state

    return train_step
