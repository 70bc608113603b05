"""The transport of the sharded frame: every read of another rank's pixels
goes through this module — the port of ``hikari_tpu.parallel.halo`` on
``torch.distributed``.

A sharded frame (``parallel/sharding.make_sharded_render``) holds on each
rank one block of every image (``utils.block.Block``). ``Transport`` moves
pixels between the blocks three ways:

* ``gather``: the whole image, for reads whose reach is not fixed
  (reprojection, the spatial-reuse spiral, the post chain);
* ``halo``: ``radius`` rows (and columns) from the neighbouring blocks,
  for the stencils whose reach is fixed (the G-buffer's depth gradient,
  the à-trous levels of ``denoise_channel_sharded``);
* ``all_sum``/``all_min``: reductions (the loss, the frame's statistics,
  the reservoir invalidation that writes into other blocks).

Gathers and halos use the list form of the differentiable all-gather,
``torch.distributed.nn.functional.all_gather``, which every backend takes
(gloo moves CUDA tensors through host memory): its backward returns each
rank the cotangents of its own pixels. A halo all-gathers the border rows
of every block of the row and keeps its neighbours' (JAX: one ppermute a
side); between ranks sharing one card that is no dearer. No tensor is
copied to the CPU here: gloo's own staging is the only host copy.

``stats`` counts every collective a rank makes: calls, bytes received
(the backward of a gather moves as many again, counted under
``"<kind> backward"``) and, with ``timing`` on, host seconds between a
synchronize before and after each call.
"""

from __future__ import annotations

import functools
import time
import warnings
from contextlib import contextmanager

import torch
import torch.distributed as dist

stats: dict = {}  # kind -> {"calls": n, "bytes": n, "seconds": s}
timing = False


def reset_stats() -> None:
    stats.clear()


def _count(kind: str, nbytes: int, seconds: float = 0.0) -> None:
    s = stats.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += int(nbytes)
    s["seconds"] += seconds


@contextmanager
def _timed(kind: str, nbytes: int, device):
    sync = timing and device.type == "cuda"
    if sync:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            torch.cuda.synchronize(device)
        _count(kind, nbytes, time.perf_counter() - t0 if timing else 0.0)


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def all_gather(x, group, kind: str = "gather"):
    """The blocks ``x`` of every rank of ``group``, in group rank order;
    differentiable when ``x`` requires grad."""
    from torch.distributed.nn.functional import all_gather as nn_all_gather

    x = x.contiguous()
    n = dist.get_world_size(group)
    with _timed(kind, _nbytes(x) * n, x.device), warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # deprecated name, same function
        parts = nn_all_gather(x, group=group)
    if x.requires_grad and torch.is_grad_enabled():
        for p in parts:
            p.register_hook(functools.partial(_count_grad, f"{kind} backward"))
    return parts


def _count_grad(kind, g):
    _count(kind, _nbytes(g))


def all_gather_plain(x, group, kind: str):
    """The list all-gather without autograd (hits, counts)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    with _timed(kind, _nbytes(x) * len(parts), x.device):
        dist.all_gather(parts, x, group=group)
    return parts


def all_reduce(x, op, group, kind: str = "reduce"):
    """A reduced copy of ``x`` (no autograd)."""
    y = x.detach().clone().contiguous()
    with _timed(kind, _nbytes(y), y.device):
        dist.all_reduce(y, op=op, group=group)
    return y


def _halo_rows(x, radius: int, group, k: int, n: int):
    """``x`` (h, ...) padded with ``radius`` rows from the blocks above and
    below along a group of ``n`` ranks (this one ``k``): (padded (h + 2r,
    ...), valid (h + 2r,)). Each rank contributes its first and last
    min(r, h) rows; a reach past the next block takes the blocks between.
    Rows beyond the image are zero and invalid (JAX ``halo_exchange_rows``)."""
    h = x.shape[0]
    m = min(radius, h)
    parts = all_gather(torch.cat([x[:m], x[-m:]]), group, "halo")

    def fill(rows, at_top):
        rows = rows[-radius:] if at_top else rows[:radius]
        pad = x.new_zeros((radius - rows.shape[0],) + x.shape[1:])
        return torch.cat([pad, rows] if at_top else [rows, pad])

    empty = x[:0]
    above = fill(torch.cat([p[m:] for p in parts[:k]] or [empty]), True)
    below = fill(torch.cat([p[:m] for p in parts[k + 1 :]] or [empty]), False)
    rows = torch.arange(-radius, h + radius, device=x.device) + k * h
    return torch.cat([above, x, below]), (rows >= 0) & (rows < n * h)


def _pad_rows(x, radius: int):
    """``_halo_rows`` of a block that spans the image's rows."""
    pad = x.new_zeros((radius,) + x.shape[1:])
    rows = torch.arange(-radius, x.shape[0] + radius, device=x.device)
    return torch.cat([pad, x, pad]), (rows >= 0) & (rows < x.shape[0])


class Transport:
    """The collectives between the blocks of a ``Placement``
    (``parallel/sharding.py``): rows split over its ``rows`` axes,
    columns over its ``cols`` axes."""

    def __init__(self, placement):
        mesh = placement.mesh
        self.ky, self.ny = mesh.index(placement.rows)
        self.kx, self.nx = mesh.index(placement.cols)
        self.tiles = mesh.group(placement.rows + placement.cols)
        self.row_group = mesh.group(placement.rows) if placement.rows else None
        self.col_group = mesh.group(placement.cols) if placement.cols else None

    def gather(self, x):
        parts = all_gather(x, self.tiles)
        rows = [torch.cat(parts[i * self.nx : (i + 1) * self.nx], dim=1) if self.nx > 1
                else parts[i] for i in range(self.ny)]
        return torch.cat(rows)

    def halo(self, x, radius: int):
        w = x.shape[1]
        if self.ny > 1:
            x, valid_rows = _halo_rows(x, radius, self.row_group, self.ky, self.ny)
        else:
            x, valid_rows = _pad_rows(x, radius)
        if self.nx == 1:
            return x, valid_rows[:, None].expand(-1, w)
        xt, valid_cols = _halo_rows(x.transpose(0, 1), radius, self.col_group, self.kx, self.nx)
        return xt.transpose(0, 1), valid_rows[:, None] & valid_cols[None, :]

    def all_sum(self, x):
        return all_reduce(x, dist.ReduceOp.SUM, self.tiles)

    def all_min(self, x):
        return all_reduce(x, dist.ReduceOp.MIN, self.tiles)


def halo_exchange_rows(x, radius: int, mesh, axis: str = "tiles"):
    """This rank's row block ``x`` (h_loc, ...) padded with ``radius`` rows
    from each neighbouring block along ``axis``: (h_loc + 2r, ...), with a
    validity mask (h_loc + 2r,); rows beyond the first and last blocks are
    zero and invalid (the reference skips out-of-bounds stencil taps)."""
    k, n = mesh.index((axis,))
    if n == 1:
        return _pad_rows(x, radius)
    return _halo_rows(x, radius, mesh.group((axis,)), k, n)


def halo_tap(fields, step: int, block, padded=None):
    """The halo tap transport (JAX ``_halo_atrous_level``'s ``tap``): each
    field padded once by ``step`` rows (and columns when they are split)
    from the neighbouring blocks; a tap (dy, dx) steps away is a slice of
    it. Unsplit columns are rolled and masked, as in the JAX package."""
    padded = {} if padded is None else padded
    r = step

    def tap(name, dy, dx):
        if name not in padded:
            padded[name] = block.halo(fields[name], r)
        p, valid = padded[name]
        h, w = fields[name].shape[0], fields[name].shape[1]
        ys = r + dy * step
        t, ok = p[ys : ys + h], valid[ys : ys + h]
        if block.nx > 1:
            xs = r + dx * step
            return t[:, xs : xs + w], ok[:, xs : xs + w]
        cols = torch.arange(w, device=t.device) + dx * step
        return torch.roll(t, -dx * step, dims=1), ok & ((cols >= 0) & (cols < w))[None, :]

    return tap


def denoise_channel_sharded(
    radiance,
    variance,
    albedo_rr,
    gbuffer,
    frame_number: int,
    settings,
    mesh,
    axis_name="tiles",
    cols=None,
):
    """The channel denoiser on this rank's block with halo exchanges only:
    the variance's 3x3 gather after one exchange of 1 row a side, each of
    the 4 à-trous levels after one exchange of exactly ``step`` rows a
    side of each field it reads (irradiance, normal, depth, instance).
    The level body is ``render/denoise.atrous_level``, shared with the
    dense denoiser; only the tap transport differs, so the result is the
    dense denoiser's bit for bit. ``axis_name`` (a name or tuple) splits
    the rows, ``cols`` the columns (a 2D tile mesh)."""
    from hikari_tpu_torch.config import F32_EPSILON
    from hikari_tpu_torch.parallel.sharding import frame_placement
    from hikari_tpu_torch.render.denoise import (
        STEP_SIZES,
        _deferred_maps,
        demodulate,
        filtered_variance,
    )
    from hikari_tpu_torch.utils.block import rendering

    block = frame_placement(mesh, axis_name, cols).block()
    with rendering(block):
        depth, normal, grad, inst = _deferred_maps(gbuffer, settings, frame_number)
        background = depth < F32_EPSILON
        irradiance = demodulate(radiance, albedo_rr)
        var = filtered_variance(variance, halo_tap({"var": variance}, 1, block))
        for step in STEP_SIZES:
            irradiance = _halo_atrous_level(irradiance, var, depth, normal, grad, inst, settings,
                                            step, block)
        out = irradiance * albedo_rr
        return torch.where(background[..., None], 0.0, out)


def _halo_atrous_level(irradiance, var, depth, normal, grad, inst, settings, step: int, block):
    """One à-trous level of ``denoise_channel_sharded``."""
    from hikari_tpu_torch.render.denoise import atrous_level

    fields = {"irr": irradiance, "normal": normal, "depth": depth, "inst": inst}
    return atrous_level(irradiance, var, (depth, normal, grad, inst), settings,
                        halo_tap(fields, step, block))


def sharded_atrous_level(irradiance, weight_maps, step: int, mesh, kernel, weight_fn,
                         axis_name: str = "tiles"):
    """One edge-aware à-trous level on this rank's row block after a single
    halo exchange of ``step`` rows a side (JAX ``sharded_atrous_level``):
    ``irradiance`` (h_loc, w, 3) and ``weight_maps`` (name -> (h_loc, w[,
    C])) are the block's; ``weight_fn(center_guides, tap_guides, dy, dx)
    -> (h, w)`` gives the edge-stopping weight, ``kernel`` the 3x3
    coefficients. Equal to the dense level."""
    names = sorted(weight_maps)
    r = step
    irr_h, valid_rows = halo_exchange_rows(irradiance, r, mesh, axis_name)
    guides_h = [halo_exchange_rows(weight_maps[k], r, mesh, axis_name)[0] for k in names]
    h_loc, w = irradiance.shape[0], irradiance.shape[1]

    center_g = {k: g[r : r + h_loc] for k, g in zip(names, guides_h)}
    acc = irradiance * float(kernel[1][1])
    wsum = torch.full((h_loc, w), float(kernel[1][1]), device=irradiance.device)
    xs = torch.arange(w, device=irradiance.device)[None, :]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            ys = r + dy * step
            tap_irr = torch.roll(irr_h[ys : ys + h_loc], -dx * step, dims=1)
            tap_g = {k: torch.roll(g[ys : ys + h_loc], -dx * step, dims=1)
                     for k, g in zip(names, guides_h)}
            col_ok = (xs + dx * step >= 0) & (xs + dx * step < w)
            ok = valid_rows[ys : ys + h_loc][:, None] & col_ok
            wgt = weight_fn(center_g, tap_g, dy, dx) * float(kernel[dy + 1][dx + 1])
            wgt = torch.where(ok, wgt, 0.0)
            acc = acc + tap_irr * wgt[..., None]
            wsum = wsum + wgt
    return acc / torch.clamp(wsum[..., None], min=1e-4)
