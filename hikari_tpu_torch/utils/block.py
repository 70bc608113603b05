"""The frame's pixel block: the rows (and columns) of the image that this
process renders.

Unsharded, the block is the whole image and every method below is the
identity, so the single-device frame runs exactly as before. The sharded
frame (``parallel/sharding.make_sharded_render``) renders under the block
of its rank: the image's rows split ``ny`` ways and its columns ``nx`` ways,
this rank holding part (``ky``, ``kx``). Every pass allocates at
``size(...)``, takes pixel coordinates from ``coords(...)`` (global, so the
camera rays, the noise bank and the RNG see the pixel's own index), and
reads other ranks' pixels only through the block's transport
(``parallel/halo.Transport``): ``gather`` for the whole image, ``halo``
for a fixed reach, ``sum``/``min``/``mean`` for reductions.

Every image size a sharded frame meets divides by the mesh's shape: the
blocks are equal, as the all-gathers need.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Block:
    ky: int = 0
    ny: int = 1
    kx: int = 0
    nx: int = 1
    transport: object = None  # parallel.halo.Transport of a sharded block

    @property
    def sharded(self) -> bool:
        return self.ny * self.nx > 1

    def size(self, size_hw) -> tuple:
        """(h, w) of this block of an image of ``size_hw``."""
        h, w = size_hw
        if h % self.ny or w % self.nx:
            raise ValueError(
                f"an image of {h}x{w} does not split into {self.ny}x{self.nx} equal blocks"
            )
        return h // self.ny, w // self.nx

    def origin(self, size_hw) -> tuple:
        """The block's first (row, column) in the image."""
        lh, lw = self.size(size_hw)
        return self.ky * lh, self.kx * lw

    def coords(self, size_hw, device, dtype=torch.int64):
        """(ys, xs): the image coordinates of the block's pixels."""
        (lh, lw), (y0, x0) = self.size(size_hw), self.origin(size_hw)
        return torch.meshgrid(
            torch.arange(y0, y0 + lh, dtype=dtype, device=device),
            torch.arange(x0, x0 + lw, dtype=dtype, device=device),
            indexing="ij",
        )

    def take(self, full):
        """This block of a whole image (h, w, ...)."""
        if not self.sharded:
            return full
        (lh, lw), (y0, x0) = self.size(full.shape[:2]), self.origin(full.shape[:2])
        return full[y0 : y0 + lh, x0 : x0 + lw]

    def gather(self, x):
        """The whole image whose block on each rank is its ``x``
        (differentiable: the backward returns each rank its rows)."""
        return self.transport.gather(x) if self.sharded else x

    def halo(self, x, radius: int):
        """``x`` padded with ``radius`` rows above and below (and columns
        left and right when the columns are split) from the neighbouring
        blocks, zero beyond the image; returns (padded, valid) with
        ``valid`` (h + 2r, w[ + 2r]) marking the image's own pixels."""
        if self.sharded:
            return self.transport.halo(x, radius)
        h, w = x.shape[0], x.shape[1]
        pad = x.new_zeros((radius,) + x.shape[1:])
        valid = torch.zeros((h + 2 * radius, w), dtype=torch.bool, device=x.device)
        valid[radius : radius + h] = True
        return torch.cat([pad, x, pad]), valid

    def edge_shift(self, x, dy: int, dx: int):
        """out[y, x] = img[clip(y + dy), clip(x + dx)] over the whole image,
        at this block's pixels: ``render/filters.edge_shift``'s clamp to
        the image's edge, not the block's."""
        h, w = x.shape[0], x.shape[1]
        if (dy == 0 or self.ny == 1) and (dx == 0 or self.nx == 1):
            rows = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
            cols = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
            return x.index_select(0, rows).index_select(1, cols)
        r = max(abs(dy), abs(dx))
        padded, _ = self.halo(x, r)
        full_h, full_w = h * self.ny, w * self.nx
        y0, x0 = self.ky * h, self.kx * w
        rows = torch.clamp(torch.arange(y0, y0 + h, device=x.device) + dy, 0, full_h - 1) - y0 + r
        if self.nx > 1:
            cols = torch.clamp(torch.arange(x0, x0 + w, device=x.device) + dx, 0, full_w - 1) - x0 + r
        else:
            cols = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
        return padded.index_select(0, rows).index_select(1, cols)

    def sum(self, x):
        """The sum over every rank of ``x`` (a partial sum of this block)."""
        return self.transport.all_sum(x) if self.sharded else x

    def min(self, x):
        """The elementwise minimum over every rank of ``x``."""
        return self.transport.all_min(x) if self.sharded else x

    def mean(self, x):
        """The whole image's mean of a per-pixel quantity given at this
        block (a cross-rank sum when sharded)."""
        if not self.sharded:
            return x.mean()
        return self.sum(x.to(torch.float32).sum()) / (x.numel() * self.ny * self.nx)


WHOLE = Block()

_blocks: list = []  # the blocks of the frames being rendered, innermost last


def current() -> Block:
    """The block of the frame being rendered (the whole image outside a
    sharded frame)."""
    return _blocks[-1] if _blocks else WHOLE


@contextmanager
def rendering(block: Block):
    """Render under ``block``: every pass inside reads it through
    ``current()``. A module-level stack, not a context variable, so that
    a backward that reruns a pass (remat) on autograd's device thread sees
    it too."""
    _blocks.append(block)
    try:
        yield block
    finally:
        _blocks.pop()
