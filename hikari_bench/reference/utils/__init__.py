"""Shared shader-library math on torch tensors — the counterpart of
``hikari_tpu.utils`` (reference src/shaders/utils.wgsl:1-66). Everything
broadcasts over leading batch dims.

``mxu_table_gather`` has no counterpart: its one-hot matmul form was a TPU
layout device, and a row gather is plain indexing here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TAU = 6.283185307
INV_TAU = 0.159154943
PI = 3.1415926

_U32 = 0xFFFFFFFF


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else the CUDA card.
    Without a card and without a device named it raises; the port never
    falls back to the CPU in silence."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def luminance(v):
    """Rec.709 luminance (reference src/shaders/utils.wgsl:62-65).
    ``v``: (..., 3) -> (...)."""
    return 0.2126 * v[..., 0] + 0.7152 * v[..., 1] + 0.0722 * v[..., 2]


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def dot3(a, b):
    """Batched vec3 dot: (...,3),(...,3) -> (...)."""
    return (a * b).sum(-1)


def dot3_ordered(a, b):
    """``dot3`` summed left to right in separate operations: the CPU's
    ``sum(-1)`` bits on both devices (a CUDA reduction over the last axis
    associates otherwise). Used where the card must reproduce the CPU
    twin's geometry: ray directions, refined hits, depth, triangle planes."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def normalize(v, eps: float = 0.0):
    """Normalize the last axis; with eps>0 the guard sits inside the sqrt
    (``sqrt(max(|v|^2, eps^2))``) so the backward stays finite at 0."""
    n2 = (v * v).sum(-1, keepdim=True)
    if eps:
        n2 = torch.clamp(n2, min=eps * eps)
    return v / torch.sqrt(n2)


def safe_normalize(v):
    return normalize(v, eps=1e-18)


def safe_sqrt0(x):
    """``sqrt(max(x, 0))`` with a finite (zero) backward at 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))), 0.0)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def fract(x):
    return x - torch.floor(x)


def pcg_hash(value):
    """Integer hash (reference src/shaders/utils.wgsl:15-25).

    torch has no usable uint32 multiply, so the u32 state lives in int64
    and every product is masked back to 32 bits: the signed int64 product
    may wrap, but its low 32 bits are exact. Returns the u32 values as an
    int64 tensor."""
    state = torch.as_tensor(value).to(torch.int64) & _U32
    state = state ^ 2747636419
    state = (state * 2654435769) & _U32
    state = state ^ (state >> 16)
    state = (state * 2654435769) & _U32
    state = state ^ (state >> 16)
    state = (state * 2654435769) & _U32
    return state


def random_float(value):
    """u32 -> [0,1] float (reference src/shaders/utils.wgsl:27-29). The
    int64 -> float32 cast rounds to nearest-even once, like a u32 cast."""
    return pcg_hash(value).to(torch.float32) / 4294967295.0


def clip_to_uv(clip):
    """Clip space (...,4) -> uv in [0,1]^2, y down
    (reference src/shaders/utils.wgsl:31-36)."""
    uv = clip[..., :2] / clip[..., 3:4]
    uv = (uv + 1.0) * 0.5
    return torch.stack([uv[..., 0], 1.0 - uv[..., 1]], dim=-1)


def pixel_coords(size_hw, device, dtype=torch.int64):
    """(ys, xs): the coordinates of every pixel of an image of ``size_hw``."""
    h, w = size_hw
    return torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device), indexing="ij")


def uv_grid(size_hw, device=None):
    """Pixel-center uv grid for an (h, w) image -> (h, w, 2) [u, v]."""
    h, w = size_hw
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([(xs + 0.5) / w, (ys + 0.5) / h], dim=-1)


def normal_basis(n):
    """Branchless orthonormal tangent frame (reference
    src/shaders/utils.wgsl:42-49, Duff et al.). ``n``: (...,3) ->
    (...,3,3) whose COLUMNS are (t, b, n)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.clamp(torch.sign(nz) * 2.0 + 1.0, max=1.0)
    u = -1.0 / (s + nz)
    v = nx * ny * u
    t = torch.stack([1.0 + s * nx * nx * u, s * v, -s * nx], dim=-1)
    b = torch.stack([v, s + ny * ny * u, -ny], dim=-1)
    return torch.stack([t, b, n], dim=-1)


def basis_apply(basis, local):
    """``basis @ local`` per element: (...,3,3) x (...,3) -> (...,3), as
    the three column sums written out (no batched matmul)."""
    return (
        basis[..., :, 0] * local[..., 0:1]
        + basis[..., :, 1] * local[..., 1:2]
        + basis[..., :, 2] * local[..., 2:3]
    )


def halton(base: int, index: int) -> float:
    """Scalar Halton sequence term (host-side; reference utils.wgsl:52-59)."""
    result, f = 0.0, 1.0
    i = index
    while i > 0:
        f /= base
        result += f * (i % base)
        i //= base
    return result


def halton23_sequence(count: int) -> np.ndarray:
    """(count, 2) Halton(2,3) points — the reference's jitter table."""
    return np.array(
        [[halton(2, i), halton(3, i)] for i in range(count)], dtype=np.float32
    )


# 16 Halton(2,3) jitter points (reference src/view.rs:130-139).
HALTON_JITTER = halton23_sequence(16)

# The reference's 3x3 à-trous kernel (src/view.rs:125-129).
ATROUS_KERNEL = np.array(
    [
        [0.0625, 0.125, 0.0625],
        [0.125, 0.25, 0.125],
        [0.0625, 0.125, 0.0625],
    ],
    dtype=np.float32,
)


def take_rows(table, idx):
    """``table[idx]`` for an integer ``idx`` (...,): the rows of ``table``
    (N, ...) as one ``index_select``, whose backward adds the cotangent
    rows into the table's gradient with ``index_add``. The backward of
    advanced indexing (``index_put`` with accumulate) sorts the indices and
    sums each run of equal ones in one warp; on the few rows of a material
    or triangle table, read by every pixel of a 960x540 frame, that took
    ~140 ms a call on the H100.

    A table read many times a row (at least ``REUSED_ROWS`` reads a row:
    a material, light or triangle table read by every pixel) adds its
    cotangent rows into up to ``SPREAD`` copies of the table, the i-th
    read into copy i mod SPREAD, and sums the copies in f64: one f32 sum
    of a 1080p frame's ~10^6 cotangents a row read up to 1.2e-5 relative
    L2 apart under another order of the adds (a sharded frame's, the
    card's atomics), and the copies also spread the atomics over more
    addresses."""
    if table.requires_grad and torch.is_grad_enabled() and idx.numel() >= REUSED_ROWS * len(table):
        return _TakeRowsSpread.apply(table, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])


REUSED_ROWS = 64
SPREAD = 256


class _TakeRowsSpread(torch.autograd.Function):
    """``index_select`` whose backward sums the cotangent rows over
    ``SPREAD`` copies of the table, the copies in f64."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        rows, n = ctx.rows, idx.numel()
        copies = max(1, min(SPREAD, n // (REUSED_ROWS * rows)))
        slot = idx + rows * (torch.arange(n, device=idx.device) % copies)
        acc = g.new_zeros((copies * rows,) + g.shape[1:]).index_add_(0, slot, g)
        return acc.view((copies, rows) + g.shape[1:]).double().sum(0).to(g.dtype), None


def gather_pixels(img, y, x):
    """Texels of img (H, W) or (H, W, C) at integer grids y/x (...,)."""
    h, w = img.shape[0], img.shape[1]
    return take_rows(img.reshape((h * w,) + img.shape[2:]), y * w + x)


def map_tensors(fn, obj):
    """Apply ``fn`` to every tensor inside a (nested) frozen dataclass,
    list, tuple or dict; other leaves are returned unchanged — the
    counterpart of ``jax.tree_util.tree_map`` for the port's records."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj,
            **{
                f.name: map_tensors(fn, getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.init
            },
        )
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    return obj


