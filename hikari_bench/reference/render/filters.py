"""Texture-sampling primitives of the post chain — the port of the math of
``hikari_tpu.render.filters``: nearest and bilinear samples,
``textureGather``, clamped shifts and the 2x2 quad interleave. Clamp-to-
edge addressing, image layout (h, w, c), uv = (u right, v down) like WGSL.

The JAX package carries every reprojected fetch on one of two TPU
transports (a packed wide-row gather, or static shifts at zero velocity:
``pack_rows``, ``pack_window_gather``, ``identity_window_accessor``,
``cond_window_gather``, ``quad_phase_sampler``, ``make_dyn_at``,
``parity_shift``). The port has one transport, ``texel``: a clamped
per-pixel gather, which equals both of them (tests/test_gather_rework.py
holds the two JAX transports equal at zero velocity).
"""

from __future__ import annotations

import torch

from hikari_bench.reference.utils import gather_pixels


def texel(img, y, x):
    """img[clip(y, 0, h-1), clip(x, 0, w-1)] at integer grids y/x
    (broadcast together): the clamp-to-edge texel fetch every post-chain
    tap reduces to."""
    h, w = img.shape[0], img.shape[1]
    y = torch.clamp(y, 0, h - 1)
    x = torch.clamp(x, 0, w - 1)
    y, x = torch.broadcast_tensors(y, x)
    return gather_pixels(img, y, x)


def pack_rows(parts):
    """Pack K same-shape 2D planes into an (H*W, K) row table whose row
    ``y*W + x`` holds every plane's value at pixel (y, x), so one row
    gather fetches all K. The JAX package's layout notes for the TPU (one
    transpose of flattened planes) do not apply here."""
    return torch.stack(parts, dim=-1).reshape(-1, len(parts))


def pixel_grid(h: int, w: int, device):
    """(ys, xs) int64 index planes of an (h, w) image."""
    return torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij"
    )


def nearest_sample(img, uv):
    """textureSampleLevel(..., nearest) — (...,2) uv -> (..., c)."""
    h, w = img.shape[0], img.shape[1]
    x = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1)
    return gather_pixels(img, y, x)


def edge_shift(img, dy: int, dx: int):
    """out[y, x] = img[clip(y + dy), clip(x + dx)]: a static shift with
    clamp-to-edge addressing."""
    h, w = img.shape[0], img.shape[1]
    rows = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img.index_select(0, rows).index_select(1, cols)


def shift2d(img, dy: int, dx: int):
    """Shift so out[y, x] = img[y + dy, x + dx] (wrapping); returns
    (shifted, valid) where valid marks in-bounds source texels (the
    reference skips out-of-bounds stencil taps, denoise.wgsl:122-125)."""
    h, w = img.shape[0], img.shape[1]
    shifted = torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
    ys = torch.arange(h, device=img.device)[:, None] + dy
    xs = torch.arange(w, device=img.device)[None, :] + dx
    valid = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    return shifted, valid


def interleave2x2(q00, q01, q10, q11):
    """out[2y + a, 2x + b] = q_ab[y, x]."""
    h, w = q00.shape[0], q00.shape[1]
    out = q00.new_empty((2 * h, 2 * w) + q00.shape[2:])
    out[0::2, 0::2] = q00
    out[0::2, 1::2] = q01
    out[1::2, 0::2] = q10
    out[1::2, 1::2] = q11
    return out
