"""The trace layer's reference: every sampled ray against every triangle
of the scene, Moller-Trumbore in float64, in blocks of rays. It needs no
acceleration structure, so it judges any search."""

from __future__ import annotations

import torch

# Ray/triangle pairs per block: bounds the (rays, triangles) temporaries.
BLOCK_PAIRS = 1 << 24
# Barycentric slack of an edge: ``edge`` > 0 grows each triangle by it,
# < 0 shrinks it, so a ray that grazes an edge counts either way.
EDGE = 1e-5


def intersect(o, d, v0, v1, v2, eps: float, edge: float = 0.0):
    """t of each ray (R, 3) against each triangle (T, 3) as (R, T), +inf
    where it misses (no hit at t > eps inside the triangle)."""
    e1, e2 = v1 - v0, v2 - v0
    p = torch.cross(d[:, None, :].expand(-1, e2.shape[0], -1), e2[None].expand(d.shape[0], -1, -1),
                    dim=-1)
    det = (e1[None] * p).sum(-1)
    inv = 1.0 / torch.where(det.abs() > 0, det, torch.ones_like(det))
    s = o[:, None, :] - v0[None]
    u = (s * p).sum(-1) * inv
    q = torch.cross(s, e1[None].expand_as(s), dim=-1)
    v = (d[:, None, :] * q).sum(-1) * inv
    t = (e2[None] * q).sum(-1) * inv
    ok = (det.abs() > 0) & (u >= -edge) & (v >= -edge) & (u + v <= 1 + edge) & (t > eps)
    return torch.where(ok, t, torch.full_like(t, float("inf")))


def closest(o, d, maxd, excl, lo, hi, tri_world, tri_inst, dtype=torch.float64,
            eps: float = 1e-7, edge: float = 0.0):
    """(t of the nearest hit below each ray's max distance, +inf for none;
    t of each ray against its own ``prim`` is ``along``). o, d (R, 3);
    maxd (R,); excl, lo, hi (R,) i32; tri_world (T, 3, 3); tri_inst (T,)."""
    R, T = o.shape[0], tri_world.shape[0]
    tri = tri_world.to(dtype)
    o, d = o.to(dtype), d.to(dtype)
    ids = torch.arange(T, device=o.device)
    best = torch.full((R,), float("inf"), dtype=dtype, device=o.device)
    rows = max(1, BLOCK_PAIRS // max(T, 1))
    for s in range(0, R, rows):
        e = min(R, s + rows)
        t = intersect(o[s:e], d[s:e], tri[:, 0], tri[:, 1], tri[:, 2], eps, edge)
        keep = ((ids[None] >= lo[s:e, None]) & (ids[None] < hi[s:e, None])
                & (tri_inst[None] != excl[s:e, None]) & (t < maxd[s:e, None].to(dtype)))
        best[s:e] = torch.where(keep, t, torch.full_like(t, float("inf"))).amin(dim=1)
    return best


def along(o, d, prim, tri_world, dtype=torch.float64, eps: float = 1e-7, edge: float = 0.0):
    """t of each ray against the one triangle ``prim`` names (+inf where it
    misses it or names none)."""
    safe = prim.clamp(min=0).long()
    tri = tri_world[safe].to(dtype)
    o, d = o.to(dtype), d.to(dtype)
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    p = torch.cross(d, e2, dim=-1)
    det = (e1 * p).sum(-1)
    inv = 1.0 / torch.where(det.abs() > 0, det, torch.ones_like(det))
    s = o - tri[:, 0]
    u = (s * p).sum(-1) * inv
    q = torch.cross(s, e1, dim=-1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    ok = (prim >= 0) & (det.abs() > 0) & (u >= -edge) & (v >= -edge) & (u + v <= 1 + edge) & (
        t > eps)
    return torch.where(ok, t, torch.full_like(t, float("inf")))
