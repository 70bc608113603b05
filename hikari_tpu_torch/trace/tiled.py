"""Phase 1 of the large-scene tracer: per-tile cluster entry distances —
the port of ``hikari_tpu.trace.tiled`` (``_cluster_bounds``,
``tile_cluster_entries``, ``safe_inv_dir``), in plain torch.

Triangles are grouped into clusters of ``cluster`` consecutive primitives
(consecutive in the compiled buffer means BVH depth-first leaf order, so
clusters are spatially tight). Rays come in tiles of ``TILE_R``; each ray
slab-tests every cluster AABB, and each tile keeps, per cluster, the
nearest entry over its rays. The tile walk (``trace/tile_walk.py``) then
visits a tile's clusters near to far.
"""

from __future__ import annotations

import torch

from hikari_tpu_torch.config import F32_MAX

TILE_R = 512  # rays per tile
# Elements of one (rays, clusters, 3) slab temporary per chunk of phase 1
# (2^26 f32 = 256 MB).
ENTRY_CHUNK_ELEMS = 1 << 26


def cluster_bounds(scene, cluster: int):
    """(L, 3) min/max cluster AABBs and (L,) validity, from the padded
    triangle buffer; padding rows and invalid triangles are masked, and a
    cluster with no valid triangle has cmin = F32_MAX, cmax = -F32_MAX."""
    tri = scene.tri_world.detach()
    P = tri.shape[0]
    L = -(-P // cluster)
    valid = scene.tri_valid.to(torch.bool)
    if L * cluster != P:
        tri = torch.cat([tri, tri.new_zeros((L * cluster - P, 3, 3))])
        valid = torch.cat([valid, valid.new_zeros((L * cluster - P,))])
    tmin = tri.amin(dim=1).reshape(L, cluster, 3)
    tmax = tri.amax(dim=1).reshape(L, cluster, 3)
    vmask = valid.reshape(L, cluster, 1)
    cmin = torch.where(vmask, tmin, F32_MAX).amin(dim=1)
    cmax = torch.where(vmask, tmax, -F32_MAX).amax(dim=1)
    return cmin, cmax, vmask[..., 0].any(dim=1)


def safe_inv_dir(d):
    """1/d with a signed epsilon floor (slab-test convention)."""
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    return 1.0 / torch.where(d.abs() < 1e-20, tiny, d)


def tile_cluster_entries(cmin, cmax, cvalid, o, inv_d, maxd, lo=None, hi=None,
                         cluster: int = 0):
    """Per-tile nearest cluster entries. o/inv_d: (R, 3), maxd (R,), R a
    multiple of TILE_R; ``lo``/``hi`` (R,) int32, optional: the per-ray
    primitive range [lo, hi), which prunes every cluster whose prim range
    [c*cluster, (c+1)*cluster) misses it (``cluster`` must then be given).

    Returns (entries (T, L), ray_maxent (R,)): per tile and cluster the
    minimum entry distance over the tile's rays (F32_MAX where none
    enters), and per ray the largest finite entry over all clusters (-1
    where the ray enters none) — the walk's per-ray retirement bound.

    The range test compares in f32 as the JAX package does; that is exact
    while the padded primitive count stays below 2^24."""
    R = o.shape[0]
    L = cmin.shape[0]
    if R % TILE_R:
        raise ValueError(f"tile_cluster_entries: {R} rays is not a multiple of {TILE_R}")
    have_range = lo is not None
    if have_range:
        if cluster <= 0:
            raise ValueError("tile_cluster_entries: a prim range needs the cluster size")
        if L * cluster >= 2**24:
            raise ValueError("f32 prim range compares are exact only below 2^24 prims")
        c_lo = torch.arange(L, dtype=torch.float32, device=o.device) * cluster
        c_hi = c_lo + cluster
    T = R // TILE_R
    entries = torch.empty((T, L), dtype=torch.float32, device=o.device)
    ray_maxent = torch.empty((R,), dtype=torch.float32, device=o.device)
    tiles = max(1, ENTRY_CHUNK_ELEMS // (TILE_R * max(L, 1) * 3))
    for t0 in range(0, T, tiles):
        t1 = min(T, t0 + tiles)
        s, e = t0 * TILE_R, t1 * TILE_R
        ob, ib = o[s:e, None, :], inv_d[s:e, None, :]
        a = (cmin[None] - ob) * ib  # (rays, L, 3)
        b = (cmax[None] - ob) * ib
        tlo = torch.minimum(a, b).amax(dim=-1)
        thi = torch.maximum(a, b).amin(dim=-1)
        del a, b
        entry = torch.clamp(tlo, min=0.0)
        hit = (thi >= entry) & (entry < maxd[s:e, None]) & cvalid[None]
        if have_range:
            lb = lo[s:e].to(torch.float32)[:, None]
            hb = hi[s:e].to(torch.float32)[:, None]
            hit = hit & (c_lo[None] < hb) & (c_hi[None] > lb)
        ray_maxent[s:e] = torch.where(hit, entry, -1.0).amax(dim=1)
        entries[t0:t1] = torch.where(hit, entry, F32_MAX).reshape(t1 - t0, TILE_R, L).amin(dim=1)
    return entries, ray_maxent
