"""The large-scene tile walk: the hand-written CUDA kernel
(``csrc/tile_walk.cu``), its wrapper ``tile_walk`` and its plain twin
``tile_walk_reference`` — the port of ``hikari_tpu.trace.pallas_tiled``
(K2, ``_make_kernel``/``_kernel``, with ``pack_clusters`` and
``trace_pallas_tiled``).

``trace_tile_walk`` runs phase 1 (``trace/tiled.py``: per-tile cluster
entries, the kernel ``csrc/tile_entries.cu`` for CUDA tensors) and a
stable sort of each tile's clusters by entry, then the walk: the kernel
for CUDA tensors, the twin only for CPU tensors.
On a CUDA tensor ``tile_walk`` launches or raises; it never falls back.

Rows may come in any order: each packed row carries its prim id
(``pack_triangles``), the search reports it and applies each ray's prim
range to it. ``trace/api.py`` walks the rows of ``tile_clusters``: whole
instances in the TLAS's depth-first leaf order (``scene.tile_rows``), so
a cluster holds near instances and its box stays tight, each box grown by
a margin that bounds the float32 rounding of the pair test.

Tie rule (kernel and twin): eight running bests per ray over the whole
walk, row ``j`` of a cluster to best ``j mod 8``, each the least key (t,
rank of prim mod 8, prim) of its pairs, where the rank is the sublane's
place in K1's halving (0, 4, 2, 6, 1, 5, 3, 7); the end takes the least
key of the eight. So the closest hit is K1's (``trace/closest_hit.py``,
tie "pallas") whenever the walk tests every pair that could win, in any
row order and any walk order. The walk order, and with it the any-hit
result of a ray that stops at ``early``, follows the tiles' composition,
the cluster size, the skip and the row order: ``trace/api.py`` sets the
first three as the JAX package does.

The kernel is built at first use from the repo's source with ``nvcc``
into ``hikari_tpu_torch/_build/`` and bound through ctypes
(``utils/nvcc.py``).
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path

import torch
from torch.profiler import record_function

from hikari_tpu_torch.config import F32_EPSILON, F32_MAX
from hikari_tpu_torch.trace.closest_hit import PACK_WIDTH, SUBLANES, pack_triangles
from hikari_tpu_torch.trace.tiled import (
    TILE_R,
    cluster_bounds,
    safe_inv_dir,
    tile_cluster_entries,
)
from hikari_tpu_torch.utils.nvcc import build_library, check_kernel_arg
from hikari_tpu_torch.utils.profiling import host_read

# Kernel launches made by ``tile_walk`` (one per call on CUDA tensors).
launches = 0

# A key above every prim's: no best yet (the kernel's -1).
NO_KEY = 1 << 62
# The sublane's rank in K1's halving: the 3-bit reversal of prim mod 8.
SUBLANE_RANK = (0, 4, 2, 6, 1, 5, 3, 7)
# Keys hold the rank above the prim: prims stay below 2^28.
KEY_PRIM_BITS = 28
# The margin of ``tile_clusters``' boxes: MARGIN_K units of float32
# rounding (UNIT) of the lengths a pair test involves, as
# ``hikari_bench.reference.trace.accel`` grows its own.
MARGIN_K = 128.0
UNIT = 2.0**-24

# Ray/triangle pairs per chunk of the twin: bounds its
# (tiles, TILE_R, cluster) temporaries (2^24 f32 = 64 MB each).
TILE_CHUNK_PAIRS = 1 << 24

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tile_walk.cu"

_lib = None
# ptxas report of the last build (registers, shared memory, spills).
build_log = ""


def pack_clusters(scene, cluster: int):
    """(L*cluster, 16) packed rows of every triangle of the padded buffer
    in prim order (``pack_triangles``' 64-byte layout, each row carrying
    its prim id), padded with zero rows to whole clusters, plus the (L, 3)
    cluster AABBs and (L,) validity: the scatter search's clusters, and the
    JAX package's (the walk takes them with ``tiled.prim_ranges`` and a
    zero margin). The TPU kernel's 128-lane row padding and the AABB
    riding in row 0 are TPU layout and are not ported: the AABBs stay
    separate arrays."""
    P = scene.tri_n.shape[0]
    L = -(-P // cluster)
    packed = pack_triangles(scene, P)
    if L * cluster != P:
        packed = torch.cat([packed, packed.new_zeros((L * cluster - P, PACK_WIDTH))])
    cmin, cmax, cvalid = cluster_bounds(scene, cluster)
    return packed, cmin.contiguous(), cmax.contiguous(), cvalid


def tile_clusters(scene, cluster: int):
    """The tile walk's clusters of ``scene``: (packed (L*cluster, 16),
    cmin, cmax (L, 3), cvalid (L,), prange (L, 2) i32, cond), the rows in
    the order ``scene.tile_rows``.

    A box may drop no pair that the pair test would accept. The float32
    rounding of the test's t, u and v moves an accepted point off its
    triangle by a few units of rounding times the lengths involved (the
    ray origin's, the vertices', the triangle's edges) scaled by how skewed
    the triangle's dual basis is (its ``cond``), as
    ``hikari_bench.reference.trace.accel`` bounds it. Each box holds its
    valid triangles, each grown by ``MARGIN_K`` such units of the scene's
    own lengths (twice the farthest vertex's distance from the origin, and
    the edges); each ray grows every box by its own share, ``ray_margin``,
    from ``cond`` (the largest of the valid triangles') and its origin. So
    a cluster entered after a ray's best t holds no pair that could win,
    whatever the row order. ``prange`` holds the least prim of each
    cluster's real rows and the greatest plus one ([0, num_tris) for a
    cluster with none), for the prim-range tests."""
    P = scene.tri_n.shape[0]
    L = -(-P // cluster)
    ids = scene.tile_rows.long()
    packed = pack_triangles(scene, P)[ids]
    tri = scene.tri_world.detach()[ids]
    valid = scene.tri_valid[ids].to(torch.bool)
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    span = e1.norm(dim=1) + e2.norm(dim=1)
    cond = (scene.tri_eu[ids].norm(dim=1) + scene.tri_ev[ids].norm(dim=1)) * span + 1.0
    far = 2.0 * torch.where(valid[:, None], tri.norm(dim=2), 0.0).amax()
    m = MARGIN_K * UNIT * (far * cond + span)
    m = torch.where(torch.isfinite(m), m, float("inf"))[:, None]
    lo, hi = tri.amin(dim=1) - m, tri.amax(dim=1) + m
    cond = torch.where(valid, cond, 0.0).amax()
    real = ids < scene.num_tris
    pad = L * cluster - P
    if pad:
        packed = torch.cat([packed, packed.new_zeros((pad, PACK_WIDTH))])
        lo, hi = (torch.cat([x, x.new_zeros((pad, 3))]) for x in (lo, hi))
        valid, real = (torch.cat([x, x.new_zeros((pad,))]) for x in (valid, real))
        ids = torch.cat([ids, ids.new_zeros((pad,))])
    vmask = valid.reshape(L, cluster, 1)
    cmin = torch.where(vmask, lo.reshape(L, cluster, 3), F32_MAX).amin(dim=1)
    cmax = torch.where(vmask, hi.reshape(L, cluster, 3), -F32_MAX).amax(dim=1)
    real = real.reshape(L, cluster)
    ids = ids.reshape(L, cluster)
    any_real = real.any(dim=1)
    c_lo = torch.where(real, ids, P).amin(dim=1)
    c_hi = torch.where(real, ids, -1).amax(dim=1) + 1
    prange = torch.stack([torch.where(any_real, c_lo, 0),
                          torch.where(any_real, c_hi, scene.num_tris)], dim=1)
    return (packed.contiguous(), cmin.contiguous(), cmax.contiguous(), vmask[..., 0].any(dim=1),
            prange.to(torch.int32).contiguous(), cond)


def ray_margin(o, cond):
    """(R,) f32: how far each ray grows every box of ``tile_clusters``, its
    share of the margin: ``MARGIN_K`` units of rounding of twice its
    origin's distance from the origin, times ``cond``. 0 for a ray whose
    origin is not finite (it hits nothing)."""
    m = MARGIN_K * UNIT * 2.0 * o.norm(dim=1) * cond
    return torch.where(torch.isfinite(m), m, 0.0).to(torch.float32).contiguous()


def tile_walk_reference(packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, order, entry,
                        ray_maxent, cluster: int, use_skip: bool, prange, margin):
    """Plain PyTorch twin of the kernel, with its exact contract and
    operation order. R = T * TILE_R rays: o, d (R,3) f32; maxd, early,
    ray_maxent, margin (R,) f32; excl, lo, hi (R,) i32; order (T,L) i32
    and entry (T,L) f32, each tile's clusters in ascending entry; packed
    (L*cluster, 16), cmin/cmax (L,3) and prange (L,2) i32 from
    ``tile_clusters`` (or ``pack_clusters`` with ``tiled.prim_ranges``).
    ``prange`` must hold the prim of each valid row of its cluster: the
    kernel then skips the range compares of a warp whose rays all take
    it, and the twin, which tests each row's prim, gives the same answer.
    Returns (t, prim i32, u, v) each (R,) and the clusters tested per tile
    (T,) i32.

    It walks LOCKSTEP over tiles: at step j every tile still active tests
    its j-th cluster, then retires or not; a retired tile keeps its values.
    The retirement test before step j is the kernel's test after step
    j-1, so each tile gets exactly its own walk. Each ray keeps eight
    bests (row k of a cluster to best k mod 8, each the least key (t,
    rank, prim) of its pairs), of which the end takes the least key. With
    ``use_skip`` a tile tests its cluster only if some ray enters the
    cluster's AABB, grown by the ray's ``margin`` (``ray_margin``; zeros
    for the JAX package's unmargined boxes), before the least of its
    bests."""
    R = o.shape[0]
    T, L = order.shape
    dev = o.device
    if cluster % SUBLANES:
        raise ValueError(f"tile_walk: cluster {cluster} is not a multiple of {SUBLANES}")
    init = torch.clamp(maxd, max=F32_MAX).reshape(T, TILE_R, 1)
    best_t = init.expand(T, TILE_R, SUBLANES).clone()
    best_k = torch.full((T, TILE_R, SUBLANES), NO_KEY, dtype=torch.int64, device=dev)
    best_u = torch.zeros((T, TILE_R, SUBLANES), dtype=torch.float32, device=dev)
    best_v = torch.zeros((T, TILE_R, SUBLANES), dtype=torch.float32, device=dev)
    tested = torch.zeros((T,), dtype=torch.int32, device=dev)
    if T > 0 and L > 0:
        _walk(packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, order, entry, ray_maxent,
              cluster, use_skip, margin, best_t, best_k, best_u, best_v, tested)
    # The least key of the eight, in the kernel's order: slot s replaces
    # the best so far on a nearer t, or an equal t and a less key.
    t, k, u, v = best_t[..., 0], best_k[..., 0], best_u[..., 0], best_v[..., 0]
    for s_ in range(1, SUBLANES):
        ts, ks = best_t[..., s_], best_k[..., s_]
        take = (ts < t) | ((ts == t) & (ks < k))
        t, k = torch.where(take, ts, t), torch.where(take, ks, k)
        u, v = torch.where(take, best_u[..., s_], u), torch.where(take, best_v[..., s_], v)
    p = torch.where(k < NO_KEY, k & ((1 << KEY_PRIM_BITS) - 1), -1).to(torch.int32)
    return t.reshape(R), p.reshape(R), u.reshape(R), v.reshape(R), tested


def _walk(packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, order, entry, ray_maxent,
          cluster, use_skip, margin, best_t, best_k, best_u, best_v, tested):
    """The lockstep walk of ``tile_walk_reference``; updates the (T,
    TILE_R, 8) bests and the tested counts in place."""
    T, L = order.shape
    dev = o.device
    ot, dt = o.reshape(T, TILE_R, 3), d.reshape(T, TILE_R, 3)
    # The skip test's origins for the boxes' lower and upper bounds.
    mt = margin.reshape(T, TILE_R, 1)
    olo, ohi = ot + mt, ot - mt
    inv = safe_inv_dir(d).reshape(T, TILE_R, 3)
    maxdt, earlyt = maxd.reshape(T, TILE_R), early.reshape(T, TILE_R)
    exclt, lot, hit_ = excl.reshape(T, TILE_R), lo.reshape(T, TILE_R), hi.reshape(T, TILE_R)
    maxentt = ray_maxent.reshape(T, TILE_R)
    rows = packed.reshape(L, cluster, PACK_WIDTH)
    rank = torch.tensor(SUBLANE_RANK, dtype=torch.int64, device=dev)
    chunk = max(1, TILE_CHUNK_PAIRS // (TILE_R * cluster))

    active = entry[:, 0] < F32_MAX
    for j in range(L):
        idx = host_read("tile_walk_twin", lambda: torch.nonzero(active)[:, 0])
        if idx.numel() == 0:
            break
        for s in range(0, idx.numel(), chunk):
            ti = idx[s : s + chunk]
            cid = order[ti, j].long()
            if use_skip:
                ib = inv[ti]
                a = (cmin[cid][:, None, :] - olo[ti]) * ib
                b = (cmax[cid][:, None, :] - ohi[ti]) * ib
                tlo = torch.minimum(a, b).amax(dim=-1)
                thi = torch.maximum(a, b).amin(dim=-1)
                box_entry = torch.clamp(tlo, min=0.0)
                bt_now = best_t[ti].amin(dim=-1)
                enters = (thi >= box_entry) & (box_entry < bt_now) & (box_entry < maxdt[ti])
                keep = enters.any(dim=1)
                ti, cid = ti[keep], cid[keep]
                if ti.numel() == 0:
                    continue
            _test_clusters(rows[cid], rank, cluster, ti, ot, dt, maxdt, exclt, lot, hit_,
                           best_t, best_k, best_u, best_v)
            tested[ti] += 1
        e_next = entry[idx, min(j + 1, L - 1)][:, None]
        bt, bk = best_t[idx], best_k[idx]
        done_early = ((bk < NO_KEY) & (bt < earlyt[idx][..., None])).any(dim=-1)
        ray_open = ~done_early & (bt.amin(dim=-1) > e_next) & (maxentt[idx] >= e_next)
        active[idx] = (j + 1 < L) & (e_next[:, 0] < F32_MAX) & ray_open.any(dim=1)


def _test_clusters(blk, rank, cluster, ti, ot, dt, maxdt, exclt, lot, hit_,
                   best_t, best_k, best_u, best_v):
    """Dense pair test of tiles ``ti`` (n,) against their clusters' rows
    ``blk`` (n, cluster, 16), in the kernel's operation order; updates the
    (n, TILE_R, 8) sublane bests of those tiles in place where a pair's
    key (t, rank, prim) is less."""
    nx, ny, nz, eux, euy, euz, evx, evy, evz, cn, cu, cv = (
        blk[:, None, :, k] for k in range(12)
    )
    valid = (blk[:, :, 12] > 0.5)[:, None, :]
    inst = blk[:, :, 13].contiguous().view(torch.int32)[:, None, :]
    prim_ids = blk[:, :, 14].contiguous().view(torch.int32)[:, None, :]
    ob, db = ot[ti], dt[ti]
    ox, oy, oz = (ob[:, :, k : k + 1] for k in range(3))
    dx, dy, dz = (db[:, :, k : k + 1] for k in range(3))
    dn = dx * nx + dy * ny + dz * nz
    on = ox * nx + oy * ny + oz * nz
    safe_dn = torch.where(dn.abs() < F32_EPSILON, 1.0, dn)
    t = (cn - on) / safe_dn
    deu = dx * eux + dy * euy + dz * euz
    oeu = ox * eux + oy * euy + oz * euz
    dev_ = dx * evx + dy * evy + dz * evz
    oev = ox * evx + oy * evy + oz * evz
    u = (oeu - cu) + t * deu
    v = (oev - cv) + t * dev_
    ok = (
        valid
        & (dn.abs() >= F32_EPSILON)
        & (t > F32_EPSILON)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t < maxdt[ti][..., None])
        & (inst != exclt[ti][..., None])
        & (prim_ids >= lot[ti][..., None])
        & (prim_ids < hit_[ti][..., None])
    )
    # Row 8*i + s goes to sublane s: (n, TILE_R, i, s). Each sublane takes
    # its least t, then among those its least key.
    n = ti.numel()
    shape8 = (n, TILE_R, cluster // SUBLANES, SUBLANES)
    key = (rank[(prim_ids & 7).long()] << KEY_PRIM_BITS) | prim_ids.long()
    tm = torch.where(ok, t, F32_MAX).reshape(shape8)
    km = torch.where(ok, key, NO_KEY).reshape(shape8)
    bt = tm.amin(dim=2, keepdim=True)
    km = torch.where(tm == bt, km, NO_KEY)
    k = torch.argmin(km, dim=2, keepdim=True)
    bt, bk = bt[:, :, 0], km.gather(2, k)[:, :, 0]
    old_t, old_k = best_t[ti], best_k[ti]
    better = (bk < NO_KEY) & ((bt < old_t) | ((bt == old_t) & (old_k < NO_KEY) & (bk < old_k)))
    best_t[ti] = torch.where(better, bt, old_t)
    best_k[ti] = torch.where(better, bk, old_k)
    best_u[ti] = torch.where(better, u.reshape(shape8).gather(2, k)[:, :, 0], best_u[ti])
    best_v[ti] = torch.where(better, v.reshape(shape8).gather(2, k)[:, :, 0], best_v[ti])


def build() -> float:
    """Compile (if needed) and load the kernel library; returns the
    seconds spent. Raises if nvcc is missing or the build fails."""
    global _lib, build_log
    if _lib is not None:
        return 0.0
    start = time.perf_counter()
    lib, build_log = build_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hikari_tile_walk.argtypes = [ptr] * 15 + [i32] * 4 + [ptr] * 6
    lib.hikari_tile_walk.restype = i32
    lib.hikari_tile_walk_error_string.argtypes = [i32]
    lib.hikari_tile_walk_error_string.restype = ctypes.c_char_p
    _lib = lib
    return time.perf_counter() - start


def tile_walk(packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, order, entry, ray_maxent,
              cluster: int, use_skip: bool, prange, margin):
    """The walk of every tile: (t, prim i32, u, v) each (R,) and the
    clusters tested per tile (T,) i32. Same arguments as
    ``tile_walk_reference``.
    CPU tensors run the twin; CUDA tensors launch the kernel (one launch
    per call) or raise. A cluster whose two row buffers and the walk's
    state exceed a block's shared memory raises the launch's CUDA error."""
    global launches
    if o.device.type == "cpu":
        return tile_walk_reference(packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, order,
                                   entry, ray_maxent, cluster, use_skip, prange, margin)
    if o.device.type != "cuda":
        raise NotImplementedError(f"tile_walk: no kernel for device {o.device}")
    R = o.shape[0]
    T, L = order.shape
    dev = o.device
    if R != T * TILE_R:
        raise ValueError(f"tile_walk: {R} rays for {T} tiles of {TILE_R}")
    for name, x, dtype, shape in (
        ("o", o, torch.float32, (R, 3)),
        ("d", d, torch.float32, (R, 3)),
        ("maxd", maxd, torch.float32, (R,)),
        ("early", early, torch.float32, (R,)),
        ("excl", excl, torch.int32, (R,)),
        ("lo", lo, torch.int32, (R,)),
        ("hi", hi, torch.int32, (R,)),
        ("ray_maxent", ray_maxent, torch.float32, (R,)),
        ("order", order, torch.int32, (T, L)),
        ("entry", entry, torch.float32, (T, L)),
        ("packed", packed, torch.float32, (L * cluster, PACK_WIDTH)),
        ("cmin", cmin, torch.float32, (L, 3)),
        ("cmax", cmax, torch.float32, (L, 3)),
        ("prange", prange, torch.int32, (L, 2)),
        ("margin", margin, torch.float32, (R,)),
    ):
        check_kernel_arg("tile_walk", name, x, dtype, shape, dev)
    if packed.data_ptr() % 16:
        raise ValueError("tile_walk: packed must be 16-byte aligned")
    if cluster % SUBLANES:
        raise ValueError(f"tile_walk: cluster {cluster} is not a multiple of {SUBLANES}")
    if L * cluster >= 2**31 // PACK_WIDTH or T >= 2**31 // TILE_R:
        raise ValueError("tile_walk: too many rays or triangles for int32 indexing")
    if L * cluster > 1 << KEY_PRIM_BITS:
        raise ValueError(f"tile_walk: keys hold prims below 2^{KEY_PRIM_BITS}")
    build()
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    prim = torch.empty((R,), dtype=torch.int32, device=dev)
    u = torch.empty((R,), dtype=torch.float32, device=dev)
    v = torch.empty((R,), dtype=torch.float32, device=dev)
    tested = torch.empty((T,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib.hikari_tile_walk(
            o.data_ptr(), d.data_ptr(), maxd.data_ptr(), early.data_ptr(), excl.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), ray_maxent.data_ptr(),
            margin.data_ptr(), order.data_ptr(),
            entry.data_ptr(), packed.data_ptr(), cmin.data_ptr(), cmax.data_ptr(),
            prange.data_ptr(), T, L, cluster, int(use_skip), t.data_ptr(), prim.data_ptr(),
            u.data_ptr(), v.data_ptr(), tested.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(
            f"tile_walk kernel launch failed (cluster {cluster}): "
            f"{_lib.hikari_tile_walk_error_string(err).decode()}"
        )
    if T:
        launches += 1
    return t, prim, u, v, tested


def tile_entries(cmin, cmax, cvalid, o, d, maxd, lo, hi, prange, num_prims: int, margin):
    """Phase 1 and the sort: per tile its clusters' ids (T, L) i32 in
    ascending entry (stable: ties keep cluster order, as ``jnp.argsort``),
    those entries (T, L), and the per-ray retirement bound (R,). The prim
    range prunes a cluster by ``prange`` (``num_prims``: the scene's
    prims, as ``tiled.tile_cluster_entries`` takes them); each ray grows
    every box by its ``margin`` (R,)."""
    entries, ray_maxent = tile_cluster_entries(
        cmin, cmax, cvalid, o, safe_inv_dir(d), maxd, lo, hi, prange, num_prims, margin
    )
    entry, order = torch.sort(entries, dim=1, stable=True)
    return order.to(torch.int32), entry, ray_maxent


def trace_tile_walk(packed, cmin, cmax, cvalid, o, d, maxd, early, excl, lo, hi,
                    cluster: int, use_skip: bool, prange, num_prims: int, margin):
    """Closest hit over R flat rays, R a multiple of TILE_R (the caller
    pads and sorts, ``trace/api.py``): phase 1 under the profiler range
    ``tile_entries``, the walk under ``tile_walk``. Returns (t, prim, u,
    v, tested) as ``tile_walk``. ``prange``, ``num_prims`` and ``margin``
    as ``tile_entries`` and ``tile_walk`` take them."""
    with record_function("tile_entries"):
        order, entry, ray_maxent = tile_entries(cmin, cmax, cvalid, o, d, maxd, lo, hi, prange,
                                                num_prims, margin)
    with record_function("tile_walk"):
        return tile_walk(packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, order, entry,
                         ray_maxent, cluster, use_skip, prange, margin)
