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

Tie rule (kernel and twin), the JAX kernel's: eight running bests per
ray over the whole walk, row ``j`` of a cluster (prim ``j mod 8``) to best
``j mod 8``, each replaced only on a strict ``<``, halved 8 -> 4 -> 2 -> 1
at the end as ``pallas_tiled.py:309-326`` does (``closest_hit.
reduce_sublanes``). The walk order, and with it the any-hit
result of a ray that stops at ``early``, follows the tiles' composition,
the cluster size and the skip: ``trace/api.py`` sets them as the JAX
package does.

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
from hikari_tpu_torch.trace.closest_hit import PACK_WIDTH, SUBLANES, pack_triangles, reduce_sublanes
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

# Ray/triangle pairs per chunk of the twin: bounds its
# (tiles, TILE_R, cluster) temporaries (2^24 f32 = 64 MB each).
TILE_CHUNK_PAIRS = 1 << 24

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tile_walk.cu"

_lib = None
# ptxas report of the last build (registers, shared memory, spills).
build_log = ""


def pack_clusters(scene, cluster: int):
    """(L*cluster, 16) packed rows of every triangle of the padded buffer
    (``pack_triangles``' 64-byte layout), padded with zero rows to whole
    clusters, plus the (L, 3) cluster AABBs and (L,) validity. The TPU
    kernel's 128-lane row padding and the AABB riding in row 0 are TPU
    layout and are not ported: the AABBs stay separate arrays."""
    P = scene.tri_n.shape[0]
    L = -(-P // cluster)
    packed = pack_triangles(scene, P)
    if L * cluster != P:
        packed = torch.cat([packed, packed.new_zeros((L * cluster - P, PACK_WIDTH))])
    cmin, cmax, cvalid = cluster_bounds(scene, cluster)
    return packed, cmin.contiguous(), cmax.contiguous(), cvalid


def tile_walk_reference(packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, order, entry,
                        ray_maxent, cluster: int, use_skip: bool):
    """Plain PyTorch twin of the kernel, with its exact contract and
    operation order. R = T * TILE_R rays: o, d (R,3) f32; maxd, early,
    ray_maxent (R,) f32; excl, lo, hi (R,) i32; order (T,L) i32 and entry
    (T,L) f32, each tile's clusters in ascending entry; packed
    (L*cluster, 16) and cmin/cmax (L,3) from ``pack_clusters``. Returns
    (t, prim i32, u, v) each (R,) and the clusters tested per tile (T,) i32.

    It walks LOCKSTEP over tiles: at step j every tile still active tests
    its j-th cluster, then retires or not; a retired tile keeps its values.
    The retirement test before step j is the kernel's test after step
    j-1, so each tile gets exactly its own walk. Each ray keeps eight
    bests (row k of a cluster to best k mod 8, strict ``<``; the first
    minimum of a sublane is its lowest prim), halved at the end. With
    ``use_skip`` a tile tests its cluster only if some ray enters the
    cluster's AABB before the least of its bests."""
    R = o.shape[0]
    T, L = order.shape
    dev = o.device
    if cluster % SUBLANES:
        raise ValueError(f"tile_walk: cluster {cluster} is not a multiple of {SUBLANES}")
    init = torch.clamp(maxd, max=F32_MAX).reshape(T, TILE_R, 1)
    best_t = init.expand(T, TILE_R, SUBLANES).clone()
    best_p = torch.full((T, TILE_R, SUBLANES), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((T, TILE_R, SUBLANES), dtype=torch.float32, device=dev)
    best_v = torch.zeros((T, TILE_R, SUBLANES), dtype=torch.float32, device=dev)
    tested = torch.zeros((T,), dtype=torch.int32, device=dev)
    if T > 0 and L > 0:
        _walk(packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, order, entry, ray_maxent,
              cluster, use_skip, best_t, best_p, best_u, best_v, tested)
    t, p, u, v = reduce_sublanes(best_t, best_p, best_u, best_v)
    return t.reshape(R), p.reshape(R), u.reshape(R), v.reshape(R), tested


def _walk(packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, order, entry, ray_maxent,
          cluster, use_skip, best_t, best_p, best_u, best_v, tested):
    """The lockstep walk of ``tile_walk_reference``; updates the (T,
    TILE_R, 8) bests and the tested counts in place."""
    T, L = order.shape
    dev = o.device
    ot, dt = o.reshape(T, TILE_R, 3), d.reshape(T, TILE_R, 3)
    inv = safe_inv_dir(d).reshape(T, TILE_R, 3)
    maxdt, earlyt = maxd.reshape(T, TILE_R), early.reshape(T, TILE_R)
    exclt, lot, hit_ = excl.reshape(T, TILE_R), lo.reshape(T, TILE_R), hi.reshape(T, TILE_R)
    maxentt = ray_maxent.reshape(T, TILE_R)
    rows = packed.reshape(L, cluster, PACK_WIDTH)
    k_ids = torch.arange(cluster, dtype=torch.int32, device=dev)
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
                ob, ib = ot[ti], inv[ti]
                a = (cmin[cid][:, None, :] - ob) * ib
                b = (cmax[cid][:, None, :] - ob) * ib
                tlo = torch.minimum(a, b).amax(dim=-1)
                thi = torch.maximum(a, b).amin(dim=-1)
                box_entry = torch.clamp(tlo, min=0.0)
                bt_now = best_t[ti].amin(dim=-1)
                enters = (thi >= box_entry) & (box_entry < bt_now) & (box_entry < maxdt[ti])
                keep = enters.any(dim=1)
                ti, cid = ti[keep], cid[keep]
                if ti.numel() == 0:
                    continue
            _test_clusters(rows[cid], cid, k_ids, cluster, ti, ot, dt, maxdt, exclt, lot, hit_,
                           best_t, best_p, best_u, best_v)
            tested[ti] += 1
        e_next = entry[idx, min(j + 1, L - 1)][:, None]
        bt, bp = best_t[idx], best_p[idx]
        done_early = ((bp >= 0) & (bt < earlyt[idx][..., None])).any(dim=-1)
        ray_open = ~done_early & (bt.amin(dim=-1) > e_next) & (maxentt[idx] >= e_next)
        active[idx] = (j + 1 < L) & (e_next[:, 0] < F32_MAX) & ray_open.any(dim=1)


def _test_clusters(blk, cid, k_ids, cluster, ti, ot, dt, maxdt, exclt, lot, hit_,
                   best_t, best_p, best_u, best_v):
    """Dense pair test of tiles ``ti`` (n,) against their clusters' rows
    ``blk`` (n, cluster, 16), in the kernel's operation order; updates the
    (n, TILE_R, 8) sublane bests of those tiles in place where a pair
    beats them strictly."""
    nx, ny, nz, eux, euy, euz, evx, evy, evz, cn, cu, cv = (
        blk[:, None, :, k] for k in range(12)
    )
    valid = (blk[:, :, 12] > 0.5)[:, None, :]
    inst = blk[:, :, 13].contiguous().view(torch.int32)[:, None, :]
    prim_ids = (cid.to(torch.int32) * cluster)[:, None, None] + k_ids[None, None, :]
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
    # Row 8*i + s goes to sublane s: (n, TILE_R, i, s).
    n = ti.numel()
    shape8 = (n, TILE_R, cluster // SUBLANES, SUBLANES)
    tm = torch.where(ok, t, F32_MAX).reshape(shape8)
    k = torch.argmin(tm, dim=2, keepdim=True)  # first minimum: the sublane's lowest prim
    bt = tm.gather(2, k)[:, :, 0]
    better = bt < best_t[ti]
    best_t[ti] = torch.where(better, bt, best_t[ti])
    best_p[ti] = torch.where(better, prim_ids.expand_as(ok).reshape(shape8).gather(2, k)[:, :, 0],
                             best_p[ti])
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
    lib.hikari_tile_walk.argtypes = [ptr] * 13 + [i32] * 4 + [ptr] * 6
    lib.hikari_tile_walk.restype = i32
    lib.hikari_tile_walk_error_string.argtypes = [i32]
    lib.hikari_tile_walk_error_string.restype = ctypes.c_char_p
    _lib = lib
    return time.perf_counter() - start


def tile_walk(packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, order, entry, ray_maxent,
              cluster: int, use_skip: bool):
    """The walk of every tile: (t, prim i32, u, v) each (R,) and the
    clusters tested per tile (T,) i32. Same arguments as
    ``tile_walk_reference``. CPU tensors run the twin; CUDA tensors launch
    the kernel (one launch per call) or raise. A cluster whose two row
    buffers and the walk's state exceed a block's shared memory raises
    the launch's CUDA error."""
    global launches
    if o.device.type == "cpu":
        return tile_walk_reference(packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, order,
                                   entry, ray_maxent, cluster, use_skip)
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
    ):
        check_kernel_arg("tile_walk", name, x, dtype, shape, dev)
    if packed.data_ptr() % 16:
        raise ValueError("tile_walk: packed must be 16-byte aligned")
    if cluster % SUBLANES:
        raise ValueError(f"tile_walk: cluster {cluster} is not a multiple of {SUBLANES}")
    if L * cluster >= 2**31 // PACK_WIDTH or T >= 2**31 // TILE_R:
        raise ValueError("tile_walk: too many rays or triangles for int32 indexing")
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
            lo.data_ptr(), hi.data_ptr(), ray_maxent.data_ptr(), order.data_ptr(),
            entry.data_ptr(), packed.data_ptr(), cmin.data_ptr(), cmax.data_ptr(), T, L,
            cluster, int(use_skip), t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
            tested.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(
            f"tile_walk kernel launch failed (cluster {cluster}): "
            f"{_lib.hikari_tile_walk_error_string(err).decode()}"
        )
    if T:
        launches += 1
    return t, prim, u, v, tested


def tile_entries(cmin, cmax, cvalid, o, d, maxd, lo, hi, cluster: int):
    """Phase 1 and the sort: per tile its clusters' ids (T, L) i32 in
    ascending entry (stable: ties keep cluster order, as ``jnp.argsort``),
    those entries (T, L), and the per-ray retirement bound (R,)."""
    entries, ray_maxent = tile_cluster_entries(
        cmin, cmax, cvalid, o, safe_inv_dir(d), maxd, lo, hi, cluster
    )
    entry, order = torch.sort(entries, dim=1, stable=True)
    return order.to(torch.int32), entry, ray_maxent


def trace_tile_walk(packed, cmin, cmax, cvalid, o, d, maxd, early, excl, lo, hi,
                    cluster: int, use_skip: bool):
    """Closest hit over R flat rays, R a multiple of TILE_R (the caller
    pads and sorts, ``trace/api.py``): phase 1 under the profiler range
    ``tile_entries``, the walk under ``tile_walk``. Returns (t, prim, u,
    v, tested) as ``tile_walk``."""
    with record_function("tile_entries"):
        order, entry, ray_maxent = tile_entries(cmin, cmax, cvalid, o, d, maxd, lo, hi, cluster)
    with record_function("tile_walk"):
        return tile_walk(packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, order, entry,
                         ray_maxent, cluster, use_skip)
