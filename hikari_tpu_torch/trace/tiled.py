"""The XLA tile-binned cluster tracer — the port of ``hikari_tpu.trace.tiled``
(``_cluster_bounds``, ``_packed_tris``, ``tile_cluster_entries``,
``safe_inv_dir``, ``trace_tiled``), in plain torch on either device.

Triangles are grouped into clusters of ``cluster`` consecutive primitives
(consecutive in the compiled buffer means BVH depth-first leaf order, so
clusters are spatially tight). Rays come in tiles of ``TILE_R``.

Phase 1 (``tile_cluster_entries``): each ray slab-tests every cluster
AABB, and each tile keeps, per cluster, the nearest entry over its rays.
CUDA tensors launch the hand-written kernel ``csrc/tile_entries.cu``;
its plain twin ``tile_cluster_entries_reference`` runs only for CPU
tensors. On a CUDA tensor ``tile_cluster_entries`` launches or raises; it
never falls back. The tile-walk kernel (``trace/tile_walk.py``) and phase
2 below then visit a tile's clusters near to far.

Phase 2 (``trace_tiled``, ``trace_rays(method="tiled")``): clusters of
``CLUSTER`` = 512. Step j tests every still-active tile's rays against
its j-th nearest cluster, densely; a tile stays active while its next
cluster is entered and one of its rays could still take a hit there.
Every ray of an active tile is updated, finished or not, as in the JAX
package: only the tile's activity reads the per-ray tests. Among equal t
the first column of a cluster wins (the lowest prim), and across
clusters the one visited first (the update takes a strictly nearer t).
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path

import torch

from hikari_tpu_torch.config import F32_EPSILON, F32_MAX
from hikari_tpu_torch.utils import dot3_ordered
from hikari_tpu_torch.utils.nvcc import build_library, check_kernel_arg
from hikari_tpu_torch.utils.profiling import host_read

CLUSTER = 512  # triangles per cluster of phase 2
TILE_R = 512  # rays per tile
# Elements of one (rays, clusters, 3) slab temporary per chunk of phase 1's
# twin (2^26 f32 = 256 MB).
ENTRY_CHUNK_ELEMS = 1 << 26

# Kernel launches made by ``tile_cluster_entries`` (two per call on CUDA
# tensors: the staged table and the test kernel), as the C call reports
# them.
launches = 0

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tile_entries.cu"

_lib = None
# ptxas report of the last build (registers, shared memory, spills).
build_log = ""


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


def packed_tris(scene):
    """(Pp, 14) plane/dual-basis rows n eu ev cn cu cv valid inst (JAX
    ``_packed_tris``), padded with zero rows to whole clusters of
    ``CLUSTER``: a padding row is invalid."""
    P = scene.tri_n.shape[0]
    packed = torch.cat(
        [
            scene.tri_n.detach(),
            scene.tri_eu.detach(),
            scene.tri_ev.detach(),
            scene.tri_cn.detach()[:, None],
            scene.tri_cu.detach()[:, None],
            scene.tri_cv.detach()[:, None],
            scene.tri_valid.to(torch.float32)[:, None],
            scene.tri_inst.to(torch.float32)[:, None],
        ],
        dim=1,
    )
    Pp = -(-P // CLUSTER) * CLUSTER
    if Pp != P:
        packed = torch.cat([packed, packed.new_zeros((Pp - P, 14))])
    return packed


def safe_inv_dir(d):
    """1/d with a signed epsilon floor (slab-test convention)."""
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    return 1.0 / torch.where(d.abs() < 1e-20, tiny, d)


def _check_entries_args(R: int, L: int, have_range: bool, cluster: int) -> None:
    if R % TILE_R:
        raise ValueError(f"tile_cluster_entries: {R} rays is not a multiple of {TILE_R}")
    if have_range:
        if cluster <= 0:
            raise ValueError("tile_cluster_entries: a prim range needs the cluster size")
        if L * cluster >= 2**24:
            raise ValueError("f32 prim range compares are exact only below 2^24 prims")


def tile_cluster_entries_reference(cmin, cmax, cvalid, o, inv_d, maxd, lo=None, hi=None,
                                   cluster: int = 0):
    """Plain PyTorch twin of the phase-1 kernel, with its exact contract.
    Per-tile nearest cluster entries. o/inv_d: (R, 3), maxd (R,), R a
    multiple of TILE_R; ``lo``/``hi`` (R,) int32, optional: the per-ray
    primitive range [lo, hi), which prunes every cluster whose prim range
    [c*cluster, (c+1)*cluster) misses it (``cluster`` must then be given).

    Returns (entries (T, L), ray_maxent (R,)): per tile and cluster the
    minimum entry distance over the tile's rays (F32_MAX where none
    enters), and per ray the largest finite entry over all clusters (-1
    where the ray enters none) — the walk's per-ray retirement bound.

    The range test compares in f32 as the JAX package does; that is exact
    while the padded primitive count stays below 2^24. A zero entry is
    +0.0: a ray whose origin lies on a cluster's max face with a negative
    direction has tlo = -0.0, which torch's clamp keeps or not by operand
    order and device, so the entry adds +0.0 (the kernel does the same)."""
    R = o.shape[0]
    L = cmin.shape[0]
    have_range = lo is not None
    _check_entries_args(R, L, have_range, cluster)
    if have_range:
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
        entry = torch.clamp(tlo, min=0.0) + 0.0
        hit = (thi >= entry) & (entry < maxd[s:e, None]) & cvalid[None]
        if have_range:
            lb = lo[s:e].to(torch.float32)[:, None]
            hb = hi[s:e].to(torch.float32)[:, None]
            hit = hit & (c_lo[None] < hb) & (c_hi[None] > lb)
        ray_maxent[s:e] = torch.where(hit, entry, -1.0).amax(dim=1)
        entries[t0:t1] = torch.where(hit, entry, F32_MAX).reshape(t1 - t0, TILE_R, L).amin(dim=1)
    return entries, ray_maxent


def build() -> float:
    """Compile (if needed) and load the phase-1 kernel library; returns the
    seconds spent. Raises if nvcc is missing or the build fails."""
    global _lib, build_log
    if _lib is not None:
        return 0.0
    start = time.perf_counter()
    lib, build_log = build_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hikari_tile_entries.argtypes = [ptr] * 8 + [i32] * 3 + [ptr] * 5
    lib.hikari_tile_entries.restype = i32
    lib.hikari_tile_entries_error_string.argtypes = [i32]
    lib.hikari_tile_entries_error_string.restype = ctypes.c_char_p
    _lib = lib
    return time.perf_counter() - start


def tile_cluster_entries(cmin, cmax, cvalid, o, inv_d, maxd, lo=None, hi=None,
                         cluster: int = 0):
    """Phase 1: (entries (T, L), ray_maxent (R,)), as
    ``tile_cluster_entries_reference`` with the same arguments. CPU
    tensors run the twin; CUDA tensors launch the kernel
    ``csrc/tile_entries.cu`` (two launches a call: the staged bound table,
    then the tests) or raise."""
    global launches
    if o.device.type == "cpu":
        return tile_cluster_entries_reference(cmin, cmax, cvalid, o, inv_d, maxd, lo, hi, cluster)
    if o.device.type != "cuda":
        raise NotImplementedError(f"tile_cluster_entries: no kernel for device {o.device}")
    R, L = o.shape[0], cmin.shape[0]
    have_range = lo is not None
    _check_entries_args(R, L, have_range, cluster)
    if (hi is None) != (lo is None):
        raise ValueError("tile_cluster_entries: give both lo and hi, or neither")
    if L == 0:
        raise ValueError("tile_cluster_entries: no clusters")
    if 3 * R >= 2**31 or L * cluster >= 2**31:
        raise ValueError("tile_cluster_entries: too many rays or prims for int32 indexing")
    dev = o.device
    args = [
        ("o", o, torch.float32, (R, 3)),
        ("inv_d", inv_d, torch.float32, (R, 3)),
        ("maxd", maxd, torch.float32, (R,)),
        ("cmin", cmin, torch.float32, (L, 3)),
        ("cmax", cmax, torch.float32, (L, 3)),
        ("cvalid", cvalid, torch.bool, (L,)),
    ]
    if have_range:
        args += [("lo", lo, torch.int32, (R,)), ("hi", hi, torch.int32, (R,))]
    for name, x, dtype, shape in args:
        check_kernel_arg("tile_cluster_entries", name, x, dtype, shape, dev)
    build()
    T = R // TILE_R
    entries = torch.empty((T, L), dtype=torch.float32, device=dev)
    ray_maxent = torch.empty((R,), dtype=torch.float32, device=dev)
    if T == 0:
        return entries, ray_maxent
    table = torch.empty((L, 8), dtype=torch.float32, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib.hikari_tile_entries(
            o.data_ptr(), inv_d.data_ptr(), maxd.data_ptr(),
            lo.data_ptr() if have_range else None, hi.data_ptr() if have_range else None,
            cmin.data_ptr(), cmax.data_ptr(), cvalid.data_ptr(), T, L, cluster,
            table.data_ptr(), entries.data_ptr(), ray_maxent.data_ptr(), stream,
            ctypes.byref(launched),
        )
    launches += launched.value
    if err:
        raise RuntimeError(f"tile_cluster_entries kernel launch failed: "
                           f"{_lib.hikari_tile_entries_error_string(err).decode()}")
    return entries, ray_maxent


# Elements of one (rays, CLUSTER) temporary of phase 2 per chunk of tiles
# (2^26 f32 = 256 MB; the ordered dot products hold three times that).
TEST_CHUNK_ELEMS = 1 << 26


def _pair_dot(x, y):
    """(A, R, 3) rays against (A, C, 3) rows -> (A, R, C): the three
    products summed left to right (``utils.dot3_ordered``), so both devices
    give the same bits."""
    return dot3_ordered(x[:, :, None, :], y[:, None, :, :])


def _test_tiles(rows, prim0, o, d, bt, maxd, excl, lo, hi):
    """One dense step (JAX ``test_cluster``) for A tiles: each tile's R rays
    (``o``/``d`` (A, R, 3), the rest (A, R)) against its cluster's C rows
    (``rows`` (A, C, 14), first prim id ``prim0`` (A,) f32). Returns the
    step's best (t, prim, u, v) per ray, each (A, R): the first column
    among equal t, t = F32_MAX where no row passes."""
    n, eu, ev = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    cn, cu, cv = rows[:, None, :, 9], rows[:, None, :, 10], rows[:, None, :, 11]
    vmask, inst = rows[:, None, :, 12], rows[:, None, :, 13]
    prim_id = (prim0[:, None] + torch.arange(rows.shape[1], dtype=torch.float32,
                                             device=o.device))[:, None, :]
    dn = _pair_dot(d, n)
    on = _pair_dot(o, n)
    deu = _pair_dot(d, eu)
    oeu = _pair_dot(o, eu)
    dev_ = _pair_dot(d, ev)
    oev = _pair_dot(o, ev)
    flat = dn.abs() < F32_EPSILON
    t = (cn - on) / torch.where(flat, 1.0, dn)
    u = (oeu - cu) + t * deu
    v = (oev - cv) + t * dev_
    ok = (
        (vmask > 0.5)
        & ~flat
        & (t > F32_EPSILON)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t < bt[..., None])
        & (t < maxd[..., None])
        & (inst != excl[..., None])
        & (prim_id >= lo[..., None])
        & (prim_id < hi[..., None])
    )
    tm = torch.where(ok, t, F32_MAX)
    j = torch.argmin(tm, dim=2, keepdim=True)  # the first minimum
    prim_id = prim_id.expand_as(tm)
    return tuple(x.gather(2, j)[..., 0] for x in (tm, prim_id, u, v))


def trace_tiled(scene, o, d, maxd, early, excl, lo, hi):
    """Closest hit of (R,) rays, R a multiple of ``TILE_R`` (the caller,
    ``trace/api.py``, sorts and pads): the JAX ``trace_tiled``. Returns
    (t, prim i32, u, v, steps, tested): a miss has t = min(maxd, F32_MAX)
    and prim -1; ``steps`` is the number of walk steps and ``tested`` (T,)
    the clusters each tile tested.

    The JAX package updates every tile at each step, masked by its
    activity; here each step gathers the active tiles, tests them and
    writes their rays back, which gives the same values. One host sync a
    step reads whether any tile is still active."""
    R = o.shape[0]
    if R % TILE_R:
        raise ValueError(f"trace_tiled: {R} rays is not a multiple of {TILE_R}")
    T = R // TILE_R
    dev = o.device
    cmin, cmax, cvalid = cluster_bounds(scene, CLUSTER)
    L = cmin.shape[0]
    # The prim id rides in f32, as in the JAX package.
    if L * CLUSTER >= 2**24:
        raise ValueError("trace_tiled: f32 prim ids are exact only below 2^24 prims")
    rows_of = packed_tris(scene).reshape(L, CLUSTER, 14)

    # ---- phase 1: per-tile cluster entry distances ----
    entry_min, ray_maxent = tile_cluster_entries(
        cmin, cmax, cvalid, o, safe_inv_dir(d), maxd, lo, hi, cluster=CLUSTER
    )
    entry_sorted, order = torch.sort(entry_min, dim=1, stable=True)  # (T, L) near to far

    def tiled(x):
        return x.reshape((T, TILE_R) + x.shape[1:])

    ray_maxent, early_t, maxd_t = tiled(ray_maxent), tiled(early), tiled(maxd)
    o_t, d_t = tiled(o), tiled(d)
    excl_t, lo_t, hi_t = (tiled(x.to(torch.float32)) for x in (excl, lo, hi))

    # ---- phase 2: the near-to-far cluster walk ----
    bt = tiled(torch.clamp(maxd, max=F32_MAX)).clone()
    bp = torch.full((T, TILE_R), -1.0, device=dev)
    bu = torch.zeros((T, TILE_R), device=dev)
    bv = torch.zeros((T, TILE_R), device=dev)
    tested = torch.zeros((T,), dtype=torch.int32, device=dev)
    chunk = max(1, TEST_CHUNK_ELEMS // (TILE_R * CLUSTER))
    steps = 0
    for j in range(L):
        # JAX _tile_active: the next cluster exists, is entered, and a ray
        # that has not stopped early could still take a hit in it.
        e_j = entry_sorted[:, j]
        done_early = (bp >= 0) & (bt < early_t)
        ray_open = ~done_early & (bt > e_j[:, None]) & (ray_maxent >= e_j[:, None])
        open_tiles = (e_j < F32_MAX) & ray_open.any(dim=1)
        ids = host_read("tiled_step", lambda: open_tiles.nonzero()[:, 0])
        if ids.numel() == 0:
            break
        steps += 1
        tested[ids] += 1
        cid = order[ids, j]
        for c0 in range(0, ids.numel(), chunk):
            tid, cc = ids[c0:c0 + chunk], cid[c0:c0 + chunk]
            bt_c, bp_c, bu_c, bv_c = bt[tid], bp[tid], bu[tid], bv[tid]
            tj, pj, uj, vj = _test_tiles(
                rows_of[cc], cc.to(torch.float32) * CLUSTER, o_t[tid], d_t[tid], bt_c,
                maxd_t[tid], excl_t[tid], lo_t[tid], hi_t[tid],
            )
            better = tj < bt_c
            bt[tid] = torch.where(better, tj, bt_c)
            bp[tid] = torch.where(better, pj, bp_c)
            bu[tid] = torch.where(better, uj, bu_c)
            bv[tid] = torch.where(better, vj, bv_c)
    return (bt.reshape(R), bp.reshape(R).to(torch.int32), bu.reshape(R), bv.reshape(R),
            steps, tested)
