"""Cluster-major wavefront tracing: exact (ray, cluster) work compaction
for incoherent large-scene rays — the port of ``hikari_tpu.trace.scatter``
(K3 ``_make_kernel``/``_kernel`` with ``trace_scatter``).

``trace_scatter`` runs four steps over R flat rays (no ordering needed):

1. phase A: slab-test every ray against every cluster AABB and count the
   entered (ray, cluster) pairs per cluster;
2. the block map and phase B: each cluster's run of items is padded to
   whole 128-item blocks; every entered pair gets the slot of its rank in
   its cluster's run, rays ascending (the slots of the JAX package's
   running per-cluster cursors), and its ray id is written there. Slots at
   or past the capacity ``CAP = ceil(items_per_ray * R / 128) * 128 + 128
   * L`` are dropped, as the JAX package's ``mode="drop"`` scatter drops
   them. ``scatter_plan`` runs both: for CUDA tensors the hand-written
   kernel ``csrc/scatter_plan.cu`` (a count launch that slab-tests each
   (ray, cluster) pair once and keeps per 512-ray chunk and cluster the
   entered pairs and per warp of 32 rays and cluster the ballot of the
   rays that enter, the scan over chunks and the block map in torch, a
   place launch that writes each pair at its chunk's base plus its rank
   in the ballots, as the JAX package's two scans do, no sort); its plain
   twin ``scatter_plan_reference`` (the entered pairs sorted by cluster,
   then ray) only for CPU tensors. On a CUDA tensor ``scatter_plan``
   launches or raises; it never falls back;
3. the kernel (``scatter_items``): each 128-item block tests its items
   against the 128 triangles of its one cluster — the hand-written CUDA
   kernel ``csrc/scatter_items.cu`` for CUDA tensors, its plain twin
   ``scatter_items_reference`` only for CPU tensors. On a CUDA tensor
   ``scatter_items`` launches or raises; it never falls back;
4. the segment-min (plain torch): each ray's winner among its items, by
   the t bits, then by the lowest item index.

Closest-hit semantics are exact; ``early_distance`` is not taken (the
trace API accepts and ignores it, as the JAX package does).

Tie rule of the kernel and the twin — the JAX kernel's, as K1 and K2 keep
it: triangle j of a cluster goes to sublane j mod 8, each sublane keeps its
first minimum (strict ``<``, so the lowest prim of the sublane), and the
eight bests are halved 8 -> 4 -> 2 -> 1, taking the upper half only when
it is strictly nearer. Among equal t the sublanes win in the order
0, 4, 2, 6, 1, 5, 3, 7.

On the card the kernel runs persistent blocks over contiguous ranges of
item blocks (``run_ranges``), so a cluster's rows stay in shared memory
across its run. A block whose cluster id lies outside ``[0, L)`` writes
misses and counts in ``cluster_errors()``; the wrapper does not read the
device to check (no sync per call).

The kernels are built at first use from the repo's sources with ``nvcc``
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
from hikari_tpu_torch.trace.closest_hit import PACK_WIDTH, SUBLANES, reduce_sublanes
from hikari_tpu_torch.trace.tiled import safe_inv_dir
from hikari_tpu_torch.utils.nvcc import build_library, check_kernel_arg
from hikari_tpu_torch.utils.profiling import host_read

CLUSTER = 128  # triangles per cluster
BLOCK_R = 128  # items per kernel block
# Item fields, rows of the (FIELDS, CAP) f32 array: o(3) d(3) maxd, then
# excl, lo, hi as int32 bits, then valid (0 or 1).
FIELDS = 11
# Elements of one (rays, clusters, 3) slab temporary per chunk of the
# plan's twin (2^26 f32 = 256 MB); any chunk size gives the same slots.
CHUNK_ELEMS = 1 << 26
# Rays per chunk of the plan kernel's counts (csrc/scatter_plan.cu kChunk).
PLAN_CHUNK = 512
# Item/triangle pairs per chunk of the twin: bounds its (blocks, 128, 128)
# temporaries (2^24 f32 = 64 MB each).
TWIN_CHUNK_PAIRS = 1 << 24
INT32_MAX = 2**31 - 1
F32_MAX_BITS = 0x7F7FFFFF  # float32 F32_MAX as int32 bits

# Kernel launches made by ``scatter_items`` (one per call on CUDA tensors).
launches = 0
# Kernel launches made by ``scatter_plan`` (three per call on CUDA
# tensors: the staged table, the count launch and the place launch), as
# the C calls report them.
plan_launches = 0
# Entered (ray, cluster) pairs that ``trace_scatter`` dropped past its
# capacity, summed over calls.
dropped = 0
# Per card, an int32 device counter of the item blocks with items whose
# cluster id lay outside [0, L): the kernel wrote misses for them.
# ``cluster_errors`` reads it (a sync), ``reset_cluster_errors`` zeroes it.
_errors: dict = {}
# Per card, the kernel's persistent blocks that fit at once (an occupancy
# query, made at the card's first launch).
_resident: dict = {}

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "scatter_items.cu"
PLAN_SOURCE = SOURCE.with_name("scatter_plan.cu")

_lib = None
_plan_lib = None
# ptxas reports of the last builds (registers, shared memory, spills).
build_log = ""
plan_build_log = ""


def _chunk_mask(cmin, cmax, cvalid, o, inv, maxd, lo, hi):
    """(chunk, L) entered mask: the slab test hits before maxd, the
    cluster is valid and its prim range [c*128, (c+1)*128) overlaps the
    ray's [lo, hi)."""
    a = (cmin[None] - o[:, None]) * inv[:, None]  # (chunk, L, 3)
    b = (cmax[None] - o[:, None]) * inv[:, None]
    tlo = torch.minimum(a, b).amax(dim=-1)
    thi = torch.maximum(a, b).amin(dim=-1)
    del a, b
    entry = torch.clamp(tlo, min=0.0)
    cstart = torch.arange(cmin.shape[0], dtype=torch.int64, device=o.device) * CLUSTER
    range_ok = (cstart[None] < hi[:, None]) & ((cstart + CLUSTER)[None] > lo[:, None])
    return (thi >= entry) & (entry < maxd[:, None]) & cvalid[None] & range_ok


def _chunks(R: int, L: int):
    step = max(1, CHUNK_ELEMS // (3 * max(L, 1)))
    return ((s, min(R, s + step)) for s in range(0, R, step))


def capacity(R: int, L: int, items_per_ray: int) -> int:
    """CAP: the item slots of R rays over L clusters."""
    return -(-items_per_ray * R // BLOCK_R) * BLOCK_R + L * BLOCK_R


def block_map(counts, R: int, items_per_ray: int):
    """The block map of per-cluster pair counts (L,) i64: (meta (NB, 2) i32
    — per block its cluster and valid item count —, each cluster's first
    slot (L,) i64, CAP). Each cluster's run is padded to whole blocks."""
    L = counts.shape[0]
    padded = -(-counts // BLOCK_R) * BLOCK_R
    cum = torch.cumsum(padded, dim=0)
    offsets = cum - padded  # start slot of each cluster's run
    cap = capacity(R, L, items_per_ray)
    nb = cap // BLOCK_R
    bstart = torch.arange(nb, dtype=torch.int64, device=counts.device) * BLOCK_R
    bc = torch.clamp(torch.searchsorted(cum, bstart, right=True), max=L - 1)
    in_use = bstart < cum[-1]
    bcount = torch.clamp(counts[bc] - (bstart - offsets[bc]), 0, BLOCK_R)
    meta = torch.stack(
        [torch.where(in_use, bc, 0), torch.where(in_use, bcount, 0)], dim=-1
    ).to(torch.int32)
    return meta, offsets, cap


def plan_bases(counts, R: int, items_per_ray: int):
    """The plan kernel's step between its launches, from the entered pairs
    per (ray chunk, cluster), counts (NCH, L) i32: (meta as
    ``block_map``'s, base (NCH, L) i32 — the first slot of each chunk's
    pairs in each cluster's run: the run's start plus the pairs of the
    chunks before, clamped to CAP —, CAP, the dropped pairs as a 0-d i64
    tensor: the pairs of each run past CAP)."""
    total = counts.sum(dim=0, dtype=torch.int64)
    meta, offsets, cap = block_map(total, R, items_per_ray)
    before = torch.cumsum(counts, dim=0, dtype=torch.int64) - counts
    base = torch.clamp(offsets[None] + before, max=cap).to(torch.int32)
    dropped = (total - torch.minimum(total, torch.clamp(cap - offsets, min=0))).sum()
    return meta, base, cap, dropped


def scatter_plan_reference(cmin, cmax, cvalid, o, d, maxd, lo, hi, items_per_ray: int = 32):
    """Plain PyTorch twin of the plan kernel: phases A and B and the block
    map. Returns (meta (NB, 2) i32 — per block its cluster and valid item
    count —, items (CAP,) i64 — the ray id of each slot, -1 where empty —,
    dropped pairs (int))."""
    R, L = o.shape[0], cmin.shape[0]
    dev = o.device
    inv = safe_inv_dir(d)
    # Phase A: the entered pairs as keys cluster * R + ray, sorted.
    keys = [torch.zeros((0,), dtype=torch.int64, device=dev)]
    for s, e in _chunks(R, L):
        mask = _chunk_mask(cmin, cmax, cvalid, o[s:e], inv[s:e], maxd[s:e], lo[s:e], hi[s:e])
        r, c = host_read("scatter_plan_twin", lambda: torch.nonzero(mask, as_tuple=True))
        keys.append(c * R + (s + r))
    key = torch.sort(torch.cat(keys)).values
    pair_c = torch.div(key, R, rounding_mode="floor")
    pair_r = key - pair_c * R
    counts = torch.bincount(pair_c, minlength=L)
    meta, offsets, cap = block_map(counts, R, items_per_ray)

    # Phase B: a pair's slot is its cluster's run start plus its rank among
    # the cluster's pairs (the rays before it that enter the cluster).
    first = torch.cumsum(counts, dim=0) - counts  # index of each cluster's first pair
    pos = offsets[pair_c] + (torch.arange(key.shape[0], device=dev) - first[pair_c])
    keep = pos < cap
    items = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    items[pos[keep]] = pair_r[keep]
    kept = host_read("scatter_plan_twin", lambda: int(keep.sum()))
    return meta, items, int(key.shape[0]) - kept


def build_plan() -> float:
    """Compile (if needed) and load the plan kernel's library; returns the
    seconds spent. Raises if nvcc is missing or the build fails."""
    global _plan_lib, plan_build_log
    if _plan_lib is not None:
        return 0.0
    start = time.perf_counter()
    lib, plan_build_log = build_library(PLAN_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hikari_scatter_plan_count.argtypes = [ptr] * 8 + [i32] * 2 + [ptr] * 5
    lib.hikari_scatter_plan_count.restype = i32
    lib.hikari_scatter_plan_place.argtypes = [ptr] * 2 + [i32] * 3 + [ptr] * 3
    lib.hikari_scatter_plan_place.restype = i32
    lib.hikari_scatter_plan_error_string.argtypes = [i32]
    lib.hikari_scatter_plan_error_string.restype = ctypes.c_char_p
    _plan_lib = lib
    return time.perf_counter() - start


def scatter_plan(cmin, cmax, cvalid, o, d, maxd, lo, hi, items_per_ray: int = 32):
    """Phases A and B and the block map: (meta, items, dropped) as
    ``scatter_plan_reference`` with the same arguments. CPU tensors run the
    twin; CUDA tensors launch the kernels of ``csrc/scatter_plan.cu``
    (the staged bound table, the count launch, which writes the counts and
    the ballot masks, then the place launch) or raise. One
    host read a call: the dropped count. The masks, (ceil(R/32), L) i32,
    live until the call returns (``mask_bytes``)."""
    if o.device.type == "cpu":
        return scatter_plan_reference(cmin, cmax, cvalid, o, d, maxd, lo, hi, items_per_ray)
    if o.device.type != "cuda":
        raise NotImplementedError(f"scatter_plan: no kernel for device {o.device}")
    R, L = o.shape[0], cmin.shape[0]
    dev = o.device
    if L == 0:
        raise ValueError("scatter_plan: no clusters")
    for name, x, dtype, shape in (
        ("o", o, torch.float32, (R, 3)),
        ("d", d, torch.float32, (R, 3)),
        ("maxd", maxd, torch.float32, (R,)),
        ("lo", lo, torch.int32, (R,)),
        ("hi", hi, torch.int32, (R,)),
        ("cmin", cmin, torch.float32, (L, 3)),
        ("cmax", cmax, torch.float32, (L, 3)),
        ("cvalid", cvalid, torch.bool, (L,)),
    ):
        check_kernel_arg("scatter_plan", name, x, dtype, shape, dev)
    cap = capacity(R, L, items_per_ray)
    if 3 * R >= 2**31 or (L + 1) * CLUSTER >= 2**31 or cap + PLAN_CHUNK >= 2**31:
        raise ValueError("scatter_plan: too many rays, clusters or slots for int32 indexing")
    build_plan()
    inv = safe_inv_dir(d)
    nch = -(-R // PLAN_CHUNK)
    table = torch.empty((L, 8), dtype=torch.float32, device=dev)
    counts = torch.empty((nch, L), dtype=torch.int32, device=dev)
    masks = torch.empty((-(-R // 32), L), dtype=torch.int32, device=dev)
    items = torch.full((cap,), -1, dtype=torch.int64, device=dev)

    launched = ctypes.c_int(0)

    def check(err):
        global plan_launches
        plan_launches += launched.value
        if err:
            raise RuntimeError(f"scatter_plan kernel launch failed: "
                               f"{_plan_lib.hikari_scatter_plan_error_string(err).decode()}")

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(_plan_lib.hikari_scatter_plan_count(
            o.data_ptr(), inv.data_ptr(), maxd.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            cmin.data_ptr(), cmax.data_ptr(), cvalid.data_ptr(), R, L, table.data_ptr(),
            counts.data_ptr(), masks.data_ptr(), stream, ctypes.byref(launched)))
        meta, base, _, dropped = plan_bases(counts, R, items_per_ray)
        del counts
        check(_plan_lib.hikari_scatter_plan_place(
            masks.data_ptr(), base.data_ptr(), R, L, cap, items.data_ptr(), stream,
            ctypes.byref(launched)))
    return meta, items, host_read("scatter_plan_dropped", lambda: int(dropped))


def mask_bytes(R: int, L: int) -> int:
    """Bytes of the plan kernel's ballot masks for R rays over L clusters."""
    return -(-R // 32) * L * 4


def item_fields(items, o, d, maxd, excl, lo, hi):
    """(FIELDS, CAP) f32 item fields gathered from the rays; empty slots
    carry ray 0's fields with valid = 0."""
    rid = torch.clamp(items, min=0)
    f = torch.empty((FIELDS, items.shape[0]), dtype=torch.float32, device=o.device)
    f[0:3] = o[rid].T
    f[3:6] = d[rid].T
    f[6] = torch.clamp(maxd, max=F32_MAX)[rid]
    for k, x in ((7, excl), (8, lo), (9, hi)):
        f[k] = x.to(torch.int32)[rid].view(torch.float32)
    f[10] = (items >= 0).to(torch.float32)
    return f


def scatter_items_reference(meta, fields, packed):
    """Plain PyTorch twin of the kernel, with its exact contract, operation
    order and tie rule: meta (NB, 2) i32, fields (FIELDS, NB*128) f32,
    packed (L*128, 16) from ``tile_walk.pack_clusters``. Returns per item
    (t, prim i32, u, v), each (CAP,): the closest hit within the item's
    block's cluster, or t = F32_MAX, prim = -1, u = v = 0."""
    nb, cap = meta.shape[0], fields.shape[1]
    dev = fields.device
    t_out = torch.full((nb, BLOCK_R), F32_MAX, dtype=torch.float32, device=dev)
    p_out = torch.full((nb, BLOCK_R), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((nb, BLOCK_R), dtype=torch.float32, device=dev)
    v_out = torch.zeros((nb, BLOCK_R), dtype=torch.float32, device=dev)
    rows = packed.reshape(-1, CLUSTER, PACK_WIDTH)
    f = fields.reshape(FIELDS, nb, BLOCK_R)
    used = host_read("scatter_items_twin", lambda: torch.nonzero(meta[:, 1] > 0)[:, 0])
    k_ids = torch.arange(CLUSTER, dtype=torch.int32, device=dev)
    chunk = max(1, TWIN_CHUNK_PAIRS // (BLOCK_R * CLUSTER))
    for s in range(0, used.numel(), chunk):
        b = used[s : s + chunk]
        cid = meta[b, 0]
        blk = rows[cid.long()]  # (n, tris, 16)
        nx, ny, nz, eux, euy, euz, evx, evy, evz, cn, cu, cv = (
            blk[:, None, :, k] for k in range(12)
        )
        valid_tri = (blk[:, :, 12] > 0.5)[:, None, :]
        inst = blk[:, :, 13].contiguous().view(torch.int32)[:, None, :]
        prim = (cid * CLUSTER)[:, None, None] + k_ids[None, None, :]
        fb = f[:, b][..., None]  # (FIELDS, n, items, 1)
        ox, oy, oz, dx, dy, dz, maxd = fb[0], fb[1], fb[2], fb[3], fb[4], fb[5], fb[6]
        excl, lo, hi = (fb[k].contiguous().view(torch.int32) for k in (7, 8, 9))
        valid = fb[10] > 0.5
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
            & valid_tri
            & (dn.abs() >= F32_EPSILON)
            & (t > F32_EPSILON)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t < maxd)
            & (inst != excl)
            & (prim >= lo)
            & (prim < hi)
        )
        n = b.numel()
        # Triangle 8*i + s goes to sublane s: (n, items, i, s).
        tm = torch.where(ok, t, F32_MAX).reshape(n, BLOCK_R, CLUSTER // SUBLANES, SUBLANES)
        i = torch.argmin(tm, dim=2, keepdim=True)  # first minimum: lowest prim of the sublane
        bt = tm.gather(2, i)[:, :, 0]
        found = bt < F32_MAX
        bp = torch.where(found, prim.expand_as(ok).reshape(tm.shape).gather(2, i)[:, :, 0], -1)
        bu = torch.where(found, u.reshape(tm.shape).gather(2, i)[:, :, 0], 0.0)
        bv = torch.where(found, v.reshape(tm.shape).gather(2, i)[:, :, 0], 0.0)
        # Halve 8 -> 4 -> 2 -> 1: the upper half only when strictly nearer.
        t_out[b], p_out[b], u_out[b], v_out[b] = reduce_sublanes(bt, bp, bu, bv)
    return (t_out.reshape(cap), p_out.reshape(cap), u_out.reshape(cap), v_out.reshape(cap))


def build() -> float:
    """Compile (if needed) and load the kernel library; returns the
    seconds spent. Raises if nvcc is missing or the build fails."""
    global _lib, build_log
    if _lib is not None:
        return 0.0
    start = time.perf_counter()
    lib, build_log = build_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hikari_scatter_items.argtypes = [ptr] * 4 + [i32] * 3 + [ptr] * 6
    lib.hikari_scatter_items.restype = i32
    lib.hikari_scatter_items_grid.argtypes = []
    lib.hikari_scatter_items_grid.restype = i32
    lib.hikari_scatter_items_error_string.argtypes = [i32]
    lib.hikari_scatter_items_error_string.restype = ctypes.c_char_p
    _lib = lib
    return time.perf_counter() - start


def run_ranges(meta, grid: int):
    """(grid, 4) i32: the item blocks of each of the kernel's ``grid``
    persistent blocks, [w0, w1) then [t0, t1). With U the count of used
    blocks (count > 0), the first ranges split [0, U) and the second split
    [U, NB) evenly, so every block gets its share of the used blocks when
    they come first (``scatter_plan``'s layout); together the ranges cover
    every block once whatever the layout. Computed on ``meta``'s device,
    without a sync."""
    nb = meta.shape[0]
    used = (meta[:, 1] > 0).sum()
    g = torch.arange(grid + 1, dtype=torch.int64, device=meta.device)
    w = torch.div(g * used, grid, rounding_mode="floor")
    t = used + torch.div(g * (nb - used), grid, rounding_mode="floor")
    return torch.stack([w[:-1], w[1:], t[:-1], t[1:]], dim=1).to(torch.int32)


def cluster_errors() -> int:
    """Item blocks with items whose cluster id lay outside [0, L), summed
    over every card's kernel launches since the last reset (reads the
    device)."""
    return sum(int(x.item()) for x in _errors.values())


def reset_cluster_errors() -> None:
    """Zero the count that ``cluster_errors`` reads, on every card."""
    for x in _errors.values():
        x.zero_()


def scatter_items(meta, fields, packed):
    """Per-item closest hit within the item's cluster: (t, prim i32, u, v),
    each (CAP,). Same arguments as ``scatter_items_reference``. CPU
    tensors run the twin; CUDA tensors launch the kernel (one launch per
    call) or raise. On the card a block with items and a cluster id
    outside [0, L) gets misses and counts in ``cluster_errors()``."""
    global launches
    if fields.device.type == "cpu":
        return scatter_items_reference(meta, fields, packed)
    if fields.device.type != "cuda":
        raise NotImplementedError(f"scatter_items: no kernel for device {fields.device}")
    nb, L = meta.shape[0], packed.shape[0] // CLUSTER
    dev = fields.device
    for name, x, dtype, shape in (
        ("meta", meta, torch.int32, (nb, 2)),
        ("fields", fields, torch.float32, (FIELDS, nb * BLOCK_R)),
        ("packed", packed, torch.float32, (L * CLUSTER, PACK_WIDTH)),
    ):
        check_kernel_arg("scatter_items", name, x, dtype, shape, dev)
    if packed.data_ptr() % 16 or fields.data_ptr() % 16:
        raise ValueError("scatter_items: packed and fields must be 16-byte aligned")
    if FIELDS * nb * BLOCK_R >= 2**31 or L * CLUSTER >= 2**31 // PACK_WIDTH:
        raise ValueError("scatter_items: too many items or triangles for int32 indexing")
    build()
    cap = nb * BLOCK_R
    t = torch.empty((cap,), dtype=torch.float32, device=dev)
    prim = torch.empty((cap,), dtype=torch.int32, device=dev)
    u = torch.empty((cap,), dtype=torch.float32, device=dev)
    v = torch.empty((cap,), dtype=torch.float32, device=dev)
    if nb == 0:
        return t, prim, u, v
    errors = _errors.get(dev.index)
    if errors is None:
        errors = _errors[dev.index] = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        resident = _resident.get(dev.index)
        if resident is None:
            resident = _resident[dev.index] = _lib.hikari_scatter_items_grid()
            if resident <= 0:
                raise RuntimeError("scatter_items: the card's occupancy query failed")
        grid = min(resident, nb)
        ranges = run_ranges(meta, grid)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib.hikari_scatter_items(
            meta.data_ptr(), fields.data_ptr(), packed.data_ptr(), ranges.data_ptr(), grid, nb,
            L, t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), errors.data_ptr(),
            stream,
        )
    if err:
        raise RuntimeError(
            f"scatter_items kernel launch failed: "
            f"{_lib.hikari_scatter_items_error_string(err).decode()}"
        )
    launches += 1
    return t, prim, u, v


def segment_min(items, t, prim, u, v, maxd):
    """Each ray's winner among its items: the least t bits (t > 0, so the
    int bits order as the floats), then the lowest item index. Rays with no
    hit get t = min(maxd, F32_MAX), prim = -1, u = v = 0."""
    R = maxd.shape[0]
    valid = items >= 0
    rid = torch.clamp(items, min=0)
    tbits = t.view(torch.int32).to(torch.int64)
    sent = torch.full((R,), INT32_MAX, dtype=torch.int64, device=t.device)
    tmin = sent.scatter_reduce(0, rid, torch.where(valid, tbits, INT32_MAX), "amin")
    contender = valid & (tbits == tmin[rid])
    idx = torch.arange(items.shape[0], dtype=torch.int64, device=t.device)
    widx = sent.scatter_reduce(0, rid, torch.where(contender, idx, INT32_MAX), "amin")
    hit = tmin < F32_MAX_BITS
    w = torch.clamp(widx, max=items.shape[0] - 1)
    return (
        torch.where(hit, t[w], torch.clamp(maxd, max=F32_MAX)),
        torch.where(hit, prim[w], -1),
        torch.where(hit, u[w], 0.0),
        torch.where(hit, v[w], 0.0),
    )


def trace_scatter(packed, cmin, cmax, cvalid, o, d, maxd, excl, lo, hi,
                  items_per_ray: int = 32):
    """Closest hit over R flat rays: o, d (R,3) f32; maxd (R,) f32; excl,
    lo, hi (R,) i32; packed, cmin, cmax, cvalid from
    ``tile_walk.pack_clusters(scene, CLUSTER)``. Returns (t, prim i32, u,
    v), each (R,). Phases A and B run under the profiler range
    ``scatter_plan``, the kernel under ``scatter_items``, the winner pick
    under ``segment_min``. Adds the dropped pairs to ``dropped``."""
    global dropped
    with record_function("scatter_plan"):
        meta, items, n_drop = scatter_plan(cmin, cmax, cvalid, o, d, maxd, lo, hi, items_per_ray)
        fields = item_fields(items, o, d, maxd, excl, lo, hi)
    dropped += n_drop
    with record_function("scatter_items"):
        it, ip, iu, iv = scatter_items(meta, fields, packed)
    with record_function("segment_min"):
        return segment_min(items, it, ip, iu, iv, maxd)
