"""Ray-tracing API: closest-hit queries over the compiled scene — the port
of ``hikari_tpu.trace.api``.

Three searches, each a hand-written CUDA kernel for CUDA tensors and its
plain twin for CPU tensors:

* ``trace/closest_hit.closest_hit`` tests every triangle (K1/K1b): the
  small-scene search, up to ``bruteforce_max_tris`` triangles;
* ``trace/tile_walk.trace_tile_walk`` (K2): rays sorted into 512-ray tiles
  by direction octant and origin Morton cell, each tile walking its
  triangle clusters near to far — above that size;
* ``trace/scatter.trace_scatter`` (K3), only when asked for with
  ``method="scatter"``: every entered (ray, 128-triangle cluster) pair
  becomes an item, each item block is tested against its one cluster, and
  a segment-min picks each ray's winner.

Two more searches are plain XLA in the JAX package and plain torch here,
on either device; no main path takes them:

* ``method="bvh"`` (``_trace_bvh``), the lockstep BVH walk over the
  stitched node graph that ``scene/update.update_transforms`` refits;
* ``method="tiled"`` (``_trace_tiled``, ``trace/tiled.trace_tiled``), the
  XLA tile-binned cluster tracer: octant-sorted 512-ray tiles walk their
  512-triangle clusters near to far in lockstep, densely.

The searches are not differentiable (they return integer hit ids plus
detached (t, u, v)); ``refine_hit`` / ``hit_info`` recompute (t, u, v) at
the fixed hit triangle from ``scene.tri_world``, so gradients reach the
vertices through them, as in the JAX package.

Under pass-level remat (``render/pipeline.py``) a pass runs twice: once in
the forward and once in the backward, to rebuild what its backward needs.
``trace_tape`` records every hit of the first run and replays them in the
same order in the second, so the backward searches nothing (the JAX
package's remat policy saves the ``"trace_hits"`` for the same reason).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch
from torch.profiler import record_function

from hikari_tpu_torch.config import DISTANCE_MAX, F32_MAX
from hikari_tpu_torch.diff import clip_gradient
from hikari_tpu_torch.scene.buffers import SceneBuffers
from hikari_tpu_torch.trace.closest_hit import closest_hit, pack_triangles
from hikari_tpu_torch.trace.intersect import intersects_aabb, intersects_triangle
from hikari_tpu_torch.trace.scatter import CLUSTER as SCATTER_CLUSTER
from hikari_tpu_torch.trace.scatter import trace_scatter
from hikari_tpu_torch.trace.tiled import TILE_R, trace_tiled
from hikari_tpu_torch.trace.tile_walk import pack_clusters, trace_tile_walk
from hikari_tpu_torch.utils import safe_normalize, take_rows
from hikari_tpu_torch.utils.profiling import host_read

# trace_rays calls that went to a kernel-backed search with rays on a CUDA
# device (each is one kernel launch, so a run can check every trace went
# through a kernel). The BVH walk and the tiled tracer launch no kernel of
# their own and are not counted, nor is a hit replayed from a tape.
trace_calls = 0
# Rays this process searched, on any device and backend (under
# shard_tracing: its shard); a replayed hit searches none.
rays_traced = 0

_SEARCH_METHODS = ("auto", "auto_xla", "pallas", "bruteforce", "pallas_tiled", "scatter", "bvh",
                   "tiled")
_PLAIN_METHODS = ("bvh", "tiled")  # no kernel: plain torch on either device

class TraceTape:
    """The hits of one remat region's trace_rays calls, in call order. Its
    first run records them; every later run replays them from the start."""

    def __init__(self):
        self.hits: list = []
        self.recorded = False
        self.pos = 0


_tapes: list = []  # the tapes of the regions being run, outermost first


@contextmanager
def trace_tape(tape: TraceTape):
    """Run a remat region under ``tape``: the first time, every trace_rays
    call inside records its hit (and searches, unless an enclosing region
    is replaying); every later time, the calls return the recorded hits in
    order and search nothing."""
    replay = tape.recorded
    tape.pos = 0
    _tapes.append((tape, replay))
    try:
        yield
    finally:
        _tapes.pop()
        tape.recorded = True


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    forward keeps no intermediate of ``fn`` for the backward, which runs
    ``fn`` again to rebuild them (JAX ``jax.checkpoint``). A ``trace_tape``
    around each run records the forward's hits and replays them, so the
    rerun searches nothing and counts no trace call; the port draws no
    torch random numbers, so the rerun computes what the forward did."""
    from torch.utils.checkpoint import checkpoint

    tape = TraceTape()

    def run(*a):
        with trace_tape(tape):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


def _replayed_hit():
    """The next hit of the innermost replaying tape, or None."""
    for tape, replay in reversed(_tapes):
        if replay:
            if tape.pos >= len(tape.hits):
                raise RuntimeError("remat replay: more trace_rays calls than the forward made")
            hit = tape.hits[tape.pos]
            tape.pos += 1
            return hit
    return None


def _record_hit(hit):
    for tape, replay in _tapes:
        if not replay:
            tape.hits.append(hit)


# ---------------------------------------------------------------------------
# Sharded dispatch: the kernel backends under shard_tracing
# ---------------------------------------------------------------------------

_SHARD_CTX: list = []  # stack of (mesh, axes) entries
_SHARDED_METHODS = ("pallas", "pallas_tiled", "scatter")


@contextmanager
def shard_tracing(mesh, axis=None):
    """Trace on a mesh of ranks (``parallel/sharding.Mesh``; JAX
    ``shard_tracing``). While active, every kernel backend ("pallas",
    "pallas_tiled", "scatter", and "auto" resolving to one of them)
    splits the flat rays over the ranks of ``axis`` (a mesh axis name or
    tuple of names; default: every mesh axis), pads the last shard with
    inert rays (max distance 0, empty prim range: they hit nothing),
    traces this rank's shard through its kernel and all-gathers the hits:
    every rank returns the whole call's hits. Inside a sharded frame
    (``utils.block``) the rays are already the rank's block of the
    frame's rays, so each rank traces its own and the hits stay sharded,
    as JAX's ``shard_map`` over rays sharded on the same axes does. The
    other backends are left alone (the JAX package leaves them to GSPMD).
    The search is detached: no gradient crosses the gather."""
    axes = tuple(mesh.axis_names) if axis is None else (
        (axis,) if isinstance(axis, str) else tuple(axis))
    _SHARD_CTX.append((mesh, axes))
    try:
        yield
    finally:
        _SHARD_CTX.pop()


def _shard_backend(search, arrays, fills):
    """``search(*arrays) -> (t, prim, u, v)`` under the active
    shard_tracing context: this rank's shard of the rays, padded with
    ``fills``, then the all-gathered hits (JAX ``_shard_backend``).
    Returns the hits and the rays this rank searched."""
    from hikari_tpu_torch.parallel.halo import all_gather_plain
    from hikari_tpu_torch.utils.block import current

    if current().sharded:
        return search(*arrays), arrays[0].shape[0]
    mesh, axes = _SHARD_CTX[-1]
    k, n = mesh.index(axes)
    R = arrays[0].shape[0]
    per = -(-R // n)

    def shard(x, fill):
        if per * n > R:
            x = torch.cat([x, torch.full((per * n - R,) + x.shape[1:], fill, dtype=x.dtype,
                                         device=x.device)])
        return x[k * per : (k + 1) * per].contiguous()

    hits = search(*(shard(x, f) for x, f in zip(arrays, fills)))
    group = mesh.group(axes)
    return tuple(torch.cat(all_gather_plain(h, group, "trace"))[:R] for h in hits), per


@dataclass(frozen=True)
class Hit:
    """SoA hit record (reference ``Hit``, light.wgsl:275-279). Miss is
    ``prim == -1`` / ``inst == -1`` with ``t = min(max_distance, F32_MAX)``."""

    t: torch.Tensor  # (...,) f32
    prim: torch.Tensor  # (...,) i32, -1 = miss
    inst: torch.Tensor  # (...,) i32, -1 = miss
    u: torch.Tensor  # (...,) f32 barycentric
    v: torch.Tensor  # (...,) f32

    @property
    def missed(self):
        return self.prim < 0


def trace_rays(
    scene: SceneBuffers,
    origin,
    direction,
    max_distance=None,
    early_distance=None,
    exclude_instance=None,
    range_lo=None,
    range_hi=None,
    method: str = "auto",
    bruteforce_max_tris: int = 2048,
    max_steps: int = 0,
) -> Hit:
    """Closest-hit query. origin/direction: (...,3). Optional per-ray
    scalars (broadcast to the ray shape): max_distance, early_distance
    (the tile walk may stop a ray at any hit nearer than it: an any-hit
    query for shadow rays), exclude_instance (i32, -1 = none), and a
    primitive id range [range_lo, range_hi). ``max_steps`` caps the steps
    of the BVH walk (0: ``num_nodes``, its exact worst case); the other
    searches ignore it.

    Dispatch, the JAX package's choice on its TPU: "auto"/"auto_xla" test
    every triangle (K1) up to ``bruteforce_max_tris`` triangles and walk
    tiles (K2) above; "pallas" and "bruteforce" always test every
    triangle; "pallas_tiled" always walks tiles; "scatter" always takes
    the cluster-major scatter search, which returns the exact closest hit
    and ignores ``early_distance``, as in the JAX package. Each runs its
    kernel on CUDA and its twin on the CPU, and each CUDA call adds one to
    ``trace_calls``. "bvh" is the JAX package's lockstep BVH walk
    (``_trace_bvh``) in plain torch on either device, over the node graph
    ``node_min``/``node_max`` that ``scene.update.update_transforms``
    refits; it makes one host sync per step, takes no kernel and does not
    count in ``trace_calls``. "tiled" is the JAX package's XLA tile-binned
    tracer (``_trace_tiled``) in plain torch on either device: rays sorted
    by direction octant into 512-ray tiles, each tile walking its
    512-triangle clusters near to far, one host sync a step; it takes no
    kernel and does not count in ``trace_calls`` either.

    On the card "scatter" does not check its plan's cluster ids on the host
    (that would sync every call): an item block naming a cluster outside
    the table gets misses and counts in ``trace.scatter.cluster_errors()``,
    which a caller reads (one sync) after a run to know it is 0.

    Among hits at exactly equal t the searches keep the JAX kernels'
    rules. "pallas" and "auto" (K1) and "pallas_tiled" (K2, over all the
    clusters a tile walks) keep a best per (prim mod 8) sublane and halve
    the eight towards the lower sublane unless the upper one is strictly
    nearer, so the sublanes win in the order 0, 4, 2, 6, 1, 5, 3, 7 (a
    triangle duplicated at prims 1, 4 and 8 returns prim 8). "scatter"
    (K3) applies that rule within each cluster, then keeps the first
    cluster among equal t. "bruteforce" keeps the lowest prim among equal
    t, as the JAX ``_trace_bruteforce`` does; "bvh" keeps the first hit
    its walk meets among equal t, as the JAX ``_trace_bvh`` does; "tiled"
    keeps, within a cluster, the first column among equal t (the lowest
    prim) and, across clusters, the cluster its tile visited first (an
    update needs a strictly nearer t), as the JAX ``trace_tiled`` does.

    Inside a remat region (``trace_tape``) a replaying run returns the
    recorded hit of the same call and searches nothing. Under
    ``shard_tracing`` the kernel backends search this rank's shard of
    the rays. A search runs under the profiler range ``trace_rays``; a
    replayed hit opens none."""
    replayed = _replayed_hit() if _tapes else None
    if replayed is not None:
        _record_hit(replayed)
        return replayed
    with record_function("trace_rays"):
        hit = _search(scene, origin, direction, max_distance, early_distance, exclude_instance,
                      range_lo, range_hi, method, bruteforce_max_tris, max_steps)
    if _tapes:
        _record_hit(hit)
    return hit


def _search(scene, origin, direction, max_distance, early_distance, exclude_instance, range_lo,
            range_hi, method, bruteforce_max_tris, max_steps) -> Hit:
    """``trace_rays``'s search, as it documents."""
    global trace_calls, rays_traced
    if method not in _SEARCH_METHODS:
        raise ValueError(f"unknown trace method {method!r}")
    if method in ("auto", "auto_xla"):
        method = "pallas_tiled" if scene.num_tris > bruteforce_max_tris else "pallas"
    shape = origin.shape[:-1]
    o = origin.detach().reshape(-1, 3).to(torch.float32).contiguous()
    d = direction.detach().reshape(-1, 3).to(torch.float32).contiguous()
    R, dev = o.shape[0], o.device

    def per_ray(x, default, dtype):
        if x is None:
            return torch.full((R,), default, dtype=dtype, device=dev)
        if not (isinstance(x, torch.Tensor) and x.device == dev):
            x = host_read("trace_args", lambda: torch.as_tensor(x, device=dev))
        x = x.detach().to(dtype)
        return torch.broadcast_to(x, shape).reshape(-1).contiguous()

    maxd = per_ray(max_distance, F32_MAX, torch.float32)
    excl = per_ray(exclude_instance, -1, torch.int32)
    lo = per_ray(range_lo, 0, torch.int32)
    hi = per_ray(range_hi, scene.num_tris, torch.int32)

    early = per_ray(early_distance, 0.0, torch.float32)

    def search(o, d, maxd, early, excl, lo, hi):
        if method == "tiled":
            return _trace_tiled(scene, o, d, maxd, early, excl, lo, hi)
        if method == "bvh":
            return _trace_bvh(scene, o, d, maxd, early, excl, lo, hi, max_steps)
        if method == "pallas_tiled":
            return _trace_tile_walk(scene, o, d, maxd, early, excl, lo, hi)
        if method == "scatter":
            return trace_scatter(*pack_clusters(scene, SCATTER_CLUSTER), o, d, maxd, excl, lo, hi)
        tie = "bruteforce" if method == "bruteforce" else "pallas"
        return closest_hit(o, d, maxd, excl, lo, hi, pack_triangles(scene), tie)

    args = (o, d, maxd, early, excl, lo, hi)
    if _SHARD_CTX and method in _SHARDED_METHODS and R:
        (t, prim, u, v), searched = _shard_backend(search, args, (0.0, 1.0, 0.0, 0.0, -1, 0, 0))
    else:
        (t, prim, u, v), searched = search(*args), R
    rays_traced += searched
    if dev.type == "cuda" and searched and method not in _PLAIN_METHODS:
        trace_calls += 1
    inst = torch.where(prim >= 0, scene.tri_inst[prim.clamp(min=0)], -1).to(torch.int32)
    return Hit(
        t=t.reshape(shape),
        prim=prim.reshape(shape),
        inst=inst.reshape(shape),
        u=u.reshape(shape),
        v=v.reshape(shape),
    )


def tile_cluster_rule(num_tris: int) -> tuple[int, bool]:
    """(cluster size, use_skip) of the tile walk for a padded triangle
    count — the JAX package's per-scene rule (trace/api.py
    _trace_pallas_tiled): 64 without the skip below 32,768 triangles, 128
    with it below 262,144, else 256 with it; doubled while there are more
    than 16,384 clusters."""
    if num_tris < 32768:
        cluster, use_skip = 64, False
    elif num_tris < 262144:
        cluster, use_skip = 128, True
    else:
        cluster, use_skip = 256, True
    while -(-num_tris // cluster) > 16384:
        cluster *= 2
    return cluster, use_skip


def _morton3(q):
    """Interleave 6-bit per-axis cells (..., 3) i32 -> 18-bit Morton."""

    def spread(x):
        x = (x | (x << 10)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(q[..., 0]) << 2) | (spread(q[..., 1]) << 1) | spread(q[..., 2])


def ray_sort_order(scene: SceneBuffers, o, d):
    """The permutation that sorts rays into tiles: by direction octant,
    then by the origin's 6-bit-per-axis Morton cell over the scene's
    instance bounds (stable, so equal keys keep ray order)."""
    octant = (
        (d[:, 0] < 0).to(torch.int32) * 4
        + (d[:, 1] < 0).to(torch.int32) * 2
        + (d[:, 2] < 0).to(torch.int32)
    )
    smin = scene.inst_min.amin(dim=0)
    smax = scene.inst_max.amax(dim=0)
    cell = torch.clamp((o - smin) / torch.clamp(smax - smin, min=1e-6) * 63.0, 0.0, 63.0)
    key = (octant << 18) | _morton3(cell.to(torch.int32))
    return torch.argsort(key, stable=True)


def _trace_tile_walk(scene: SceneBuffers, o, d, maxd, early, excl, lo, hi):
    """Sort the rays into tiles, pad to whole tiles with inert rays
    (maxd = 0, hi = 0: no cluster entry, never open), walk, and put the
    hits back in ray order."""
    cluster, use_skip = tile_cluster_rule(scene.tri_n.shape[0])
    R = o.shape[0]
    order = ray_sort_order(scene, o, d)
    pad = -(-R // TILE_R) * TILE_R - R

    def tiles(x, fill):
        x = x[order]
        if pad:
            x = torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)])
        return x.contiguous()

    packed, cmin, cmax, cvalid = pack_clusters(scene, cluster)
    t, prim, u, v, _ = trace_tile_walk(
        packed, cmin, cmax, cvalid, tiles(o, 0.0), tiles(d, 1.0), tiles(maxd, 0.0),
        tiles(early, 0.0), tiles(excl, -1), tiles(lo, 0), tiles(hi, 0), cluster, use_skip,
    )
    out = []
    for x in (t, prim, u, v):
        y = torch.empty((R,), dtype=x.dtype, device=x.device)
        y[order] = x[:R]
        out.append(y)
    return out


def octant_order(d):
    """The stable permutation that sorts rays by direction octant."""
    key = (
        (d[:, 0] < 0).to(torch.int32) * 4
        + (d[:, 1] < 0).to(torch.int32) * 2
        + (d[:, 2] < 0).to(torch.int32)
    )
    return torch.argsort(key, stable=True)


def tiled_inputs(o, d, maxd, early, excl, lo, hi):
    """The rays of ``_trace_tiled`` in tile order: (order, [o, d, maxd,
    early, excl, lo, hi] sorted by direction octant (stable; not the tile
    walk's Morton order) and padded to whole tiles with inert rays (o 0,
    d 1, maxd 0, early 0, excl -1, lo 0, hi 0: no cluster entry, never
    open)). Tiles are independent, so any subset of whole tiles traces to
    the same hits."""
    R = o.shape[0]
    order = octant_order(d)
    pad = -(-R // TILE_R) * TILE_R - R

    def tiles(x, fill):
        x = x[order]
        if pad:
            x = torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)])
        return x.contiguous()

    fills = (0.0, 1.0, 0.0, 0.0, -1, 0, 0)
    return order, [tiles(x, f) for x, f in zip((o, d, maxd, early, excl, lo, hi), fills)]


def _trace_tiled(scene: SceneBuffers, o, d, maxd, early, excl, lo, hi):
    """The JAX ``_trace_tiled``: the rays in tile order (``tiled_inputs``),
    ``trace/tiled.trace_tiled``, and the hits back in ray order. A caller
    that wants the walk's steps and clusters tested per tile calls those
    two itself."""
    R = o.shape[0]
    order, rays = tiled_inputs(o, d, maxd, early, excl, lo, hi)
    t, prim, u, v, _, _ = trace_tiled(scene, *rays)
    out = []
    for x in (t, prim, u, v):
        y = torch.empty((R,), dtype=x.dtype, device=x.device)
        y[order] = x[:R]
        out.append(y)
    return out


# ---------------------------------------------------------------------------
# Stackless BVH walk (vectorized lockstep)
# ---------------------------------------------------------------------------


BVH_RAY_CHUNK = 65536  # rays per lockstep walk


def _trace_bvh(scene: SceneBuffers, o, d, maxd, early, excl, lo, hi, max_steps: int = 0):
    """Chunked lockstep walks (JAX ``_trace_bvh``): each ``BVH_RAY_CHUNK``-ray
    walk ends on its own, so coherent chunks exit in few steps. Above one
    chunk the rays are first sorted by direction octant (stable), so each
    chunk's walk is coherent. Returns (t, prim, u, v) in ray order."""
    R = o.shape[0]
    if R <= BVH_RAY_CHUNK:
        return _trace_bvh_chunk(scene, o, d, maxd, early, excl, lo, hi, max_steps)
    order = octant_order(d)
    # The last chunk is filled with the JAX package's inert rays (maxd = 0,
    # hi = 0: they never hit). They can lengthen that chunk's walk, and a
    # finished ray re-tests the last node on every step, so they stay.
    pad = -(-R // BVH_RAY_CHUNK) * BVH_RAY_CHUNK - R

    def sort_pad(x, fill):
        x = x[order]
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype,
                                        device=x.device)])

    rays = [sort_pad(x, f) for x, f in ((o, 0.0), (d, 1.0), (maxd, 0.0), (early, 0.0),
                                         (excl, -1), (lo, 0), (hi, 0))]
    parts = [
        _trace_bvh_chunk(scene, *(x[s:s + BVH_RAY_CHUNK] for x in rays), max_steps=max_steps)
        for s in range(0, R, BVH_RAY_CHUNK)
    ]
    out = []
    for k in range(4):
        x = torch.cat([p[k] for p in parts])[:R]
        y = torch.empty_like(x)
        y[order] = x
        out.append(y)
    return out


def _trace_bvh_chunk(scene: SceneBuffers, o, d, maxd, early, excl, lo, hi, max_steps: int = 0):
    """One lockstep walk of the stitched node graph (JAX
    ``_trace_bvh_chunk``): every ray follows the stackless entry/exit
    links (``node_entry``/``node_exit``) from node 0, testing a leaf's
    triangle and descending into an inner node whose box it enters before
    its best hit. Exclusion applies only to nodes tagged with an instance.
    It stops once no ray is left walking (one host sync per step) or after
    ``max_steps or num_nodes`` steps (the entry/exit walk visits each node
    at most once; rays past a smaller cap keep their best hit so far). A
    ray whose hit is nearer than ``early`` stops there. As in the JAX
    package, a ray that has stopped still tests the last node's triangle
    on every later step of its chunk."""
    R = o.shape[0]
    dev = o.device
    num_nodes = scene.num_nodes
    step_cap = max_steps if max_steps > 0 else num_nodes
    inv_d = 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    tri = scene.tri_world.detach()
    P = tri.shape[0]
    end = num_nodes

    idx = torch.zeros((R,), dtype=torch.int32, device=dev)
    best_t = torch.clamp(maxd, max=F32_MAX)
    best_prim = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((R,), device=dev)
    best_v = torch.zeros((R,), device=dev)
    for _ in range(step_cap):
        active = idx != end
        keep = active & ~((best_prim >= 0) & (best_t < early))
        if not host_read("bvh_step", lambda: bool(keep.any())):
            break
        safe_idx = torch.clamp(idx, 0, num_nodes - 1).long()
        entry = scene.node_entry[safe_idx]
        exit_ = scene.node_exit[safe_idx]
        ninst = scene.node_inst[safe_idx]

        is_leaf = entry < 0
        prim_id = -entry - 1
        safe_prim = torch.clamp(prim_id, 0, P - 1).long()
        tv0, tv1, tv2 = gather_triangle_vertices(tri, safe_prim)
        t, u, v = intersects_triangle(o, d, tv0, tv1, tv2)
        # Untagged nodes carry inst == -1, which must never match the "no
        # exclusion" sentinel (-1).
        not_excluded = (ninst < 0) | (ninst != excl)
        tri_ok = (
            is_leaf
            & scene.tri_valid[safe_prim]
            & (t < best_t)
            & not_excluded
            & (prim_id >= lo)
            & (prim_id < hi)
        )
        best_t = torch.where(tri_ok, t, best_t)
        best_prim = torch.where(tri_ok, prim_id, best_prim).to(torch.int32)
        best_u = torch.where(tri_ok, u, best_u)
        best_v = torch.where(tri_ok, v, best_v)

        aabb_t = intersects_aabb(o, inv_d, scene.node_min[safe_idx], scene.node_max[safe_idx])
        descend = (~is_leaf) & (aabb_t < best_t) & not_excluded
        next_idx = torch.where(is_leaf | ~descend, exit_, entry)
        done_early = (best_prim >= 0) & (best_t < early)
        idx = torch.where(active & ~done_early, next_idx, end).to(torch.int32)
    return best_t, best_prim, best_u, best_v


# ---------------------------------------------------------------------------
# Differentiable hit attribute reconstruction
# ---------------------------------------------------------------------------


def gather_triangle_vertices(tri_world, prim):
    """Hit-triangle vertices (v0, v1, v2), each (..., 3); differentiable
    with respect to ``tri_world``."""
    v = take_rows(tri_world.reshape(tri_world.shape[0], 9), prim)
    return v[..., 0:3], v[..., 3:6], v[..., 6:9]


def refine_hit(scene: SceneBuffers, origin, direction, hit: Hit):
    """Recompute (t, u, v) differentiably at the fixed hit triangle — the
    fixed-topology gradient path. Misses keep their sentinel values."""
    v0, v1, v2 = gather_triangle_vertices(scene.tri_world, hit.prim.clamp(min=0))
    return _refine_from_vertices(origin, direction, hit, v0, v1, v2)


def _refine_from_vertices(origin, direction, hit: Hit, v0, v1, v2):
    # Firewalls on both sides of the refine math (see hikari_tpu.trace.api).
    v0 = clip_gradient(v0, 1e6, "refine_verts")
    v1 = clip_gradient(v1, 1e6, "refine_verts")
    v2 = clip_gradient(v2, 1e6, "refine_verts")
    t, u, v = intersects_triangle(origin, direction, v0, v1, v2)
    t = clip_gradient(t, 1e4, "refine_tuv")
    u = clip_gradient(u, 1e4, "refine_tuv")
    v = clip_gradient(v, 1e4, "refine_tuv")
    miss = hit.prim < 0
    return (
        torch.where(miss, hit.t, t),
        torch.where(miss, hit.u, u),
        torch.where(miss, hit.v, v),
    )


@dataclass(frozen=True)
class HitInfo:
    """Interpolated surface info (reference ``HitInfo``/``hit_info``,
    light.wgsl:290-296, :496-523). ``position`` carries the hit flag in w
    (1 = hit, 0 = miss at origin + DISTANCE_MAX * dir)."""

    position: torch.Tensor  # (..., 4)
    normal: torch.Tensor  # (..., 3)
    uv: torch.Tensor  # (..., 2)
    instance: torch.Tensor  # (...,) i32, -1 = miss
    material: torch.Tensor  # (...,) i32, -1 = miss


def _hit_rows(scene: SceneBuffers):
    """Per-triangle rows (P, 24): [v0 v1 v2 (9) | n0 n1 n2 (9) |
    uv0 uv1 uv2 (6)], so one row gather by prim serves the refine
    vertices and the vertex attributes."""
    P = scene.tri_world.shape[0]
    attr = torch.cat([scene.vert_normal, scene.vert_uv], dim=-1)[scene.tri_vidx]  # (P,3,5)
    return torch.cat(
        [
            scene.tri_world.reshape(P, 9),
            attr[..., :3].reshape(P, 9),
            attr[..., 3:].reshape(P, 6),
        ],
        dim=-1,
    )


def hit_info(scene: SceneBuffers, origin, direction, hit: Hit) -> HitInfo:
    """Reference ``hit_info`` (light.wgsl:496-523): barycentric-interpolated
    uv + world normal from vertex attributes, world position from the
    (differentiably refined) distance."""
    safe_prim = hit.prim.clamp(min=0)
    rows = take_rows(_hit_rows(scene), safe_prim)  # (..., 24)
    v0, v1, v2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    t, u, v = _refine_from_vertices(origin, direction, hit, v0, v1, v2)
    n0, n1, n2 = rows[..., 9:12], rows[..., 12:15], rows[..., 15:18]
    uv0, uv1, uv2 = rows[..., 18:20], rows[..., 20:22], rows[..., 22:24]
    tri_material = scene.inst_material[scene.tri_inst.clamp(min=0)][safe_prim]
    uu = u[..., None]
    vv = v[..., None]
    normal = safe_normalize(n0 + uu * (n1 - n0) + vv * (n2 - n0))
    uv = uv0 + uu * (uv1 - uv0) + vv * (uv2 - uv0)

    miss = hit.prim < 0
    # Straight-through clamp of the refined distance to the trace bound
    # (value clamped, gradient untouched), as in the JAX package.
    t = t + (torch.clamp(t, max=DISTANCE_MAX) - t).detach()
    pos_hit = origin + direction * t[..., None]
    pos_miss = origin + direction * DISTANCE_MAX
    position = torch.where(miss[..., None], pos_miss, pos_hit)
    w = torch.where(miss, 0.0, 1.0)
    position = torch.cat([position, w[..., None]], dim=-1)

    return HitInfo(
        position=position,
        normal=torch.where(miss[..., None], 0.0, normal),
        uv=torch.where(miss[..., None], 0.0, uv),
        instance=hit.inst,
        material=torch.where(miss, -1, tri_material).to(torch.int32),
    )


def occlude_hit_info(origin, direction, hit: Hit, info: HitInfo) -> HitInfo:
    """Reference ``occlude_hit_info`` (light.wgsl:526-533): after a shadow
    ray, replace the light-sample info with the occluder on hit (position
    flag stays 1, normal zeroed)."""
    occluded = hit.prim >= 0
    pos = origin + direction * hit.t[..., None]
    position = torch.where(
        occluded[..., None], torch.cat([pos, torch.ones_like(pos[..., :1])], dim=-1), info.position
    )
    return HitInfo(
        position=position,
        normal=torch.where(occluded[..., None], 0.0, info.normal),
        uv=info.uv,
        instance=torch.where(occluded, hit.inst, info.instance).to(torch.int32),
        material=torch.where(occluded, -1, info.material).to(torch.int32),
    )
