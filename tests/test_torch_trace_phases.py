"""The slab-test phases of the port's large-scene tracers and their
hand-written kernels: phase 1 of the tile walk
(``trace/tiled.tile_cluster_entries``, kernel ``csrc/tile_entries.cu``)
and phases A and B of the scatter tracer (``trace/scatter.scatter_plan``,
kernel ``csrc/scatter_plan.cu``).

On the CPU: a plain-torch restatement of the kernels' slab test as they
run it (``_kernel_test``: the staged table of ``csrc/slab_test.cuh``, each
warp's choice of the test without NaN compares where its 32 rays are all
clean and without range compares where they all take every cluster's
range) equals the twins on rays and clusters chosen to break it; the plan
kernel's decomposition in plain torch (a count launch that keeps per warp
and cluster the ballot of the entered rays and per chunk the counts, the
scan over chunks in ``scatter.plan_bases``, a place launch that ranks each
pair from the masks alone) equals the twin ``scatter_plan_reference`` bit
for bit; rays whose origins lie on cluster faces and rays with NaN or
infinite directions pin the twins' signed-zero and NaN results, which the
kernels must match; the wrappers raise on a device that is neither the
CPU nor CUDA and never run a twin there. The cuda-marked tests hold each
kernel against its twin bit for bit on the card (every float compared by
its bits), also on warps that mix clean and NaN rays, on clusters with
non-finite bounds and on cluster counts that are no multiple of the
kernels' stage of 128 clusters.

The scenes are the small cities of ``test_torch_tiled.py``
(``city_scene(blocks=3, detail=True)``, 18,422 triangles) and
``test_torch_scatter.py`` (``procedural_city(blocks=4)``), compiled by the
port; the twins are held against the JAX package in those two files
(``test_tile_entries_and_sort_equal``, ``test_dropped_items_match_jax``).
Every comparison here is exact."""

import numpy as np
import pytest
import torch

from hikari_tpu_torch.config import F32_MAX
from hikari_tpu_torch.io.scenes import _sun_from_euler, city_scene, procedural_city
from hikari_tpu_torch.scene import compile_scene, to_device
from hikari_tpu_torch.scene.compile import Scene
from hikari_tpu_torch.trace import api as tapi
from hikari_tpu_torch.trace import scatter as tsc
from hikari_tpu_torch.trace import tile_walk as tw
from hikari_tpu_torch.trace import tiled as ttiled
from hikari_tpu_torch.utils import same_bits

torch.set_num_threads(2)

N_RAYS = 1500  # a ragged last chunk at 32 and at 1,024 rays, and a ragged last tile
PHASE1_CLUSTER = 64


@pytest.fixture(scope="module")
def cities():
    """name -> (arrays, CPU buffers): the two small cities."""
    city4 = procedural_city(Scene(materials=[], directional_light=_sun_from_euler(-1, 0.6, 0)),
                            blocks=4)
    out = {}
    for name, scene in (("blocks3_detail", city_scene(blocks=3, detail=True)),
                        ("blocks4", city4)):
        arrays = compile_scene(scene, builder="numpy")
        out[name] = (arrays, to_device(arrays, "cpu"))
    return out


def _rays(arrays, n, seed, ranged):
    """Seeded rays into the small city with random max distances; with
    ``ranged`` half of them keep one instance's prims, and every 50th ray
    has an empty range."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-25, 25, n), rng.uniform(0.5, 22, n), rng.uniform(-25, 25, n)], -1)
    target = np.stack([rng.uniform(-15, 15, n), rng.uniform(0, 15, n), rng.uniform(-15, 15, n)],
                      -1)
    d = target - o + rng.normal(scale=2.0, size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxd = np.where(rng.uniform(size=n) < 0.5, rng.uniform(5, 60, n), 3.0e38)
    P = len(arrays.tri_world)
    lo, hi = np.zeros(n, np.int64), np.full(n, P, np.int64)
    if ranged:
        inst = rng.integers(0, len(arrays.inst_material), n)
        half = rng.uniform(size=n) < 0.5
        lo[half] = arrays.inst_prim_offset[inst[half]]
        hi[half] = lo[half] + arrays.inst_prim_count[inst[half]]
        hi[::50] = lo[::50]
    return [torch.from_numpy(np.ascontiguousarray(x).astype(t)) for x, t in (
        (o, np.float32), (d, np.float32), (maxd, np.float32), (lo, np.int32), (hi, np.int32))]


def _edge_rays(cmin, cmax, cvalid, n_face=256):
    """Rays at the slab test's hazards, (o, d, maxd, lo, hi) on the CPU:
    origins on valid clusters' max corners with negative directions (tlo =
    -0.0), on their min corners with positive directions, on a max face
    with a zero direction component, then NaN directions, NaN origins,
    infinite direction components, NaN and zero max distances. Returns the
    rays, the index ranges of the groups and the cluster of each max-corner
    ray."""
    rng = np.random.default_rng(3)
    ids = torch.nonzero(cvalid)[:, 0].numpy()
    c = ids[rng.integers(0, len(ids), n_face)]
    hi_corner, lo_corner = cmax.numpy()[c], cmin.numpy()[c]
    neg = -rng.uniform(0.2, 1.0, (n_face, 3))
    pos = rng.uniform(0.2, 1.0, (n_face, 3))
    flat = neg.copy()
    flat[:, 1] = 0.0  # inv = 1e20 on y: safe_inv_dir's signed epsilon floor
    o = [hi_corner, lo_corner, hi_corner]
    d = [neg, pos, flat]
    groups = {"max_corner": (0, n_face), "min_corner": (n_face, 2 * n_face),
              "flat_axis": (2 * n_face, 3 * n_face)}
    start = 3 * n_face
    base_o = rng.uniform(-20, 20, (64, 3))
    base_d = rng.normal(size=(64, 3))
    for name, fix in (
        ("nan_dir", lambda o_, d_: (o_, np.where(np.arange(3) == 0, np.nan, d_))),
        ("nan_origin", lambda o_, d_: (np.where(np.arange(3) == 1, np.nan, o_), d_)),
        ("inf_dir", lambda o_, d_: (o_, np.where(np.arange(3) == 2, np.inf, d_))),
        ("nan_maxd", lambda o_, d_: (o_, d_)),
        ("zero_maxd", lambda o_, d_: (o_, d_)),
    ):
        oo, dd = fix(base_o, base_d)
        o.append(oo)
        d.append(dd)
        groups[name] = (start, start + 64)
        start += 64
    o, d = np.concatenate(o).astype(np.float32), np.concatenate(d).astype(np.float32)
    R = o.shape[0]
    maxd = np.full(R, 3.0e38, np.float32)
    maxd[groups["max_corner"][0]:groups["max_corner"][1]:2] = 1e-30  # enters only at 0
    maxd[slice(*groups["nan_maxd"])] = np.nan
    maxd[slice(*groups["zero_maxd"])] = 0.0
    lo = np.zeros(R, np.int32)
    hi = np.full(R, 2**31 - 1, np.int32)
    return [torch.from_numpy(x) for x in (o, d, maxd, lo, hi)], groups, torch.from_numpy(c)


def _hazard_case(arrays, tb, cluster, n=1500, seed=29):
    """Clusters with non-finite bounds and warps that mix clean and unclean
    rays, on the CPU: (cmin, cmax, cvalid, o, d, maxd, lo, hi). Cluster 3
    has a NaN min x, 10 a min x of -inf, 11 a max y of +inf, 12 a min z of
    +inf (above its max), 20 is invalid (clusters 0-4 where there are no
    more than 20). Then the edge rays (warps of one
    kind each) and seeded city rays with prim ranges, of which every 97th
    has an infinite direction component, every 101st a NaN origin
    component and every 103rd a NaN direction (warps of both kinds)."""
    cmin, cmax, cvalid = ttiled.cluster_bounds(tb, cluster)
    edge = _edge_rays(cmin, cmax, cvalid)[0]
    cmin, cmax, cvalid = cmin.clone(), cmax.clone(), cvalid.clone()
    c = (3, 10, 11, 12, 20) if cmin.shape[0] > 20 else tuple(range(5))
    cmin[c[0], 0] = float("nan")
    cmin[c[1], 0] = float("-inf")
    cmax[c[2], 1] = float("inf")
    cmin[c[3], 2] = float("inf")
    cvalid[c[4]] = False
    o, d, maxd, lo, hi = _rays(arrays, n, seed, True)
    d[::97, 0] = float("inf")
    o[::101, 1] = float("nan")
    d[::103, 2] = float("nan")
    rays = [torch.cat([x, y]) for x, y in zip(edge, (o, d, maxd, lo, hi))]
    return (cmin, cmax, cvalid, *rays)


def _pad_tiles(rays):
    """(o, d, maxd, lo, hi) padded to whole 512-ray tiles with inert rays."""
    R = rays[0].shape[0]
    pad = -(-R // ttiled.TILE_R) * ttiled.TILE_R - R
    fills = (0.0, 1.0, 0.0, 0, 0)
    return [torch.cat([x, torch.full((pad,) + x.shape[1:], f, dtype=x.dtype)]) for x, f in
            zip(rays, fills)]


def _bits(x):
    return x.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# 1. Phases A and B: the kernel's decomposition against the twin
# ---------------------------------------------------------------------------


STAGE = 128  # clusters a stage of the kernels' staged table (slab_test.cuh kStage)
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def _slab_table(cmin, cmax, cvalid, cluster, range_dtype):
    """The kernels' staged table (slab_test.cuh ``slab_table_kernel``) in
    torch: (bounds (L, 6): each axis's min, then each axis's max, lo_c
    (L,), hi_c (L,)). A cluster that is invalid or has a NaN bound stages
    +inf bounds and an empty range (lo_c the range type's largest value,
    hi_c its least)."""
    L = cmin.shape[0]
    bounds = torch.cat([torch.fmin(cmin, cmax), torch.fmax(cmin, cmax)], 1)
    ok = cvalid & ~torch.cat([cmin, cmax], 1).isnan().any(1)
    first = torch.arange(L, dtype=torch.int64) * cluster
    if range_dtype == torch.float32:
        big, least = float("inf"), float("-inf")
    else:
        big, least = INT32_MAX, INT32_MIN
    lo_c = torch.where(ok, first.to(range_dtype), torch.tensor(big, dtype=range_dtype))
    hi_c = torch.where(ok, (first + cluster).to(range_dtype), torch.tensor(least, dtype=range_dtype))
    return torch.where(ok[:, None], bounds, float("inf")), lo_c, hi_c


def _kernel_test(cmin, cmax, cvalid, o, inv, maxd, lo, hi, cluster, range_dtype, full,
                 choose=True):
    """The slab test as the kernels run it, in torch: (hit (R, L), entry
    (R, L) f32, the rays' warp path (R,): 0 clean, full range and one
    octant; 1 clean and full range; 2 clean; 3 with NaN compares). The
    staged table; NaN-dropping min/max (fminf, fmaxf: torch.fmin,
    torch.fmax); the entry as the signed-int max of tlo's bits and 0. Per
    warp of 32 rays (the last one padded with rays that are clean, take
    every range and enter nothing): the NaN compares unless every ray is
    clean, the range compares unless, besides, every ray takes every
    cluster's range, and the per-axis min and max unless, besides, every
    ray has the signs of lane 0's inv (then the near and far bound of each
    axis by the sign). ``lo``/``hi`` are the ray ranges in ``range_dtype``
    (f32 for phase 1, int32 for phase A); a ray takes every cluster's range
    where lo < full[0] and hi > full[1] (phase 1: (1, num_prims - 1);
    phase A: (cluster, (L - 1) * cluster)). With ``choose`` False every warp
    takes the test without NaN and range compares, which is right only
    where the choice would have taken it."""
    R, L = o.shape[0], cmin.shape[0]
    bounds, lo_c, hi_c = _slab_table(cmin, cmax, cvalid, cluster, range_dtype)
    pad = -(-R // 32) * 32 - R
    if range_dtype == torch.float32:
        dead_lo, dead_hi = float("-inf"), float("inf")
    else:
        dead_lo, dead_hi = INT32_MIN, INT32_MAX
    o = torch.cat([o, torch.zeros((pad, 3))])
    inv = torch.cat([inv, torch.ones((pad, 3))])
    maxd = torch.cat([maxd, torch.full((pad,), float("-inf"))])
    lo = torch.cat([lo, torch.full((pad,), dead_lo, dtype=range_dtype)])
    hi = torch.cat([hi, torch.full((pad,), dead_hi, dtype=range_dtype)])
    a = (bounds[None, :, :3] - o[:, None]) * inv[:, None]  # (R, L, 3)
    b = (bounds[None, :, 3:] - o[:, None]) * inv[:, None]
    nan = (a.isnan() | b.isnan()).any(-1)
    clean = torch.isfinite(o).all(1) & torch.isfinite(inv).all(1) & (inv != 0).all(1)
    full = (lo < torch.tensor(full[0]).to(range_dtype)) & (
        hi > torch.tensor(full[1]).to(range_dtype))
    sign = inv < 0
    warp_clean = clean.reshape(-1, 32).all(1).repeat_interleave(32)
    warp_full = full.reshape(-1, 32).all(1).repeat_interleave(32)
    warp_oct = (sign.reshape(-1, 32, 3) == sign.reshape(-1, 32, 3)[:, :1]).all(2).all(1)
    warp_oct = warp_oct.repeat_interleave(32)
    if not choose:
        warp_clean = warp_full = torch.ones_like(clean)
    skip_range = warp_clean & warp_full
    octant = skip_range & warp_oct
    lo3, hi3 = torch.fmin(a, b), torch.fmax(a, b)
    near = torch.where(sign[:, None], b, a)  # inv < 0: the max bound is near
    far = torch.where(sign[:, None], a, b)
    lo3 = torch.where(octant[:, None, None], near, lo3)
    hi3 = torch.where(octant[:, None, None], far, hi3)
    tlo = torch.fmax(torch.fmax(lo3[..., 0], lo3[..., 1]), lo3[..., 2])
    thi = torch.fmin(torch.fmin(hi3[..., 0], hi3[..., 1]), hi3[..., 2])
    entry = torch.clamp(tlo.contiguous().view(torch.int32), min=0).view(torch.float32)
    hit = (thi >= entry) & (entry < maxd[:, None])
    in_range = (lo_c[None] < hi[:, None]) & (hi_c[None] > lo[:, None])
    hit = hit & (~nan | warp_clean[:, None]) & (in_range | skip_range[:, None])
    path = torch.where(octant, 0, torch.where(skip_range, 1, torch.where(warp_clean, 2, 3)))
    return hit[:R], entry[:R], path[:R]


def _kernel_entries(cmin, cmax, cvalid, o, inv, maxd, lo=None, hi=None, cluster=0, num_prims=0,
                    choose=True):
    """Phase 1 as its kernel runs it (``_kernel_test`` in f32) on clusters
    in prim order (``tiled.prim_ranges``): (entries (T, L), ray_maxent
    (R,), the warp paths (R,))."""
    R = o.shape[0]
    if lo is None:
        lo, hi = torch.full((R,), float("-inf")), torch.full((R,), float("inf"))
    else:
        lo, hi = lo.to(torch.float32), hi.to(torch.float32)
    hit, entry, path = _kernel_test(cmin, cmax, cvalid, o, inv, maxd, lo, hi, cluster,
                                    torch.float32, (1, num_prims - 1), choose)
    entries = torch.where(hit, entry, F32_MAX).reshape(R // ttiled.TILE_R, ttiled.TILE_R, -1)
    return entries.amin(dim=1), torch.where(hit, entry, -1.0).amax(dim=1), path


def _decomposed_plan(cmin, cmax, cvalid, o, d, maxd, lo, hi, items_per_ray, chunk):
    """The plan kernel's decomposition in plain torch. The count launch:
    the kernels' slab test (``_kernel_test``, int ranges) once a (ray,
    cluster) pair, kept as each 32-ray warp's ballot of each cluster, masks
    (ceil(R/32), L) as u32 values, and per chunk of ``chunk`` rays and
    cluster the entered pairs (the masks' popcounts). ``scatter.plan_bases``
    (the wrapper's step between the two launches). The place launch, from
    the masks alone: each pair at its chunk's base plus the popcounts of
    the warps below in the chunk plus the bits below in its own mask."""
    R, L = o.shape[0], cmin.shape[0]
    hit = _kernel_test(cmin, cmax, cvalid, o, ttiled.safe_inv_dir(d), maxd, lo, hi, tsc.CLUSTER,
                       torch.int32, (tsc.CLUSTER, (L - 1) * tsc.CLUSTER))[0]
    nw, nch = -(-R // 32), -(-R // chunk)
    lane = torch.arange(32, dtype=torch.int64)
    bits = torch.zeros((nw * 32, L), dtype=torch.int64)
    bits[:R] = hit.to(torch.int64)
    masks = (bits.reshape(nw, 32, L) << lane[None, :, None]).sum(dim=1)  # (nw, L) u32 values
    # Everything below reads only the masks.
    wpc = chunk // 32
    rows = torch.zeros((nch * wpc, L), dtype=torch.int64)
    rows[:nw] = masks
    bit = (rows[:, None, :] >> lane[None, :, None]) & 1  # (rows, 32, L)
    pop = bit.sum(dim=1).reshape(nch, wpc, L)
    counts = pop.sum(dim=1).to(torch.int32)
    meta, base, cap, dropped = tsc.plan_bases(counts, R, items_per_ray)
    bit = bit.reshape(nch, wpc, 32, L)
    below_in_mask = torch.cumsum(bit, dim=2) - bit
    warps_below = (torch.cumsum(pop, dim=1) - pop)[:, :, None, :]
    slot = base.to(torch.int64)[:, None, None, :] + warps_below + below_in_mask
    ray = torch.arange(nch * chunk).reshape(nch, wpc, 32, 1).expand_as(slot)
    keep = (bit == 1) & (slot < cap)
    items = torch.full((cap,), -1, dtype=torch.int64)
    items[slot[keep]] = ray[keep]
    return meta, items, int(dropped)


@pytest.mark.parametrize("scene_name", ["blocks3_detail", "blocks4"])
@pytest.mark.parametrize("ranged", [False, True])
@pytest.mark.parametrize("items_per_ray", [32, 2, 1])
@pytest.mark.parametrize("chunk", [32, 1024])
def test_plan_decomposition_equals_twin(cities, scene_name, chunk, items_per_ray, ranged):
    arrays, tb = cities[scene_name]
    _, cmin, cmax, cvalid = tw.pack_clusters(tb, tsc.CLUSTER)
    o, d, maxd, lo, hi = _rays(arrays, N_RAYS, 23, ranged)
    assert N_RAYS % chunk
    want = tsc.scatter_plan_reference(cmin, cmax, cvalid, o, d, maxd, lo, hi, items_per_ray)
    got = _decomposed_plan(cmin, cmax, cvalid, o, d, maxd, lo, hi, items_per_ray, chunk)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert got[2] == want[2]
    entered = int(want[0][:, 1].sum()) + want[2]
    assert entered > 2 * N_RAYS
    if items_per_ray == 32:
        assert want[2] == 0
    elif not ranged or (scene_name, items_per_ray) == ("blocks4", 1):
        assert want[2] > 0  # drops (ranged rays enter fewer clusters)
    # The wrapper on CPU tensors is the twin.
    plain = tsc.scatter_plan(cmin, cmax, cvalid, o, d, maxd, lo, hi, items_per_ray)
    assert all(torch.equal(a, b) for a, b in zip(plain[:2], want[:2])) and plain[2] == want[2]


@pytest.mark.parametrize("scene_name", ["blocks3_detail", "blocks4"])
@pytest.mark.parametrize("phase", ["entries", "plan"])
def test_kernel_test_equals_twins_on_hazards(cities, phase, scene_name):
    """The kernels' slab test (``_kernel_test``) against the twins on
    clusters with non-finite bounds and warps that mix clean and unclean
    rays: the entered pairs (phase A, int ranges) or the entries and max
    entries bit for bit, with and without prim ranges (phase 1, f32
    ranges). All four warp paths run. Without the choice of path (every
    warp testing without NaN and range compares) some pair differs from
    the twin: the clean-ray predicate is what keeps the short test
    exact. The small city has 288 / 144 clusters (no multiple of the
    kernels' stage of 128), the 4-block one 16 / 8 (less than a stage)."""
    arrays, tb = cities[scene_name]
    cluster = PHASE1_CLUSTER if phase == "entries" else tsc.CLUSTER
    cmin, cmax, cvalid, o, d, maxd, lo, hi = _hazard_case(arrays, tb, cluster)
    assert cmin.shape[0] % STAGE
    if phase == "plan":
        inv = ttiled.safe_inv_dir(d)
        want = tsc._chunk_mask(cmin, cmax, cvalid, o, inv, maxd, lo, hi)
        full = (cluster, (cmin.shape[0] - 1) * cluster)
        got, _, path = _kernel_test(cmin, cmax, cvalid, o, inv, maxd, lo, hi, cluster, torch.int32,
                                    full)
        assert torch.equal(got, want)
        assert want.sum() > o.shape[0]
        short = _kernel_test(cmin, cmax, cvalid, o, inv, maxd, lo, hi, cluster, torch.int32, full,
                             choose=False)[0]
        assert not torch.equal(short, want)
    else:
        o, d, maxd, lo, hi = _pad_tiles([o, d, maxd, lo, hi])
        inv = ttiled.safe_inv_dir(d)
        differs = False
        prange = ttiled.prim_ranges(cmin.shape[0], cluster, "cpu")
        for rng in ((lo, hi), (None, None)):
            ranges = (prange, tb.num_tris) if rng[0] is not None else (None, 0)
            want = ttiled.tile_cluster_entries_reference(cmin, cmax, cvalid, o, inv, maxd, *rng,
                                                         *ranges)
            got = _kernel_entries(cmin, cmax, cvalid, o, inv, maxd, *rng, cluster=cluster,
                                  num_prims=tb.num_tris)
            assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
            short = _kernel_entries(cmin, cmax, cvalid, o, inv, maxd, *rng, cluster=cluster,
                                    num_prims=tb.num_tris, choose=False)
            differs |= not (same_bits(short[0], want[0]) and same_bits(short[1], want[1]))
            if rng[0] is not None:
                path = got[2]
        assert differs
    assert set(path.tolist()) == {0, 1, 2, 3}


def test_plan_bases_clamps_and_counts_drops():
    """``plan_bases`` on hand-made counts: the bases of a run that starts
    past CAP clamp to CAP, and the drops are each run's pairs past CAP."""
    counts = torch.tensor([[3, 0, 200], [2, 1, 90]], dtype=torch.int32)  # 2 chunks, 3 clusters
    R, ipr = 4, 32  # CAP = 128 + 3 * 128 = 512
    meta, base, cap, dropped = tsc.plan_bases(counts, R, ipr)
    assert cap == tsc.capacity(R, 3, ipr) == 512
    # Runs: cluster 0 at 0 (5 pairs), 1 at 128 (1), 2 at 256 (290 pairs: 34 past CAP).
    assert base.tolist() == [[0, 128, 256], [3, 128, 456]]
    assert int(dropped) == 290 - (512 - 256)
    assert meta[:, 0].tolist() == [0, 1, 2, 2]
    assert meta[:, 1].tolist() == [5, 1, 128, 128]


# ---------------------------------------------------------------------------
# 2. The twins' signed-zero and NaN results, which the kernels match
# ---------------------------------------------------------------------------


def test_entries_signed_zero_and_nan_pinned(cities):
    """Phase 1's twin on the edge rays: a ray from a cluster's max corner
    with a negative direction has tlo = -0.0 (checked), and its entry into
    that cluster is +0.0 (bits 0), as is the max entry of a ray that enters
    only at 0; rays with a NaN direction or origin, or a NaN or zero max
    distance, enter nothing (max entry -1), and a tile of them only holds
    F32_MAX; an infinite direction component (inv = 0) still enters."""
    _, tb = cities["blocks3_detail"]
    cmin, cmax, cvalid = ttiled.cluster_bounds(tb, PHASE1_CLUSTER)
    rays, groups, corner = _edge_rays(cmin, cmax, cvalid)
    o, d, maxd, lo, hi = _pad_tiles(rays)
    inv = ttiled.safe_inv_dir(d)
    prange = ttiled.prim_ranges(cmin.shape[0], PHASE1_CLUSTER, "cpu")
    entries, maxent = ttiled.tile_cluster_entries(cmin, cmax, cvalid, o, inv, maxd, lo, hi,
                                                  prange, tb.num_tris)
    s, e = groups["max_corner"]
    assert s == 0 and e <= ttiled.TILE_R  # tile 0 starts with these rays
    # The twin's slab test without the +0.0, at each ray's own cluster.
    a = (cmin[corner] - o[s:e]) * inv[s:e]
    b = (cmax[corner] - o[s:e]) * inv[s:e]
    raw = torch.clamp(torch.minimum(a, b).amax(dim=-1), min=0.0)
    assert (_bits(raw) == torch.iinfo(torch.int32).min).all()  # -0.0, which the +0.0 removes
    assert (_bits(entries[0, corner]) == 0).all()
    assert (_bits(maxent[s:e:2]) == 0).all()  # maxd 1e-30: entries at 0 only
    for k in ("nan_dir", "nan_origin", "nan_maxd", "zero_maxd"):
        assert (maxent[slice(*groups[k])] == -1.0).all(), k
    assert torch.isfinite(maxent).all()
    # A tile of NaN-direction rays only.
    nan_tile = [x[groups["nan_dir"][0]:groups["nan_dir"][1]].repeat((8,) + (1,) * (x.dim() - 1))
                for x in (o, d, maxd, lo, hi)]
    e_nan, m_nan = ttiled.tile_cluster_entries(
        cmin, cmax, cvalid, nan_tile[0], ttiled.safe_inv_dir(nan_tile[1]), *nan_tile[2:],
        prange, tb.num_tris)
    assert (e_nan == F32_MAX).all() and (m_nan == -1.0).all()


def test_plan_nan_rays_enter_nothing(cities):
    """The plan twin on the edge rays: rays with a NaN direction, origin
    or max distance, or a zero max distance, get no slot; rays from max
    corners do (an entry of 0 < maxd)."""
    _, tb = cities["blocks3_detail"]
    _, cmin, cmax, cvalid = tw.pack_clusters(tb, tsc.CLUSTER)
    (o, d, maxd, lo, hi), groups, _ = _edge_rays(cmin, cmax, cvalid)
    # items_per_ray = L leaves a slot for every pair.
    meta, items, dropped = tsc.scatter_plan(cmin, cmax, cvalid, o, d, maxd, lo, hi,
                                            items_per_ray=cmin.shape[0])
    assert dropped == 0
    placed = torch.zeros(o.shape[0], dtype=torch.bool)
    placed[items[items >= 0]] = True
    for k in ("nan_dir", "nan_origin", "nan_maxd", "zero_maxd"):
        assert not placed[slice(*groups[k])].any(), k
    assert placed[slice(*groups["max_corner"])].all()


# ---------------------------------------------------------------------------
# 3. The wrappers: the twin only on the CPU, a kernel or an error elsewhere
# ---------------------------------------------------------------------------


def test_wrappers_raise_off_cpu_and_cuda(cities, monkeypatch):
    """On a device that is neither the CPU nor CUDA both wrappers raise
    NotImplementedError and never reach their twins (patched to fail);
    on the CPU they count no launch."""
    _, tb = cities["blocks4"]
    _, cmin, cmax, cvalid = tw.pack_clusters(tb, tsc.CLUSTER)
    R = ttiled.TILE_R
    o = torch.zeros((R, 3))
    d = torch.ones((R, 3))
    maxd = torch.ones((R,))
    lo, hi = torch.zeros((R,), dtype=torch.int32), torch.ones((R,), dtype=torch.int32)
    launches = (ttiled.launches, tsc.plan_launches)
    prange = ttiled.prim_ranges(cmin.shape[0], tsc.CLUSTER, "cpu")
    ttiled.tile_cluster_entries(cmin, cmax, cvalid, o, d, maxd, lo, hi, prange, tb.num_tris)
    tsc.scatter_plan(cmin, cmax, cvalid, o, d, maxd, lo, hi)
    assert (ttiled.launches, tsc.plan_launches) == launches

    def fail(*args, **kwargs):
        raise AssertionError("a twin ran on a device that is not the CPU")

    monkeypatch.setattr(ttiled, "tile_cluster_entries_reference", fail)
    monkeypatch.setattr(tsc, "scatter_plan_reference", fail)
    meta = [x.to("meta") for x in (cmin, cmax, cvalid, o, d, maxd, lo, hi)]
    with pytest.raises(NotImplementedError, match="tile_cluster_entries"):
        ttiled.tile_cluster_entries(*meta, prange.to("meta"), tb.num_tris)
    with pytest.raises(NotImplementedError, match="scatter_plan"):
        tsc.scatter_plan(*meta)
    assert (ttiled.launches, tsc.plan_launches) == launches


# ---------------------------------------------------------------------------
# 4. The kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the phase kernels have no CPU mode")
    return torch.device("cuda", 0)


def _entries_cases(arrays, tb):
    """(label, cmin, cmax, cvalid, o, d, maxd, lo, hi, cluster) on the CPU."""
    cases = []
    for cluster in (64, 256):
        cmin, cmax, cvalid = ttiled.cluster_bounds(tb, cluster)
        o, d, maxd, lo, hi = _pad_tiles(_rays(arrays, 65536 - 300, 41, True))
        cases.append((f"city rays, cluster {cluster}", cmin, cmax, cvalid, o, d, maxd, lo, hi,
                      cluster))
        edge = _edge_rays(cmin, cmax, cvalid)[0]
        cases.append((f"edge rays, cluster {cluster}", cmin, cmax, cvalid, *_pad_tiles(edge),
                      cluster))
        hz = _hazard_case(arrays, tb, cluster, n=20000)
        cases.append((f"mixed warps, non-finite bounds, cluster {cluster}", *hz[:3],
                      *_pad_tiles(hz[3:]), cluster))
    return cases


@pytest.mark.cuda
def test_tile_entries_kernel_matches_twin_on_card(cities, cuda_device):
    """Entries and max entries bit for bit, with and without the prim
    range, with and without a per-ray box margin, and the stable sort of
    the entries equal; two launches a call (the staged table, the tests).
    The cases include warps that mix clean and NaN rays and clusters with
    non-finite bounds or a min above the max (``_hazard_case``); 288 and
    72 clusters, neither a multiple of the kernel's stage of 128."""
    arrays, tb = cities["blocks3_detail"]
    g = torch.Generator().manual_seed(7)
    for label, cmin, cmax, cvalid, o, d, maxd, lo, hi, cluster in _entries_cases(arrays, tb):
        inv = ttiled.safe_inv_dir(d)
        prange = ttiled.prim_ranges(cmin.shape[0], cluster, "cpu")
        grown = torch.rand(o.shape[0], generator=g) * 0.5
        for ranged, margin in ((False, None), (True, None), (False, grown), (True, grown)):
            rng_args = (lo, hi, prange) if ranged else (None, None, None)
            num_prims = tb.num_tris if ranged else 0
            want = ttiled.tile_cluster_entries(cmin, cmax, cvalid, o, inv, maxd, *rng_args,
                                               num_prims, margin)
            dev_args = [x.to(cuda_device) if x is not None else None
                        for x in (cmin, cmax, cvalid, o, inv, maxd, *rng_args)]
            before = ttiled.launches
            got = ttiled.tile_cluster_entries(*dev_args, num_prims,
                                              margin.to(cuda_device) if margin is not None
                                              else None)
            torch.cuda.synchronize()
            assert ttiled.launches == before + 2
            for g_, w in zip(got, want):
                assert same_bits(g_.cpu(), w), (label, ranged, margin is not None)
            assert torch.equal(torch.sort(got[0], dim=1, stable=True)[1].cpu(),
                               torch.sort(want[0], dim=1, stable=True)[1])


@pytest.mark.cuda
def test_scatter_plan_kernel_matches_twin_on_card(cities, cuda_device):
    """meta, items and the dropped count bit for bit: city rays with and
    without prim ranges, a ragged last chunk, drops (items_per_ray=2), the
    edge rays, and warps that mix clean and NaN rays over clusters with
    non-finite bounds; 144 and 8 clusters (no multiple of the kernel's
    stage of 128); one plan (three launches: table, count, place) a call, and
    ``trace_rays(method="scatter")`` and ``method="pallas_tiled"`` go
    through the phase kernels."""
    for name in ("blocks3_detail", "blocks4"):
        arrays, tb = cities[name]
        _, cmin, cmax, cvalid = tw.pack_clusters(tb, tsc.CLUSTER)
        cases = [(f"{name} ranged={r} ipr={ipr}", _rays(arrays, 65536 - 300, 43, r), ipr)
                 for r in (False, True) for ipr in (32, 2)]
        cases.append((f"{name} edge rays", _edge_rays(cmin, cmax, cvalid)[0], 32))
        bounds = (cmin, cmax, cvalid)
        if name == "blocks3_detail":
            hz = _hazard_case(arrays, tb, tsc.CLUSTER, n=40000)
            cases.append((f"{name} mixed warps, non-finite bounds", hz, 32))
        for label, rays, ipr in cases:
            c_args, rays = (rays[:3], rays[3:]) if len(rays) == 8 else (bounds, rays)
            want = tsc.scatter_plan(*c_args, *rays, ipr)
            dev_args = [x.to(cuda_device) for x in (*c_args, *rays)]
            before = tsc.plan_launches
            got = tsc.scatter_plan(*dev_args, items_per_ray=ipr)
            torch.cuda.synchronize()
            assert tsc.plan_launches == before + 3
            assert torch.equal(got[0].cpu(), want[0]), label
            assert torch.equal(got[1].cpu(), want[1]), label
            assert got[2] == want[2], label
            if ipr == 2 and "ranged=False" in label:
                assert want[2] > 0, label
    tb_dev = to_device(cities["blocks3_detail"][0], cuda_device)
    o, d = (x.to(cuda_device) for x in _rays(cities["blocks3_detail"][0], 4096, 5, False)[:2])
    before = (ttiled.launches, tsc.plan_launches)
    tapi.trace_rays(tb_dev, o, d, method="scatter")
    tapi.trace_rays(tb_dev, o, d, method="pallas_tiled")
    assert (ttiled.launches, tsc.plan_launches) == (before[0] + 2, before[1] + 3)
