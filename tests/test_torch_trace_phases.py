"""The slab-test phases of the port's large-scene tracers and their
hand-written kernels: phase 1 of the tile walk
(``trace/tiled.tile_cluster_entries``, kernel ``csrc/tile_entries.cu``)
and phases A and B of the scatter tracer (``trace/scatter.scatter_plan``,
kernel ``csrc/scatter_plan.cu``).

On the CPU: a plain-torch restatement of the plan kernel's decomposition
(per-chunk counts, the scan over chunks in ``scatter.plan_bases``, each
pair's rank in its chunk as the kernel's warp ballots count it) equals the
twin ``scatter_plan_reference`` bit for bit; rays whose origins lie on
cluster faces and rays with NaN or infinite directions pin the twins'
signed-zero and NaN results, which the kernels must match; the wrappers
raise on a device that is neither the CPU nor CUDA and never run a twin
there. The cuda-marked tests hold each kernel against its twin bit for bit
on the card (every float compared by its bits).

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


def _decomposed_plan(cmin, cmax, cvalid, o, d, maxd, lo, hi, items_per_ray, chunk):
    """The plan kernel's decomposition in plain torch: the entered mask per
    chunk of ``chunk`` rays (32-lane warps), its counts per (chunk,
    cluster), ``scatter.plan_bases`` (the wrapper's step between the two
    launches), then each pair at its chunk's base plus the entered rays
    before it in the chunk: the lanes below in its warp (popc of the
    ballot) plus the warps below."""
    R, L = o.shape[0], cmin.shape[0]
    nch = -(-R // chunk)
    mask = torch.zeros((nch * chunk, L), dtype=torch.bool)
    mask[:R] = tsc._chunk_mask(cmin, cmax, cvalid, o, ttiled.safe_inv_dir(d), maxd, lo, hi)
    mask = mask.reshape(nch, chunk // 32, 32, L)
    counts = mask.sum(dim=(1, 2), dtype=torch.int32)
    meta, base, cap, dropped = tsc.plan_bases(counts, R, items_per_ray)
    m = mask.to(torch.int64)
    lanes_below = torch.cumsum(m, dim=2) - m
    warp_total = m.sum(dim=2, keepdim=True)
    warps_below = torch.cumsum(warp_total, dim=1) - warp_total
    slot = base.to(torch.int64)[:, None, None, :] + warps_below + lanes_below
    ray = torch.arange(nch * chunk).reshape(nch, chunk // 32, 32, 1).expand_as(slot)
    keep = mask & (slot < cap)
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
    entries, maxent = ttiled.tile_cluster_entries(cmin, cmax, cvalid, o, inv, maxd, lo, hi,
                                                  cluster=PHASE1_CLUSTER)
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
        cluster=PHASE1_CLUSTER)
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
    ttiled.tile_cluster_entries(cmin, cmax, cvalid, o, d, maxd, lo, hi, cluster=tsc.CLUSTER)
    tsc.scatter_plan(cmin, cmax, cvalid, o, d, maxd, lo, hi)
    assert (ttiled.launches, tsc.plan_launches) == launches

    def fail(*args, **kwargs):
        raise AssertionError("a twin ran on a device that is not the CPU")

    monkeypatch.setattr(ttiled, "tile_cluster_entries_reference", fail)
    monkeypatch.setattr(tsc, "scatter_plan_reference", fail)
    meta = [x.to("meta") for x in (cmin, cmax, cvalid, o, d, maxd, lo, hi)]
    with pytest.raises(NotImplementedError, match="tile_cluster_entries"):
        ttiled.tile_cluster_entries(*meta, cluster=tsc.CLUSTER)
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
    return cases


@pytest.mark.cuda
def test_tile_entries_kernel_matches_twin_on_card(cities, cuda_device):
    """Entries and max entries bit for bit, with and without the prim
    range, and the stable sort of the entries equal; one launch a call."""
    arrays, tb = cities["blocks3_detail"]
    for label, cmin, cmax, cvalid, o, d, maxd, lo, hi, cluster in _entries_cases(arrays, tb):
        inv = ttiled.safe_inv_dir(d)
        for ranged in (False, True):
            rng_args = (lo, hi) if ranged else (None, None)
            want = ttiled.tile_cluster_entries(cmin, cmax, cvalid, o, inv, maxd, *rng_args,
                                               cluster=cluster)
            dev_args = [x.to(cuda_device) if x is not None else None
                        for x in (cmin, cmax, cvalid, o, inv, maxd, *rng_args)]
            before = ttiled.launches
            got = ttiled.tile_cluster_entries(*dev_args, cluster=cluster)
            torch.cuda.synchronize()
            assert ttiled.launches == before + 1
            for g, w in zip(got, want):
                assert same_bits(g.cpu(), w), (label, ranged)
            assert torch.equal(torch.sort(got[0], dim=1, stable=True)[1].cpu(),
                               torch.sort(want[0], dim=1, stable=True)[1])


@pytest.mark.cuda
def test_scatter_plan_kernel_matches_twin_on_card(cities, cuda_device):
    """meta, items and the dropped count bit for bit: city rays with and
    without prim ranges, a ragged last chunk, drops (items_per_ray=2) and
    the edge rays; one plan a call, and ``trace_rays(method="scatter")``
    and ``method="pallas_tiled"`` go through the phase kernels."""
    for name in ("blocks3_detail", "blocks4"):
        arrays, tb = cities[name]
        _, cmin, cmax, cvalid = tw.pack_clusters(tb, tsc.CLUSTER)
        cases = [(f"{name} ranged={r} ipr={ipr}", _rays(arrays, 65536 - 300, 43, r), ipr)
                 for r in (False, True) for ipr in (32, 2)]
        cases.append((f"{name} edge rays", _edge_rays(cmin, cmax, cvalid)[0], 32))
        for label, rays, ipr in cases:
            want = tsc.scatter_plan(cmin, cmax, cvalid, *rays, ipr)
            dev_args = [x.to(cuda_device) for x in (cmin, cmax, cvalid, *rays)]
            before = tsc.plan_launches
            got = tsc.scatter_plan(*dev_args, items_per_ray=ipr)
            torch.cuda.synchronize()
            assert tsc.plan_launches == before + 2
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
    assert (ttiled.launches, tsc.plan_launches) == (before[0] + 1, before[1] + 2)
