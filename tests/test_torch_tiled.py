"""Parity of the PyTorch port's large-scene path with ``hikari_tpu``: the
mesh builders and the procedural city, the C++ BVH builder, phase 1 of the
tile walk (``trace/tiled.py``) and the ray sort, the tile-walk twin
(``trace/tile_walk.tile_walk_reference``, what runs for CPU tensors)
against K2 (``trace_pallas_tiled``) in interpret mode, ``trace_rays``
dispatch above 2048 triangles, and whole frames of a small city. One
scene compile (the JAX package's) feeds both packages.

Tolerances: ids, scenes, BVHs, cluster bounds, entries and sort orders
are equal (the same float operations in the same order); walk results
have prim/inst equal, t within 1e-5 relative + 1e-6 absolute and u/v
within 1e-5 — XLA's CPU compiler contracts the JAX side's multiply-adds
into FMAs, while the twin rounds every operation (the CUDA kernel matches
the twin bit for bit; see the cuda-marked test). Frames: the image
tolerance of ``test_torch_pipeline.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu.config as jc
import hikari_tpu_torch.config as tc
from hikari_tpu.io import scenes as jscenes
from hikari_tpu.scene.buffers import to_device as jax_to_device
from hikari_tpu.scene.compile import Scene as JScene
from hikari_tpu.scene.compile import compile_scene as jax_compile
from hikari_tpu.trace import api as japi
from hikari_tpu.trace import pallas_tiled as jpt
from hikari_tpu.trace import tiled as jtiled
from hikari_tpu_torch.io import scenes as tscenes
from hikari_tpu_torch.scene.buffers import to_device as torch_to_device
from hikari_tpu_torch.trace import api as tapi
from hikari_tpu_torch.trace import intersect as tint
from hikari_tpu_torch.trace import tile_walk as tw
from hikari_tpu_torch.trace import tiled as ttiled
from hikari_tpu_torch.utils import map_tensors

torch.set_num_threads(2)

WALK_CASES = [(64, False), (128, True), (256, True)]


def _jax_city(blocks, detail):
    """The JAX package's City scene as ``gltf_scene("City")`` builds it
    without assets, at ``blocks`` x ``blocks``."""
    scene = JScene(materials=[], directional_light=jscenes._sun_from_euler(-1.0, 0.6, 0.0, 10000.0))
    return jscenes.procedural_city(scene, blocks=blocks, detail=detail)


@pytest.fixture(scope="module")
def city():
    """procedural_city(blocks=3, detail=True): 18,422 triangles, 5 lamps."""
    arrays = jax_compile(_jax_city(3, True))
    return arrays, jax_to_device(arrays), torch_to_device(arrays, "cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# 1. Meshes and the procedural city
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "name,args",
    [("plane_mesh", (3.0,)), ("building_mesh", (8, 5, 3)), ("building_mesh", (12, 4, 6)),
     ("uv_sphere_mesh", (1.0, 12, 6)), ("uv_sphere_mesh", (2.0, 36, 18))],
)
def test_mesh_builders_equal(name, args):
    from hikari_tpu.scene import mesh as jmesh
    from hikari_tpu_torch.scene import mesh as tmesh

    want, got = getattr(jmesh, name)(*args), getattr(tmesh, name)(*args)
    for f in ("positions", "normals", "uvs", "indices"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def _assert_scenes_equal(want, got):
    assert len(got.meshes) == len(want.meshes)
    for a, b in zip(want.meshes, got.meshes):
        for f in ("positions", "normals", "uvs", "indices"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    assert [dataclasses.asdict(m) for m in got.materials] == [
        dataclasses.asdict(m) for m in want.materials
    ]
    assert len(got.instances) == len(want.instances)
    for a, b in zip(want.instances, got.instances):
        assert (b.mesh, b.material) == (a.mesh, a.material)
        np.testing.assert_array_equal(b.transform, a.transform)
        np.testing.assert_array_equal(b.previous_transform, a.previous_transform)
    np.testing.assert_array_equal(
        got.directional_light.direction_to_light, want.directional_light.direction_to_light
    )
    assert tuple(got.directional_light.color) == tuple(want.directional_light.color)
    assert tuple(got.ambient_color) == tuple(want.ambient_color)


@pytest.mark.parametrize("detail", [False, True])
def test_procedural_city_equal(detail):
    _assert_scenes_equal(_jax_city(3, detail), tscenes.city_scene(blocks=3, detail=detail))


def test_city_config_matches():
    """``city_config`` at its full size: the same scene (blocks=16, 343
    instances), camera and settings as the JAX package's."""
    jscene, jcam, js = jscenes.city_config(512, 512)
    tscene, tcam, ts = tscenes.city_config(512, 512, device="cpu")
    _assert_scenes_equal(jscene, tscene)
    assert len(tscene.instances) == 343
    np.testing.assert_array_equal(tcam.world_from_view.numpy(), np.asarray(jcam.world_from_view))
    assert (ts.width, ts.height, ts.denoise) == (js.width, js.height, js.denoise)
    assert (ts.upscale.mode.value, ts.upscale.ratio) == (js.upscale.mode.value, js.upscale.ratio)


# ---------------------------------------------------------------------------
# 2. The C++ builder
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_native():
    """The JAX package's C++ builder. Its build writes one fixed temporary
    file, and a process whose build or load loses a race with another
    test process building it at the same time keeps None for good. So on
    None, wait (at most 120 s) until the other process's library is in
    place — newer than the source, no temporary file left — then clear the
    failure flag and load it; no second g++ is started meanwhile. At the
    deadline it loads, or builds, once more. Skips only where there is no
    g++; fails if the builder still does not load."""
    import os
    import shutil
    import time

    from hikari_tpu.scene import native

    if shutil.which("g++") is None:
        pytest.skip("no g++: the JAX package's C++ builder cannot build here")
    builder = native.get_builder()
    deadline = time.monotonic() + 120.0
    while builder is None:
        last = time.monotonic() > deadline
        lib = native._LIB
        fresh = os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(native._SRC)
        if last or (fresh and not os.path.exists(lib + ".tmp")):
            native._builder_failed = False
            builder = native.get_builder()
        if builder is None and last:
            pytest.fail("the JAX package's C++ builder did not build or load within 120 s")
        if builder is None:
            time.sleep(0.5)
    return builder


@pytest.mark.parametrize("n", [1, 7, 300, 4000])
def test_native_bvh_matches_jax(jax_native, n):
    from hikari_tpu_torch.scene.bvh import build_flat_bvh, validate_flat_bvh

    rng = np.random.default_rng(n)
    lo = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 1.0, (n, 3)).astype(np.float32)
    want, got = jax_native.build(lo, hi), build_flat_bvh(lo, hi, "native")
    validate_flat_bvh(got, n)
    for f in ("mins", "maxs", "entry", "exit", "inst"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_native_alias_matches_jax(jax_native):
    from hikari_tpu_torch.scene.alias import alias_sample_pdf, build_alias_table

    areas = np.random.default_rng(3).uniform(0.01, 3.0, 1001).astype(np.float32)
    prob, index = build_alias_table(areas, "native")
    jprob, jindex = jax_native.build_alias_table(areas)
    np.testing.assert_array_equal(prob, jprob)
    np.testing.assert_array_equal(index, jindex)
    np.testing.assert_allclose(alias_sample_pdf(prob, index), areas / areas.sum(), rtol=1e-4)


def test_native_city_compile_matches_jax(jax_native, city):
    """The port's compile of its own small detailed city with the C++
    builder equals the JAX package's compile (C++ builder too), field by
    field: the triangle order follows the builder."""
    from hikari_tpu_torch.scene.compile import compile_scene

    want, got = city[0], compile_scene(tscenes.city_scene(blocks=3, detail=True), "native")
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), err_msg=f.name)


def test_unknown_builder_raises():
    from hikari_tpu_torch.scene.bvh import build_flat_bvh

    with pytest.raises(ValueError, match="builder"):
        build_flat_bvh(np.zeros((2, 3)), np.ones((2, 3)), "rust")


# ---------------------------------------------------------------------------
# 3. Phase 1 and the ray sort
# ---------------------------------------------------------------------------


def _walk_rays(n, seed):
    """Rays into the small city with the whole trace contract: random
    max distance, exclusion, early distance on a third of them and one
    instance's prim range on half of them."""
    rng = np.random.default_rng(seed)
    o = np.stack(
        [rng.uniform(-25, 25, n), rng.uniform(0.5, 22, n), rng.uniform(-25, 25, n)], axis=-1
    )
    target = np.stack(
        [rng.uniform(-15, 15, n), rng.uniform(0, 15, n), rng.uniform(-15, 15, n)], axis=-1
    )
    d = target - o + rng.normal(scale=2.0, size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxd = np.where(rng.uniform(size=n) < 0.5, rng.uniform(5, 60, n), np.float32(3.0e38))
    early = np.where(rng.uniform(size=n) < 0.35, rng.uniform(0, 40, n), 0.0)
    excl = rng.integers(-1, 12, n)
    return dict(o=o.astype(np.float32), d=d.astype(np.float32), maxd=maxd.astype(np.float32),
                early=early.astype(np.float32), excl=excl.astype(np.int32),
                seed=rng.integers(1 << 30))


def _ranges(arrays, n, seed):
    rng = np.random.default_rng(seed)
    P = len(arrays.tri_world)
    lo, hi = np.zeros(n, np.int32), np.full(n, P, np.int32)
    inst = rng.integers(0, len(arrays.inst_material), n)
    half = rng.uniform(size=n) < 0.5
    lo[half] = arrays.inst_prim_offset[inst[half]]
    hi[half] = lo[half] + arrays.inst_prim_count[inst[half]]
    return lo, hi


def _padded(arrays, n, seed):
    """The rays padded to whole 512-ray tiles with inert rays, as the
    trace API pads them."""
    r = _walk_rays(n, seed)
    lo, hi = _ranges(arrays, n, r["seed"])
    Rp = -(-n // 512) * 512

    def pad(x, fill):
        return np.concatenate([x, np.full((Rp - n,) + x.shape[1:], fill, x.dtype)])

    return [pad(r["o"], 0.0), pad(r["d"], 1.0), pad(r["maxd"], 0.0), pad(r["early"], 0.0),
            pad(r["excl"], -1), pad(lo, 0), pad(hi, 0)]


@pytest.mark.parametrize("cluster", [64, 128, 256])
def test_cluster_bounds_equal(city, cluster):
    _, jb, tb = city
    want = jtiled._cluster_bounds(jb, cluster)
    got = ttiled.cluster_bounds(tb, cluster)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(_np(b), _np(a))
    assert got[0].shape == (-(-tb.tri_n.shape[0] // cluster), 3)


@pytest.mark.parametrize("with_range", [False, True])
def test_tile_entries_and_sort_equal(city, with_range):
    arrays, jb, tb = city
    cluster = 64
    o, d, maxd, _, _, lo, hi = _padded(arrays, 1500, 11)
    T = o.shape[0] // 512
    cmin, cmax, cvalid = jtiled._cluster_bounds(jb, cluster)
    jinv = jtiled.safe_inv_dir(jnp.asarray(d))
    rng_j = (jnp.asarray(lo, jnp.float32).reshape(T, 512), jnp.asarray(hi, jnp.float32).reshape(T, 512))
    want_e, want_m = jtiled.tile_cluster_entries(
        cmin, cmax, cvalid, jnp.asarray(o).reshape(T, 512, 3), jinv.reshape(T, 512, 3),
        jnp.asarray(maxd).reshape(T, 512), *(rng_j if with_range else (None, None)), cluster,
    )
    tcmin, tcmax, tcvalid = ttiled.cluster_bounds(tb, cluster)
    tinv = ttiled.safe_inv_dir(torch.from_numpy(d))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    rng_t = (torch.from_numpy(lo), torch.from_numpy(hi))
    got_e, got_m = ttiled.tile_cluster_entries(
        tcmin, tcmax, tcvalid, torch.from_numpy(o), tinv, torch.from_numpy(maxd),
        *(rng_t if with_range else (None, None)), cluster=cluster,
    )
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m).reshape(-1))
    assert (got_e.numpy() < 3e38).sum() > 10 and (got_m.numpy() < 0).any()
    # The stable sort of each tile's clusters (many share 0.0 or F32_MAX).
    order = np.asarray(jnp.argsort(want_e, axis=1))
    np.testing.assert_array_equal(torch.sort(got_e, dim=1, stable=True)[1].numpy(), order)
    if with_range:  # tile_entries always applies the range, as trace_pallas_tiled does
        t_order, t_entry, t_maxent = tw.tile_entries(
            tcmin, tcmax, tcvalid, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(maxd), torch.from_numpy(lo), torch.from_numpy(hi), cluster,
        )
        assert t_order.dtype == torch.int32
        np.testing.assert_array_equal(t_order.numpy(), order)
        np.testing.assert_array_equal(t_entry.numpy(), np.take_along_axis(np.asarray(want_e), order, 1))
        np.testing.assert_array_equal(t_maxent.numpy(), got_m.numpy())


def test_morton3_equal():
    q = np.random.default_rng(5).integers(0, 64, (4096, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tapi._morton3(torch.from_numpy(q)).numpy(), np.asarray(japi._morton3(jnp.asarray(q)))
    )


def test_ray_sort_order_equal(city):
    """The port's tile sort equals the key and stable argsort of the JAX
    package's ``_trace_pallas_tiled`` (written out here: the JAX package
    keeps them inline)."""
    arrays, jb, tb = city
    r = _walk_rays(3000, 12)
    o, d = jnp.asarray(r["o"]), jnp.asarray(r["d"])
    octant = ((d[:, 0] < 0).astype(jnp.int32) * 4 + (d[:, 1] < 0).astype(jnp.int32) * 2
              + (d[:, 2] < 0).astype(jnp.int32))
    smin, smax = jb.inst_min.min(axis=0), jb.inst_max.max(axis=0)
    cell = jnp.clip((o - smin) / jnp.maximum(smax - smin, 1e-6) * 63.0, 0.0, 63.0).astype(jnp.int32)
    want = jnp.argsort((octant << 18) | japi._morton3(cell), stable=True)
    got = tapi.ray_sort_order(tb, torch.from_numpy(r["o"]), torch.from_numpy(r["d"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("P", [470, 32767, 32768, 262143, 262144, 551040, 5_000_000])
def test_tile_cluster_rule(P):
    """The JAX package's per-scene cluster rule (trace/api.py:515-523)."""
    if P < 32768:
        want = (64, False)
    elif P < 262144:
        want = (128, True)
    else:
        want = (256, True)
    cluster = want[0]
    while -(-P // cluster) > 16384:
        cluster *= 2
    assert tapi.tile_cluster_rule(P) == (cluster, want[1])


# ---------------------------------------------------------------------------
# 4-5. The walk twin against K2 in interpret mode, and dispatch
# ---------------------------------------------------------------------------


def _assert_hits_match(prim, t, u, v, jprim, jt, ju, jv):
    np.testing.assert_array_equal(_np(prim), _np(jprim))
    np.testing.assert_allclose(_np(t), _np(jt), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(u), _np(ju), atol=1e-5)
    np.testing.assert_allclose(_np(v), _np(jv), atol=1e-5)


@pytest.mark.parametrize("cluster,use_skip", WALK_CASES)
def test_walk_twin_matches_jax_kernel(city, cluster, use_skip):
    """700 rays (two tiles, the second padded with inert rays) with the
    whole contract. Both sides get the same packed rows (the JAX package's
    rows, with the instance id as integer bits), cluster bounds, cluster
    size and skip, so done-early (any-hit) rays agree too."""
    arrays, jb, tb = city
    args = _padded(arrays, 700, 21)
    jpacked = jpt.pack_clusters(jb, cluster)
    jt, jp, ju, jv = jpt.trace_pallas_tiled(
        *jpacked, *(jnp.asarray(a) for a in args), interpret=True, cluster=cluster,
        use_skip=use_skip,
    )
    rows = np.asarray(jpacked[0])[:, :16].copy()
    rows[:, 13] = rows[:, 13].astype(np.int32).view(np.float32)
    rows[:, 14:] = 0.0
    own = tw.pack_clusters(tb, cluster)
    np.testing.assert_allclose(own[0].numpy(), rows, rtol=1e-5, atol=1e-5)  # FMA: see above
    packed = torch.from_numpy(rows)
    cmin, cmax, cvalid = (torch.from_numpy(np.array(x)) for x in jpacked[1:])
    for a, b in zip((cmin, cmax, cvalid), own[1:]):
        assert torch.equal(a, b)
    t, prim, u, v, tested = tw.trace_tile_walk(
        packed, cmin, cmax, cvalid, *(torch.from_numpy(a) for a in args), cluster, use_skip
    )
    _assert_hits_match(prim, t, u, v, jp, jt, ju, jv)
    p = prim.numpy()[:700]
    inst = np.where(p >= 0, arrays.tri_inst[np.maximum(p, 0)], -1)
    assert (inst[p >= 0] != args[4][:700][p >= 0]).all()
    early = args[3][:700]
    assert ((p >= 0) & (t.numpy()[:700] < early)).sum() >= 10  # done-early rays
    assert (p >= 0).sum() >= 250 and (p < 0).sum() >= 50
    assert tested.shape == (2,) and 0 < int(tested.min()) <= int(tested.max()) <= cmin.shape[0]


@pytest.mark.parametrize("use_skip", [False, True])
def test_walk_tie_rule_across_clusters(use_skip):
    """One triangle duplicated at prims 1 and 4 of cluster 0 and prim 72 of
    cluster 1 (row 8: sublane 0), every other row invalid, one tile of
    rays through it. The JAX kernel carries its eight sublane bests across
    the clusters and halves them at the end, so sublane 0 wins: prim 72,
    from the cluster visited second. With the skip, cluster 1's box lies
    at no ray's current best, so it is never tested, and sublane 4 beats
    sublane 1 within cluster 0: prim 4. The twin gives the same."""
    from hikari_tpu.trace.intersect import precompute_triangles as jax_precompute

    cluster, L = 64, 2
    rows = cluster * L
    tri = np.array([[[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]]], np.float32)
    tris = np.repeat(tri, rows, axis=0)
    valid = np.zeros(rows, np.float32)
    valid[[1, 4, 72]] = 1.0
    pre = jax_precompute(jnp.asarray(tris))
    cols = [np.asarray(pre[k]).reshape(rows, -1) for k in ("n", "eu", "ev", "cn", "cu", "cv")]
    rows16 = np.concatenate(cols + [valid[:, None], np.zeros((rows, 3), np.float32)], axis=1)
    cmin = np.repeat(tri[0].min(0)[None], L, 0)
    cmax = np.repeat(tri[0].max(0)[None], L, 0)
    jrows = np.concatenate([rows16, np.zeros((rows, 112), np.float32)], axis=1)
    jrows[[0, cluster], 16:22] = np.concatenate([cmin, cmax], axis=1)
    rng = np.random.default_rng(5)
    n = 512
    xy = rng.uniform(-0.3, 0.3, (n, 2)).astype(np.float32)
    front = rng.uniform(size=n) < 0.5
    o = np.concatenate([xy, np.where(front, -5.0, 4.0)[:, None]], 1).astype(np.float32)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = np.where(front, 1.0, -1.0)
    args = [o, d, np.full(n, 3.0e38, np.float32), np.zeros(n, np.float32),
            np.full(n, -1, np.int32), np.zeros(n, np.int32), np.full(n, rows, np.int32)]
    jt, jp, ju, jv = jpt.trace_pallas_tiled(
        jnp.asarray(jrows), jnp.asarray(cmin), jnp.asarray(cmax), jnp.ones(L, bool),
        *(jnp.asarray(a) for a in args), interpret=True, cluster=cluster, use_skip=use_skip)
    t, prim, u, v, tested = tw.trace_tile_walk(
        torch.from_numpy(rows16), torch.from_numpy(cmin), torch.from_numpy(cmax),
        torch.ones(L, dtype=torch.bool), *(torch.from_numpy(a) for a in args), cluster, use_skip)
    want, n_tested = (4, 1) if use_skip else (72, 2)
    assert (prim.numpy() == want).all() and tested.tolist() == [n_tested]
    _assert_hits_match(prim, t, u, v, jp, jt, ju, jv)


def _tie_walk(prims, device="cpu"):
    """The walk arguments of one tile of rays through a triangle duplicated
    at ``prims`` of two clusters of 64 (every other row invalid, no skip)."""
    cluster, L = 64, 2
    rows = cluster * L
    tri = np.array([[[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]]], np.float32)
    pre = tint.precompute_triangles(torch.from_numpy(np.repeat(tri, rows, axis=0)))
    valid = torch.zeros(rows)
    valid[list(prims)] = 1.0
    packed = torch.cat([pre["n"], pre["eu"], pre["ev"], pre["cn"][:, None], pre["cu"][:, None],
                        pre["cv"][:, None], valid[:, None], torch.zeros((rows, 3))], dim=1)
    rng = np.random.default_rng(5)
    n = 512
    xy = rng.uniform(-0.3, 0.3, (n, 2)).astype(np.float32)
    front = rng.uniform(size=n) < 0.5
    o = np.concatenate([xy, np.where(front, -5.0, 4.0)[:, None]], 1).astype(np.float32)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = np.where(front, 1.0, -1.0)
    rays = [torch.from_numpy(a) for a in (
        o, d, np.full(n, 3.0e38, np.float32), np.zeros(n, np.float32), np.full(n, -1, np.int32),
        np.zeros(n, np.int32), np.full(n, rows, np.int32))]
    cmin = torch.from_numpy(np.repeat(tri[0].min(0)[None], L, 0))
    cmax = torch.from_numpy(np.repeat(tri[0].max(0)[None], L, 0))
    order, entry, maxent = tw.tile_entries(cmin, cmax, torch.ones(L, dtype=torch.bool), rays[0],
                                           rays[1], rays[2], rays[5], rays[6], cluster)
    walk = (packed, cmin, cmax, *rays, order, entry, maxent, cluster, False)
    return tuple(x.to(device) if isinstance(x, torch.Tensor) else x for x in walk)


@pytest.mark.parametrize("prims, want", [((1, 4, 72), 72), ((8, 16, 64), 8)])
def test_walk_twin_tie_order(prims, want):
    """The twin's sublane rule on one sublane: duplicates at prims 8 and 16
    of cluster 0 and 64 of cluster 1 (all sublane 0) return the first found,
    8; spread over sublanes 1, 4 and 0 (of cluster 1) the halving returns
    72. The card's kernel splits each cluster's row groups between two
    halves of its block (8 in one, 16 and 64 in the other), so these cases
    hold its merge to the walk order."""
    t, prim, u, v, tested = tw.tile_walk_reference(*_tie_walk(prims))
    assert (prim == want).all() and tested.tolist() == [2]


def test_auto_dispatch_matches_jax_pallas_tiled(city):
    """On CPU tensors ``trace_rays(method="auto")`` above 2048 triangles
    sorts, pads and walks with the twin, and equals the JAX package's
    ``method="pallas_tiled"`` (its kernel in interpret mode)."""
    arrays, jb, tb = city
    r = _walk_rays(900, 31)
    lo, hi = _ranges(arrays, 900, 32)
    kw = dict(max_distance=r["maxd"], early_distance=r["early"], exclude_instance=r["excl"],
              range_lo=lo, range_hi=hi)
    jh = japi.trace_rays(jb, jnp.asarray(r["o"]), jnp.asarray(r["d"]), method="pallas_tiled",
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    th = tapi.trace_rays(tb, torch.from_numpy(r["o"]), torch.from_numpy(r["d"]),
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    _assert_hits_match(th.prim, th.t, th.u, th.v, jh.prim, jh.t, jh.u, jh.v)
    np.testing.assert_array_equal(th.inst.numpy(), np.asarray(jh.inst))
    assert (th.prim.numpy() >= 0).sum() > 300


def test_tile_walk_equals_closest_hit():
    """Forced "pallas_tiled" on the 36-triangle cornell box gives the
    closest hit of every triangle (no early distance): the same prim and
    bitwise t, u, v as the K1 twin."""
    from hikari_tpu.io.scenes import cornell_box_scene

    tb = torch_to_device(jax_compile(cornell_box_scene()), "cpu")
    rng = np.random.default_rng(8)
    o = torch.from_numpy(rng.uniform(-0.9, 0.9, (2000, 3)).astype(np.float32)) + torch.tensor([0.0, 1.0, 0.0])
    d = torch.from_numpy(rng.normal(size=(2000, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    a = tapi.trace_rays(tb, o, d, method="pallas_tiled")
    b = tapi.trace_rays(tb, o, d, method="pallas")
    assert (a.prim >= 0).sum() > 1000
    for x, y in zip((a.prim, a.t, a.u, a.v), (b.prim, b.t, b.u, b.v)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# 6. Whole frames of a small plain city
# ---------------------------------------------------------------------------

FRAME_H, FRAME_W = 24, 30
FRAME_PATH = dict(
    width=FRAME_W, height=FRAME_H, denoise=False, indirect_spatial_reuse=False,
    emissive_spatial_reuse=False, emissive_lit=True, indirect_bounces=1, reservoir_f16=True,
    reproject="shift", remat=False, collect_stats=True, bruteforce_max_tris=256,
)


@pytest.fixture(scope="module")
def plain_city():
    """procedural_city(blocks=3): 470 triangles (8 clusters of 64), 3
    lamps, under the city camera. The JAX package walks tiles with
    ``tracer="pallas_tiled"``; the port's ``tracer="auto"`` walks them
    because ``bruteforce_max_tris=256``. The width is even: at an odd
    width the center column lies on the x = z plane through the diagonal
    buildings' edges, where a 1-ulp difference decides hit or miss."""
    from hikari_tpu.render.camera import Camera as JCam
    from hikari_tpu.render.pipeline import initial_state, render_frame_jit
    from hikari_tpu_torch.render.camera import Camera as TCam

    arrays = jax_compile(_jax_city(3, False))
    jb, tb = jax_to_device(arrays), torch_to_device(arrays, "cpu")
    view = dict(eye=(30.0, 20.0, 30.0), target=(0.0, 0.0, 0.0))
    jcam, tcam = JCam.from_lookat(**view), TCam.from_lookat(**view, device="cpu")
    js = jc.RenderSettings(upscale=jc.Upscale.none(), taa=jc.Taa.NONE, tracer="pallas_tiled",
                           **FRAME_PATH)
    ts = tc.RenderSettings(upscale=tc.Upscale.none(), taa=tc.Taa.NONE, tracer="auto", **FRAME_PATH)
    states = [initial_state(js)]
    outs = []
    for _ in range(2):
        out, nxt = render_frame_jit(jb, jcam, states[-1], js)
        outs.append(out)
        states.append(nxt)
    return dict(tb=tb, tcam=tcam, ts=ts, states=states, outs=outs, num_tris=len(arrays.tri_world))


@pytest.mark.parametrize("frame", [0, 1])
def test_plain_city_frame_matches(plain_city, frame):
    from hikari_tpu_torch.render.pipeline import render_frame
    from hikari_tpu_torch.scene.buffers import frame_state_from_numpy
    from test_torch_pipeline import assert_gbuffer_close, assert_image_close

    w = plain_city
    assert w["num_tris"] == 470 > w["ts"].bruteforce_max_tris
    jo = w["outs"][frame]
    with torch.no_grad():
        to, tnext = render_frame(w["tb"], w["tcam"], frame_state_from_numpy(w["states"][frame], "cpu"),
                                 w["ts"])
    assert bool(torch.isfinite(to.image).all()) and float(to.image[..., :3].mean()) > 0.0
    for name in ("image", "tonemapped", "albedo", "direct", "emissive", "indirect"):
        assert_image_close(getattr(to, name), getattr(jo, name), name)
    assert float(to.emissive.abs().max()) > 0.0
    for k, v in jo.stats.items():
        np.testing.assert_allclose(float(to.stats[k]), float(v), rtol=2e-3, atol=1e-5, err_msg=k)
    assert_gbuffer_close(tnext.prev_gbuffer, w["states"][frame + 1].prev_gbuffer)
    # Under the city's 10,000-lux sun the f16 reservoir storage overflows
    # (w_sum, w2_sum): the port keeps the JAX package's inf entries.
    want, got = w["states"][frame + 1].direct_temporal, tnext.direct_temporal
    for f in ("w_sum", "w2_sum"):
        np.testing.assert_array_equal(torch.isinf(getattr(got, f)).numpy(),
                                      np.isinf(np.asarray(getattr(want, f))), err_msg=f)
    assert bool(torch.isinf(got.w2_sum).any())


def test_tile_walk_never_falls_back():
    """Off the CPU the wrapper launches its kernel or raises: tensors on a
    device with no kernel raise, and run no twin."""
    walk = _tie_walk((1, 4, 72), "meta")
    before = tw.launches
    with pytest.raises(NotImplementedError, match="no kernel for device meta"):
        tw.tile_walk(*walk)
    assert tw.launches == before


# ---------------------------------------------------------------------------
# 7. The kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the tile-walk kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(city, cuda_device):
    """On the card the kernel equals its twin bit for bit on t, prim, u, v
    and the per-tile tested-cluster counts, for each cluster/skip case, on
    rays with the whole contract (done-early rays included)."""
    arrays, _, tb_cpu = city
    tb = map_tensors(lambda x: x.to(cuda_device), tb_cpu)
    args = [torch.from_numpy(a).to(cuda_device) for a in _padded(arrays, 65536, 41)]
    for cluster, use_skip in WALK_CASES:
        packed, cmin, cmax, cvalid = tw.pack_clusters(tb, cluster)
        order, entry, maxent = tw.tile_entries(cmin, cmax, cvalid, args[0], args[1], args[2],
                                               args[5], args[6], cluster)
        walk = (packed, cmin, cmax, *args, order, entry, maxent, cluster, use_skip)
        before = tw.launches
        got = tw.tile_walk(*walk)
        assert tw.launches == before + 1
        want = tw.tile_walk_reference(*walk)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_ragged_tile_and_part_ties_on_card(city, cuda_device):
    """The redesigned kernel's own cases, each bit for bit against the twin:
    rays whose last tile is ragged (padded with inert rays, as the trace API
    pads) on tiles of unequal length, for each cluster/skip case, and ties
    across the two parts of the block that split a cluster's rows."""
    arrays, _, tb_cpu = city
    tb = map_tensors(lambda x: x.to(cuda_device), tb_cpu)
    args = [torch.from_numpy(a).to(cuda_device) for a in _padded(arrays, 65536 - 300, 43)]
    for cluster, use_skip in WALK_CASES:
        packed, cmin, cmax, cvalid = tw.pack_clusters(tb, cluster)
        order, entry, maxent = tw.tile_entries(cmin, cmax, cvalid, args[0], args[1], args[2],
                                               args[5], args[6], cluster)
        walk = (packed, cmin, cmax, *args, order, entry, maxent, cluster, use_skip)
        want = tw.tile_walk_reference(*walk)
        assert int(want[4].min()) < int(want[4].max())  # tiles of unequal length
        for a, b in zip(tw.tile_walk(*walk), want):
            assert torch.equal(a, b), cluster
    for prims in ((1, 4, 72), (8, 16, 64)):  # ties across the kernel's two halves
        walk = _tie_walk(prims, cuda_device)
        for a, b in zip(tw.tile_walk(*walk), tw.tile_walk_reference(*walk)):
            assert torch.equal(a, b), prims
