"""The tile walk's row order (``SceneBuffers.tile_rows``,
``trace/tile_walk.tile_clusters``): K2's twin, through ``trace_rays``,
gives the same hits bit for bit under the prim order, the TLAS order and
seeded random orders of the instances, each equal to the K1 twin's (tie
"pallas"), on a triangle soup with duplicated triangles (equal t, so the
key decides), coplanar floor copies spread over clusters (which only the
boxes' margin keeps) and rays with a max distance, an excluded instance
and a prim range; and on Bevy's ``many_cubes`` at a grid of 40 (62,220
triangles, clusters of 128 with the skip), where the coherent order tests
at least ten times fewer clusters than the spawn order."""

import dataclasses

import numpy as np
import pytest
import torch

from hikari_tpu_torch.io import scenes
from hikari_tpu_torch.scene.buffers import to_device
from hikari_tpu_torch.scene.compile import Instance, Material, Scene, compile_scene
from hikari_tpu_torch.scene.mesh import Mesh
from hikari_tpu_torch.trace import api

torch.set_num_threads(2)

F32_MAX = 3.402823466e38


def _soup_scene(seed: int, P: int = 2100, dup: int = 300, floor: int = 60, per: int = 7):
    """Seeded triangles, ``per`` an instance, ``dup`` of them copies of
    others, and ``floor`` copies of a 20 x 20 floor quad at y = 0 (two
    triangles an instance), the instances shuffled."""
    g = np.random.default_rng(seed)
    tri = g.uniform(-5, 5, (P, 1, 3)) + g.normal(scale=0.5, size=(P, 3, 3))
    tri[g.integers(0, P, dup)] = tri[g.integers(0, P, dup)]
    quad = np.array([[[-10.0, 0, -10], [10, 0, -10], [10, 0, 10]],
                     [[-10.0, 0, -10], [10, 0, 10], [-10, 0, 10]]])
    groups = [tri[i:i + per] for i in range(0, P, per)] + [quad] * floor
    scene = Scene(materials=[])
    mat = scene.add_material(Material())
    for k in g.permutation(len(groups)):
        t = groups[k].astype(np.float32)
        n = len(t)
        mesh = scene.add_mesh(Mesh(t.reshape(-1, 3), np.tile([0.0, 1.0, 0.0], (3 * n, 1)),
                                   np.zeros((3 * n, 2)), np.arange(3 * n).reshape(n, 3)))
        scene.add_instance(Instance(mesh, mat))
    return scene


def _buffers(scene):
    arrays = compile_scene(scene)
    return arrays, to_device(arrays, "cpu")


def _soup_rays(seed: int, R: int, arrays):
    """Seeded rays through the soup's box, a third of them down onto the
    floor; a third each get a max distance, an excluded instance, a prim
    range (an instance's, or a random one)."""
    g = np.random.default_rng(seed)
    P, I = len(arrays.tri_world), len(arrays.inst_material)
    o = g.uniform(-8, 8, (R, 3))
    d = g.normal(size=(R, 3))
    down = np.arange(R) % 3 == 0
    o[down, 1] = 9.0
    d[down] = d[down] * [1.0, 0.2, 1.0] - [0.0, 1.0, 0.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pick = lambda: g.uniform(size=R) < 1 / 3  # noqa: E731
    maxd = np.where(pick(), g.uniform(0, 12, R), F32_MAX)
    excl = np.where(pick(), g.integers(0, I, R), -1)
    inst = g.integers(0, I, R)
    lo = np.where(pick(), arrays.inst_prim_offset[inst], 0)
    hi = np.where(lo > 0, lo + arrays.inst_prim_count[inst], P)
    wide = pick()
    lo = np.where(wide, g.integers(0, P, R), lo)
    hi = np.where(wide, np.maximum(lo, g.integers(0, P, R)), hi)
    return [torch.from_numpy(x.astype(dt)) for x, dt in (
        (o, np.float32), (d, np.float32), (maxd, np.float32), (excl, np.int32), (lo, np.int32),
        (hi, np.int32))]


def _camera_rays(R: int, seed: int):
    """Rays of the ``many_cubes`` camera: from (200, 200, 200) along -Z
    through a 45-degree cone, jittered."""
    g = np.random.default_rng(seed)
    xy = g.uniform(-np.tan(np.pi / 8), np.tan(np.pi / 8), (R, 2)) * [4 / 3, 1]
    d = np.concatenate([xy, -np.ones((R, 1))], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile([200.0, 200.0, 200.0], (R, 1))
    return [torch.from_numpy(x.astype(dt)) for x, dt in (
        (o, np.float32), (d, np.float32), (np.full(R, F32_MAX), np.float32),
        (np.full(R, -1), np.int32), (np.zeros(R), np.int32), (np.full(R, 10**9), np.int32))]


def _random_rows(arrays, padded: int, seed: int):
    """Whole instances in a seeded random order, padding last."""
    order = np.random.default_rng(seed).permutation(len(arrays.inst_material))
    rows = np.concatenate([np.arange(arrays.inst_prim_offset[i],
                                     arrays.inst_prim_offset[i] + arrays.inst_prim_count[i])
                           for i in order] + [np.arange(len(arrays.tri_world), padded)])
    return torch.from_numpy(rows.astype(np.int32))


def _orders(arrays, tb):
    P = tb.tri_n.shape[0]
    return {"prim": torch.arange(P, dtype=torch.int32), "tlas": tb.tile_rows,
            "random_a": _random_rows(arrays, P, 1), "random_b": _random_rows(arrays, P, 2)}


def _walk(tb, rows, rays):
    """The K2 twin's hits under the row order ``rows`` and the clusters
    its tiles tested."""
    o, d, maxd, excl, lo, hi = rays
    before = api.clusters_tested
    hit = api.trace_rays(dataclasses.replace(tb, tile_rows=rows), o, d, max_distance=maxd,
                         exclude_instance=excl, range_lo=lo, range_hi=hi, method="pallas_tiled")
    return (hit.t, hit.prim, hit.u, hit.v), int(api.clusters_tested - before)


def _assert_bitwise(want, got, what):
    for name, a, b in zip(("t", "prim", "u", "v"), want, got):
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert int((a != b).sum()) == 0, f"{what}: {name} differs"


@pytest.fixture(scope="module")
def soup():
    return _buffers(_soup_scene(5))


@pytest.fixture(scope="module")
def cubes():
    return _buffers(scenes.many_cubes_scene(grid=40))


@pytest.mark.parametrize("order", ["prim", "tlas", "random_a", "random_b"])
def test_soup_hits_equal_k1_under_every_order(soup, order):
    arrays, tb = soup
    rays = _soup_rays(9, 3000, arrays)
    o, d, maxd, excl, lo, hi = rays
    k1 = api.trace_rays(tb, o, d, max_distance=maxd, exclude_instance=excl, range_lo=lo,
                        range_hi=hi, method="pallas")
    assert int((k1.prim >= 0).sum()) > 500
    got, _ = _walk(tb, _orders(arrays, tb)[order], rays)
    _assert_bitwise((k1.t, k1.prim, k1.u, k1.v), got, order)


def test_soup_has_the_ties_the_key_decides(soup):
    """Duplicates and floor copies give equal t at several prims: the key
    (t, rank, prim) takes K1's, not the lowest prim."""
    arrays, tb = soup
    o, d, maxd, excl, lo, hi = _soup_rays(9, 3000, arrays)
    k1 = api.trace_rays(tb, o, d, max_distance=maxd, exclude_instance=excl, range_lo=lo,
                        range_hi=hi, method="pallas")
    low = api.trace_rays(tb, o, d, max_distance=maxd, exclude_instance=excl, range_lo=lo,
                         range_hi=hi, method="bruteforce")
    assert int((k1.prim != low.prim).sum()) > 20


@pytest.mark.parametrize("order", ["prim", "tlas", "random_a", "random_b"])
def test_many_cubes_hits_equal_k1_under_every_order(cubes, order):
    arrays, tb = cubes
    assert len(arrays.tri_world) == 62220 and api.tile_cluster_rule(tb.tri_n.shape[0]) == (128, True)
    rays = _camera_rays(1024, 3)
    o, d, maxd, excl, lo, hi = rays
    k1 = api.trace_rays(tb, o, d, max_distance=maxd, method="pallas")
    assert int((k1.prim >= 0).sum()) > 100
    got, _ = _walk(tb, _orders(arrays, tb)[order], rays)
    _assert_bitwise((k1.t, k1.prim, k1.u, k1.v), got, order)


def test_coherent_order_tests_ten_times_fewer_clusters(cubes):
    arrays, tb = cubes
    rays = _camera_rays(1024, 4)
    spawn, n_spawn = _walk(tb, torch.arange(tb.tri_n.shape[0], dtype=torch.int32), rays)
    tlas, n_tlas = _walk(tb, tb.tile_rows, rays)
    _assert_bitwise(spawn, tlas, "spawn against tlas")
    assert 0 < 10 * n_tlas <= n_spawn, (n_tlas, n_spawn)


def test_tile_rows_keep_instances_whole(cubes):
    arrays, tb = cubes
    rows = tb.tile_rows.numpy()
    P = len(arrays.tri_world)
    assert sorted(rows.tolist()) == list(range(len(rows)))
    assert (rows[P:] == np.arange(P, len(rows))).all()
    inst = arrays.tri_inst[rows[:P]]
    starts = np.flatnonzero(np.diff(inst)) + 1
    assert len(starts) + 1 == len(arrays.inst_material)  # each instance one run
    first = np.concatenate([[0], starts])
    assert (rows[first] == arrays.inst_prim_offset[inst[first]]).all()


def test_many_cubes_is_the_example():
    """Bevy's loop: 129,601 cubes of 12 triangles in four planes and one
    5x cube last, under the default light and the start pose."""
    scene, cam, _ = scenes.many_cubes_config(device="cpu")
    assert len(scene.instances) == 129601 and len(scene.meshes) == 1
    assert sum(len(scene.meshes[i.mesh].indices) for i in scene.instances[:2]) == 24
    t = np.stack([i.transform[:3, 3] for i in scene.instances[:-1]])
    assert (t[0::4, 2] == 0).all() and (t[1::4, 1] == 500).all()
    assert (t[2::4, 1] == 0).all() and (t[3::4, 0] == 0).all()
    big = scene.instances[-1].transform
    assert np.allclose(np.diag(big)[:3], 5.0) and np.allclose(big[:3, 3], [0, 500, 0])
    m = scene.materials[0]
    assert (m.base_color, m.perceptual_roughness, m.metallic) == ((1.0, 0.08, 0.58, 1.0), 0.089,
                                                                  0.01)
    assert np.allclose(scene.directional_light.direction, (0, 0, -1))
    assert np.allclose(cam.world_from_view[:3, 3].numpy(), [200, 200, 200])
    assert np.allclose(cam.world_from_view[:3, 2].numpy(), [0, 0, 1])  # looking along -Z


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the tile walk's kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["tlas", "random_a"])
def test_kernels_match_twins_under_orders_on_card(cubes, order, cuda_device):
    """On the card, phase 1 and the walk over ``tile_clusters``' rows equal
    their twins bit for bit (entries, hits, tested clusters), on the
    camera's rays and on rays with limits and early distances, in the TLAS
    order and a random one; ``trace_rays`` then equals K1's kernel."""
    from hikari_tpu_torch.trace import tile_walk as tw
    from hikari_tpu_torch.trace.tiled import safe_inv_dir, tile_cluster_entries_reference
    from hikari_tpu_torch.utils import map_tensors

    arrays, tb_cpu = cubes
    tb = dataclasses.replace(map_tensors(lambda x: x.to(cuda_device), tb_cpu),
                             tile_rows=_orders(arrays, tb_cpu)[order].to(cuda_device))
    cam = _camera_rays(65536, 7)
    g = np.random.default_rng(8)
    R = 65536
    o = torch.from_numpy(g.uniform(-10, 510, (R, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(g.normal(size=(R, 3)).astype(np.float32)),
                                      dim=1)
    P = len(arrays.tri_world)
    lo = torch.from_numpy(np.where(g.uniform(size=R) < 0.3, g.integers(0, P, R), 0).astype(np.int32))
    hi = torch.from_numpy(np.where(g.uniform(size=R) < 0.3, g.integers(0, P, R), P).astype(np.int32))
    early = torch.from_numpy(np.where(g.uniform(size=R) < 0.3, g.uniform(0, 300, R), 0)
                             .astype(np.float32))
    cluster, use_skip = api.tile_cluster_rule(tb.tri_n.shape[0])
    for o_, d_, early_, lo_, hi_ in ((cam[0], cam[1], torch.zeros(R), cam[4], cam[5]),
                                     (o, d, early, lo, hi)):
        rays = [x.to(cuda_device) for x in (o_, d_, torch.full((R,), F32_MAX), early_,
                                            torch.full((R,), -1, dtype=torch.int32), lo_, hi_)]
        packed, cmin, cmax, cvalid, prange, cond = tw.tile_clusters(tb, cluster)
        margin = tw.ray_margin(rays[0], cond)
        got = tw.tile_entries(cmin, cmax, cvalid, rays[0], rays[1], rays[2], rays[5], rays[6],
                              prange, tb.num_tris, margin)
        e_want, m_want = tile_cluster_entries_reference(
            cmin, cmax, cvalid, rays[0], safe_inv_dir(rays[1]), rays[2], rays[5], rays[6],
            prange, tb.num_tris, margin)
        e_sorted, e_order = torch.sort(e_want, dim=1, stable=True)
        assert torch.equal(got[0], e_order.to(torch.int32)) and torch.equal(got[1], e_sorted)
        assert torch.equal(got[2], m_want)
        walk = (packed, cmin, cmax, *rays, *got, cluster, use_skip, prange, margin)
        want = tw.tile_walk_reference(*walk)
        for a, b in zip(tw.tile_walk(*walk), want):
            assert torch.equal(a, b), order
    o_, d_ = cam[0].to(cuda_device), cam[1].to(cuda_device)
    k2 = api.trace_rays(tb, o_, d_, method="pallas_tiled")
    k1 = api.trace_rays(tb, o_, d_, method="pallas")
    for a, b in zip((k2.t, k2.prim, k2.u, k2.v), (k1.t, k1.prim, k1.u, k1.v)):
        assert torch.equal(a, b)
