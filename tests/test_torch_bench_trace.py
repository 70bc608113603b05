"""The port's per-scene tracer bench (``hikari_tpu_torch.bench_trace``)
against the repository's ``bench_trace.py``, and the terrain geometry it
adds: ``terrain_mesh`` and ``procedural_terrain`` are numpy generators,
so their arrays are equal to the JAX package's; ``make_rays`` gives the
same numpy rays; the budget rule is the JAX bench's. The measurement
function runs every backend on the CPU at 4,096 rays of cornell and
city-8, and each backend's prims equal the brute force's except ties
(rays whose two hits lie within 1e-5 relative of each other in t), which
are counted; the K1 tie rule ("pallas") and the BVH walk meet a few."""

import numpy as np
import pytest
import torch

import bench_trace as jbench
from hikari_tpu.io import scenes as jscenes
from hikari_tpu.scene import mesh as jmesh
from hikari_tpu.scene.buffers import to_device as jax_to_device
from hikari_tpu.scene.compile import Scene as JScene
from hikari_tpu.scene.compile import compile_scene as jax_compile
from hikari_tpu_torch import bench_trace as tbench
from hikari_tpu_torch.io import scenes as tscenes
from hikari_tpu_torch.scene import mesh as tmesh
from hikari_tpu_torch.scene.buffers import to_device as torch_to_device
from hikari_tpu_torch.scene.compile import Scene as TScene
from test_torch_tiled import _assert_scenes_equal

torch.set_num_threads(2)


def test_terrain_mesh_equal():
    want, got = jmesh.terrain_mesh(16), tmesh.terrain_mesh(16)
    assert len(got.indices) == 2 * 16 * 16
    for f in ("positions", "normals", "uvs", "indices"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_procedural_terrain_equal():
    want = jscenes.procedural_terrain(
        JScene(materials=[], directional_light=jscenes._sun_from_euler(-1.0, 0.6, 0.0)), n=24)
    got = tscenes.procedural_terrain(
        TScene(materials=[], directional_light=tscenes._sun_from_euler(-1.0, 0.6, 0.0)), n=24)
    _assert_scenes_equal(want, got)
    assert len(got.instances) == 5


@pytest.fixture(scope="module")
def scenes():
    """cornell and city-8 of the port's ``build_scenes``, each compiled once
    (the JAX package's compile, on both sides)."""
    out = {}
    for name, scene in tbench.build_scenes().items():
        if name in ("cornell", "city-8"):
            arrays = jax_compile(scene)
            out[name] = (arrays, torch_to_device(arrays, "cpu"))
    return out


def test_build_scenes_match_jax():
    """The default scene set is the JAX bench's (city-24 in the helmet's
    place without the assets), scene for scene."""
    want, got = jbench.build_scenes(), tbench.build_scenes()
    if "helmet" in want:
        pytest.skip("the reference assets are present for the JAX bench only")
    assert list(got) == list(want) == ["cornell", "city-8", "city-24", "city-551k"]
    for name in ("city-8", "city-24"):
        _assert_scenes_equal(want[name], got[name])


@pytest.mark.parametrize("name", ["cornell", "city-8"])
def test_make_rays_equal(scenes, name):
    arrays, tb = scenes[name]
    jo, jd = jbench.make_rays(jax_to_device(arrays), 5000)
    o, d = tbench.make_rays(tb, 5000, device="cpu")
    assert o.shape == (5000, 3)  # 50^2 coherent + 2,500 incoherent
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


@pytest.mark.parametrize("method", tbench.BACKENDS)
@pytest.mark.parametrize("tris", [36, 8_000, 30_000, 550_994, 1_002_528])
def test_ray_budget(method, tris):
    """The JAX bench's per-backend budgets (``bench_trace.py:148-167``)."""
    rays = 1 << 20
    if method == "bvh":
        budget = rays if tris <= 10_000 else 1 << 16
    elif method == "pallas_tiled":
        budget = max(1 << 16, int(5.1e11) // tris)
    elif method == "scatter":
        budget = 1 << 18
    else:
        budget = max(1 << 16, int(4e10) // tris)
    want = max(min(rays, 1 << (max(budget, 2).bit_length() - 1)), 1 << 14)
    assert tbench.ray_budget(method, tris, rays) == want


def _count_ties(got, want, rel=1e-5):
    """(ties, others): rays whose prims differ with both hit at t within
    ``rel`` of each other, and rays whose prims differ otherwise."""
    differ = got.prim != want.prim
    scale = torch.clamp(torch.maximum(got.t.abs(), want.t.abs()), min=1.0)
    tie = differ & (got.prim >= 0) & (want.prim >= 0) & ((got.t - want.t).abs() <= rel * scale)
    return int(tie.sum()), int((differ & ~tie).sum())


@pytest.mark.parametrize("name", ["cornell", "city-8"])
def test_measure_every_backend(scenes, name):
    """``measure`` at 4,096 rays for each backend (one window of one call):
    a finite positive rate, no launch and no counted trace call on CPU
    tensors, and the brute force's prims but for counted ties."""
    _, tb = scenes[name]
    o, d = tbench.make_rays(tb, 4096, device="cpu")
    want = tbench.measure(tb, o, d, "bruteforce", windows=1, max_inner=1)["hit"]
    assert int((want.prim >= 0).sum()) > 1000
    ties = {}
    for method in tbench.BACKENDS:
        m = tbench.measure(tb, o, d, method, windows=1, max_inner=1)
        assert np.isfinite(m["rays_per_s"]) and m["rays_per_s"] > 0 and m["inner"] == 1
        assert (m["launches"], m["k1b_launches"], m["trace_calls"]) == (0, 0, 0)
        ties[method], others = _count_ties(m["hit"], want)
        assert others == 0, (method, others, ties)
    assert ties["bruteforce"] == 0 and max(ties.values()) <= 40, ties
