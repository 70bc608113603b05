"""Whole frames of the city bench configuration in the port against
``hikari_tpu`` (the settings of test_torch_bench_frames.py):
``city_scene(blocks=3, detail=True)``, 18,422 triangles, at 48x60 output
(render 24x30) under the city camera. The port traces with
``tracer="scatter"`` (the scatter twin), the JAX package with
``tracer="bruteforce"`` (its interpreted scatter kernel is too slow for a
CPU test); both are exact closest-hit searches. The width is even: at an
odd width the city camera's centre column grazes the diagonal buildings'
edges.

Frames 1, 4 and 5 are compared. Frame 0 resets every reservoir (see
test_torch_bench_frames.py); frames 2 and 3 jitter by Halton point 1,
whose primary ray through one building edge hits in one package and misses
in the other (XLA contracts FMAs), which moves that pixel's G-buffer and
all that reuses it. Tolerances as in test_torch_bench_frames.py."""

import pytest
import torch

from test_torch_bench_frames import _check_frame, _world

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def city():
    from hikari_tpu.io import scenes as jscenes
    from hikari_tpu.render.camera import Camera as JCam
    from hikari_tpu.scene.compile import Scene, compile_scene
    from hikari_tpu_torch.render.camera import Camera as TCam

    sun = jscenes._sun_from_euler(-1.0, 0.6, 0.0, 10000.0)
    scene = jscenes.procedural_city(Scene(materials=[], directional_light=sun), blocks=3,
                                    detail=True)
    arrays = compile_scene(scene)
    assert len(arrays.tri_world) > 2048
    view = dict(eye=(30.0, 20.0, 30.0), target=(0.0, 0.0, 0.0))
    return _world(arrays, JCam.from_lookat(**view), TCam.from_lookat(**view, device="cpu"), 60, 48,
                  "bruteforce", "scatter")


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("frame", [1, 4, 5])
def test_city_bench_frame_scatter_matches(city, frame, monkeypatch):
    """Every trace of the port's frame goes through the scatter search
    (its twin on CPU tensors), none through the other two."""
    from hikari_tpu_torch.trace import closest_hit, scatter, tile_walk

    searches = {
        "scatter": _count_calls(monkeypatch, scatter, "scatter_items_reference"),
        "closest_hit": _count_calls(monkeypatch, closest_hit, "closest_hit_reference"),
        "tile_walk": _count_calls(monkeypatch, tile_walk, "tile_walk_reference"),
    }
    before = scatter.dropped
    out = _check_frame(city, frame)
    assert len(searches["scatter"]) >= 7
    assert not searches["closest_hit"] and not searches["tile_walk"]
    assert scatter.dropped == before  # 32 items per ray leave room on this city
    assert float(out.emissive.abs().max()) > 0.0
