"""The reference's twin of the port's ``many_cubes`` configuration
(``io/scenes.many_cubes_scene``, ``many_cubes_config``): Bevy v0.9.1's
``examples/stress_tests/many_cubes.rs``, default mode, built from the
reference's classes alone, loop for loop in the example's spawn order."""

from __future__ import annotations

import numpy as np

from hikari_bench.reference.config import RenderSettings
from hikari_bench.reference.io.scenes import _euler_xyz_matrix, _transform
from hikari_bench.reference.render.camera import Camera
from hikari_bench.reference.scene.compile import DirectionalLight, Instance, Material, Scene
from hikari_bench.reference.scene.mesh import cube_mesh


def many_cubes_scene(grid: int = 200) -> Scene:
    """For each (x, y) of a ``grid`` x ``grid`` grid at 2.5 spacing, every
    tenth row and column left out, one unit cube in each of the planes
    z = 0, y = 500, y = 0 and x = 0, then one 5x cube at (0, 500, 0); one
    pink material with Bevy 0.9.1's defaults; the default directional
    light (along -Z, 100,000 lux). A ``grid`` below 200 scales the layout,
    cubes included, by 200 / grid."""
    s = 200.0 / grid
    rot = _euler_xyz_matrix(0.0, 0.0, 0.0)
    sun = DirectionalLight(direction=tuple(rot @ np.array([0.0, 0.0, -1.0], dtype=np.float32)),
                           color=(100000.0,) * 3)
    scene = Scene(materials=[], directional_light=sun)
    pink = scene.add_material(Material(base_color=(1.0, 0.08, 0.58, 1.0),
                                       perceptual_roughness=0.089, metallic=0.01,
                                       reflectance=0.5))
    cube = scene.add_mesh(cube_mesh(1.0))
    top = grid * 2.5 * s
    for x in range(grid):
        for y in range(grid):
            if x % 10 == 0 or y % 10 == 0:
                continue
            a, b = x * 2.5 * s, y * 2.5 * s
            for pos in ((a, b, 0.0), (a, top, b), (a, 0.0, b), (0.0, a, b)):
                scene.add_instance(Instance(cube, pink, _transform(pos, None, (s, s, s))))
    scene.add_instance(Instance(cube, pink, _transform((0.0, top, 0.0), None, (5.0 * s,) * 3)))
    return scene


def many_cubes_config(width: int = 512, height: int = 512, device=None):
    """The example's start pose: the camera at (200, 200, 200) looking
    along -Z, 45 degrees of vertical field of view."""
    cam = Camera.from_lookat(eye=(200.0, 200.0, 200.0), target=(200.0, 200.0, 199.0),
                             fov_y=float(np.pi / 4), device=device)
    return many_cubes_scene(), cam, RenderSettings(width=width, height=height)
