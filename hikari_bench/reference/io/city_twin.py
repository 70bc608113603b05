"""The reference's twin of the port's procedural city (``io/scenes.
city_scene``, ``city_config``), for the CPU tests' cell made of new files
only: its configuration names this module under ``reference_scene``, as a
later configuration names its own module beside this one. Built from the
reference's classes alone: the same grid of boxes, lamps and ground,
drawn from the same seed."""

from __future__ import annotations

import numpy as np

from hikari_bench.reference.config import RenderSettings, Upscale
from hikari_bench.reference.io.scenes import _euler_xyz_matrix, _transform
from hikari_bench.reference.render.camera import Camera
from hikari_bench.reference.scene.compile import DirectionalLight, Instance, Material, Scene
from hikari_bench.reference.scene.mesh import Mesh, cube_mesh


def plane_mesh(size: float = 1.0) -> Mesh:
    """A plane in the XZ plane facing +Y (bevy ``shape::Plane``)."""
    h = size / 2.0
    positions = [[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]]
    normals = [[0, 1, 0]] * 4
    uvs = [[0, 0], [1, 0], [1, 1], [0, 1]]
    return Mesh(positions, normals, uvs, [[0, 2, 1], [0, 3, 2]])


def uv_sphere_mesh(radius: float = 1.0, sectors: int = 36, stacks: int = 18) -> Mesh:
    """A UV sphere (bevy ``shape::UVSphere``-like)."""
    positions, normals, uvs = [], [], []
    for i in range(stacks + 1):
        phi = np.pi * i / stacks
        for j in range(sectors + 1):
            theta = 2.0 * np.pi * j / sectors
            n = [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)]
            positions.append([radius * c for c in n])
            normals.append(n)
            uvs.append([j / sectors, i / stacks])
    indices = []
    for i in range(stacks):
        for j in range(sectors):
            a = i * (sectors + 1) + j
            b = a + sectors + 1
            if i != 0:
                indices.append([a, b, a + 1])
            if i != stacks - 1:
                indices.append([a + 1, b, b + 1])
    return Mesh(positions, normals, uvs, indices)


def city_scene(blocks: int = 16, detail: bool = False, seed: int = 7) -> Scene:
    """A grid of ``blocks`` x ``blocks`` boxes of seed-drawn sizes and
    colours on a ground plane, an emissive lamp beside every third, under
    the city's sun. The port's ``detail`` facades are not copied."""
    if detail:
        raise ValueError("the twin has the plain boxes only")
    rot = _euler_xyz_matrix(-1.0, 0.6, 0.0)
    sun = DirectionalLight(direction=tuple(rot @ np.array([0.0, 0.0, -1.0], dtype=np.float32)),
                           color=(10000.0,) * 3)
    scene = Scene(materials=[], directional_light=sun)
    rng = np.random.default_rng(seed)
    ground = scene.add_material(Material(base_color=(0.25, 0.25, 0.27, 1.0)))
    lamp = scene.add_material(Material(base_color=(1, 1, 1, 1), emissive=(1.0, 0.9, 0.7, 0.3)))
    plane = scene.add_mesh(plane_mesh(1.0))
    box = scene.add_mesh(cube_mesh(1.0))
    sphere = scene.add_mesh(uv_sphere_mesh(1.0, 12, 6))
    size = blocks * 12.0
    scene.add_instance(Instance(plane, ground, _transform((0, 0, 0), None, (size, 1.0, size))))
    for i in range(blocks):
        for j in range(blocks):
            x = (i - blocks / 2 + 0.5) * 12.0
            z = (j - blocks / 2 + 0.5) * 12.0
            h = float(rng.uniform(4.0, 20.0))
            w = float(rng.uniform(4.0, 8.0))
            c = rng.uniform(0.3, 0.8, size=3)
            mat = scene.add_material(Material(
                base_color=(float(c[0]), float(c[1]), float(c[2]), 1.0),
                perceptual_roughness=float(rng.uniform(0.3, 0.9))))
            scene.add_instance(Instance(box, mat, _transform((x, h / 2, z), None, (w, h, w))))
            if (i + j) % 3 == 0:
                scene.add_instance(
                    Instance(sphere, lamp, _transform((x + 6.0, 3.0, z), None, (0.3, 0.3, 0.3))))
    return scene


def city_config(width: int = 512, height: int = 512, device=None):
    """The port's ``city_config``: its camera and settings; the geometry
    comes from the configuration's ``geometry`` (``city_scene``)."""
    cam = Camera.from_lookat(eye=(30.0, 20.0, 30.0), target=(0.0, 0.0, 0.0), device=device)
    settings = RenderSettings(width=width, height=height, upscale=Upscale.smaa_tu4x(2.0),
                              denoise=True)
    return city_scene(), cam, settings
