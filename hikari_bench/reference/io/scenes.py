"""The scenes of the benchmark's configurations, built as the reference's
examples build them: ``CONFIGS`` maps a configuration's ``scene`` to its
constructor, which returns (Scene, Camera, RenderSettings). The Cornell
box is the procedural replica of examples/cornell.rs's geometry and
materials (cornell.glb is not in the repository).
"""

from __future__ import annotations

import numpy as np

from hikari_bench.reference.config import RenderSettings, Upscale
from hikari_bench.reference.render.camera import Camera
from hikari_bench.reference.scene.compile import DirectionalLight, Instance, Material, Scene
from hikari_bench.reference.scene.mesh import cube_mesh, quad_mesh


def _euler_xyz_matrix(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rotation matrix for Quat::from_euler(EulerRot::XYZ, rx, ry, rz)
    (glam semantics: R = Rx @ Ry @ Rz)."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    rxm = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    rym = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rzm = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rxm @ rym @ rzm).astype(np.float32)


def _transform(translation=(0, 0, 0), rotation=None, scale=(1, 1, 1)) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    r = np.eye(3, dtype=np.float32) if rotation is None else rotation
    m[:3, :3] = r * np.asarray(scale, dtype=np.float32)[None, :]
    m[:3, 3] = translation
    return m


def _procedural_cornell(scene: Scene) -> Scene:
    """Classic Cornell-box layout (matches cornell.glb's materials)."""
    white = scene.add_material(Material(base_color=(0.725, 0.71, 0.68, 1.0), metallic=0.0))
    red = scene.add_material(Material(base_color=(0.63, 0.065, 0.05, 1.0), metallic=0.0))
    green = scene.add_material(Material(base_color=(0.14, 0.45, 0.091, 1.0), metallic=0.0))
    light = scene.add_material(
        Material(base_color=(0.78, 0.78, 0.78, 1.0), emissive=(1.0, 1.0, 1.0, 1.0), metallic=0.0)
    )
    quad = scene.add_mesh(quad_mesh(2.0))
    ident = np.eye(3)
    rx90 = _euler_xyz_matrix(-np.pi / 2, 0, 0)  # +Z normal -> +Y (floor)
    rx_90 = _euler_xyz_matrix(np.pi / 2, 0, 0)  # +Z -> -Y (ceiling)
    ry90 = _euler_xyz_matrix(0, np.pi / 2, 0)  # +Z -> +X (left wall)
    ry_90 = _euler_xyz_matrix(0, -np.pi / 2, 0)  # +Z -> -X (right wall)
    # Box interior [-1,1]^2 x [0,2]; camera looks down -Z into the box.
    scene.add_instance(Instance(quad, white, _transform((0, 1, -1), ident)))  # back
    scene.add_instance(Instance(quad, white, _transform((0, 0, 0), rx90)))  # floor
    scene.add_instance(Instance(quad, white, _transform((0, 2, 0), rx_90)))  # ceiling
    scene.add_instance(Instance(quad, red, _transform((-1, 1, 0), ry90)))  # left
    scene.add_instance(Instance(quad, green, _transform((1, 1, 0), ry_90)))  # right
    light_quad = scene.add_mesh(quad_mesh(0.5))
    scene.add_instance(Instance(light_quad, light, _transform((0, 1.98, 0), rx_90)))
    box = scene.add_mesh(cube_mesh(1.0))
    rshort = _euler_xyz_matrix(0, -0.3, 0)
    rtall = _euler_xyz_matrix(0, 0.3, 0)
    scene.add_instance(Instance(box, white, _transform((0.35, 0.3, 0.35), rshort, (0.6, 0.6, 0.6))))
    scene.add_instance(Instance(box, white, _transform((-0.35, 0.6, -0.3), rtall, (0.6, 1.2, 0.6))))
    return scene


def cornell_config(size: int = 512, device=None):
    """BASELINE config 1: 'cornell.rs Cornell box: direct lighting only,
    1 bounce, 1 spp, 512x512' (the sun is black). The camera lives on
    ``device``."""
    scene = _procedural_cornell(
        Scene(materials=[], directional_light=DirectionalLight(color=(0.0, 0.0, 0.0))))
    cam = Camera.from_lookat(eye=(0.0, 1.0, 4.0), target=(0.0, 1.0, 0.0), device=device)
    settings = RenderSettings(
        width=size,
        height=size,
        upscale=Upscale.none(),
        indirect_bounces=1,
        # examples/cornell.rs:18 inserts ClearColor(Color::BLACK)
        clear_color=(0.0, 0.0, 0.0, 1.0),
    )
    return scene, cam, settings


CONFIGS = {"cornell": cornell_config}
