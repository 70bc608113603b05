"""Built-in scene configs — the port of ``hikari_tpu.io.scenes``. Each
constructor returns (Scene, Camera, RenderSettings) matching the
reference's example scenes (examples/*.rs); ``CONFIGS`` maps the five
names to them.

The asset rules are the JAX package's, with the asset directory taken
from ``assets`` or ``$HIKARI_REFERENCE_ASSETS``: the Cornell box loads
``models/cornell.glb`` when it is there, else builds its procedural
replica; ``scene_config`` loads the FlightHelmet glTF when it is there and
falls back to the procedural Cornell box under the sun when it is absent or
incomplete (``FileNotFoundError``, ``OSError``, ``KeyError``); the city
config builds the procedural city (the JAX package's stand-in when the City
glTF geometry is absent).
"""

from __future__ import annotations

import os

import numpy as np

from hikari_tpu_torch.config import RenderSettings, Upscale
from hikari_tpu_torch.render.camera import Camera
from hikari_tpu_torch.scene.compile import DirectionalLight, Instance, Material, Scene
from hikari_tpu_torch.scene.mesh import (
    building_mesh,
    cube_mesh,
    plane_mesh,
    quad_mesh,
    terrain_mesh,
    uv_sphere_mesh,
)


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


def _sun_from_euler(rx, ry, rz, illuminance=10000.0) -> DirectionalLight:
    """Bevy directional lights shine along the rotated -Z axis; the GPU
    light color is premultiplied by illuminance (bevy_pbr 0.9)."""
    rot = _euler_xyz_matrix(rx, ry, rz)
    direction = rot @ np.array([0.0, 0.0, -1.0], dtype=np.float32)
    return DirectionalLight(direction=tuple(direction), color=(illuminance,) * 3)


# Where the configs look for the reference's assets when not given a
# directory: models/cornell.glb and models/FlightHelmet/FlightHelmet.gltf.
ASSETS_ENV = "HIKARI_REFERENCE_ASSETS"
CORNELL_GLB = os.path.join("models", "cornell.glb")
FLIGHT_HELMET = os.path.join("models", "FlightHelmet", "FlightHelmet.gltf")


def _asset(assets: str | None, rel: str) -> str | None:
    """The path of asset ``rel`` under ``assets`` (default: the
    ``HIKARI_REFERENCE_ASSETS`` directory) if it exists, else None."""
    assets = os.environ.get(ASSETS_ENV) if assets is None else assets
    path = os.path.join(assets, rel) if assets else None
    return path if path and os.path.exists(path) else None


def cornell_box_scene(assets: str | None = None) -> Scene:
    """The Cornell box of reference examples/cornell.rs (the sun is
    black): ``models/cornell.glb`` under ``assets`` when it is there, as the
    JAX package loads it, else the procedural replica of its geometry and
    materials."""
    scene = Scene(materials=[], directional_light=DirectionalLight(color=(0.0, 0.0, 0.0)))
    glb = _asset(assets, CORNELL_GLB)
    if glb is not None:
        from hikari_tpu_torch.io.gltf import load_gltf

        return load_gltf(glb, scene)
    return _procedural_cornell(scene)


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


def cornell_config(size: int = 512, device=None, assets: str | None = None):
    """BASELINE config 1: 'cornell.rs Cornell box: direct lighting only,
    1 bounce, 1 spp, 512x512', on ``cornell_box_scene(assets)``. The
    camera lives on ``device``: the CUDA card unless the caller names
    another (raises without a card)."""
    scene = cornell_box_scene(assets)
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


def minimal_scene() -> Scene:
    """reference examples/minimal.rs:26-52 — plane + cube + sun."""
    sun = _sun_from_euler(-np.pi / 4, np.pi / 4, 0.0, 10000.0)
    scene = Scene(materials=[], directional_light=sun)
    green = scene.add_material(Material(base_color=(0.3, 0.5, 0.3, 1.0)))
    tan = scene.add_material(Material(base_color=(0.8, 0.7, 0.6, 1.0)))
    plane = scene.add_mesh(plane_mesh(5.0))
    cube = scene.add_mesh(cube_mesh(1.0))
    scene.add_instance(Instance(plane, green))
    scene.add_instance(Instance(cube, tan, _transform((0.0, 0.5, 0.0))))
    return scene


def minimal_config(width: int = 512, height: int = 512, device=None):
    """BASELINE config 2: 'minimal.rs single mesh: full path trace 2 bounces
    + emissive sampling'. The camera lives on ``device``, the CUDA card
    unless the caller names another."""
    scene = minimal_scene()
    cam = Camera.from_lookat(eye=(-2.0, 2.5, 5.0), target=(0.0, 0.0, 0.0), device=device)
    settings = RenderSettings(
        width=width, height=height, indirect_bounces=2, upscale=Upscale.none()
    )
    return scene, cam, settings


def simple_scene() -> Scene:
    """reference examples/simple.rs:54-246 (subset: the Bevy-shape
    entities): ground cube, plane, two cubes, two emissive spheres, sun."""
    sun = _sun_from_euler(-np.pi / 4, np.pi / 4, 0.0, 10000.0)
    scene = Scene(materials=[], directional_light=sun)
    ground = scene.add_material(Material(base_color=(0.3, 0.5, 0.3, 1.0)))
    white = scene.add_material(Material(base_color=(1.0, 1.0, 1.0, 1.0)))
    pink = scene.add_material(Material(base_color=(1.0, 0.08, 0.58, 1.0)))
    aqua = scene.add_material(Material(base_color=(0.5, 1.0, 0.83, 1.0)))
    em_a = scene.add_material(Material(base_color=(1, 1, 1, 1), emissive=(1.0, 1.0, 1.0, 0.5)))
    em_b = scene.add_material(Material(base_color=(1, 1, 1, 1), emissive=(1.0, 1.0, 1.0, 0.1)))
    cube = scene.add_mesh(cube_mesh(1.0))
    plane = scene.add_mesh(plane_mesh(1.0))
    sphere = scene.add_mesh(uv_sphere_mesh(1.0, 24, 12))
    scene.add_instance(
        Instance(cube, ground, _transform((0, -5.0, 0), None, (200.0, 10.0, 200.0)))
    )
    wall = _euler_xyz_matrix(0, 0, np.pi / 2)
    scene.add_instance(Instance(plane, white, _transform((4.0, 1.0, 0.0), wall, (4.0, 4.0, 4.0))))
    scene.add_instance(Instance(cube, pink, _transform((-2.0, 0.5, 2.0))))
    scene.add_instance(Instance(cube, aqua, _transform((2.0, 0.5, -2.0))))
    scene.add_instance(Instance(sphere, em_a, _transform((0.0, 4.0, 0.0), None, (0.8,) * 3)))
    scene.add_instance(Instance(sphere, em_b, _transform((5.0, 6.0, -5.0), None, (0.5,) * 3)))
    return scene


def simple_config(width: int = 512, height: int = 512, device=None):
    """BASELINE config 3: ReSTIR temporal reservoir reuse + motion vectors
    (the default settings: SMAA TU4x at 2x, TAA, denoise, indirect spatial
    reuse). The camera lives on ``device``, the CUDA card unless the
    caller names another."""
    scene = simple_scene()
    cam = Camera.from_lookat(eye=(-10.0, 2.5, 20.0), target=(0.0, 0.0, 0.0), device=device)
    settings = RenderSettings(width=width, height=height, temporal_reuse=True)
    return scene, cam, settings


def flight_helmet_scene(assets: str | None = None) -> Scene:
    """The scene of reference examples/scene.rs, as the JAX package's
    ``gltf_scene("FlightHelmet")`` builds it: the FlightHelmet glTF under
    ``assets`` (default: the ``HIKARI_REFERENCE_ASSETS`` directory) under a
    10,000-lux sun at euler (-1.0, 0.6, 0); without the asset, or when its
    checkout is incomplete, the procedural Cornell box under that sun."""
    scene = Scene(materials=[], directional_light=_sun_from_euler(-1.0, 0.6, 0.0, 10000.0))
    path = _asset(assets, FLIGHT_HELMET)
    if path is not None:
        from hikari_tpu_torch.io.gltf import load_gltf

        try:
            return load_gltf(path, scene)
        except (FileNotFoundError, OSError, KeyError):
            pass  # an incomplete asset checkout: the procedural fallback
    return _procedural_cornell(scene)


def scene_config(width: int = 512, height: int = 512, device=None, assets: str | None = None):
    """BASELINE config 4: spatial reservoir reuse (indirect and emissive) +
    the denoise chain, on ``flight_helmet_scene(assets)``. The camera lives
    on ``device``, the CUDA card unless the caller names another."""
    scene = flight_helmet_scene(assets)
    cam = Camera.from_lookat(eye=(1.2, 1.0, 1.2), target=(0.0, 0.4, 0.0), device=device)
    settings = RenderSettings(
        width=width, height=height, indirect_spatial_reuse=True, emissive_spatial_reuse=True,
        denoise=True,
    )
    return scene, cam, settings


def procedural_city(scene: Scene, blocks: int = 8, seed: int = 7, detail: bool = False) -> Scene:
    """Large-scene stand-in for the City config: a grid of buildings with
    varied heights, a ground plane, street lamps (emissive spheres) and the
    scene's sun. ``detail=True`` swaps the plain boxes for window-facade
    tower meshes (``building_mesh``, 8 variants shared across instances —
    the geometry class of the reference's City stage, examples/city.rs).
    At blocks=16, detail=True: 343 instances, 550,994 triangles, 86 lamps."""
    rng = np.random.default_rng(seed)
    ground = scene.add_material(Material(base_color=(0.25, 0.25, 0.27, 1.0)))
    lamp = scene.add_material(Material(base_color=(1, 1, 1, 1), emissive=(1.0, 0.9, 0.7, 0.3)))
    plane = scene.add_mesh(plane_mesh(1.0))
    box = scene.add_mesh(cube_mesh(1.0))
    towers = None
    if detail:
        towers = [
            scene.add_mesh(building_mesh(floors=6 + (v % 4) * 2, cols=4 + v % 3, seed=v))
            for v in range(8)
        ]
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
            mat = scene.add_material(
                Material(
                    base_color=(float(c[0]), float(c[1]), float(c[2]), 1.0),
                    perceptual_roughness=float(rng.uniform(0.3, 0.9)),
                )
            )
            mesh_id = box if towers is None else towers[(i * blocks + j) % 8]
            scene.add_instance(Instance(mesh_id, mat, _transform((x, h / 2, z), None, (w, h, w))))
            if (i + j) % 3 == 0:
                scene.add_instance(
                    Instance(sphere, lamp, _transform((x + 6.0, 3.0, z), None, (0.3, 0.3, 0.3)))
                )
    return scene


def city_scene(blocks: int = 16, detail: bool = True) -> Scene:
    """The City scene as the JAX package's ``gltf_scene("City")`` builds
    it without the City geometry: the procedural city under its sun."""
    scene = Scene(materials=[], directional_light=_sun_from_euler(-1.0, 0.6, 0.0, 10000.0))
    return procedural_city(scene, blocks=blocks, detail=detail)


def city_config(width: int = 512, height: int = 512, device=None):
    """BASELINE config 5: large scene, full pipeline + temporal upscaling +
    differentiable materials. The geometry is ``city_scene()`` (glTF
    loading waits for ``io/gltf.py``); the camera lives on ``device``, the
    CUDA card unless the caller names another."""
    scene = city_scene()
    cam = Camera.from_lookat(eye=(30.0, 20.0, 30.0), target=(0.0, 0.0, 0.0), device=device)
    settings = RenderSettings(
        width=width,
        height=height,
        upscale=Upscale.smaa_tu4x(2.0),
        denoise=True,
    )
    return scene, cam, settings


def procedural_terrain(scene: Scene, n: int = 708, size: float = 200.0, seed: int = 3) -> Scene:
    """Million-triangle stress geometry for the large-scene tracer benches:
    one displaced-grid terrain instance (2*n^2 triangles) plus four
    emissive marker spheres. n=708 gives 1,002,528 terrain triangles."""
    ground = scene.add_material(Material(base_color=(0.35, 0.4, 0.3, 1.0), perceptual_roughness=0.9))
    lamp = scene.add_material(Material(base_color=(1, 1, 1, 1), emissive=(1.0, 0.9, 0.7, 0.3)))
    terr = scene.add_mesh(terrain_mesh(n, size=size, height=size * 0.06, seed=seed))
    scene.add_instance(Instance(terr, ground, _transform((0, 0, 0))))
    sphere = scene.add_mesh(uv_sphere_mesh(1.0, 12, 6))
    rng = np.random.default_rng(seed + 1)
    for _ in range(4):
        x, z = rng.uniform(-size / 3, size / 3, size=2)
        scene.add_instance(
            Instance(sphere, lamp, _transform((float(x), size * 0.08, float(z)), None, (1.0, 1.0, 1.0)))
        )
    return scene


CONFIGS = {
    "cornell": cornell_config,
    "minimal": minimal_config,
    "simple": simple_config,
    "scene": scene_config,
    "city": city_config,
}
