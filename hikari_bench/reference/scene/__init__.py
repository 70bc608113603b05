"""Scene layer: host-side compile of meshes/materials/instances into flat
device tensors (port of ``hikari_tpu.scene``)."""

from hikari_bench.reference.scene.mesh import Mesh, cube_mesh, quad_mesh
from hikari_bench.reference.scene.compile import (
    DirectionalLight,
    Instance,
    Material,
    Scene,
    SceneArrays,
    compile_scene,
)
from hikari_bench.reference.scene.buffers import SceneBuffers, build_scene_buffers, to_device
from hikari_bench.reference.scene.bvh import FlatBvh, build_flat_bvh, validate_flat_bvh
from hikari_bench.reference.scene.alias import build_alias_table

__all__ = [
    "Mesh",
    "cube_mesh",
    "quad_mesh",
    "DirectionalLight",
    "Instance",
    "Material",
    "Scene",
    "SceneArrays",
    "compile_scene",
    "SceneBuffers",
    "build_scene_buffers",
    "to_device",
    "FlatBvh",
    "build_flat_bvh",
    "validate_flat_bvh",
    "build_alias_table",
]
