"""Scene compiler: host-side description -> flat SoA device buffers.

The port of ``hikari_tpu.scene.compile``, host numpy code carried over
unchanged: mesh asset compile + BLAS build (reference mesh.rs:106-166),
material compile (material.rs:139-203), and instance compile + TLAS +
emissive light BVH + alias tables (instance.rs:244-444). The output
``SceneArrays`` is lifted to tensors by ``scene/buffers.to_device``.

Triangles are pre-transformed to world space and the per-instance BLAS
trees + the TLAS are stitched into one stackless entry/exit node graph;
instance-restricted traversal (emissive target rays, light.wgsl:687) uses
the per-instance subtree [blas_start, blas_end), and shadow-ray instance
exclusion (light.wgsl:459) the per-node ``inst`` tag.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from hikari_bench.reference.scene.alias import build_alias_table
from hikari_bench.reference.scene.bvh import (
    FlatBvh,
    build_flat_bvh,
    flat_bvh_children,
    offset_bvh,
    tree_depth,
)
from hikari_bench.reference.scene.mesh import Mesh, transform_normals, transform_points

# ---------------------------------------------------------------------------
# Host-side scene description (the "ECS world")
# ---------------------------------------------------------------------------


@dataclass
class Material:
    """Mirrors ``GpuStandardMaterial`` (reference src/mesh_material/mod.rs:203-218)
    with Bevy 0.9 ``StandardMaterial`` defaults. Texture slots use -1 for
    "no texture" (reference uses u32::MAX, material.rs:78-87)."""

    base_color: tuple = (1.0, 1.0, 1.0, 1.0)
    emissive: tuple = (0.0, 0.0, 0.0, 1.0)
    perceptual_roughness: float = 0.5
    metallic: float = 0.01
    reflectance: float = 0.5
    base_color_texture: int = -1
    emissive_texture: int = -1
    metallic_roughness_texture: int = -1
    normal_map_texture: int = -1
    occlusion_texture: int = -1


@dataclass
class Instance:
    """An entity: (mesh handle, material handle, transform) — reference
    ``GpuInstance`` inputs (instance.rs:130-175)."""

    mesh: int
    material: int
    transform: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    previous_transform: np.ndarray | None = None  # for motion vectors

    def __post_init__(self):
        self.transform = np.asarray(self.transform, dtype=np.float32).reshape(4, 4)
        if self.previous_transform is None:
            self.previous_transform = self.transform.copy()
        else:
            self.previous_transform = np.asarray(
                self.previous_transform, dtype=np.float32
            ).reshape(4, 4)


@dataclass
class DirectionalLight:
    """The single directional light the reference samples
    (``lights.directional_lights[0]``, light.wgsl:611)."""

    direction: tuple = (0.0, -1.0, 0.0)  # direction the light travels
    color: tuple = (1.0, 1.0, 1.0)  # premultiplied radiance

    @property
    def direction_to_light(self) -> np.ndarray:
        d = -np.asarray(self.direction, dtype=np.float32)
        return d / max(np.linalg.norm(d), 1e-20)


@dataclass
class Scene:
    meshes: list = field(default_factory=list)
    materials: list = field(default_factory=list)
    instances: list = field(default_factory=list)
    # raw texture images (numpy (h,w,3|4)); Material.*_texture index here
    textures: list = field(default_factory=list)
    directional_light: DirectionalLight = field(default_factory=DirectionalLight)
    # Premultiplied ambient (Bevy AmbientLight color*brightness default 0.05).
    ambient_color: tuple = (0.05, 0.05, 0.05)

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_material(self, material: Material) -> int:
        self.materials.append(material)
        return len(self.materials) - 1

    def add_instance(self, inst: Instance) -> int:
        self.instances.append(inst)
        return len(self.instances) - 1

# ---------------------------------------------------------------------------
# Device-side flat buffers (numpy here; to_device() lifts to tensors)
# ---------------------------------------------------------------------------


@dataclass
class SceneArrays:
    """All scene data as flat numpy SoA arrays, pre-padding. Field-by-field
    analogue of mesh_material_types.wgsl:3-84 plus the stitched node graph."""

    # triangles (world space, grouped by instance, each instance's run in
    # its BLAS depth-first leaf order — spatially coherent, so the tracer
    # backends' 128-triangle clusters get tight AABBs)
    tri_world: np.ndarray  # (P, 3, 3) vertex positions
    tri_vidx: np.ndarray  # (P, 3) global vertex indices
    tri_inst: np.ndarray  # (P,) instance id
    tri_mesh_index: np.ndarray  # (P,) instance-local MESH-order triangle id
    # local-space copy for the device-side transform-update path
    # (scene/update.py; reference rebuilds on events, instance.rs:244-444)
    tri_local: np.ndarray  # (P, 3, 3)

    # vertex attributes (world space, concatenated per instance)
    vert_normal: np.ndarray  # (V, 3)
    vert_uv: np.ndarray  # (V, 2)
    vert_normal_local: np.ndarray  # (V, 3) local-space normals
    vert_inst: np.ndarray  # (V,) owning instance id

    # stitched TLAS+BLAS node graph
    node_min: np.ndarray  # (N, 3)
    node_max: np.ndarray  # (N, 3)
    node_entry: np.ndarray  # (N,) leaf = -(prim+1)
    node_exit: np.ndarray  # (N,)
    node_inst: np.ndarray  # (N,) instance id or -1
    # refit topology: children per node (-1 = none); portals have a single
    # child = their instance's BLAS root
    node_left: np.ndarray  # (N,)
    node_right: np.ndarray  # (N,)
    refit_depth: int  # bottom-up sweeps needed to refit the whole graph
    num_tlas_nodes: int  # nodes [0, num_tlas_nodes) are the TLAS

    # instances
    inst_min: np.ndarray  # (I, 3) world AABB
    inst_max: np.ndarray  # (I, 3)
    inst_material: np.ndarray  # (I,)
    inst_prim_offset: np.ndarray  # (I,)
    inst_prim_count: np.ndarray  # (I,)
    inst_blas_start: np.ndarray  # (I,) node index of instance BLAS root
    inst_blas_end: np.ndarray  # (I,) exit index terminating the subtree walk
    inst_model: np.ndarray  # (I, 4, 4)
    inst_prev_model: np.ndarray  # (I, 4, 4)
    inst_inv_model: np.ndarray  # (I, 4, 4)

    # materials
    mat_base_color: np.ndarray  # (M, 4)
    mat_emissive: np.ndarray  # (M, 4)
    mat_perceptual_roughness: np.ndarray  # (M,)
    mat_metallic: np.ndarray  # (M,)
    mat_reflectance: np.ndarray  # (M,)
    mat_base_color_texture: np.ndarray  # (M,) i32, -1 = none
    mat_emissive_texture: np.ndarray  # (M,)
    mat_metallic_roughness_texture: np.ndarray  # (M,)
    mat_normal_map_texture: np.ndarray  # (M,)
    mat_occlusion_texture: np.ndarray  # (M,)
    tex_atlas: np.ndarray  # (N,) u32 packed RGBA8, native-res flat atlas
    tex_meta: np.ndarray  # (T, 3) i32 [offset, h, w] per texture
    num_textures: int  # T (atlas arrays are 1-padded when T == 0)

    # emissives + light BVH + alias tables
    em_emissive: np.ndarray  # (E, 4)
    em_position: np.ndarray  # (E, 3)
    em_radius: np.ndarray  # (E,)
    em_instance: np.ndarray  # (E,)
    em_alias_offset: np.ndarray  # (E,)
    em_alias_count: np.ndarray  # (E,)
    em_surface_area: np.ndarray  # (E,)
    enode_min: np.ndarray  # (EN, 3)
    enode_max: np.ndarray  # (EN, 3)
    enode_entry: np.ndarray  # (EN,) leaf = -(emissive+1)
    enode_exit: np.ndarray  # (EN,)
    enode_left: np.ndarray  # (EN,) refit children
    enode_right: np.ndarray  # (EN,)
    erefit_depth: int
    alias_prob: np.ndarray  # (A,)
    alias_index: np.ndarray  # (A,) instance-local primitive index

    # lights
    sun_direction_to_light: np.ndarray  # (3,)
    sun_color: np.ndarray  # (3,)
    ambient_color: np.ndarray  # (3,)


def _build_texture_atlas(scene: Scene):
    """The empty atlas of a scene without textures, which the reference
    frame does not sample."""
    if scene.textures:
        raise ValueError("the reference frame samples no textures")
    return np.zeros((1,), dtype=np.uint32), np.zeros((1, 3), dtype=np.int32)


def compile_scene(scene: Scene, builder: str = "native") -> SceneArrays:
    """Run the full host scene compile (reference Extract/Prepare stages,
    SURVEY.md §3.2): triangulate -> world transform -> BLAS per instance ->
    TLAS -> stitch -> emissive detection -> alias tables -> emissive BVH.
    ``builder`` ("native" or "numpy") builds every BVH and alias table; the
    triangle order follows it."""
    insts = scene.instances
    num_inst = len(insts)
    if num_inst == 0:
        raise ValueError("scene has no instances")

    tri_world, tri_vidx, tri_inst, tri_local = [], [], [], []
    tri_mesh_index, inst_perm = [], []
    vert_normal, vert_uv, vert_normal_local, vert_inst = [], [], [], []
    inst_min, inst_max = [], []
    inst_material = np.array([i.material for i in insts], dtype=np.int32)
    inst_prim_offset, inst_prim_count = [], []
    inst_model = np.stack([i.transform for i in insts])
    inst_prev_model = np.stack([i.previous_transform for i in insts])
    inst_inv_model = np.stack([np.linalg.inv(i.transform) for i in insts])

    blas_list: list[FlatBvh] = []
    vert_offset = 0
    prim_offset = 0
    for inst_id, inst in enumerate(insts):
        mesh: Mesh = scene.meshes[inst.mesh]
        wpos = transform_points(inst.transform, mesh.positions)
        wnorm = transform_normals(inst.transform, mesh.normals)
        tris = wpos[mesh.indices]  # (p, 3, 3)

        lo = tris.min(axis=1)
        hi = tris.max(axis=1)
        blas = build_flat_bvh(lo, hi, builder)
        # Reorder this instance's triangles into the BLAS's depth-first
        # leaf order, as the port's compile does (the order sets the prim
        # ids and the light samples). Leaf entries are then relabeled to
        # the permuted ids (leaf rank i now holds local prim i).
        leaf_mask = blas.entry < 0
        perm = (-blas.entry[leaf_mask] - 1).astype(np.int64)
        blas.entry[leaf_mask] = -(
            np.arange(len(perm), dtype=np.int32) + 1
        )
        blas_list.append(blas)
        inst_perm.append(perm)

        tri_world.append(tris[perm])
        tri_vidx.append(mesh.indices[perm].astype(np.int32) + vert_offset)
        tri_inst.append(np.full(len(tris), inst_id, dtype=np.int32))
        tri_mesh_index.append(perm.astype(np.int32))
        tri_local.append(mesh.positions[mesh.indices[perm]])
        vert_normal.append(wnorm)
        vert_uv.append(mesh.uvs)
        vert_normal_local.append(mesh.normals)
        vert_inst.append(np.full(mesh.num_vertices, inst_id, dtype=np.int32))

        inst_min.append(wpos.min(axis=0))
        inst_max.append(wpos.max(axis=0))

        inst_prim_offset.append(prim_offset)
        inst_prim_count.append(len(tris))
        vert_offset += mesh.num_vertices
        prim_offset += len(tris)

    tri_world = np.concatenate(tri_world).astype(np.float32)
    tri_vidx = np.concatenate(tri_vidx)
    tri_inst = np.concatenate(tri_inst)
    tri_mesh_index = np.concatenate(tri_mesh_index)
    tri_local = np.concatenate(tri_local).astype(np.float32)
    vert_normal = np.concatenate(vert_normal).astype(np.float32)
    vert_uv = np.concatenate(vert_uv).astype(np.float32)
    vert_normal_local = np.concatenate(vert_normal_local).astype(np.float32)
    vert_inst = np.concatenate(vert_inst)
    inst_min = np.stack(inst_min).astype(np.float32)
    inst_max = np.stack(inst_max).astype(np.float32)
    inst_prim_offset = np.asarray(inst_prim_offset, dtype=np.int32)
    inst_prim_count = np.asarray(inst_prim_count, dtype=np.int32)

    # --- stitch TLAS + per-instance BLAS into one node graph ---
    tlas = build_flat_bvh(inst_min, inst_max, builder)
    tlas_count = tlas.count
    blas_offsets = np.zeros(num_inst, dtype=np.int32)
    total = tlas_count
    for i, b in enumerate(blas_list):
        blas_offsets[i] = total
        total += b.count

    node_min = np.zeros((total, 3), dtype=np.float32)
    node_max = np.zeros((total, 3), dtype=np.float32)
    node_entry = np.zeros(total, dtype=np.int32)
    node_exit = np.zeros(total, dtype=np.int32)
    node_inst = np.full(total, -1, dtype=np.int32)
    node_left = np.full(total, -1, dtype=np.int32)
    node_right = np.full(total, -1, dtype=np.int32)

    # TLAS nodes; leaves become portals into the instance BLAS.
    node_min[:tlas_count] = tlas.mins
    node_max[:tlas_count] = tlas.maxs
    node_exit[:tlas_count] = np.where(
        tlas.exit >= tlas_count, total, tlas.exit
    )  # "leave TLAS" = leave whole graph
    tlas_left, tlas_right = flat_bvh_children(tlas)
    node_left[:tlas_count] = tlas_left
    node_right[:tlas_count] = tlas_right
    inst_blas_start = np.zeros(num_inst, dtype=np.int32)
    inst_blas_end = np.zeros(num_inst, dtype=np.int32)
    for t in range(tlas_count):
        e = tlas.entry[t]
        if e < 0:  # TLAS leaf -> portal
            inst_id = -e - 1
            node_entry[t] = blas_offsets[inst_id]
            node_inst[t] = inst_id
            inst_blas_start[inst_id] = blas_offsets[inst_id]
            inst_blas_end[inst_id] = node_exit[t]
            # Refit: portal AABB mirrors its BLAS root (single child).
            node_left[t] = blas_offsets[inst_id]
            node_right[t] = -1
        else:
            node_entry[t] = e

    for inst_id, b in enumerate(blas_list):
        off = int(blas_offsets[inst_id])
        portal_exit = int(inst_blas_end[inst_id])
        shifted = offset_bvh(b, off, portal_exit)
        sl = slice(off, off + b.count)
        node_min[sl] = shifted.mins
        node_max[sl] = shifted.maxs
        # Re-base leaf primitive ids to global triangle indices.
        entry = shifted.entry
        leaf = entry < 0
        entry = np.where(leaf, entry - int(inst_prim_offset[inst_id]), entry)
        node_entry[sl] = entry
        node_exit[sl] = shifted.exit
        node_inst[sl] = inst_id
        bl, br = flat_bvh_children(b)
        node_left[sl] = np.where(bl >= 0, bl + off, -1)
        node_right[sl] = np.where(br >= 0, br + off, -1)

    refit_depth = tree_depth(node_left, node_right, root=0)

    # --- emissives: detection, alias tables, bounding spheres, light BVH ---
    # (reference src/mesh_material/instance.rs:380-428)
    em_emissive, em_position, em_radius = [], [], []
    em_instance, em_alias_offset, em_alias_count, em_surface_area = [], [], [], []
    alias_prob_all, alias_index_all = [], []
    for inst_id, inst in enumerate(insts):
        mat: Material = scene.materials[inst.material]
        emissive = np.asarray(mat.emissive, dtype=np.float32)
        intensity = 255.0 * emissive[3] * np.linalg.norm(emissive[:3])
        if intensity <= 0.0:
            continue
        mesh: Mesh = scene.meshes[inst.mesh]
        # Areas in the instance's DFS-leaf triangle order: alias_index
        # values are instance-local PERMUTED prim ids (sampling converts
        # them to global ids via inst_prim_offset, render/sampling.py:212).
        areas = mesh.triangle_areas(inst.transform)[inst_perm[inst_id]]
        prob, index = build_alias_table(areas, builder)
        em_emissive.append(emissive)
        center = 0.5 * (inst_min[inst_id] + inst_max[inst_id])
        diag = inst_max[inst_id] - inst_min[inst_id]
        em_position.append(center)
        em_radius.append(0.5 * np.linalg.norm(diag) + np.sqrt(intensity))
        em_instance.append(inst_id)
        em_alias_offset.append(len(alias_prob_all))
        em_alias_count.append(len(prob))
        em_surface_area.append(float(areas.sum()))
        alias_prob_all.extend(prob.tolist())
        alias_index_all.extend(index.tolist())

    num_em = len(em_instance)
    if num_em:
        em_position_a = np.asarray(em_position, dtype=np.float32)
        em_radius_a = np.asarray(em_radius, dtype=np.float32)
        ebvh = build_flat_bvh(
            em_position_a - em_radius_a[:, None], em_position_a + em_radius_a[:, None], builder
        )
        enode_min, enode_max = ebvh.mins, ebvh.maxs
        enode_entry, enode_exit = ebvh.entry, ebvh.exit
        enode_left, enode_right = flat_bvh_children(ebvh)
        erefit_depth = tree_depth(enode_left, enode_right, root=0)
    else:
        em_position_a = np.zeros((0, 3), dtype=np.float32)
        em_radius_a = np.zeros((0,), dtype=np.float32)
        enode_min = np.zeros((0, 3), dtype=np.float32)
        enode_max = np.zeros((0, 3), dtype=np.float32)
        enode_entry = np.zeros((0,), dtype=np.int32)
        enode_exit = np.zeros((0,), dtype=np.int32)
        enode_left = np.zeros((0,), dtype=np.int32)
        enode_right = np.zeros((0,), dtype=np.int32)
        erefit_depth = 0

    mats = scene.materials
    return SceneArrays(
        tri_world=tri_world,
        tri_vidx=tri_vidx,
        tri_inst=tri_inst,
        tri_mesh_index=tri_mesh_index,
        tri_local=tri_local,
        vert_normal=vert_normal,
        vert_uv=vert_uv,
        vert_normal_local=vert_normal_local,
        vert_inst=vert_inst,
        node_min=node_min,
        node_max=node_max,
        node_entry=node_entry,
        node_exit=node_exit,
        node_inst=node_inst,
        node_left=node_left,
        node_right=node_right,
        refit_depth=refit_depth,
        num_tlas_nodes=tlas_count,
        inst_min=inst_min,
        inst_max=inst_max,
        inst_material=inst_material,
        inst_prim_offset=inst_prim_offset,
        inst_prim_count=inst_prim_count,
        inst_blas_start=inst_blas_start,
        inst_blas_end=inst_blas_end,
        inst_model=inst_model.astype(np.float32),
        inst_prev_model=inst_prev_model.astype(np.float32),
        inst_inv_model=inst_inv_model.astype(np.float32),
        mat_base_color=np.asarray(
            [m.base_color for m in mats], dtype=np.float32
        ).reshape(-1, 4),
        mat_emissive=np.asarray([m.emissive for m in mats], dtype=np.float32).reshape(
            -1, 4
        ),
        mat_perceptual_roughness=np.asarray(
            [m.perceptual_roughness for m in mats], dtype=np.float32
        ),
        mat_metallic=np.asarray([m.metallic for m in mats], dtype=np.float32),
        mat_reflectance=np.asarray([m.reflectance for m in mats], dtype=np.float32),
        mat_base_color_texture=np.asarray(
            [m.base_color_texture for m in mats], dtype=np.int32
        ),
        mat_emissive_texture=np.asarray(
            [m.emissive_texture for m in mats], dtype=np.int32
        ),
        mat_metallic_roughness_texture=np.asarray(
            [m.metallic_roughness_texture for m in mats], dtype=np.int32
        ),
        mat_normal_map_texture=np.asarray(
            [m.normal_map_texture for m in mats], dtype=np.int32
        ),
        mat_occlusion_texture=np.asarray(
            [m.occlusion_texture for m in mats], dtype=np.int32
        ),
        tex_atlas=_build_texture_atlas(scene)[0],
        tex_meta=_build_texture_atlas(scene)[1],
        num_textures=len(scene.textures),
        em_emissive=np.asarray(em_emissive, dtype=np.float32).reshape(-1, 4),
        em_position=em_position_a,
        em_radius=em_radius_a,
        em_instance=np.asarray(em_instance, dtype=np.int32),
        em_alias_offset=np.asarray(em_alias_offset, dtype=np.int32),
        em_alias_count=np.asarray(em_alias_count, dtype=np.int32),
        em_surface_area=np.asarray(em_surface_area, dtype=np.float32),
        enode_min=enode_min,
        enode_max=enode_max,
        enode_entry=enode_entry,
        enode_exit=enode_exit,
        enode_left=enode_left,
        enode_right=enode_right,
        erefit_depth=erefit_depth,
        alias_prob=np.asarray(alias_prob_all, dtype=np.float32),
        alias_index=np.asarray(alias_index_all, dtype=np.int32),
        sun_direction_to_light=scene.directional_light.direction_to_light.astype(
            np.float32
        ),
        sun_color=np.asarray(scene.directional_light.color, dtype=np.float32),
        ambient_color=np.asarray(scene.ambient_color, dtype=np.float32),
    )
