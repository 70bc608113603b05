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

from hikari_tpu_torch.scene.alias import build_alias_table
from hikari_tpu_torch.scene.bvh import (
    build_flat_bvh,
    build_flat_bvhs,
    flat_bvh_children,
    tree_depth,
)
from hikari_tpu_torch.scene.mesh import Mesh

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

    def add_texture(self, image) -> int:
        self.textures.append(image)
        return len(self.textures) - 1


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
    from hikari_tpu_torch.render.texture import build_texture_atlas

    return build_texture_atlas(scene.textures)


def compile_scene(scene: Scene, builder: str = "native") -> SceneArrays:
    """Run the full host scene compile (reference Extract/Prepare stages,
    SURVEY.md §3.2): triangulate -> world transform -> BLAS per instance ->
    TLAS -> stitch -> emissive detection -> alias tables -> emissive BVH.
    ``builder`` ("native" or "numpy") builds every BVH and alias table; the
    triangle order follows it.

    The work is batched, not looped per instance: the transforms run over
    all instances of a mesh at once, the BLASes in one native call, and
    the stitch over every node at once. The arrays are the per-instance
    loop's bit for bit (the same operations on the same values)."""
    insts = scene.instances
    num_inst = len(insts)
    if num_inst == 0:
        raise ValueError("scene has no instances")

    inst_mesh = np.array([i.mesh for i in insts], dtype=np.int64)
    inst_material = np.array([i.material for i in insts], dtype=np.int32)
    inst_model = np.stack([i.transform for i in insts])
    inst_prev_model = np.stack([i.previous_transform for i in insts])
    inst_inv_model = np.linalg.inv(inst_model)

    tri_count = np.array([len(m.indices) for m in scene.meshes], dtype=np.int64)[inst_mesh]
    vert_count = np.array([m.num_vertices for m in scene.meshes], dtype=np.int64)[inst_mesh]
    prim_start = np.concatenate([[0], np.cumsum(tri_count)[:-1]]).astype(np.int64)
    vert_start = np.concatenate([[0], np.cumsum(vert_count)[:-1]]).astype(np.int64)
    P, V = int(tri_count.sum()), int(vert_count.sum())

    # World space, in each instance's mesh order, mesh by mesh.
    tris = np.empty((P, 3, 3), dtype=np.float32)
    local = np.empty((P, 3, 3), dtype=np.float32)
    vidx = np.empty((P, 3), dtype=np.int64)
    vert_normal = np.empty((V, 3), dtype=np.float32)
    vert_uv = np.empty((V, 2), dtype=np.float32)
    vert_normal_local = np.empty((V, 3), dtype=np.float32)
    inst_min = np.empty((num_inst, 3), dtype=np.float32)
    inst_max = np.empty((num_inst, 3), dtype=np.float32)
    for m in np.unique(inst_mesh):
        ids = np.nonzero(inst_mesh == m)[0]
        mesh: Mesh = scene.meshes[m]
        model = inst_model[ids]
        # transform_points and transform_normals, over the instances at once.
        wpos = np.matmul(mesh.positions[None], model[:, :3, :3].transpose(0, 2, 1))
        wpos = wpos + model[:, None, :3, 3]
        wnorm = np.matmul(mesh.normals[None], np.linalg.inv(model[:, :3, :3]))
        wnorm = wnorm / np.maximum(np.linalg.norm(wnorm, axis=-1, keepdims=True), 1e-20)
        rows = (prim_start[ids][:, None] + np.arange(len(mesh.indices))).reshape(-1)
        vrows = (vert_start[ids][:, None] + np.arange(mesh.num_vertices)).reshape(-1)
        tris[rows] = wpos[:, mesh.indices].reshape(-1, 3, 3)
        local[rows] = np.broadcast_to(mesh.positions[mesh.indices],
                                      (len(ids),) + (len(mesh.indices), 3, 3)).reshape(-1, 3, 3)
        vidx[rows] = np.broadcast_to(mesh.indices, (len(ids),) + mesh.indices.shape).reshape(-1, 3)
        vert_normal[vrows] = wnorm.reshape(-1, 3)
        vert_uv[vrows] = np.broadcast_to(mesh.uvs, (len(ids),) + mesh.uvs.shape).reshape(-1, 2)
        vert_normal_local[vrows] = np.broadcast_to(
            mesh.normals, (len(ids),) + mesh.normals.shape).reshape(-1, 3)
        inst_min[ids] = wpos.min(axis=1)
        inst_max[ids] = wpos.max(axis=1)

    # One BLAS per instance. Each instance's triangles go into its BLAS's
    # depth-first leaf order: the SAH tree is spatially coherent, so the
    # tracer backends' fixed 128-triangle clusters (trace/tiled.py,
    # trace/pallas_tiled.py) inherit tight AABBs instead of
    # mesh-emission-order luck. Leaf entries are then relabeled to the
    # permuted ids (leaf rank i now holds local prim i).
    blas_min, blas_max, blas_entry, blas_exit, node_count = build_flat_bvhs(
        tris.min(axis=1), tris.max(axis=1), tri_count, builder)
    leaf = blas_entry < 0
    tri_owner = np.repeat(np.arange(num_inst, dtype=np.int64), tri_count)
    perm = (-blas_entry[leaf] - 1).astype(np.int64)  # instance-local, in instance order
    rank = np.arange(P, dtype=np.int64) - prim_start[tri_owner]
    src = prim_start[tri_owner] + perm

    tri_world = tris[src]
    tri_vidx = (vidx[src] + vert_start[tri_owner][:, None]).astype(np.int32)
    tri_inst = tri_owner.astype(np.int32)
    tri_mesh_index = perm.astype(np.int32)
    tri_local = local[src]
    vert_inst = np.repeat(np.arange(num_inst, dtype=np.int32), vert_count)
    inst_prim_offset = prim_start.astype(np.int32)
    inst_prim_count = tri_count.astype(np.int32)

    # --- stitch TLAS + per-instance BLAS into one node graph ---
    tlas = build_flat_bvh(inst_min, inst_max, builder)
    tlas_count = tlas.count
    node_start = np.concatenate([[0], np.cumsum(node_count)[:-1]]).astype(np.int64)
    blas_offsets = (tlas_count + node_start).astype(np.int32)
    total = tlas_count + int(node_count.sum())

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
    node_entry[:tlas_count] = tlas.entry
    portal = np.nonzero(tlas.entry < 0)[0]
    portal_inst = -tlas.entry[portal] - 1
    node_entry[portal] = blas_offsets[portal_inst]
    node_inst[portal] = portal_inst
    inst_blas_start = np.zeros(num_inst, dtype=np.int32)
    inst_blas_end = np.zeros(num_inst, dtype=np.int32)
    inst_blas_start[portal_inst] = blas_offsets[portal_inst]
    inst_blas_end[portal_inst] = node_exit[portal]
    # Refit: portal AABB mirrors its BLAS root (single child).
    node_left[portal] = blas_offsets[portal_inst]
    node_right[portal] = -1

    # Every BLAS node at once: internal entries and exits shifted to the
    # node's place in the graph, "leave the tree" rewired to the portal's
    # exit, leaf primitive ids re-based to global triangle indices.
    owner = np.repeat(np.arange(num_inst, dtype=np.int64), node_count)
    off = blas_offsets[owner].astype(np.int64)
    internal = ~leaf
    sl = slice(tlas_count, total)
    node_min[sl] = blas_min
    node_max[sl] = blas_max
    entry = blas_entry + off
    entry[leaf] = -(rank + 1) - prim_start[tri_owner]
    node_entry[sl] = entry
    node_exit[sl] = np.where(blas_exit >= node_count[owner], inst_blas_end[owner], blas_exit + off)
    node_inst[sl] = owner
    left_local = np.where(internal, blas_entry, -1).astype(np.int64)
    right_local = np.where(internal, blas_exit[node_start[owner] + np.maximum(left_local, 0)], -1)
    node_left[sl] = np.where(left_local >= 0, left_local + off, -1)
    node_right[sl] = np.where(right_local >= 0, right_local + off, -1)

    refit_depth = tree_depth(node_left, node_right, root=0)

    # --- emissives: detection, alias tables, bounding spheres, light BVH ---
    # (reference src/mesh_material/instance.rs:380-428)
    em_emissive, em_position, em_radius = [], [], []
    em_instance, em_alias_offset, em_alias_count, em_surface_area = [], [], [], []
    alias_prob_all, alias_index_all = [], []
    mat_emissive = [np.asarray(m.emissive, dtype=np.float32) for m in scene.materials]
    mat_intensity = [255.0 * e[3] * np.linalg.norm(e[:3]) for e in mat_emissive]
    for inst_id in range(num_inst):
        if mat_intensity[inst_material[inst_id]] <= 0.0:
            continue
        inst = insts[inst_id]
        emissive = mat_emissive[inst.material]
        intensity = mat_intensity[inst.material]
        mesh: Mesh = scene.meshes[inst.mesh]
        # Areas in the instance's DFS-leaf triangle order: alias_index
        # values are instance-local PERMUTED prim ids (sampling converts
        # them to global ids via inst_prim_offset, render/sampling.py:212).
        s0 = prim_start[inst_id]
        areas = mesh.triangle_areas(inst.transform)[perm[s0:s0 + tri_count[inst_id]]]
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
    tex_atlas, tex_meta = _build_texture_atlas(scene)
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
        tex_atlas=tex_atlas,
        tex_meta=tex_meta,
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
