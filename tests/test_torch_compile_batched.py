"""The batched scene compile (``scene/compile.compile_scene``) against a
kept copy of the per-instance loop it replaced (``_compile_loop`` below,
as it stood before the batching): every array bit for bit and every
integer equal, with both BVH builders, on the Cornell box, the procedural
city at 8 blocks, Bevy's ``many_cubes`` at a grid of 20, and a scene whose
meshes mix instance orders and emissives. The batched native BLAS build
equals one build per set."""


import numpy as np
import pytest

from hikari_tpu_torch.io import scenes
from hikari_tpu_torch.scene.alias import build_alias_table
from hikari_tpu_torch.scene.bvh import (
    FlatBvh,
    build_flat_bvh,
    build_flat_bvhs,
    flat_bvh_children,
)
from hikari_tpu_torch.scene.compile import compile_scene
from hikari_tpu_torch.scene.mesh import Mesh, transform_normals, transform_points


def offset_bvh(bvh, node_offset, exit_remap):
    count = bvh.count
    entry = bvh.entry.copy()
    internal = entry >= 0
    entry[internal] += node_offset
    exit_ = np.where(bvh.exit >= count, exit_remap, bvh.exit + node_offset)
    return FlatBvh(bvh.mins.copy(), bvh.maxs.copy(), entry, exit_.astype(np.int32),
                   bvh.inst.copy())


def tree_depth(left, right, root=0):
    if len(left) == 0:
        return 0
    depth = 0
    frontier = [root]
    while frontier:
        nxt = []
        for i in frontier:
            l, r = int(left[i]), int(right[i])
            if l >= 0:
                nxt.append(l)
            if r >= 0 and r != l:
                nxt.append(r)
        if not nxt:
            break
        depth += 1
        frontier = nxt
    return depth


def _compile_loop(scene, builder: str = "native"):
    """The compile before batching: a Python loop per instance."""
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
        # leaf order: the SAH tree is spatially coherent, so the tracer
        # backends' fixed 128-triangle clusters (trace/tiled.py,
        # trace/pallas_tiled.py) inherit tight AABBs instead of
        # mesh-emission-order luck. Leaf entries are then relabeled to
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

    return dict(
        tri_world=tri_world, tri_vidx=tri_vidx, tri_inst=tri_inst, tri_mesh_index=tri_mesh_index,
        tri_local=tri_local, vert_normal=vert_normal, vert_uv=vert_uv,
        vert_normal_local=vert_normal_local, vert_inst=vert_inst, node_min=node_min,
        node_max=node_max, node_entry=node_entry, node_exit=node_exit, node_inst=node_inst,
        node_left=node_left, node_right=node_right, refit_depth=refit_depth,
        num_tlas_nodes=tlas_count, inst_min=inst_min, inst_max=inst_max,
        inst_material=inst_material, inst_prim_offset=inst_prim_offset,
        inst_prim_count=inst_prim_count, inst_blas_start=inst_blas_start,
        inst_blas_end=inst_blas_end, inst_model=inst_model.astype(np.float32),
        inst_prev_model=inst_prev_model.astype(np.float32),
        inst_inv_model=inst_inv_model.astype(np.float32),
        em_emissive=np.asarray(em_emissive, dtype=np.float32).reshape(-1, 4),
        em_position=em_position_a, em_radius=em_radius_a,
        em_instance=np.asarray(em_instance, dtype=np.int32),
        em_alias_offset=np.asarray(em_alias_offset, dtype=np.int32),
        em_alias_count=np.asarray(em_alias_count, dtype=np.int32),
        em_surface_area=np.asarray(em_surface_area, dtype=np.float32),
        enode_min=enode_min, enode_max=enode_max, enode_entry=enode_entry,
        enode_exit=enode_exit, enode_left=enode_left, enode_right=enode_right,
        erefit_depth=erefit_depth, alias_prob=np.asarray(alias_prob_all, dtype=np.float32),
        alias_index=np.asarray(alias_index_all, dtype=np.int32),
    )


def _mixed_scene():
    """Three meshes whose instances interleave, rotated and scaled, two
    of them emissive."""
    scene = scenes.Scene(materials=[])
    plain = scene.add_material(scenes.Material(base_color=(0.5, 0.5, 0.5, 1.0)))
    glow = scene.add_material(scenes.Material(emissive=(1.0, 0.5, 0.2, 0.4)))
    meshes = [scene.add_mesh(scenes.cube_mesh(1.0)), scene.add_mesh(scenes.uv_sphere_mesh(1.0, 8, 5)),
              scene.add_mesh(scenes.plane_mesh(2.0))]
    rng = np.random.default_rng(3)
    for k in range(40):
        rot = scenes._euler_xyz_matrix(*rng.uniform(-3, 3, 3))
        scene.add_instance(scenes.Instance(
            meshes[k % 3], glow if k % 7 == 0 else plain,
            scenes._transform(tuple(rng.uniform(-20, 20, 3)), rot, tuple(rng.uniform(0.2, 3, 3)))))
    return scene


SCENES = {
    "cornell": lambda: scenes.cornell_box_scene(assets=""),
    "city8": lambda: scenes.city_scene(blocks=8, detail=False),
    "many_cubes20": lambda: scenes.many_cubes_scene(grid=20),
    "mixed": _mixed_scene,
}


def _assert_same(got, want):
    for name, w in want.items():
        g = getattr(got, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), name
        else:
            assert g == w, name


@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_batched_compile_equals_the_loop(name, builder):
    scene = SCENES[name]()
    _assert_same(compile_scene(scene, builder), _compile_loop(scene, builder))


def test_build_many_equals_one_build_a_set():
    rng = np.random.default_rng(0)
    counts = np.array([1, 12, 0, 7, 300, 2])
    lo = rng.uniform(-5, 5, (counts.sum(), 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, lo.shape).astype(np.float32)
    mins, maxs, entry, exit_, nodes = build_flat_bvhs(lo, hi, counts)
    start, node = 0, 0
    for n, c in zip(counts, nodes):
        one = build_flat_bvh(lo[start:start + n], hi[start:start + n])
        assert c == one.count == max(2 * n - 1, 0)
        for a, b in ((mins, one.mins), (maxs, one.maxs), (entry, one.entry), (exit_, one.exit)):
            assert np.array_equal(a[node:node + c], b)
        start, node = start + n, node + c
