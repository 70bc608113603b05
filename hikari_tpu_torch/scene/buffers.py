"""Device-side scene buffers: a frozen dataclass of tensors, the port of
``hikari_tpu.scene.buffers.SceneBuffers`` (reference mesh/material bind
group, src/mesh_material/mod.rs:488-675). Array sizes are padded to the
same multiples as the JAX package, so both packages index the same rows.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from hikari_tpu_torch.scene.compile import Scene, SceneArrays, compile_scene
from hikari_tpu_torch.utils import resolve_device


def _round_up(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


@dataclass(frozen=True)
class SceneBuffers:
    """Flat SoA scene tensors on one device. ``num_*`` fields are plain
    ints: they bound loops and gate emissive sampling on the host."""

    # triangles
    tri_world: torch.Tensor  # (P, 3, 3) f32
    tri_vidx: torch.Tensor  # (P, 3) i32
    tri_inst: torch.Tensor  # (P,) i32
    tri_mesh_index: torch.Tensor  # (P,) i32
    tri_local: torch.Tensor  # (P, 3, 3) f32
    # plane/dual-basis form (trace/intersect.precompute_triangles)
    tri_n: torch.Tensor  # (P, 3)
    tri_eu: torch.Tensor  # (P, 3)
    tri_ev: torch.Tensor  # (P, 3)
    tri_cn: torch.Tensor  # (P,)
    tri_cu: torch.Tensor  # (P,)
    tri_cv: torch.Tensor  # (P,)
    tri_valid: torch.Tensor  # (P,) bool
    # vertex attributes
    vert_normal: torch.Tensor  # (V, 3)
    vert_uv: torch.Tensor  # (V, 2)
    vert_normal_local: torch.Tensor  # (V, 3)
    vert_inst: torch.Tensor  # (V,) i32, -1 on padding
    # stitched node graph
    node_min: torch.Tensor
    node_max: torch.Tensor
    node_entry: torch.Tensor
    node_exit: torch.Tensor
    node_inst: torch.Tensor
    node_left: torch.Tensor
    node_right: torch.Tensor
    # instances
    inst_min: torch.Tensor
    inst_max: torch.Tensor
    inst_material: torch.Tensor
    inst_prim_offset: torch.Tensor
    inst_prim_count: torch.Tensor
    inst_blas_start: torch.Tensor
    inst_blas_end: torch.Tensor
    inst_model: torch.Tensor
    inst_prev_model: torch.Tensor
    inst_inv_model: torch.Tensor
    inst_active: torch.Tensor  # (I,) bool
    # materials
    mat_base_color: torch.Tensor
    mat_emissive: torch.Tensor
    mat_perceptual_roughness: torch.Tensor
    mat_metallic: torch.Tensor
    mat_reflectance: torch.Tensor
    mat_base_color_texture: torch.Tensor
    mat_emissive_texture: torch.Tensor
    mat_metallic_roughness_texture: torch.Tensor
    mat_normal_map_texture: torch.Tensor
    mat_occlusion_texture: torch.Tensor
    tex_atlas: torch.Tensor  # (N,) packed RGBA8 texels, held in int64
    tex_meta: torch.Tensor  # (T, 3) i32 [offset, h, w]
    # emissives
    em_emissive: torch.Tensor
    em_position: torch.Tensor
    em_radius: torch.Tensor
    em_instance: torch.Tensor
    em_alias_offset: torch.Tensor
    em_alias_count: torch.Tensor
    em_surface_area: torch.Tensor
    enode_min: torch.Tensor
    enode_max: torch.Tensor
    enode_entry: torch.Tensor
    enode_exit: torch.Tensor
    enode_left: torch.Tensor
    enode_right: torch.Tensor
    alias_prob: torch.Tensor
    alias_index: torch.Tensor
    # lights
    sun_direction_to_light: torch.Tensor
    sun_color: torch.Tensor
    ambient_color: torch.Tensor
    # The tile walk's row order (trace/tile_walk.tile_clusters): the prim of
    # each of the (P,) rows, whole instances in the TLAS's depth-first leaf
    # order, each instance's prims in order, padding last.
    tile_rows: torch.Tensor

    num_tris: int = 0
    num_nodes: int = 0
    num_instances: int = 0
    num_emissives: int = 0
    num_enodes: int = 0
    num_materials: int = 0
    num_textures: int = 0
    refit_depth: int = 0
    erefit_depth: int = 0
    num_tlas_nodes: int = 0

    @property
    def device(self) -> torch.device:
        return self.tri_world.device


def _pad(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad axis 0 of ``arr`` to length ``n``."""
    arr = np.asarray(arr)
    if len(arr) >= n:
        return arr
    pad_shape = (n - len(arr),) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)])


def tile_rows(arrays, padded: int) -> np.ndarray:
    """(padded,) int32: the prims in the tile walk's row order. Instances
    take the order of the TLAS's leaves, depth first (the nodes
    [0, num_tlas_nodes) of the stitched graph, whose portals carry their
    instance), which keeps near instances together; each instance's prims
    stay in order; the padding prims come last."""
    tlas_inst = np.asarray(arrays.node_inst[: int(arrays.num_tlas_nodes)])
    order = tlas_inst[tlas_inst >= 0]
    count = np.asarray(arrays.inst_prim_count)[order].astype(np.int64)
    first = np.asarray(arrays.inst_prim_offset)[order].astype(np.int64)
    before = np.cumsum(count) - count
    rows = np.repeat(first - before, count) + np.arange(int(count.sum()))
    return np.concatenate([rows, np.arange(len(rows), padded)]).astype(np.int32)


def to_device(
    arrays: SceneArrays,
    device=None,
    tri_pad: int = 128,
    node_pad: int = 128,
) -> SceneBuffers:
    """Pad + upload compiled scene arrays to ``device`` (the CUDA card
    unless the caller names another). Takes any object with
    ``SceneArrays``' numpy fields — the JAX package's compile output
    included, which is how the tests feed one compiled scene to both
    packages. Padded triangles are degenerate (guaranteed miss); padded
    nodes are unreachable."""
    from hikari_tpu_torch.trace.intersect import precompute_triangles

    device = resolve_device(device)

    num_tris = len(arrays.tri_world)
    num_nodes = len(arrays.node_entry)
    num_inst = len(arrays.inst_material)
    num_em = len(arrays.em_instance)
    num_enodes = len(arrays.enode_entry)

    p = _round_up(num_tris, tri_pad)
    n = _round_up(num_nodes, node_pad)
    v = _round_up(len(arrays.vert_normal), tri_pad)
    a = _round_up(max(len(arrays.alias_prob), 1), tri_pad)
    e = max(num_em, 1)
    en = max(num_enodes, 1)

    def dev(x):
        x = np.asarray(x)
        if x.dtype == np.uint32:
            x = x.astype(np.int64)
        return torch.from_numpy(np.array(x)).to(device)

    tri_world = dev(_pad(arrays.tri_world, p))
    pre = precompute_triangles(tri_world)

    return SceneBuffers(
        tri_world=tri_world,
        tri_vidx=dev(_pad(arrays.tri_vidx, p)),
        tri_inst=dev(_pad(arrays.tri_inst, p, fill=-1)),
        tri_mesh_index=dev(_pad(arrays.tri_mesh_index, p, fill=-1)),
        tri_local=dev(_pad(arrays.tri_local, p)),
        tri_n=pre["n"],
        tri_eu=pre["eu"],
        tri_ev=pre["ev"],
        tri_cn=pre["cn"],
        tri_cu=pre["cu"],
        tri_cv=pre["cv"],
        tri_valid=pre["valid"],
        vert_normal=dev(_pad(arrays.vert_normal, v)),
        vert_uv=dev(_pad(arrays.vert_uv, v)),
        vert_normal_local=dev(_pad(arrays.vert_normal_local, v)),
        vert_inst=dev(_pad(arrays.vert_inst, v, fill=-1)),
        node_min=dev(_pad(arrays.node_min, n)),
        node_max=dev(_pad(arrays.node_max, n)),
        node_entry=dev(_pad(arrays.node_entry, n)),
        node_exit=dev(_pad(arrays.node_exit, n, fill=num_nodes)),
        node_inst=dev(_pad(arrays.node_inst, n, fill=-1)),
        node_left=dev(_pad(arrays.node_left, n, fill=-1)),
        node_right=dev(_pad(arrays.node_right, n, fill=-1)),
        inst_min=dev(arrays.inst_min),
        inst_max=dev(arrays.inst_max),
        inst_material=dev(arrays.inst_material),
        inst_prim_offset=dev(arrays.inst_prim_offset),
        inst_prim_count=dev(arrays.inst_prim_count),
        inst_blas_start=dev(arrays.inst_blas_start),
        inst_blas_end=dev(arrays.inst_blas_end),
        inst_model=dev(arrays.inst_model),
        inst_prev_model=dev(arrays.inst_prev_model),
        inst_inv_model=dev(arrays.inst_inv_model),
        inst_active=torch.ones((num_inst,), dtype=torch.bool, device=device),
        mat_base_color=dev(arrays.mat_base_color),
        mat_emissive=dev(arrays.mat_emissive),
        mat_perceptual_roughness=dev(arrays.mat_perceptual_roughness),
        mat_metallic=dev(arrays.mat_metallic),
        mat_reflectance=dev(arrays.mat_reflectance),
        mat_base_color_texture=dev(arrays.mat_base_color_texture),
        mat_emissive_texture=dev(arrays.mat_emissive_texture),
        mat_metallic_roughness_texture=dev(arrays.mat_metallic_roughness_texture),
        mat_normal_map_texture=dev(arrays.mat_normal_map_texture),
        mat_occlusion_texture=dev(arrays.mat_occlusion_texture),
        tex_atlas=dev(arrays.tex_atlas),
        tex_meta=dev(arrays.tex_meta),
        em_emissive=dev(_pad(arrays.em_emissive, e)),
        em_position=dev(_pad(arrays.em_position, e)),
        em_radius=dev(_pad(arrays.em_radius, e)),
        em_instance=dev(_pad(arrays.em_instance, e, fill=-1)),
        em_alias_offset=dev(_pad(arrays.em_alias_offset, e)),
        em_alias_count=dev(_pad(arrays.em_alias_count, e)),
        em_surface_area=dev(_pad(arrays.em_surface_area, e)),
        enode_min=dev(_pad(arrays.enode_min, en)),
        enode_max=dev(_pad(arrays.enode_max, en)),
        enode_entry=dev(_pad(arrays.enode_entry, en)),
        enode_exit=dev(_pad(arrays.enode_exit, en, fill=max(num_enodes, 1))),
        enode_left=dev(_pad(arrays.enode_left, en, fill=-1)),
        enode_right=dev(_pad(arrays.enode_right, en, fill=-1)),
        alias_prob=dev(_pad(arrays.alias_prob, a)),
        alias_index=dev(_pad(arrays.alias_index, a)),
        sun_direction_to_light=dev(arrays.sun_direction_to_light),
        sun_color=dev(arrays.sun_color),
        ambient_color=dev(arrays.ambient_color),
        tile_rows=dev(tile_rows(arrays, p)),
        num_tris=num_tris,
        num_nodes=num_nodes,
        num_instances=num_inst,
        num_emissives=num_em,
        num_enodes=num_enodes,
        num_materials=len(arrays.mat_base_color),
        num_textures=int(arrays.num_textures),
        refit_depth=int(arrays.refit_depth),
        erefit_depth=int(arrays.erefit_depth),
        num_tlas_nodes=int(arrays.num_tlas_nodes),
    )


def build_scene_buffers(scene: Scene, device=None, builder: str = "native", **pad_kw) -> SceneBuffers:
    """Convenience: full host compile (with ``builder``) + upload to
    ``device`` (the CUDA card unless the caller names another)."""
    device = resolve_device(device)
    return to_device(compile_scene(scene, builder), device, **pad_kw)


def frame_state_from_numpy(state, device=None):
    """Build the port's ``FrameState`` from any object with the same
    nested field names whose leaves convert with ``np.asarray`` — e.g. the
    JAX package's ``FrameState`` — so both packages can start from one
    mid-sequence state. dtypes (f16 reservoir storage included) carry
    over unchanged. The state lands on ``device``, the CUDA card unless
    the caller names another."""
    from hikari_tpu_torch.render.restir import Reservoir, Sample
    from hikari_tpu_torch.render.types import FrameState, GBuffer

    device = resolve_device(device)

    def arr(x):
        return torch.from_numpy(np.array(x)).to(device)

    def record(cls, obj):
        return cls(**{f.name: arr(getattr(obj, f.name)) for f in fields(cls)})

    def reservoir(r):
        rest = {f.name: arr(getattr(r, f.name)) for f in fields(Reservoir) if f.name != "s"}
        return Reservoir(s=record(Sample, r.s), **rest)

    return FrameState(
        frame_number=int(np.asarray(state.frame_number)),
        prev_gbuffer=record(GBuffer, state.prev_gbuffer),
        direct_temporal=reservoir(state.direct_temporal),
        emissive_temporal=reservoir(state.emissive_temporal),
        indirect_temporal=reservoir(state.indirect_temporal),
        de_spatial=reservoir(state.de_spatial),
        indirect_spatial=reservoir(state.indirect_spatial),
        prev_tonemapped=arr(state.prev_tonemapped),
        prev_taa=arr(state.prev_taa),
        prev_upscaled=arr(state.prev_upscaled),
    )
