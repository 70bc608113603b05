"""Light sampling / next-event estimation — the port of
``hikari_tpu.render.sampling`` (reference src/shaders/light.wgsl:536-708):
disk/cosine-hemisphere/cone/triangle sampling with pdfs, the emissive-BVH
reservoir walk picking one light per shading point, alias-table triangle
selection and the instance-restricted target ray, all as masked math over
the pixel grid."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hikari_tpu_torch.config import DISTANCE_MAX, F32_MAX, GOLDEN_RATIO, RAY_BIAS
from hikari_tpu_torch.diff import stable_div
from hikari_tpu_torch.scene.buffers import SceneBuffers
from hikari_tpu_torch.trace.api import Hit, HitInfo, gather_triangle_vertices, hit_info, trace_rays
from hikari_tpu_torch.trace.intersect import inside_aabb
from hikari_tpu_torch.utils import INV_TAU, TAU, basis_apply, dot3, fract, normal_basis, safe_normalize
from hikari_tpu_torch.utils.profiling import host_read

# "No emissive chosen" — the reference's DONT_SAMPLE_EMISSIVE (light.wgsl:243).
NO_EMISSIVE = -1


def sample_uniform_disk(rand2):
    """(reference light.wgsl:537-541)."""
    r = torch.sqrt(rand2[..., 0])
    theta = TAU * rand2[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_cosine_hemisphere(rand2):
    """-> (direction (...,3) in +Z hemisphere, pdf (...,)) (light.wgsl:544-549)."""
    t = sample_uniform_disk(rand2)
    z = torch.sqrt(torch.clamp(1.0 - (t * t).sum(-1), min=0.0))
    return torch.cat([t, z[..., None]], dim=-1), 2.0 * INV_TAU * z


def sample_uniform_cone(rand2, cos_angle):
    """-> (direction (...,3) around +Z, pdf) (light.wgsl:552-559).
    ``cos_angle`` is a host float32 scalar."""
    one_minus = np.float32(1.0) - np.float32(cos_angle)
    z = 1.0 - float(one_minus) * rand2[..., 0]
    theta = TAU * rand2[..., 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    direction = torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], dim=-1)
    pdf = float(np.float32(INV_TAU) / max(one_minus, np.float32(1e-8)))
    return direction, torch.full_like(z, pdf)


def sample_uniform_triangle_barycentric(rand2):
    """(light.wgsl:562-565; pbr-book 3ed §13.6)."""
    srx = torch.sqrt(rand2[..., 0])
    return torch.stack([1.0 - srx, rand2[..., 1] * srx], dim=-1)


def directional_cone(scene: SceneBuffers, solar_angle: float):
    """Sun cone (direction_to_light, cos half-angle as a host float32)
    (light.wgsl:571-573)."""
    return scene.sun_direction_to_light, np.cos(np.float32(solar_angle))


@dataclass(frozen=True)
class LightCandidate:
    """Reference ``LightCandidate`` (light.wgsl:298-304)."""

    direction: torch.Tensor  # (..., 3)
    max_distance: torch.Tensor  # (...,)
    min_distance: torch.Tensor  # (...,)
    emissive_instance: torch.Tensor  # (...,) i32; NO_EMISSIVE = sun sample
    p: torch.Tensor  # (...,) selection pdf


def empty_hit_info(position, direction) -> HitInfo:
    """Reference ``empty_hit_info`` (light.wgsl:488-494)."""
    pos = position + direction * DISTANCE_MAX
    shape = pos.shape[:-1]
    dev = pos.device
    return HitInfo(
        position=torch.cat([pos, torch.zeros(shape + (1,), device=dev)], dim=-1),
        normal=torch.zeros_like(pos),
        uv=torch.zeros(shape + (2,), device=dev),
        instance=torch.full(shape, -1, dtype=torch.int32, device=dev),
        material=torch.full(shape, -1, dtype=torch.int32, device=dev),
    )


def _emissive_walk(scene: SceneBuffers, position, exclude_instance, rand_1d):
    """Walk the emissive BVH, reservoir-picking one emissive whose bounding
    sphere's AABB contains the shading point (reference light.wgsl:626-657).

    The JAX package's ``lax.while_loop`` becomes a host loop: node indices
    only grow along a stackless walk, so it ends within ``num_enodes``
    steps, and it stops once every ray has left the tree (one host sync per
    step after the first; none for a one-node tree). As in the JAX
    package, every step evaluates all rays, finished ones at the last node.

    Returns (chosen emissive index or NO_EMISSIVE, count of candidates)."""
    shape = position.shape[:-1]
    dev = position.device
    pos = position.reshape(-1, 3)
    R = pos.shape[0]
    if not (isinstance(exclude_instance, torch.Tensor) and exclude_instance.device == dev):
        exclude_instance = host_read("emissive_exclude",
                                     lambda: torch.as_tensor(exclude_instance, device=dev))
    excl = torch.broadcast_to(exclude_instance, shape).reshape(-1)
    rand = torch.broadcast_to(rand_1d, shape).reshape(-1)

    num_enodes = scene.num_enodes
    end = num_enodes
    E = scene.em_position.shape[0]
    node_em = torch.clamp(-scene.enode_entry - 1, 0, E - 1)
    # One float and one int row table per node: each step is two gathers.
    frows = torch.cat(
        [
            scene.enode_min,
            scene.enode_max,
            scene.em_position[node_em],
            scene.em_radius[node_em][:, None],
        ],
        dim=-1,
    ).detach()
    irows = torch.stack(
        [scene.enode_entry, scene.enode_exit, scene.em_instance[node_em]], dim=-1
    ).to(torch.int32)

    idx = torch.zeros((R,), dtype=torch.int32, device=dev)
    count = torch.zeros((R,), device=dev)
    chosen = torch.full((R,), NO_EMISSIVE, dtype=torch.int32, device=dev)
    for step in range(num_enodes):
        if step > 0 and not host_read("emissive_walk", lambda: bool((idx != end).any())):
            break
        safe_idx = torch.clamp(idx, 0, num_enodes - 1)
        f = frows[safe_idx]
        i = irows[safe_idx]
        entry, exit_, em_inst = i[:, 0], i[:, 1], i[:, 2]
        is_leaf = entry < 0
        em_pos = f[:, 6:9]
        em_rad = f[:, 9:10]
        accept = is_leaf & inside_aabb(pos, em_pos - em_rad, em_pos + em_rad) & (em_inst != excl)
        rand = torch.where(accept, fract(rand + GOLDEN_RATIO), rand)
        count = torch.where(accept, count + 1.0, count)
        take = accept & (rand < 1.0 / torch.clamp(count, min=1.0))
        chosen = torch.where(take, -entry - 1, chosen)
        node_inside = inside_aabb(pos, f[:, 0:3], f[:, 3:6])
        next_idx = torch.where(is_leaf | ~node_inside, exit_, entry)
        idx = torch.where(idx != end, next_idx, end)
    return chosen.reshape(shape), count.reshape(shape)


def select_light_candidate(
    scene: SceneBuffers,
    rand,  # (..., 4)
    position,  # (..., 3)
    normal,  # (..., 3)
    instance,  # (...,) i32, excluded from emissive selection
    solar_angle: float,
    sample_emissive: bool,
    trace_method: str = "auto",
) -> tuple[LightCandidate, HitInfo]:
    """Reference ``select_light_candidate`` (light.wgsl:599-708). Always
    produces the sun-cone fallback; when ``sample_emissive`` and the scene
    has emissives, walks the light BVH, picks a triangle via the alias
    table and traces the instance-restricted target ray (masked: every
    pixel pays the emissive cost, the dense form of the GPU's branch)."""
    shape = position.shape[:-1]
    dev = position.device

    sun_dir, sun_cos = directional_cone(scene, solar_angle)
    local, _ = sample_uniform_cone(rand[..., 2:4], sun_cos)
    basis = normal_basis(torch.broadcast_to(sun_dir, position.shape))
    rand_direction = basis_apply(basis, local)

    candidate = LightCandidate(
        direction=rand_direction,
        max_distance=torch.full(shape, F32_MAX, device=dev),
        min_distance=torch.full(shape, DISTANCE_MAX, device=dev),
        emissive_instance=torch.full(shape, NO_EMISSIVE, dtype=torch.int32, device=dev),
        p=torch.ones(shape, device=dev),
    )
    info = empty_hit_info(position, rand_direction)

    if not sample_emissive or scene.num_emissives == 0:
        return candidate, info

    chosen, count = _emissive_walk(scene, position, instance, rand[..., 0])
    has_em = chosen >= 0
    safe_em = chosen.clamp(min=0)

    # Alias-table triangle pick (light.wgsl:661-669).
    em_inst_tbl = scene.em_instance.clamp(min=0)
    alias_count = scene.em_alias_count[safe_em]
    alias_off = scene.em_alias_offset[safe_em]
    em_inst = scene.em_instance[safe_em]
    em_area = scene.em_surface_area[safe_em].detach()
    em_prim_off = scene.inst_prim_offset[em_inst_tbl][safe_em]
    em_prim_cnt = scene.inst_prim_count[em_inst_tbl][safe_em]
    alias_idx = torch.minimum(
        (rand[..., 0] * alias_count.to(torch.float32)).to(torch.int32),
        torch.clamp(alias_count - 1, min=0),
    )
    entry_idx = torch.clamp(alias_off + alias_idx, 0, scene.alias_prob.shape[0] - 1)
    a_prob = scene.alias_prob[entry_idx]
    a_index = scene.alias_index[entry_idx]
    local_prim = torch.where(rand[..., 1] < a_prob, a_index, alias_idx)
    prim = torch.clamp(em_prim_off + local_prim, 0, scene.tri_world.shape[0] - 1)

    tv0, tv1, tv2 = gather_triangle_vertices(scene.tri_world.detach(), prim)
    b = sample_uniform_triangle_barycentric(rand[..., 2:4])
    bx = b[..., 0:1]
    by = b[..., 1:2]
    p_world = bx * tv0 + by * tv1 + (1.0 - bx - by) * tv2

    ray_origin = position + normal * RAY_BIAS
    ray_dir = safe_normalize(p_world - position)

    # Instance-restricted closest hit on the emissive instance
    # (light.wgsl:672-687); an empty range for non-emissive pixels.
    lo = torch.where(has_em, em_prim_off, 0)
    hi = torch.where(has_em, em_prim_off + em_prim_cnt, 0)
    hit = trace_rays(scene, ray_origin, ray_dir, range_lo=lo, range_hi=hi, method=trace_method)
    front = dot3(ray_dir, normal) > 0.0
    ok = has_em & front & (hit.prim >= 0)

    # Record the emissive instance itself (light.wgsl:688).
    em_hit = Hit(
        t=hit.t,
        prim=hit.prim,
        inst=torch.where(ok, em_inst, hit.inst).to(torch.int32),
        u=hit.u,
        v=hit.v,
    )
    target = hit_info(scene, ray_origin, ray_dir, em_hit)

    delta = target.position[..., :3] - position
    d2 = (delta * delta).sum(-1)
    denom = (dot3(ray_dir, target.normal) * em_area).abs()
    p_em = stable_div(d2, torch.clamp(denom, min=1e-12)) / torch.clamp(count, min=1.0)

    okf = ok[..., None]
    merged_info = HitInfo(
        position=torch.where(okf, target.position, info.position),
        normal=torch.where(okf, target.normal, info.normal),
        uv=torch.where(okf, target.uv, info.uv),
        instance=torch.where(ok, target.instance, info.instance).to(torch.int32),
        material=torch.where(ok, target.material, info.material).to(torch.int32),
    )
    merged = LightCandidate(
        direction=torch.where(okf, ray_dir, candidate.direction),
        max_distance=torch.where(ok, hit.t, candidate.max_distance),
        min_distance=torch.where(ok, hit.t - 0.1, candidate.min_distance),
        emissive_instance=torch.where(ok, em_inst, NO_EMISSIVE).to(torch.int32),
        p=torch.where(ok, p_em, candidate.p),
    )
    return merged, merged_info


def input_radiance(
    scene: SceneBuffers,
    ray_direction,
    info: HitInfo,
    sample_directional,  # bool or (...,) bool tensor
    sample_emissive_instance,  # (...,) i32, NO_EMISSIVE = none
    sample_ambient,  # bool or (...,) bool tensor
    solar_angle: float,
):
    """Classify a ray's incoming radiance: sun / ambient on miss, emissive
    on hitting the sampled emissive instance (reference ``input_radiance``,
    light.wgsl:835-867). Returns (..., 4): rgb + (1 - ambient_flag)."""
    from hikari_tpu_torch.render.brdf import compute_emissive_radiance, retrieve_emissive

    miss = info.instance < 0
    sun_dir, sun_cos = directional_cone(scene, solar_angle)
    hit_directional = dot3(ray_direction, torch.broadcast_to(sun_dir, ray_direction.shape)) >= float(sun_cos)

    take_sun = miss & sample_directional & hit_directional
    take_amb = miss & ~take_sun

    em_radiance = compute_emissive_radiance(retrieve_emissive(scene, info.material, info.uv))
    take_em = (~miss) & (info.instance == sample_emissive_instance)

    rgb = torch.zeros(ray_direction.shape, device=ray_direction.device)
    rgb = torch.where(take_sun[..., None], scene.sun_color, rgb)
    rgb = torch.where((take_amb & sample_ambient)[..., None], scene.ambient_color, rgb)
    rgb = torch.where(take_em[..., None], em_radiance, rgb)

    ambient_flag = torch.where(take_amb, 1.0, 0.0)
    return torch.cat([rgb, (1.0 - ambient_flag)[..., None]], dim=-1)
