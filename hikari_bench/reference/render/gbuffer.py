"""G-buffer generation by jittered primary rays — the port of
``hikari_tpu.render.gbuffer``. The reference rasterizes 5 MRTs
(src/prepass.rs, src/shaders/prepass.wgsl); here one primary ray per
output pixel produces the same contents: world position + reversed-Z
depth, world normal, depth gradients, instance/material ids, screen-space
velocity and surface uv."""

from __future__ import annotations

import numpy as np
import torch

from hikari_bench.reference.config import DISTANCE_MAX, RenderSettings, Taa, UpscaleMode
from hikari_bench.reference.render.camera import Camera
from hikari_bench.reference.render.filters import edge_shift
from hikari_bench.reference.render.types import GBuffer
from hikari_bench.reference.scene.buffers import SceneBuffers
from hikari_bench.reference.trace.api import hit_info, trace_rays
from hikari_bench.reference.utils import HALTON_JITTER, clip_to_uv


def frame_jitter(frame_number: int, smaa_tu4x: bool) -> np.ndarray:
    """Reference ``frame_jitter`` (prepass.wgsl:30-38): Halton(2,3) point
    indexed by frame & 15 (halved under SMAA TU4x)."""
    index = ((frame_number >> 1) if smaa_tu4x else frame_number) & 15
    return HALTON_JITTER[index]


def render_gbuffer(
    scene: SceneBuffers, camera: Camera, frame_number: int, settings: RenderSettings
) -> GBuffer:
    size = settings.output_size
    smaa = settings.upscale.mode == UpscaleMode.SMAA_TU4X
    if settings.taa == Taa.JASMINE or smaa:
        # The ray-traced equivalent of the clip-space jitter +(j.x, -j.y)
        # (prepass.wgsl:69) samples the scene at pixel center - j.
        jitter = -frame_jitter(frame_number, smaa)
    else:
        jitter = None

    origin, direction = camera.pixel_rays(size, jitter)
    # Primary hits are bounded at DISTANCE_MAX (the reference's miss
    # convention) so grazing hits cannot overflow the velocity math.
    hit = trace_rays(
        scene,
        origin,
        direction,
        max_distance=DISTANCE_MAX,
        method=settings.tracer,
        bruteforce_max_tris=settings.bruteforce_max_tris,
        max_steps=settings.max_traversal_steps,
    )
    info = hit_info(scene, origin, direction, hit)

    miss = hit.prim < 0
    world_pos = info.position[..., :3]
    depth = torch.where(miss, 0.0, camera.depth_of(world_pos))
    position = torch.cat([world_pos, depth[..., None]], dim=-1)

    # Motion vectors: previous world position via the instance's previous
    # model matrix (reference prepass.wgsl:55-58, :96). Static instances
    # snap to the exact identity, so a static scene has exactly zero
    # velocity (prev_model @ inv(model) carries ~1e-7 of rounding).
    prev_from_cur = scene.inst_prev_model @ scene.inst_inv_model  # (I, 4, 4)
    eye = torch.eye(4, dtype=prev_from_cur.dtype, device=prev_from_cur.device)
    is_static = ((prev_from_cur - eye).abs() < 1e-6).all(-1).all(-1)
    prev_from_cur = torch.where(is_static[:, None, None], eye, prev_from_cur)
    rows12 = prev_from_cur.reshape(-1, 16)[:, :12][hit.inst.clamp(min=0)]  # (h, w, 12)

    x, y, z = world_pos[..., 0], world_pos[..., 1], world_pos[..., 2]

    def row(k):
        return rows12[..., k] * x + rows12[..., k + 1] * y + rows12[..., k + 2] * z + rows12[..., k + 3]

    prev_world = torch.stack([row(0), row(4), row(8), torch.ones_like(x)], dim=-1)
    wp_h = torch.cat([world_pos, torch.ones_like(depth)[..., None]], dim=-1)

    clip_cur = wp_h @ camera.view_proj(size).T
    clip_prev = prev_world @ camera.view_proj(size, previous=True).T
    velocity = clip_to_uv(clip_cur) - clip_to_uv(clip_prev)
    velocity = torch.where(miss[..., None], 0.0, velocity)
    # Scrub residual non-finite values (previous position behind the
    # camera); the reference leaves unrasterized texels cleared.
    velocity = torch.where(torch.isfinite(velocity), velocity, 0.0)
    velocity_uv = torch.cat([velocity, info.uv], dim=-1)

    # Screen-space forward differences stand in for the rasterizer's
    # dpdx/dpdy (prepass.wgsl:89); 0 on the image's last column and row.
    ddx = edge_shift(depth, 0, 1) - depth
    ddy = edge_shift(depth, 1, 0) - depth

    return GBuffer(
        position=position,
        normal=torch.where(miss[..., None], 0.0, info.normal),
        depth_gradient=torch.stack([ddx, ddy], dim=-1),
        instance=torch.where(miss, -1, hit.inst).to(torch.int32),
        material=torch.where(miss, -1, info.material).to(torch.int32),
        velocity_uv=velocity_uv,
    )
