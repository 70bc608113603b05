"""ReSTIR spatial reuse — the port of ``hikari_tpu.render.spatial``
(reference ``spatial_reuse`` kernel, src/shaders/light.wgsl:1500-1684):
merge the pixel's fresh temporal reservoir into the reprojected running
spatial reservoir, then take 16 (emissive: 8) neighbour taps on a
Fibonacci spiral, rejecting by depth ratio, normal agreement, backface and
a screen-space depth ray-march occlusion test, and merging the survivors
with the GRIS reconnection Jacobian.

Both tap forms of the JAX package are ported, selected by
``RenderSettings.spatial_taps``:

* ``"rolls"`` (the default, what the JAX frames run): K globally rotated
  copies of the spiral; each pixel takes one variant per frame, so every
  neighbour of a variant sits at one integer offset. The JAX package
  fetches each variant with a wrapping roll and picks per pixel; here each
  pixel fetches its own variant's texels with one wrapping gather, which
  gives the same values.
* any other value: the reference's per-pixel rotated spiral with
  per-pixel gathers.

The TPU-only unrolled loop (``_spatial_unroll``) is not ported: it gives
the same math. The reuse loop works on detached reservoirs (the selection
is estimator machinery); gradients reach the materials through the final
shade.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from hikari_tpu_torch.config import (
    F32_EPSILON,
    GOLDEN_RATIO,
    MAX_VARIANCE,
    SPATIAL_REUSE_COUNT_DIRECT,
    SPATIAL_REUSE_COUNT_EMISSIVE,
    SPATIAL_REUSE_RANGE_DIRECT,
    SPATIAL_REUSE_RANGE_EMISSIVE,
    SPATIAL_REUSE_TAPS,
    SPATIAL_VARIANCE_SAMPLE_THRESHOLD,
    RenderSettings,
)
from hikari_tpu_torch.render.brdf import calculate_view, retrieve_surface, shading
from hikari_tpu_torch.render.camera import Camera
from hikari_tpu_torch.render.light import (
    _render_uv,
    fetch_gbuffer_deferred,
    gather_reservoir,
    jittered_deferred_uv,
    load_previous_reservoir,
    render_coords,
    uv_to_coords,
)
from hikari_tpu_torch.render.restir import (
    Reservoir,
    clamp_reservoir,
    compute_jacobian,
    merge_reservoir,
    reservoir_variance,
)
from hikari_tpu_torch.render.types import GBuffer
from hikari_tpu_torch.scene.buffers import SceneBuffers
from hikari_tpu_torch.utils import (
    TAU,
    dot3,
    fract,
    luminance,
    map_tensors,
    random_float,
    safe_normalize,
)
from hikari_tpu_torch.utils.block import current
from hikari_tpu_torch.utils.profiling import host_read

_f32 = np.float32


def _spiral_radius(i: int, reuse_count: int, reuse_range: float):
    """Tap i's spiral radius, ray-march interval and tap count, in float32
    as the JAX package computes them."""
    radius = np.sqrt(_f32(i) / _f32(reuse_count)) * _f32(reuse_range)
    interval = max(_f32(1.0), radius / _f32(SPATIAL_REUSE_TAPS + 1))
    return radius, interval, int(radius / interval)


def _march_fraction(j: int, tap_count: int) -> float:
    """j / (tap_count + 1) in float32: where the j-th occlusion tap sits
    between the pixel's depth and the sample's."""
    return float(_f32(j) / (_f32(tap_count) + _f32(1.0)))


def spatial_reuse_pass(
    scene: SceneBuffers,
    camera: Camera,
    gbuffer: GBuffer,
    temporal: Reservoir,
    spatial_prev: Reservoir,
    variance_in,
    frame_number: int,
    settings: RenderSettings,
    emissive_lit: bool,
):
    """``temporal``: this channel's freshly written temporal grid;
    ``spatial_prev``: the previous frame's spatial grid (reprojected here);
    ``variance_in`` (rh, rw): the temporal pass's variance. Returns
    (radiance (rh, rw, 3), variance, new spatial reservoir grid).

    Under a sharded frame the pass computes its block's pixels and reads
    the taps, which reach any pixel (the spiral wraps around the image),
    from the gathered temporal grid and depths."""
    render_size = settings.render_size
    deferred_size = settings.output_size
    ratio = settings.upscale_ratio
    rh, rw = render_size
    blk = current()
    lh, lw = blk.size(render_size)
    dev = gbuffer.position.device

    reuse_count = SPATIAL_REUSE_COUNT_EMISSIVE if emissive_lit else SPATIAL_REUSE_COUNT_DIRECT
    reuse_range = SPATIAL_REUSE_RANGE_EMISSIVE if emissive_lit else SPATIAL_REUSE_RANGE_DIRECT

    ys, xs = render_coords(render_size, dev)
    uv = _render_uv(render_size, dev)
    duv = jittered_deferred_uv(uv, frame_number, deferred_size, ratio)
    g = fetch_gbuffer_deferred(gbuffer, frame_number, settings)
    depth = g.position[..., 3]
    background = depth < F32_EPSILON
    position = g.position[..., :3]

    def detach(r):
        det = map_tensors(lambda x: x.detach(), r)
        if not settings.spatial_radiance_grads:
            return det
        return replace(det, s=replace(det.s, radiance=r.s.radiance))

    temporal = detach(temporal)
    spatial_prev = detach(spatial_prev)
    temporal_all = map_tensors(blk.gather, temporal)
    depth_all = blk.gather(depth)
    gdepth_all = blk.gather(gbuffer.position[..., 3])

    r = temporal  # load_reservoir(coords), light.wgsl:1520
    q0 = r
    s = q0.s
    use_spatial_variance = r.count <= SPATIAL_VARIANCE_SAMPLE_THRESHOLD
    previous_uv = duv - g.velocity_uv[..., :2]

    max_lifetime = (
        float("inf") if settings.max_reservoir_lifetime <= 1.0 else settings.max_reservoir_lifetime
    )
    use_prev = r.lifetime <= max_lifetime
    r_prev = load_previous_reservoir(spatial_prev, previous_uv, render_size)
    r = r_prev.select(use_prev, r)

    surface = retrieve_surface(scene, g.material, g.velocity_uv[..., 2:4])
    view = calculate_view(camera.position, position)

    def target_p(sample, direction):
        if emissive_lit:
            p = luminance(sample.radiance[..., :3])
        else:
            p = luminance(shading(view, s.visible_normal, direction, surface, sample.radiance,
                                  scene.ambient_color))
        return p.detach()  # resampling weights are estimator machinery

    self_dir = safe_normalize(s.sample_position[..., :3] - s.visible_position[..., :3])
    r = merge_reservoir(r, q0, target_p(q0.s, self_dir))
    r = replace(r, s=replace(r.s, visible_position=s.visible_position,
                             visible_normal=s.visible_normal))

    frame_phase = float(random_float(frame_number))
    rot = fract(s.random.sum(-1) + frame_phase)
    wh = host_read("spatial_size", lambda: torch.tensor([rw, rh], dtype=torch.float32, device=dev))

    def eval_tap(r, q, sample_depth, in_bounds, occluded):
        """Rejection + GRIS-Jacobian merge of one neighbour candidate
        (light.wgsl:1576-1642)."""
        depth_ratio = depth / torch.where(sample_depth == 0.0, 1e-8, sample_depth)
        ok = in_bounds & (depth_ratio >= 0.9) & (depth_ratio <= 1.1)
        ok = ok & (q.count >= F32_EPSILON)
        ok = ok & (dot3(s.visible_normal, q.s.visible_normal) >= 0.866)
        sample_direction = safe_normalize(q.s.sample_position[..., :3] - s.visible_position[..., :3])
        ok = ok & (dot3(sample_direction, s.visible_normal) >= 0.0)
        ok = ok & ~occluded
        jac = torch.where(q.s.sample_position[..., 3] > 0.5, compute_jacobian(q.s, s), 1.0)
        p = target_p(q.s, sample_direction) / jac
        return merge_reservoir(r, q, p, mask=ok)

    def pixel_tap(i, r):
        """The reference's per-pixel rotated spiral (light.wgsl:1566-1628)."""
        radius, interval, tap_count = _spiral_radius(i, reuse_count, reuse_range)
        angle = TAU * fract(float(_f32(i) * _f32(GOLDEN_RATIO)) + rot)
        offset = float(radius) * torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
        coords = torch.stack([xs.to(torch.float32), ys.to(torch.float32)], dim=-1)
        sample_coords = (offset + coords).to(torch.int32)
        sample_uv = (sample_coords.to(torch.float32) + 0.5) / wh
        in_bounds = ((sample_uv >= 0.0) & (sample_uv <= 1.0)).all(-1)
        sx = torch.clamp(sample_coords[..., 0], 0, rw - 1)
        sy = torch.clamp(sample_coords[..., 1], 0, rh - 1)
        s_duv = jittered_deferred_uv(sample_uv, frame_number, deferred_size, ratio)
        sdy, sdx = uv_to_coords(s_duv, deferred_size)
        sample_depth = gdepth_all[sdy.long(), sdx.long()]
        q = gather_reservoir(temporal_all, sy, sx)

        occluded = torch.zeros((lh, lw), dtype=torch.bool, device=dev)
        offset_dir = offset / float(max(radius, _f32(1e-8)))
        for j in range(1, min(tap_count, SPATIAL_REUSE_TAPS + 1) + 1):
            tap_dist = float(_f32(j) * interval)
            tap_uv = uv + tap_dist * offset_dir / wh
            tdy, tdx = uv_to_coords(jittered_deferred_uv(tap_uv, frame_number, deferred_size, ratio),
                                    deferred_size)
            tap_depth = gdepth_all[tdy.long(), tdx.long()]
            ref_depth = depth + (sample_depth - depth) * _march_fraction(j, tap_count)
            occluded = occluded | (tap_depth > ref_depth + 1e-5)
        return eval_tap(r, q, sample_depth, in_bounds, occluded)

    K = settings.spatial_tap_variants
    variant = torch.clamp((rot * K).to(torch.int32), max=K - 1)

    def rolled_tap(i, r):
        """K globally rotated spirals; the pixel's variant (variant + i) mod
        K fixes its integer offset, and a wrapping fetch at that offset
        gives what the JAX package's roll of that variant gives."""
        radius, interval, tap_count = _spiral_radius(i, reuse_count, reuse_range)
        offs, march = [], []
        for k in range(K):
            a = _f32(i) * _f32(GOLDEN_RATIO) + (_f32(k) + _f32(frame_phase)) / _f32(K)
            ang = _f32(TAU) * (a - np.floor(a))
            ox, oy = radius * np.cos(ang), radius * np.sin(ang)
            offs.append((int(np.floor(oy)), int(np.floor(ox))))
            taps = []
            for j in range(1, min(tap_count, SPATIAL_REUSE_TAPS + 1) + 1):
                f = interval * _f32(j) / max(radius, _f32(1e-8))
                taps.append((int(np.floor(oy * f)), int(np.floor(ox * f))))
            march.append(taps)
        v = torch.remainder(variant + i, K).long()

        def at(table):
            t = host_read("spatial_taps",
                          lambda: torch.tensor(table, dtype=torch.int64, device=dev))
            t = t[v]  # (rh, rw, 2)
            return t[..., 0], t[..., 1]

        oy, ox = at(offs)
        yy, xx = torch.remainder(ys + oy, rh), torch.remainder(xs + ox, rw)
        q = gather_reservoir(temporal_all, yy, xx)
        sample_depth = depth_all[yy, xx]
        in_bounds = (xs + ox >= 0) & (xs + ox < rw) & (ys + oy >= 0) & (ys + oy < rh)
        occluded = torch.zeros((lh, lw), dtype=torch.bool, device=dev)
        for j in range(len(march[0])):
            ty, tx = at([m[j] for m in march])
            tap_depth = depth_all[torch.remainder(ys + ty, rh), torch.remainder(xs + tx, rw)]
            ref_depth = depth + (sample_depth - depth) * _march_fraction(j + 1, tap_count)
            occluded = occluded | (tap_depth > ref_depth + 1e-5)
        return eval_tap(r, q, sample_depth, in_bounds, occluded)

    tap = rolled_tap if settings.spatial_taps == "rolls" else pixel_tap
    for i in range(1, reuse_count + 1):
        r = tap(i, r)

    r = clamp_reservoir(r, settings.max_spatial_reuse_count)

    out_dir = safe_normalize(r.s.sample_position[..., :3] - s.visible_position[..., :3])
    out_radiance = shading(view, s.visible_normal, out_dir, surface, r.s.radiance,
                           scene.ambient_color)
    if emissive_lit:
        total_lum = r.count * luminance(r.s.radiance[..., :3])
    else:
        total_lum = r.count * luminance(out_radiance)
    w = torch.where(total_lum > 0.0, r.w_sum / torch.where(total_lum == 0.0, 1.0, total_lum), 0.0)
    r = replace(r, w=w, lifetime=r.lifetime + 1.0)

    variance = torch.where(use_spatial_variance, reservoir_variance(r, MAX_VARIANCE), variance_in)

    # Background: keep the temporal (empty) reservoir, zero output
    # (light.wgsl:1526-1530).
    r = temporal.select(background, r)
    out = torch.where(background[..., None], 0.0, out_radiance * r.w[..., None])
    variance = torch.where(background, 0.0, variance)
    return out, variance, r
