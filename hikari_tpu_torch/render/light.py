"""The path-traced lighting passes: direct (sun), emissive and indirect,
with ReSTIR temporal reuse and sample validation — the port of
``hikari_tpu.render.light`` (reference kernels ``direct_lit`` and
``indirect_lit_ambient``, src/shaders/light.wgsl:1044-1498).

GPU divergent branches become masked dense math. The uniform branches of
the JAX package (``lax.cond`` on the validation frame and on the
reprojection transport) are Python ``if``s on host values. Reprojection
always takes the general gather transport; the JAX package's "shift"
transport is a TPU shortcut that gives the same values at zero velocity.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import numpy as np
import torch

from hikari_tpu_torch.config import (
    DIRECT_VALIDATION_FRAME_SAMPLE_THRESHOLD,
    F32_EPSILON,
    GOLDEN_RATIO,
    MAX_VARIANCE,
    RAY_BIAS,
    RenderSettings,
)
from hikari_tpu_torch.diff import clip_gradient, stable_div
from hikari_tpu_torch.render.brdf import (
    calculate_view,
    compute_emissive_radiance,
    env_brdf,
    retrieve_surface,
    shading,
)
from hikari_tpu_torch.render.camera import Camera
from hikari_tpu_torch.render.noise import noise_plane
from hikari_tpu_torch.render.restir import (
    Reservoir,
    Sample,
    check_previous_reservoir,
    finalize_w,
    reservoir_variance,
    set_reservoir,
    temporal_restir,
)
from hikari_tpu_torch.render.sampling import (
    NO_EMISSIVE,
    input_radiance,
    sample_cosine_hemisphere,
    select_light_candidate,
)
from hikari_tpu_torch.render.stops import channel_sum
from hikari_tpu_torch.render.types import GBuffer
from hikari_tpu_torch.scene.buffers import SceneBuffers
from hikari_tpu_torch.trace.api import hit_info, occlude_hit_info, remat, trace_rays
from hikari_tpu_torch.utils import (
    basis_apply,
    dot3,
    fract,
    gather_pixels,
    luminance,
    map_tensors,
    normal_basis,
    safe_normalize,
)
from hikari_tpu_torch.utils.block import current
from hikari_tpu_torch.utils.profiling import host_read

# ---------------------------------------------------------------------------
# G-buffer fetch at render resolution (reference jittered_deferred_*
# helpers, light.wgsl:1007-1017)
# ---------------------------------------------------------------------------


def _frame_sign(frame_number: int, amount: float) -> float:
    return amount if frame_number % 2 == 0 else -amount


def jittered_deferred_uv(uv, frame_number: int, deferred_size, upscale_ratio, amount=0.25):
    h, w = deferred_size
    sign = _frame_sign(frame_number, amount)
    dev = uv.device
    texel = host_read("deferred_texel",
                      lambda: torch.tensor([1.0 / w, 1.0 / h], dtype=torch.float32, device=dev))
    return uv + sign * texel * (upscale_ratio - 1.0)


def uv_to_coords(uv, size_hw):
    h, w = size_hw
    x = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1)
    return y, x


def _deferred_phase(frame_number: int, ratio_int: int, amount: float) -> int:
    """Integer offset c of the jittered deferred map dy = R*y + c for an
    integer upscale ratio R (same derivation as jittered_deferred_uv +
    uv_to_coords), evaluated in float32 on the host."""
    sign = np.float32(_frame_sign(frame_number, amount))
    c = np.floor(np.float32(ratio_int / 2.0) + sign * np.float32(ratio_int - 1.0))
    return int(min(max(c, 0), ratio_int - 1))


def strided_deferred_plane(a, c: int, ratio_int: int, render_size):
    """Sample a full-res plane at the affine deferred map dy = R*y + c."""
    rh, rw = render_size
    R = ratio_int
    return a[c : c + R * (rh - 1) + 1 : R, c : c + R * (rw - 1) + 1 : R]


def render_coords(render_size, device):
    """(ys, xs) int32: the image coordinates of the frame block's render
    pixels (``utils.block``; the whole image unsharded)."""
    return current().coords(render_size, device, torch.int32)


def _render_uv(render_size, device):
    rh, rw = render_size
    ys, xs = render_coords(render_size, device)
    return torch.stack(
        [(xs.to(torch.float32) + 0.5) / rw, (ys.to(torch.float32) + 0.5) / rh], dim=-1
    )


def fetch_gbuffer_deferred(gb: GBuffer, frame_number: int, settings, amount: float = 0.25) -> GBuffer:
    """Nearest full-res G-buffer sample at every render pixel's jittered
    deferred uv (light.wgsl:1007-1017): for an integer upscale ratio a
    strided view, whose float planes pass the ``gb_fetch`` gradient
    firewall; for a fractional one (FSR1) a gather at the deferred
    coordinates (``fetch_gbuffer``)."""
    ratio = settings.upscale_ratio
    blk = current()
    if not float(ratio).is_integer():
        duv = jittered_deferred_uv(
            _render_uv(settings.render_size, gb.position.device), frame_number,
            settings.output_size, ratio, amount,
        )
        dy, dx = uv_to_coords(duv, settings.output_size)
        return fetch_gbuffer(map_tensors(blk.gather, gb), dy, dx)
    # An integer ratio keeps a render block's deferred texels inside the
    # same block of the output.
    Ri = int(ratio)
    c = _deferred_phase(frame_number, Ri, amount)

    def f(a):
        out = strided_deferred_plane(a, c, Ri, blk.size(settings.render_size))
        return clip_gradient(out, 1e4, "gb_fetch") if out.is_floating_point() else out

    return GBuffer(
        position=f(gb.position),
        normal=f(gb.normal),
        depth_gradient=f(gb.depth_gradient),
        instance=f(gb.instance),
        material=f(gb.material),
        velocity_uv=f(gb.velocity_uv),
    )


def fetch_gbuffer(gb: GBuffer, y, x) -> GBuffer:
    """The G-buffer at integer grids y/x; the float planes pass the
    ``gb_gather`` gradient firewall, which bounds and NaN-scrubs the
    cotangents flowing back into the G-buffer from the lighting chains."""

    def f(a):
        out = gather_pixels(a, y, x)
        return clip_gradient(out, 1e4, "gb_gather") if out.is_floating_point() else out

    return GBuffer(
        position=f(gb.position),
        normal=f(gb.normal),
        depth_gradient=f(gb.depth_gradient),
        instance=f(gb.instance),
        material=f(gb.material),
        velocity_uv=f(gb.velocity_uv),
    )


def gather_reservoir(r: Reservoir, y, x) -> Reservoir:
    """Reproject a reservoir grid: every field at the integer grids y/x."""
    return map_tensors(lambda a: gather_pixels(a, y, x), r)


def load_previous_reservoir(grid: Reservoir, prev_uv, render_size) -> Reservoir:
    """Reference ``load_previous_reservoir`` (light.wgsl:181-190): empty
    outside [0,1]^2, nearest gather inside. Under a sharded frame the
    reprojection reaches any pixel, so it reads the gathered grid."""
    in_bounds = ((prev_uv - 0.5).abs() < 0.5).all(-1)
    y, x = uv_to_coords(prev_uv, render_size)
    empty = Reservoir.zeros(in_bounds.shape, in_bounds.device)
    full = map_tensors(current().gather, grid)
    return gather_reservoir(full, y, x).select(in_bounds, empty)


def scatter_invalidate(grid: Reservoir, prev_uv, mask, render_size) -> Reservoir:
    """Zero the reservoir at reprojected coords where ``mask`` — the
    reference's store_previous_spatial_reservoir of a reset reservoir
    (light.wgsl:1092-1095, :1199-1202). Collisions all write zeros. Under
    a sharded frame a pixel may write into another rank's block: each
    rank marks the whole image and the marks meet in a cross-rank min."""
    rh, rw = render_size
    blk = current()
    in_bounds = ((prev_uv - 0.5).abs() <= 0.5).all(-1)
    m = mask & in_bounds
    y, x = uv_to_coords(prev_uv, render_size)
    keep = torch.ones((rh * rw,), device=prev_uv.device)
    keep.scatter_reduce_(
        0,
        (y.to(torch.int64) * rw + x).reshape(-1),
        torch.where(m, 0.0, 1.0).reshape(-1),
        reduce="amin",
    )
    invalidated = blk.take((blk.min(keep) < 0.5).reshape(rh, rw))
    return Reservoir.zeros(blk.size(render_size), prev_uv.device).select(invalidated, grid)


def _channel_cut(acc, render_size, device, temporal, spatial):
    """A light channel cut by ``stop_after`` (JAX ``light.py`` ``_trunc``):
    radiance and variance hold ``acc``, no pixel is background, and the
    reservoirs pass through."""
    rh, rw = current().size(render_size)
    out3 = torch.zeros((rh, rw, 3), device=device) + acc
    var = torch.zeros((rh, rw), device=device) + acc
    bgd = torch.zeros((rh, rw), dtype=torch.bool, device=device)
    return out3, var, temporal, spatial, bgd, temporal


def channel_random(noise_bank, frame_number: int, render_size):
    """Blue-noise 4D random + golden-ratio temporal scrambling
    (light.wgsl:1075-1079)."""
    blk = current()
    r = noise_plane(noise_bank, frame_number, blk.size(render_size), blk.origin(render_size))
    return fract(r + _golden_offset(frame_number))


def _golden_offset(frame_number: int) -> float:
    # frame * GOLDEN_RATIO rounded in float32, as the JAX package computes it.
    return float(np.float32(frame_number) * np.float32(GOLDEN_RATIO))


# ---------------------------------------------------------------------------
# full_screen_albedo (light.wgsl:1019-1042)
# ---------------------------------------------------------------------------


def full_screen_albedo(scene: SceneBuffers, camera: Camera, gb: GBuffer):
    """Env-BRDF albedo for demodulation + overlay fallback."""
    has = gb.depth >= F32_EPSILON
    surface = retrieve_surface(scene, gb.material, gb.velocity_uv[..., 2:4])
    view = calculate_view(camera.position, gb.position[..., :3])
    return torch.where(has[..., None], env_brdf(view, gb.normal, surface), 0.0)


def _primary_sample(g: GBuffer, rand, normal):
    rh, rw = g.instance.shape
    dev = g.instance.device
    position = g.position[..., :3]
    depth = g.position[..., 3]
    return Sample(
        radiance=torch.zeros((rh, rw, 4), device=dev),
        random=rand,
        visible_position=torch.cat([position, depth[..., None]], dim=-1),
        visible_normal=normal,
        visible_instance=g.instance,
        sample_position=torch.zeros((rh, rw, 4), device=dev),
        sample_normal=torch.zeros((rh, rw, 3), device=dev),
    )


def _weight(radiance, p):
    """w = luminance / p with the stable_div backward, 0 where p <= 0."""
    return torch.where(p > 0.0, stable_div(luminance(radiance[..., :3]), torch.clamp(p, min=1e-12)), 0.0)


# ---------------------------------------------------------------------------
# direct_lit (sun + emissive variants)
# ---------------------------------------------------------------------------


def direct_lit_pass(
    scene: SceneBuffers,
    camera: Camera,
    gbuffer: GBuffer,
    temporal: Reservoir,
    de_spatial_prev: Reservoir,
    noise_bank,
    frame_number: int,
    settings: RenderSettings,
    emissive_lit: bool,
    render_emissive: bool,
):
    """One temporal lighting channel (reference ``direct_lit``,
    light.wgsl:1044-1261). ``emissive_lit`` selects the EMISSIVE_LIT
    variant; ``render_emissive`` adds surface self-emission.

    Returns (radiance (rh,rw,3), variance (rh,rw), new temporal reservoir,
    updated shared spatial-previous reservoir, background mask, reservoir)."""
    render_size = settings.render_size
    rh, rw = current().size(render_size)
    dev = gbuffer.position.device

    duv = jittered_deferred_uv(
        _render_uv(render_size, dev), frame_number, settings.output_size, settings.upscale_ratio
    )
    g = fetch_gbuffer_deferred(gbuffer, frame_number, settings)
    background = g.position[..., 3] < F32_EPSILON
    position = g.position[..., :3]
    normal = g.normal
    rand = channel_random(noise_bank, frame_number, render_size)
    # settings.stop_after "<channel>:<stage>" cuts this channel after
    # <stage> (render/stops.py).
    chan = "emissive" if emissive_lit else "direct"

    def stopped(stage):
        return settings.stop_after == f"{chan}:{stage}"

    def cut(spatial, *trees):
        return _channel_cut(current().sum(channel_sum(*trees)), render_size, dev, temporal,
                            spatial)

    if stopped("fetch"):
        return cut(de_spatial_prev, g, rand, duv)
    s = _primary_sample(g, rand, normal)

    # Temporal reprojection + geometric validation.
    previous_uv = duv - g.velocity_uv[..., :2]
    r = load_previous_reservoir(temporal, previous_uv, render_size)
    r, reproj_ok = check_previous_reservoir(r, s)
    de_spatial_prev = scatter_invalidate(de_spatial_prev, previous_uv, ~reproj_ok, render_size)
    if stopped("reproject"):
        return cut(de_spatial_prev, g, rand, r, de_spatial_prev)

    trace_kw = dict(
        method=settings.tracer,
        bruteforce_max_tris=settings.bruteforce_max_tris,
        max_steps=settings.max_traversal_steps,
    )

    def candidate_for(sample: Sample):
        return select_light_candidate(
            scene, sample.random, sample.visible_position[..., :3], sample.visible_normal,
            g.instance, settings.solar_angle, sample_emissive=emissive_lit,
            trace_method=settings.tracer,
        )

    if stopped("candidate") or stopped("trace"):
        candidate, info = candidate_for(s)
        if stopped("candidate"):
            return cut(de_spatial_prev, g, r, candidate, info)
        hit = trace_rays(
            scene, position + normal * RAY_BIAS, candidate.direction,
            max_distance=candidate.max_distance,
            early_distance=candidate.min_distance,
            exclude_instance=candidate.emissive_instance,
            **trace_kw,
        )
        return cut(de_spatial_prev, g, r, candidate, info, hit)

    def shadow_trace(ray_origin, ray_dir, candidate, trace_condition, info):
        """Trace the shadow ray + classify radiance (masked)."""
        hit = trace_rays(
            scene, ray_origin, ray_dir,
            max_distance=candidate.max_distance,
            early_distance=candidate.min_distance,
            exclude_instance=candidate.emissive_instance,
            **trace_kw,
        )
        info2 = occlude_hit_info(ray_origin, ray_dir, hit, info)
        if emissive_lit:
            rad = input_radiance(
                scene, ray_dir, info2, False, candidate.emissive_instance, False,
                settings.solar_angle,
            )
        else:
            no_em = torch.full(trace_condition.shape, NO_EMISSIVE, dtype=torch.int32, device=dev)
            rad = input_radiance(scene, ray_dir, info2, True, no_em, False, settings.solar_angle)
        return torch.where(trace_condition[..., None], rad, 0.0), info2

    def sampling_branch(r_in, take_mask):
        """New-candidate sampling + temporal ReSTIR (light.wgsl:1108-1153);
        ``take_mask``: pixels whose reservoir takes the update."""
        candidate, info = candidate_for(s)
        ray_origin = position + normal * RAY_BIAS
        ray_dir = candidate.direction
        cond = (dot3(ray_dir, normal) > 0.0) & (candidate.p > 0.0)
        if emissive_lit:
            cond = cond & (candidate.emissive_instance != NO_EMISSIVE)
        rad, info2 = shadow_trace(ray_origin, ray_dir, candidate, cond, info)
        s2 = replace(s, radiance=rad, sample_position=info2.position, sample_normal=info2.normal)
        w_new = _weight(s2.radiance, candidate.p)
        return temporal_restir(r_in, s2, w_new, settings.max_temporal_reuse_count, mask=take_mask)

    def validation_branch(r_in, sp_prev):
        """Re-trace the reservoir's retained sample and reset on luminance
        mismatch (light.wgsl:1156-1214)."""
        low_count = r_in.count < DIRECT_VALIDATION_FRAME_SAMPLE_THRESHOLD
        r1 = sampling_branch(r_in, low_count)

        candidate, info = candidate_for(r1.s)
        ray_origin = s.visible_position[..., :3] + s.visible_normal * RAY_BIAS
        ray_dir = safe_normalize(r1.s.sample_position[..., :3] - s.visible_position[..., :3])
        cond = (dot3(candidate.direction, r1.s.visible_normal) > 0.0) & (candidate.p > 0.0)
        if emissive_lit:
            cond = cond & (candidate.emissive_instance != NO_EMISSIVE)
        validate_rad, info2 = shadow_trace(ray_origin, ray_dir, candidate, cond, info)

        # High-count pixels adopt the validation ray as this frame's sample.
        high = ~low_count
        s_val = replace(
            s, random=r1.s.random, radiance=validate_rad,
            sample_position=info2.position, sample_normal=info2.normal,
        )
        lum_ratio = luminance(validate_rad[..., :3]) / torch.clamp(
            luminance(r1.s.radiance[..., :3]), min=0.0001
        )
        lum_miss = (lum_ratio > 1.25) | (lum_ratio < 0.8)
        sp_prev2 = scatter_invalidate(sp_prev, previous_uv, lum_miss, render_size)

        s_new = s_val.select(high, replace(s, random=r1.s.random))
        r_reset = set_reservoir(s_new, _weight(s_new.radiance, candidate.p))
        return r_reset.select(lum_miss, r1), sp_prev2

    validate_interval = (
        settings.emissive_validate_interval if emissive_lit else settings.direct_validate_interval
    )
    val_fn, samp_fn = validation_branch, sampling_branch
    if settings.channel_remat and torch.is_grad_enabled():
        # Estimator-chain remat (JAX light.py:599-610): the taken branch
        # runs again in the backward from its inputs, replaying its hits.
        val_fn = functools.partial(remat, validation_branch)
        samp_fn = functools.partial(remat, sampling_branch)
    if frame_number % validate_interval == 0:
        r, sp_after = val_fn(r, de_spatial_prev)
    else:
        r = samp_fn(r, torch.ones((rh, rw), dtype=torch.bool, device=dev))
        sp_after = de_spatial_prev
    if stopped("restir"):
        return cut(de_spatial_prev, g, r, sp_after)

    # Finalize W, refresh visible surface, lifetime++ (light.wgsl:1216-1227).
    r = finalize_w(r, luminance(r.s.radiance[..., :3]))
    r = replace(
        r,
        s=replace(r.s, visible_position=s.visible_position, visible_normal=s.visible_normal),
        lifetime=r.lifetime + 1.0,
    )
    variance = reservoir_variance(r, MAX_VARIANCE)

    # Background pixels reset everything (light.wgsl:1058-1069).
    empty = set_reservoir(Sample.zeros((rh, rw), dev), torch.zeros((rh, rw), device=dev))
    r = empty.select(background, r)
    variance = torch.where(background, 0.0, variance)

    # Shade (light.wgsl:1233-1259).
    surface = retrieve_surface(scene, g.material, g.velocity_uv[..., 2:4])
    view = calculate_view(camera.position, position)
    out_radiance = shading(
        view,
        r.s.visible_normal,
        safe_normalize(r.s.sample_position[..., :3] - r.s.visible_position[..., :3]),
        surface,
        r.s.radiance,
        scene.ambient_color,
    )
    out = out_radiance * r.w[..., None]
    if render_emissive:
        out = out + compute_emissive_radiance(surface.emissive)
    out = torch.where(background[..., None], 0.0, out)

    new_temporal = r if settings.temporal_reuse else temporal
    return out, variance, new_temporal, sp_after, background, r


# ---------------------------------------------------------------------------
# indirect_lit_ambient (light.wgsl:1263-1498)
# ---------------------------------------------------------------------------


def indirect_lit_pass(
    scene: SceneBuffers,
    camera: Camera,
    gbuffer: GBuffer,
    temporal: Reservoir,
    spatial_prev: Reservoir,
    noise_bank,
    frame_number: int,
    settings: RenderSettings,
):
    """Indirect diffuse channel with 1..N cosine-hemisphere bounces and NEE
    at each bounce (reference ``indirect_lit_ambient``). Returns the same
    tuple as ``direct_lit_pass``."""
    render_size = settings.render_size
    rh, rw = current().size(render_size)
    dev = gbuffer.position.device

    duv = jittered_deferred_uv(
        _render_uv(render_size, dev), frame_number, settings.output_size, settings.upscale_ratio
    )
    g = fetch_gbuffer_deferred(gbuffer, frame_number, settings)
    background = g.position[..., 3] < F32_EPSILON
    position = g.position[..., :3]
    normal = safe_normalize(torch.where(background[..., None], 1.0, g.normal))
    rand = channel_random(noise_bank, frame_number, render_size)

    def stopped(stage):  # settings.stop_after "indirect:<stage>"
        return settings.stop_after == f"indirect:{stage}"

    def cut(spatial, *trees):
        return _channel_cut(current().sum(channel_sum(*trees)), render_size, dev, temporal,
                            spatial)

    if stopped("fetch"):
        return cut(spatial_prev, g, rand)
    s = _primary_sample(g, rand, g.normal)

    trace_kw = dict(
        method=settings.tracer,
        bruteforce_max_tris=settings.bruteforce_max_tris,
        max_steps=settings.max_traversal_steps,
    )
    golden = _golden_offset(frame_number)
    no_em = torch.full((rh, rw), NO_EMISSIVE, dtype=torch.int32, device=dev)

    accum = torch.zeros((rh, rw, 4), device=dev)
    color_transport = torch.ones((rh, rw, 3), device=dev)
    bounce_pos = position
    bounce_normal = normal
    bounce_rand = rand
    alive = ~background
    first_pdf = first_sample_position = first_sample_normal = None

    for n in range(max(settings.indirect_bounces, 1)):
        local, pdf = sample_cosine_hemisphere(bounce_rand[..., 0:2])
        ray_dir = basis_apply(normal_basis(bounce_normal), local)
        ray_origin = bounce_pos + bounce_normal * RAY_BIAS
        hit = trace_rays(scene, ray_origin, ray_dir, **trace_kw)
        info = hit_info(scene, ray_origin, ray_dir, hit)
        if stopped("bounce"):
            return cut(spatial_prev, g, hit, info)
        if n == 0:
            first_pdf = pdf
            first_sample_position = info.position
            first_sample_normal = info.normal

        hit_ok = (hit.prim >= 0) & alive

        # NEE at the bounce point (light.wgsl:1338-1379).
        surface_b = retrieve_surface(scene, info.material, info.uv)
        surface_b = surface_b.replace_roughness(torch.ones((rh, rw), device=dev))
        candidate, cinfo = select_light_candidate(
            scene, bounce_rand, info.position[..., :3], info.normal, hit.inst,
            settings.solar_angle, sample_emissive=scene.num_emissives > 0,
            trace_method=settings.tracer,
        )
        # Secondary-vertex NEE geometry is detached, as in the JAX package.
        candidate, cinfo = map_tensors(lambda x: x.detach(), (candidate, cinfo))
        sample_directional = candidate.emissive_instance == NO_EMISSIVE
        nee_cond = (dot3(candidate.direction, info.normal) > 0.0) & (candidate.p > 0.0) & hit_ok

        nee_origin = info.position[..., :3] + info.normal * RAY_BIAS
        nee_hit = trace_rays(
            scene, nee_origin, candidate.direction,
            max_distance=candidate.max_distance,
            early_distance=candidate.min_distance,
            exclude_instance=candidate.emissive_instance,
            **trace_kw,
        )
        cinfo2 = occlude_hit_info(nee_origin, candidate.direction, nee_hit, cinfo)
        if stopped("nee"):
            return cut(spatial_prev, g, hit, info, candidate, cinfo2)
        in_rad = input_radiance(
            scene, candidate.direction, cinfo2, sample_directional,
            candidate.emissive_instance, False, settings.solar_angle,
        )
        bounce_view = safe_normalize(bounce_pos - info.position[..., :3])
        out_rad = shading(bounce_view, info.normal, candidate.direction, surface_b, in_rad,
                          scene.ambient_color)
        out_rad = stable_div(out_rad, torch.clamp(candidate.p[..., None], min=1e-12))
        if n > 0:
            out_rad = torch.where(
                (pdf < 0.01)[..., None],
                0.0,
                stable_div(out_rad, torch.clamp(pdf[..., None], min=1e-6)),
            )
        # Firefly clamp (light.wgsl:1372-1376).
        out_lum = luminance(out_rad)
        scale = torch.where(
            out_lum > settings.max_indirect_luminance,
            settings.max_indirect_luminance / torch.clamp(out_lum, min=1e-8),
            1.0,
        )
        out_rad = out_rad * scale[..., None]
        contrib_rgb = torch.where(nee_cond[..., None], color_transport * out_rad, 0.0)
        contrib_a = torch.where(nee_cond, 1.0, 0.0)
        accum = accum + torch.cat([contrib_rgb, contrib_a[..., None]], dim=-1)

        # Miss -> ambient via color transport, alpha += 0 (light.wgsl:1388-1393).
        miss_now = (hit.prim < 0) & alive
        amb = input_radiance(scene, ray_dir, info, False, no_em, True, settings.solar_angle)[..., :3]
        amb_rgb = torch.where(miss_now[..., None], color_transport * amb, 0.0)
        accum = accum + torch.cat([amb_rgb, torch.zeros((rh, rw, 1), device=dev)], dim=-1)

        # Throughput update + next bounce state (light.wgsl:1381-1387).
        transport = env_brdf(bounce_view, info.normal, surface_b)
        color_transport = torch.where(hit_ok[..., None], color_transport * transport, color_transport)
        alive = hit_ok & (color_transport > 0.01).any(-1)
        bounce_rand = fract(bounce_rand + golden)
        bounce_pos = info.position[..., :3]
        bounce_normal = info.normal

    s = replace(
        s, radiance=accum, sample_position=first_sample_position, sample_normal=first_sample_normal
    )

    # Temporal ReSTIR (light.wgsl:1452-1471): the target pdf is the
    # luminance of the shaded radiance at the primary surface.
    previous_uv = duv - g.velocity_uv[..., :2]
    r = load_previous_reservoir(temporal, previous_uv, render_size)
    r, reproj_ok = check_previous_reservoir(r, s)
    spatial_prev = scatter_invalidate(spatial_prev, previous_uv, ~reproj_ok, render_size)

    surface = retrieve_surface(scene, g.material, g.velocity_uv[..., 2:4])
    view = calculate_view(camera.position, position)
    sample_shaded = shading(
        view,
        s.visible_normal,
        safe_normalize(s.sample_position[..., :3] - s.visible_position[..., :3]),
        surface,
        s.radiance,
        scene.ambient_color,
    )
    w_new = torch.where(
        first_pdf > 0.0,
        stable_div(luminance(sample_shaded), torch.clamp(first_pdf, min=1e-12)),
        0.0,
    )
    r = temporal_restir(r, s, w_new, settings.max_temporal_reuse_count)
    if stopped("restir"):
        return cut(spatial_prev, g, r, spatial_prev)

    out_radiance = shading(
        view,
        r.s.visible_normal,
        safe_normalize(r.s.sample_position[..., :3] - r.s.visible_position[..., :3]),
        surface,
        r.s.radiance,
        scene.ambient_color,
    )
    r = finalize_w(r, luminance(out_radiance))
    r = replace(
        r,
        s=replace(r.s, visible_position=s.visible_position, visible_normal=s.visible_normal),
        lifetime=r.lifetime + 1.0,
    )
    variance = reservoir_variance(r, MAX_VARIANCE)

    r = Reservoir.zeros((rh, rw), dev).select(background, r)
    variance = torch.where(background, 0.0, variance)
    out = torch.where(background[..., None], 0.0, out_radiance * r.w[..., None])

    new_temporal = r if settings.temporal_reuse else temporal
    return out, variance, new_temporal, spatial_prev, background, r
