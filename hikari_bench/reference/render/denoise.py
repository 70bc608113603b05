"""SVGF-style denoiser: demodulation + 4-level edge-aware à-trous filter
— the port of ``hikari_tpu.render.denoise`` (reference
src/shaders/denoise.wgsl, entry points ``demodulation`` and ``denoise``
with step sizes 8/4/2/1, dispatched per lighting channel by
``PostProcessNode::run``, src/post_process.rs:1190-1224). Temporal
accumulation stays disabled, as in the reference.

Every à-trous tap is a static pixel offset: the filter is shifts and
masked weighted sums, differentiable in the irradiance. The taps come
from ``tap(name, dy, dx) -> (tap, valid)``: ``dense_tap``, whole-image
shifts.
"""

from __future__ import annotations

import torch

from hikari_bench.reference.config import F32_EPSILON, RenderSettings
from hikari_bench.reference.render.filters import nearest_sample, shift2d
from hikari_bench.reference.render.light import (
    _deferred_phase,
    _render_uv,
    jittered_deferred_uv,
    strided_deferred_plane,
)
from hikari_bench.reference.render.types import GBuffer
from hikari_bench.reference.utils import ATROUS_KERNEL, luminance, safe_sqrt0

_OFFSETS = [(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1)]

STEP_SIZES = (8, 4, 2, 1)


def deferred_planes(planes, settings: RenderSettings, frame_number: int):
    """Nearest samples of full-res planes at every render pixel's jittered
    deferred uv with amount 0.5 (denoise.wgsl:37-42, :148-150): for an
    integer upscale ratio a strided view, for a fractional one (FSR1) a
    nearest sample at the deferred uv."""
    ratio = settings.upscale_ratio
    if not float(ratio).is_integer():
        duv = jittered_deferred_uv(
            _render_uv(settings.render_size, planes[0].device), frame_number,
            settings.output_size, ratio, amount=0.5,
        )
        return [nearest_sample(a, duv) for a in planes]
    c = _deferred_phase(frame_number, int(ratio), 0.5)
    return [strided_deferred_plane(a, c, int(ratio), settings.render_size) for a in planes]


def normal_weight(n0, n1):
    """(denoise.wgsl:45-48): pow(max(0, dot), 16)."""
    return torch.pow(torch.clamp((n0 * n1).sum(-1), min=0.0), 16.0)


def depth_weight(d0, d1, gradient, offset):
    """(denoise.wgsl:51-54)."""
    grad_dot = gradient[..., 0] * offset[0] + gradient[..., 1] * offset[1]
    return torch.exp(-(d0 - d1).abs() / (grad_dot.abs() + 0.01))


def luminance_weight(l0, l1, variance):
    """(denoise.wgsl:57-62)."""
    strictness, exponent, eps = 4.0, 0.25, 0.001
    return torch.exp(
        -(l0 - l1).abs() / (strictness * torch.pow(torch.clamp(variance, min=0.0), exponent) + eps)
    )


def instance_weight(i0, i1):
    """(denoise.wgsl:65-67)."""
    return torch.clamp(1.0 - (i0 - i1).abs(), min=0.0)


def demodulate(radiance, albedo_rr):
    """irradiance = radiance / albedo, black where albedo < 0.01
    (denoise.wgsl:151-153). ``albedo_rr``: albedo at render res."""
    dark = albedo_rr < 0.01
    return torch.where(dark, 0.0, radiance / torch.where(dark, 1.0, albedo_rr))


def filtered_variance(variance, tap=None):
    """3x3 kernel-weighted variance gather (denoise.wgsl:155-162);
    ``tap("var", dy, dx)`` fetches the neighbours (default ``dense_tap``)."""
    if tap is None:
        tap = dense_tap({"var": variance}, 1)
    k = ATROUS_KERNEL
    out = float(k[1][1]) * torch.clamp(variance, min=0.0)
    for dx, dy in _OFFSETS:
        v, valid = tap("var", dy, dx)
        out = out + float(k[dy + 1][dx + 1]) * torch.where(valid, torch.clamp(v, min=0.0), 0.0)
    return out


def atrous_level(irradiance, var, guides, settings: RenderSettings, tap):
    """One edge-aware à-trous level. ``guides`` = (depth, normal, grad,
    inst); ``tap(name, dy, dx) -> (tap_array, valid)`` supplies the
    neighbour ``(dy, dx)`` steps away of "irr", "normal", "depth" or
    "inst" (``dense_tap``)."""
    depth, normal, grad, inst = guides
    k = ATROUS_KERNEL
    lum_c = luminance(irradiance)
    center_w = float(k[1][1])
    # NaN scrub matches denoise.wgsl:190-196.
    nan_c = (torch.isnan(irradiance) | (irradiance > 3.0e38)).any(-1)
    irr_c = torch.where(nan_c[..., None], 0.0, irradiance)
    sum_irr = irr_c * center_w
    sum_w = torch.where(nan_c, 0.0, center_w)

    firefly = settings.firefly_filtering
    if firefly:
        ff_m1 = torch.zeros_like(lum_c)
        ff_m2 = torch.zeros_like(lum_c)
        ff_n = torch.zeros_like(lum_c)

    for dx, dy in _OFFSETS:
        s_irr, valid = tap("irr", dy, dx)
        s_norm, _ = tap("normal", dy, dx)
        s_depth, _ = tap("depth", dy, dx)
        s_inst, _ = tap("inst", dy, dx)
        s_lum = luminance(s_irr)
        nan_s = (torch.isnan(s_irr) | (s_irr > 3.0e38)).any(-1)
        ok = valid & ~nan_s

        w = (
            normal_weight(normal, s_norm)
            * depth_weight(depth, s_depth, grad, (dx, dy))
            * instance_weight(inst, s_inst)
            * luminance_weight(lum_c, s_lum, var)
        )
        w = torch.clamp(w, 0.0, 1.0) * float(k[dy + 1][dx + 1])
        # Edge-stopping weights are guides, not signal: detached, so the
        # filter is linear in irradiance (as in the JAX package).
        w = torch.where(ok, w, 0.0).detach()
        sum_irr = sum_irr + torch.where(ok[..., None], s_irr, 0.0) * w[..., None]
        sum_w = sum_w + w

        if firefly:
            ff_m1 = ff_m1 + torch.where(ok, s_lum, 0.0)
            ff_m2 = ff_m2 + torch.where(ok, s_lum * s_lum, 0.0)
            ff_n = ff_n + torch.where(ok, 1.0, 0.0)

    new_irr = torch.where(
        (sum_w < 0.0001)[..., None], 0.0, sum_irr / torch.clamp(sum_w[..., None], min=0.0001)
    )

    if firefly:
        ff_mean = ff_m1 / torch.clamp(ff_n, min=1.0)
        ff_var = ff_m2 / torch.clamp(ff_n, min=1.0) - ff_mean * ff_mean
        fire = lum_c > ff_mean + 3.0 * safe_sqrt0(ff_var)
        scale = torch.where(fire, ff_mean / torch.clamp(lum_c, min=1e-8), 1.0)
        new_irr = new_irr * scale[..., None]
    return new_irr


def dense_tap(fields, step: int):
    """The whole-image tap transport: ``shift2d`` of each field by (dy,
    dx) steps of ``step``."""

    def tap(name, dy, dx):
        return shift2d(fields[name], dy * step, dx * step)

    return tap


def _deferred_maps(gbuffer: GBuffer, settings: RenderSettings, frame_number: int):
    """(depth, normal, grad, inst) at render resolution: the guides."""
    pos, normal, grad, inst = deferred_planes(
        (gbuffer.position, gbuffer.normal, gbuffer.depth_gradient,
         gbuffer.instance.to(torch.float32)),
        settings, frame_number,
    )
    return pos[..., 3], normal, grad, inst


def denoise_channel(
    radiance,
    variance,
    albedo_rr,
    gbuffer: GBuffer,
    frame_number: int,
    settings: RenderSettings,
):
    """Full chain for one channel — radiance (rh, rw, 3) and variance
    (rh, rw) after temporal/spatial reuse, albedo resampled to render res:
    demodulation, 4 à-trous levels with the optional firefly clamp, and
    re-modulation by the albedo."""
    depth, normal, grad, inst = _deferred_maps(gbuffer, settings, frame_number)
    background = depth < F32_EPSILON

    irradiance = demodulate(radiance, albedo_rr)
    var = filtered_variance(variance)
    guides = {"normal": normal, "depth": depth, "inst": inst}
    for step in STEP_SIZES:
        tap = dense_tap({"irr": irradiance, **guides}, step)
        irradiance = atrous_level(irradiance, var, (depth, normal, grad, inst), settings, tap)

    out = irradiance * albedo_rr  # re-modulate (denoise.wgsl:314-315)
    return torch.where(background[..., None], 0.0, out)
