"""SMAA TU4x temporal upscaler (checkerboard 4x reconstruction) — the port
of ``hikari_tpu.render.smaa`` (reference src/shaders/smaa.wgsl): each
render pixel maps to a 2x2 output quad; the current sample fills one
diagonal slot (by frame parity), the reprojected previous output fills the
other (with depth/instance/velocity disocclusion, a 2x2 YCoCg clip and the
subpixel-velocity remix), and the extrapolate pass fills the remaining two
slots by a differential blend of their neighbours.

This ports the math of the JAX package's ``_smaa_body``/``_consume``.
Every fetch is a clamped texel gather (``filters.texel``): the static
quad taps at out-res texel (2y + j + cy, 2x + j + cx), and the reprojected
taps around the base floor(sample_position - 0.5). The JAX package's
100-channel window pack and its zero-velocity phase sampler are TPU
transports of the same values.
"""

from __future__ import annotations

import torch

from hikari_bench.reference.render.filters import edge_shift, interleave2x2, pixel_grid, texel
from hikari_bench.reference.render.taa import (
    clip_aabb_planes,
    dilation_offsets,
    rgb_to_ycocg_planes,
    ycocg_to_rgb_planes,
)
from hikari_bench.reference.render.types import GBuffer
from hikari_bench.reference.utils import TAU, fract, luminance, safe_sqrt0

_BIASES = [(0.0, 0.0), (2.5, 2.5), (-2.5, 2.5), (2.5, -2.5), (-2.5, -2.5)]
# Floor shift of the out-res gather base per bias.
_BSHIFT = {0.0: 0, 2.5: 2, -2.5: -3}
# Floor shift of the render-res gather base per bias: even frames (j = 1)
# and odd frames (j = 0).
_RSHIFT = {True: {0.0: 0, 2.5: 1, -2.5: -1}, False: {0.0: -1, 2.5: 1, -2.5: -2}}


def smaa_tu4x(
    render,
    prev_upscaled,
    gbuffer: GBuffer,
    prev_gbuffer: GBuffer,
    frame_number: int,
):
    """``render`` (h, w, 4): the tonemapped current frame at render res;
    ``prev_upscaled`` (2h, 2w, 4): the previous output; the G-buffers at
    output res. Returns (2h, 2w, 4)."""
    h, w = render.shape[0], render.shape[1]
    oh, ow = 2 * h, 2 * w
    dev = render.device

    even = frame_number % 2 == 0
    j = 1 if even else 0  # the quad slot the previous output fills

    cur = render[..., :3]
    ys, xs = pixel_grid(h, w, dev)
    depth_plane = gbuffer.position[..., 3]

    def quad_tap(img, cy, cx):
        """img at out-res texel (2y + j + cy, 2x + j + cx), clamped."""
        return texel(img, 2 * ys + j + cy, 2 * xs + j + cx)

    sy, sx = dilation_offsets(lambda dy, dx: quad_tap(depth_plane, dy, dx))
    vel = texel(gbuffer.velocity_uv[..., :2], 2 * ys + j + sy, 2 * xs + j + sx)
    vel_x, vel_y = vel[..., 0], vel[..., 1]
    xf, yf = xs.to(torch.float32), ys.to(torch.float32)
    prev_ux = (2.0 * xf + j + 0.5) / ow - vel_x
    prev_uy = (2.0 * yf + j + 0.5) / oh - vel_y
    boundary_miss = ((prev_ux - 0.5).abs() > 0.5) | ((prev_uy - 0.5).abs() > 0.5)

    cur_instance = quad_tap(gbuffer.instance.to(torch.float32), 0, 0)
    cur_depth = quad_tap(depth_plane, 0, 0)

    # Reprojected fetches share the base k = floor(sp - 0.5); a ±2.5-texel
    # bias lands at k + a static offset + the half-texel bit.
    # (2x + j + 0.5) - vel * size, not prev_ux * size: the uv round trip
    # loses bits on the floor boundaries the base sits on.
    spx = (2.0 * xf + j + 0.5) - vel_x * ow
    spy = (2.0 * yf + j + 0.5) - vel_y * oh
    tpx, tpy = torch.floor(spx - 0.5), torch.floor(spy - 0.5)
    frx, fry = spx - 0.5 - tpx, spy - 0.5 - tpy
    kx = torch.clamp(tpx.to(torch.int32), 0, ow - 1).long()
    ky = torch.clamp(tpy.to(torch.int32), 0, oh - 1).long()
    bit_x, bit_y = (frx >= 0.5).long(), (fry >= 0.5).long()

    def at(img, oy, ox):
        """img at the base + (oy, ox); an offset pair (lo, hi) picks hi on
        the pixel's half-texel bit."""
        if isinstance(oy, tuple):
            oy = oy[0] + bit_y * (oy[1] - oy[0])
        if isinstance(ox, tuple):
            ox = ox[0] + bit_x * (ox[1] - ox[0])
        return texel(img, ky + oy, kx + ox)

    def gather_base(o):
        """textureGather corner base for a uv bias of o texels."""
        return 0 if o == 0.0 else ((2, 3) if o > 0 else (-3, -2))

    def nearest_off(o):
        """nearest-sample offset for a uv bias of o texels."""
        return (0, 1) if o == 0.0 else (3 if o > 0 else -2)

    prev = at(prev_upscaled[..., :3], (0, 1), (0, 1))
    prev_depth = prev_gbuffer.position[..., 3]
    prev_instance_plane = prev_gbuffer.instance.to(torch.float32)

    depth_miss = cur_depth == 0.0
    instance_miss = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for bx, by in _BIASES:
        # The 2x2 textureGather's OR of cur/pd < 0.95 is cur/max(pd) < 0.95
        # (division is monotone in the denominator).
        gy, gx = gather_base(by), gather_base(bx)
        maxpd = None
        for ddy in (0, 1):
            for ddx in (0, 1):
                oy = tuple(o + ddy for o in gy) if isinstance(gy, tuple) else gy + ddy
                ox = tuple(o + ddx for o in gx) if isinstance(gx, tuple) else gx + ddx
                pd = at(prev_depth, oy, ox)
                maxpd = pd if maxpd is None else torch.maximum(maxpd, pd)
        miss_here = torch.where(
            maxpd == 0.0, False, cur_depth / torch.where(maxpd == 0.0, 1.0, maxpd) < 0.95
        )
        depth_miss = depth_miss | miss_here
        prev_instance = at(prev_instance_plane, nearest_off(by), nearest_off(bx))
        instance_miss = instance_miss | (miss_here & ((prev_instance - cur_instance).abs() > 1.0))

    pvel = at(prev_gbuffer.velocity_uv[..., :2], (0, 1), (0, 1))
    velocity_miss = ((vel_x - pvel[..., 0]) ** 2 + (vel_y - pvel[..., 1]) ** 2) > 0.0001**2
    # Disocclusion -> nearest-depth-biased 2x2 YCoCg clip (smaa.wgsl:159-189):
    # the render-texture gather corners at the winning bias.
    rshift = _RSHIFT[even]
    min_ds = torch.full((h, w), 10.0, device=dev)
    quad = [None] * 4
    for bx, by in _BIASES:
        cy, cx = _BSHIFT[by], _BSHIFT[bx]
        dds = None
        for dy in (0, 1):
            for dx in (0, 1):
                d = cur_depth - quad_tap(depth_plane, cy + dy, cx + dx)
                dds = d * d if dds is None else dds + d * d
        dds = safe_sqrt0(dds)
        take = dds < min_ds
        for i, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            corner = edge_shift(cur, rshift[by] + dy, rshift[bx] + dx)
            quad[i] = corner if quad[i] is None else torch.where(take[..., None], corner, quad[i])
        min_ds = torch.minimum(min_ds, dds)

    m1 = torch.zeros((h, w, 3), device=dev)
    m2 = torch.zeros((h, w, 3), device=dev)
    for corner in quad:
        t = torch.stack(rgb_to_ycocg_planes(corner[..., 0], corner[..., 1], corner[..., 2]), -1)
        m1 = m1 + t
        m2 = m2 + t * t
    mean = m1 / 4.0
    var = safe_sqrt0(m2 / 4.0 - mean * mean)
    prev_y = rgb_to_ycocg_planes(prev[..., 0], prev[..., 1], prev[..., 2])
    lo, hi = mean - var, mean + var
    clipped = clip_aabb_planes(prev_y, lo.unbind(-1), hi.unbind(-1))
    clip_rgb = torch.stack(ycocg_to_rgb_planes(*clipped), dim=-1)
    do_clip = boundary_miss | ((depth_miss | instance_miss) & velocity_miss)
    prev = torch.where(do_clip[..., None], clip_rgb, prev)
    # Subpixel-velocity differential remix (smaa.wgsl:186-195): bilinear at
    # the previous quad uv on the render texture, whose corners and
    # fraction depend only on the frame parity.
    subpix_x = fract(vel_x * (0.5 * ow))
    subpix_y = fract(vel_y * (0.5 * oh))
    blend = torch.clamp(-torch.cos(torch.maximum(subpix_x, subpix_y) * TAU), 0.0, 1.0)
    fxy = 0.25 if even else 0.75
    base = 0 if even else -1
    c00 = edge_shift(cur, base, base)
    c10 = edge_shift(cur, base, base + 1)
    c01 = edge_shift(cur, base + 1, base)
    c11 = edge_shift(cur, base + 1, base + 1)
    remix = (c00 * (1 - fxy) + c10 * fxy) * (1 - fxy) + (c01 * (1 - fxy) + c11 * fxy) * fxy
    prev = prev + (remix - prev) * blend[..., None]
    ones = torch.ones((h, w, 1), device=dev)
    cur_rgba = torch.cat([cur, ones], dim=-1)
    prev_rgba = torch.cat([prev, ones], dim=-1)
    q00 = cur_rgba if even else prev_rgba  # slot (j, j) on even frames etc.
    q11 = prev_rgba if even else cur_rgba

    # ------ extrapolate pass (smaa.wgsl:201-271) ------
    def shift(p, dy, dx):  # out[y, x] = p[(y + dy) mod h, (x + dx) mod w]
        return torch.roll(p, shifts=(-dy, -dx), dims=(0, 1))

    t_c, b_c = q00, q11
    n_c = shift(q11, -1, 0)
    e_c = shift(q00, 0, 1)
    s_c = shift(q00, 1, 0)
    w_c = shift(q11, 0, -1)

    def lum_absdiff(a, b):
        return luminance((a[..., :3] - b[..., :3]).abs())

    dh0 = lum_absdiff(w_c, b_c)
    dh1 = lum_absdiff(t_c, e_c)
    dv0 = lum_absdiff(t_c, s_c)
    dv1 = lum_absdiff(n_c, b_c)
    factor_x = (torch.clamp(dv0, min=0.001) * torch.clamp(dv1, min=0.001))[..., None]
    factor_y = (torch.clamp(dh0, min=0.001) * torch.clamp(dh1, min=0.001))[..., None]
    factor_z = 1.0 / (factor_x + factor_y)

    def diff_blend(t_, b_, l_, r_):
        return (0.5 * factor_z) * ((l_ + r_) * factor_x + (t_ + b_) * factor_y)

    q10 = diff_blend(t_c, s_c, w_c, b_c)  # out[2y+1, 2x]
    q01 = diff_blend(n_c, b_c, t_c, e_c)  # out[2y, 2x+1]
    return interleave2x2(q00, q01, q10, q11)
