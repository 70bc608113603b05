"""TAA "Jasmine": temporal anti-aliasing with nearest-velocity dilation,
5-tap Catmull-Rom history resampling, multi-probe disocclusion tests and
3x3 YCoCg variance clipping on disocclusion — the port of
``hikari_tpu.render.taa`` (reference src/shaders/taa.wgsl, entry
``taa_jasmine``, run by ``PostProcessNode`` at the post-SMAA resolution,
src/post_process.rs:1260-1277).

Every previous-frame fetch is a clamped texel gather around the shared
base k = floor(sample_position - 0.5) (``filters.texel``); the JAX
package's packed window gather and its zero-velocity shift accessor give
the same values.
"""

from __future__ import annotations

import torch

from hikari_tpu_torch.render.filters import edge_shift, nearest_sample, pixel_grid, texel
from hikari_tpu_torch.render.types import GBuffer
from hikari_tpu_torch.utils import safe_sqrt0, uv_grid
from hikari_tpu_torch.utils.profiling import host_read


def clip_towards_aabb_center(prev_c, cur_c, aabb_min, aabb_max):
    """(taa.wgsl:37-45) on (..., C) colours."""
    p_clip = 0.5 * (aabb_max + aabb_min)
    e_clip = 0.5 * (aabb_max - aabb_min)
    v_clip = prev_c - p_clip
    v_unit = v_clip / torch.where(e_clip == 0.0, 1e-8, e_clip)
    ma_unit = v_unit.abs().amax(-1, keepdim=True)
    clipped = p_clip + v_clip / torch.clamp(ma_unit, min=1e-8)
    return torch.where(ma_unit > 1.0, clipped, prev_c)


def clip_aabb_planes(prev, aabb_min, aabb_max):
    """``clip_towards_aabb_center`` on per-channel planes: ``prev``,
    ``aabb_min``, ``aabb_max`` are same-length sequences of (H, W) tensors."""
    p_clips, v_clips = [], []
    ma = None
    for pc, mn, mx in zip(prev, aabb_min, aabb_max):
        p_clip = 0.5 * (mx + mn)
        e_clip = 0.5 * (mx - mn)
        v_clip = pc - p_clip
        a = (v_clip / torch.where(e_clip == 0.0, 1e-8, e_clip)).abs()
        ma = a if ma is None else torch.maximum(ma, a)
        p_clips.append(p_clip)
        v_clips.append(v_clip)
    denom = torch.clamp(ma, min=1e-8)
    take = ma > 1.0
    return [torch.where(take, p + v / denom, pc) for p, v, pc in zip(p_clips, v_clips, prev)]


def rgb_to_ycocg_planes(r, g, b):
    """(taa.wgsl:20-26) on planes."""
    return r / 4.0 + g / 2.0 + b / 4.0, r / 2.0 - b / 2.0, -r / 4.0 + g / 2.0 - b / 4.0


def ycocg_to_rgb_planes(y, co, cg):
    """(taa.wgsl:28-34) on planes — clamps to [0, 1]."""
    return (
        torch.clamp(y + co - cg, 0.0, 1.0),
        torch.clamp(y + cg, 0.0, 1.0),
        torch.clamp(y - co - cg, 0.0, 1.0),
    )


# Diagonal depth probes of the velocity dilation, as (ox, oy) signs.
_DILATION_SIGNS = [(1.0, 1.0), (-1.0, 1.0), (1.0, -1.0), (-1.0, -1.0)]


def dilation_offsets(depth_tap):
    """Velocity dilation by 4-tap max depth (taa.wgsl:54-73):
    ``depth_tap(dy, dx)`` gives the depth plane at a texel offset. The four
    diagonal taps pick the farthest-depth direction; the offset per axis is
    the sum of the tied max-depth taps' signs, in [-2, 2], and 0 where the
    centre is not nearer than them. Returns (sy, sx) int64 planes."""
    depths = [depth_tap(int(oy), int(ox)) for ox, oy in _DILATION_SIGNS]
    depth = depth_tap(0, 0)
    max_depth = depths[0]
    for d in depths[1:]:
        max_depth = torch.maximum(max_depth, d)
    sx = torch.zeros_like(depth)
    sy = torch.zeros_like(depth)
    for (xsgn, ysgn), d in zip(_DILATION_SIGNS, depths):
        is_max = d == max_depth
        sx = sx + torch.where(is_max, xsgn, 0.0)
        sy = sy + torch.where(is_max, ysgn, 0.0)
    take = depth < max_depth
    return (torch.where(take, sy, 0.0).to(torch.int64),
            torch.where(take, sx, 0.0).to(torch.int64))


def nearest_velocity(gbuffer: GBuffer, uv, inv_size):
    """Velocity dilation via 4-tap max depth (taa.wgsl:54-73) at uv (h, w,
    2); ``inv_size`` is the texel size of the texture the pass runs at.
    At the G-buffer's own resolution the taps are ±1-texel clamped shifts;
    otherwise they are nearest samples at uv ± one texel."""
    gh, gw = gbuffer.position.shape[:2]
    if tuple(uv.shape[:2]) == (gh, gw):
        ys, xs = pixel_grid(gh, gw, uv.device)
        depth = gbuffer.position[..., 3]
        sy, sx = dilation_offsets(lambda dy, dx: edge_shift(depth, dy, dx))
        return texel(gbuffer.velocity_uv[..., :2], ys + sy, xs + sx)
    tx, ty = inv_size
    offs = [(tx, ty), (-tx, ty), (tx, -ty), (-tx, -ty)]
    dev = uv.device
    depths = torch.stack(
        [nearest_sample(gbuffer.position, uv + host_read(
            "taa_dilation", lambda: torch.tensor(o, dtype=torch.float32, device=dev)))[..., 3]
         for o in offs], dim=-1,
    )
    depth = nearest_sample(gbuffer.position, uv)[..., 3]
    max_depth = depths.amax(-1)
    is_max = depths == max_depth[..., None]
    xsign = host_read("taa_dilation", lambda: torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev))
    ysign = host_read("taa_dilation", lambda: torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev))
    ox = tx * torch.where(is_max, xsign, 0.0).sum(-1)
    oy = ty * torch.where(is_max, ysign, 0.0).sum(-1)
    offset = torch.where((depth < max_depth)[..., None], torch.stack([ox, oy], dim=-1), 0.0)
    return nearest_sample(gbuffer.velocity_uv, uv + offset)[..., :2]


def catmull_weights(fx, fy):
    """The 5-tap Catmull-Rom blend as a function of the 4x4 window around
    the sample (taa.wgsl:127-144, TheRealMJP): returns ``apply(W)`` where
    ``W(i, j)`` gives window row i, column j (the sample sits between (1, 1)
    and (2, 2)) as (..., C); the corner taps are never requested."""

    def weights(f):
        w0 = f * (-0.5 + f * (1.0 - 0.5 * f))
        w1 = 1.0 + f * f * (-2.5 + 1.5 * f)
        w2 = f * (0.5 + f * (2.0 - 1.5 * f))
        w3 = f * f * (-0.5 + 0.5 * f)
        return w0, w1, w2, w3

    wx = [w[..., None] for w in weights(fx)]
    wy = [w[..., None] for w in weights(fy)]
    w12x = wx[1] + wx[2]
    w12y = wy[1] + wy[2]
    ox = wx[2] / torch.clamp(w12x, min=1e-8)
    oy = wy[2] / torch.clamp(w12y, min=1e-8)

    def apply(W):
        def lx(a, b):
            return a + (b - a) * ox

        def ly(a, b):
            return a + (b - a) * oy

        def cl(x):
            return torch.clamp(x, 0.0, 1.0)

        acc = cl(lx(W(0, 1), W(0, 2))) * (w12x * wy[0])
        acc = acc + cl(ly(W(1, 0), W(2, 0))) * (wx[0] * w12y)
        acc = acc + cl(ly(lx(W(1, 1), W(1, 2)), lx(W(2, 1), W(2, 2)))) * (w12x * w12y)
        acc = acc + cl(ly(W(1, 3), W(2, 3))) * (wx[3] * w12y)
        acc = acc + cl(lx(W(3, 1), W(3, 2))) * (w12x * wy[3])
        return acc

    return apply


def catmull_rom_5tap(img, sample_position, size_hw):
    """5-tap Catmull-Rom history resample of img (h, w, C) at
    ``sample_position`` (..., 2) in texels. Every texel of the five
    bilinear taps lies in the 4x4 window one texel above-left of the
    sample; the window base clamps into the image and each tap clamps
    again."""
    h, w = size_hw
    texel_pos_1 = torch.floor(sample_position - 0.5) + 0.5
    f = sample_position - texel_pos_1
    kx = torch.clamp(torch.floor(texel_pos_1[..., 0]).to(torch.int32), 0, w - 1).long()
    ky = torch.clamp(torch.floor(texel_pos_1[..., 1]).to(torch.int32), 0, h - 1).long()
    apply = catmull_weights(f[..., 0], f[..., 1])
    return apply(lambda i, j: texel(img, ky + i - 1, kx + j - 1))


def taa_jasmine(
    render,
    previous_render,
    gbuffer: GBuffer,
    prev_gbuffer: GBuffer,
    clear_color,
    upscale_ratio: float,
):
    """One TAA pass: ``render`` (h, w, 4) is the current frame at this
    pass's resolution, ``previous_render`` (h, w, 4) the history; the
    G-buffers are at the full deferred resolution. Returns (h, w, 4)."""
    h, w = render.shape[0], render.shape[1]
    dev = render.device
    cur = render[..., :3]

    if tuple(gbuffer.position.shape[:2]) == (h, w):
        vel = nearest_velocity(gbuffer, uv_grid((h, w), dev), (1.0 / w, 1.0 / h))
        cur_pos = gbuffer.position
    else:
        uv = uv_grid((h, w), dev)
        vel = nearest_velocity(gbuffer, uv, (1.0 / w, 1.0 / h))
        cur_pos = nearest_sample(gbuffer.position, uv)
    vel_x, vel_y = vel[..., 0], vel[..., 1]
    cur_depth = cur_pos[..., 3]

    ys, xs = pixel_grid(h, w, dev)
    xf, yf = xs.to(torch.float32), ys.to(torch.float32)
    prev_ux = (xf + 0.5) / w - vel_x
    prev_uy = (yf + 0.5) / h - vel_y
    boundary_miss = ((prev_ux - 0.5).abs() > 0.5) | ((prev_uy - 0.5).abs() > 0.5)

    has_content = cur_depth > 0.0
    depth_miss = cur_depth == 0.0
    position_miss = cur_depth == 0.0

    # Every previous-frame tap shares the base k = floor(sp - 0.5); a
    # ±1.5-texel bias lands at k + a static offset + the half-texel bit.
    # (x + 0.5) - vel * w, not prev_ux * w: the uv round trip loses bits
    # on the floor boundaries the base sits on.
    spx = (xf + 0.5) - vel_x * w
    spy = (yf + 0.5) - vel_y * h
    tpx, tpy = torch.floor(spx - 0.5), torch.floor(spy - 0.5)
    frx, fry = spx - 0.5 - tpx, spy - 0.5 - tpy
    kx = torch.clamp(tpx.to(torch.int32), 0, w - 1).long()
    ky = torch.clamp(tpy.to(torch.int32), 0, h - 1).long()
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
        return 0 if o == 0.0 else ((1, 2) if o > 0 else (-2, -1))

    def nearest_off(o):
        """nearest-sample offset for a uv bias of o texels."""
        return (0, 1) if o == 0.0 else (2 if o > 0 else -1)

    prev_depth = prev_gbuffer.position[..., 3]
    cur_p = cur_pos[..., :3]
    for bx, by in [(0.0, 0.0), (1.5, 1.5), (-1.5, 1.5), (1.5, -1.5), (-1.5, -1.5)]:
        # The 2x2 textureGather of previous depth reduces to its max: any
        # corner > 0, and any corner with cur/pd < 0.95, are both monotone
        # in pd (pd == 0 corners are never a miss).
        gy, gx = gather_base(by), gather_base(bx)
        maxpd = None
        for ddy in (0, 1):
            for ddx in (0, 1):
                oy = tuple(o + ddy for o in gy) if isinstance(gy, tuple) else gy + ddy
                ox = tuple(o + ddx for o in gx) if isinstance(gx, tuple) else gx + ddx
                pd = at(prev_depth, oy, ox)
                maxpd = pd if maxpd is None else torch.maximum(maxpd, pd)
        has_content = has_content | (maxpd > 0.0)
        depth_miss = depth_miss | torch.where(
            maxpd == 0.0, False, cur_depth / torch.where(maxpd == 0.0, 1.0, maxpd) < 0.95
        )
        pp = at(prev_gbuffer.position[..., :3], nearest_off(by), nearest_off(bx))
        d = cur_p - pp
        dist2 = d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2
        position_miss = position_miss | (dist2 > 0.25)

    pvel = at(prev_gbuffer.velocity_uv[..., :2], (0, 1), (0, 1))
    velocity_miss = ((vel_x - pvel[..., 0]) ** 2 + (vel_y - pvel[..., 1]) ** 2) > 0.00005**2

    prev_rgb = previous_render[..., :3]
    prev = catmull_weights(frx, fry)(lambda i, j: at(prev_rgb, i - 1, j - 1))

    # Disocclusion -> 3x3 YCoCg variance clipping (taa.wgsl:146-164).
    # YCoCg is linear per pixel, so the taps shift the converted planes.
    cc = torch.clamp(cur, 0.0, 1.0)
    center = rgb_to_ycocg_planes(cc[..., 0], cc[..., 1], cc[..., 2])
    m1 = [torch.zeros_like(p) for p in center]
    m2 = [torch.zeros_like(p) for p in center]
    for dy, dx in [(1, -1), (1, 0), (1, 1), (0, -1), (0, 0), (0, 1), (-1, -1), (-1, 0), (-1, 1)]:
        for c, p in enumerate(center):
            t = p if (dy == 0 and dx == 0) else edge_shift(p, dy, dx)
            m1[c] = m1[c] + t
            m2[c] = m2[c] + t * t
    mean = [a / 9.0 for a in m1]
    var = [safe_sqrt0(b / 9.0 - m * m) for b, m in zip(m2, mean)]
    prev_y = rgb_to_ycocg_planes(prev[..., 0], prev[..., 1], prev[..., 2])
    clipped = clip_aabb_planes(prev_y, [m - v for m, v in zip(mean, var)],
                               [m + v for m, v in zip(mean, var)])
    clip_rgb = torch.stack(ycocg_to_rgb_planes(*clipped), dim=-1)
    do_clip = boundary_miss | (position_miss & velocity_miss & depth_miss)
    prev = torch.where(do_clip[..., None], clip_rgb, prev)

    out_rgb = prev + (cur - prev) * (0.1 / upscale_ratio)
    out = torch.cat([out_rgb, render[..., 3:4]], dim=-1)
    clear = host_read("taa_clear",
                      lambda: torch.tensor(clear_color, dtype=torch.float32, device=dev))
    clear = clear.broadcast_to((4,))
    return torch.where(has_content[..., None], out, clear)
