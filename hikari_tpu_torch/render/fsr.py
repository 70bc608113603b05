"""FSR 1.0: EASU (edge-adaptive spatial upsampling) + RCAS (robust
contrast-adaptive sharpening) — the port of ``hikari_tpu.render.fsr``.

The reference ships these as prebuilt SPIR-V (src/shaders/fsr/, dispatched
at src/post_process.rs:1279-1308; algorithm AMD FidelityFX ``ffx_fsr1.h``).
This follows the JAX package's re-derivation of that algorithm: the 12-tap
EASU pattern with its bilinear-weighted edge direction and length, the
anisotropic polynomial Lanczos2 lobe, the 2x2 dering clamp; the RCAS cross
sharpen with its no-clip lobe limit. Reciprocals are exact where ffx uses
bit-trick approximations, as in the JAX package.
"""

from __future__ import annotations

import torch

from hikari_tpu_torch.render.filters import bilinear_sample, texel
from hikari_tpu_torch.utils import saturate, uv_grid

FSR_RCAS_LIMIT = 0.25 - 1.0 / 16.0


def _luma2(c):
    """FSR's "luma times 2" (ffx_fsr1.h:366): B*0.5 + R*0.5 + G."""
    return 0.5 * c[..., 0] + c[..., 1] + 0.5 * c[..., 2]


def _easu_set(dir_x, dir_y, length, w, lA, lB, lC, lD, lE):
    """``FsrEasuSetF`` (ffx_fsr1.h:276-312): accumulate the bilinear-
    weighted '+' gradient direction and edge length at one quad tap;
    lA..lE follow the plus layout  a / b c d / e."""
    dc = lD - lC
    cb = lC - lB
    len_x = 1.0 / torch.clamp(torch.maximum(dc.abs(), cb.abs()), min=1e-20)
    dir_xx = lD - lB
    dir_x = dir_x + dir_xx * w
    len_x = saturate(dir_xx.abs() * len_x)
    len_x = len_x * len_x
    length = length + len_x * w

    ec = lE - lC
    ca = lC - lA
    len_y = 1.0 / torch.clamp(torch.maximum(ec.abs(), ca.abs()), min=1e-20)
    dir_yy = lE - lA
    dir_y = dir_y + dir_yy * w
    len_y = saturate(dir_yy.abs() * len_y)
    len_y = len_y * len_y
    length = length + len_y * w
    return dir_x, dir_y, length


def easu(img, out_size):
    """``FsrEasuF`` (ffx_fsr1.h:315-436) over the whole output grid.
    img: (ih, iw, >=3); returns (oh, ow, 3)."""
    ih, iw = img.shape[0], img.shape[1]
    oh, ow = out_size
    dev = img.device

    # con0: output integer position -> input pixel position ('f').
    ox = torch.arange(ow, dtype=torch.float32, device=dev)[None, :]
    oy = torch.arange(oh, dtype=torch.float32, device=dev)[:, None]
    ppx = (ox * (iw / ow) + (0.5 * iw / ow - 0.5)).expand(oh, ow)
    ppy = (oy * (ih / oh) + (0.5 * ih / oh - 0.5)).expand(oh, ow)
    fpx, fpy = torch.floor(ppx), torch.floor(ppy)
    px, py = ppx - fpx, ppy - fpy  # position inside the f/g/j/k quad
    ix, iy = fpx.to(torch.int32).long(), fpy.to(torch.int32).long()
    rgb = img[..., :3]

    def tap(dx, dy):
        return texel(rgb, iy + dy, ix + dx)  # (oh, ow, 3), clamped

    # 12-tap pattern (ffx_fsr1.h:330-334):
    #     b c
    #   e f g h
    #   i j k l
    #     n o
    b, c = tap(0, -1), tap(1, -1)
    e, f, g, h = tap(-1, 0), tap(0, 0), tap(1, 0), tap(2, 0)
    i, j, k, l = tap(-1, 1), tap(0, 1), tap(1, 1), tap(2, 1)
    n, o = tap(0, 2), tap(1, 2)

    bL, cL, eL, fL, gL, hL = map(_luma2, (b, c, e, f, g, h))
    iL, jL, kL, lL, nL, oL = map(_luma2, (i, j, k, l, n, o))

    # Bilinear-weighted direction/length accumulation (ffx_fsr1.h:388-391).
    zeros = torch.zeros((oh, ow), device=dev)
    dir_x, dir_y, length = zeros, zeros, zeros
    dir_x, dir_y, length = _easu_set(dir_x, dir_y, length, (1.0 - px) * (1.0 - py),
                                     bL, eL, fL, gL, jL)
    dir_x, dir_y, length = _easu_set(dir_x, dir_y, length, px * (1.0 - py), cL, fL, gL, hL, kL)
    dir_x, dir_y, length = _easu_set(dir_x, dir_y, length, (1.0 - px) * py, fL, iL, jL, kL, nL)
    dir_x, dir_y, length = _easu_set(dir_x, dir_y, length, px * py, gL, jL, kL, lL, oL)

    # Normalize the direction; zero-gradient pixels become (1, 0)
    # (ffx_fsr1.h:394-402).
    dir_r = dir_x * dir_x + dir_y * dir_y
    zro = dir_r < (1.0 / 32768.0)
    dir_rs = 1.0 / torch.sqrt(torch.clamp(dir_r, min=1e-30))
    dir_rs = torch.where(zro, 1.0, dir_rs)
    dir_x = torch.where(zro, 1.0, dir_x) * dir_rs
    dir_y = torch.where(zro, 0.0, dir_y) * dir_rs

    # len in {0..2} -> {0..1}, shaped (ffx_fsr1.h:404-405).
    length = (length * 0.5) ** 2
    # Kernel stretch: 1.0 horz/vert to sqrt(2) diagonal (ffx_fsr1.h:407).
    stretch = (dir_x * dir_x + dir_y * dir_y) / torch.clamp(
        torch.maximum(dir_x.abs(), dir_y.abs()), min=1e-20
    )
    len2_x = 1.0 + (stretch - 1.0) * length
    len2_y = 1.0 - 0.5 * length
    # Negative lobe strength + window clip (ffx_fsr1.h:413-416).
    lob = 0.5 + ((1.0 / 4.0 - 0.04) - 0.5) * length
    clp = 1.0 / lob

    # Dering hull: min/max of the nearest 2x2 f, g, j, k (ffx_fsr1.h:419-422).
    min4 = torch.minimum(torch.minimum(f, g), torch.minimum(j, k))
    max4 = torch.maximum(torch.maximum(f, g), torch.maximum(j, k))

    aC = torch.zeros((oh, ow, 3), device=dev)
    aW = zeros
    for off_x, off_y, color in (
        (0.0, -1.0, b), (1.0, -1.0, c),
        (-1.0, 1.0, i), (0.0, 1.0, j), (0.0, 0.0, f), (-1.0, 0.0, e),
        (1.0, 1.0, k), (2.0, 1.0, l), (2.0, 0.0, h), (1.0, 0.0, g),
        (1.0, 2.0, o), (0.0, 2.0, n),
    ):
        # ``FsrEasuTapF`` (ffx_fsr1.h:240-270).
        vx = (off_x - px) * dir_x + (off_y - py) * dir_y
        vy = (off_x - px) * (-dir_y) + (off_y - py) * dir_x
        vx = vx * len2_x
        vy = vy * len2_y
        d2 = torch.minimum(vx * vx + vy * vy, clp)
        wB = (2.0 / 5.0) * d2 - 1.0
        wA = lob * d2 - 1.0
        wB = wB * wB
        wA = wA * wA
        wB = (25.0 / 16.0) * wB - (25.0 / 16.0 - 1.0)
        w = wB * wA
        aC = aC + color * w[..., None]
        aW = aW + w

    pix = aC / torch.clamp(aW, min=1e-20)[..., None]
    return torch.minimum(torch.maximum(pix, min4), max4)


def rcas(img, sharpness: float = 0.0):
    """``FsrRcasF`` (ffx_fsr1.h:684-772): sharpen without ringing.
    ``sharpness`` in stops: 0.0 = maximum (FsrRcasCon, ffx_fsr1.h:662)."""
    ih, iw = img.shape[0], img.shape[1]
    gain = float(2.0 ** (-sharpness))
    rgb = img[..., :3]
    ys = torch.arange(ih, device=img.device)[:, None]
    xs = torch.arange(iw, device=img.device)[None, :]

    def tap(dx, dy):
        return texel(rgb, ys + dy, xs + dx)

    b, d, e, f, h = tap(0, -1), tap(-1, 0), rgb, tap(1, 0), tap(0, 1)

    # Min/max of the cross ring, per channel (ffx_fsr1.h:739-744).
    mn4 = torch.minimum(torch.minimum(b, d), torch.minimum(f, h))
    mx4 = torch.maximum(torch.maximum(b, d), torch.maximum(f, h))
    # Limiters: the largest negative lobe that cannot clip
    # (ffx_fsr1.h:746-755).
    hit_min = torch.minimum(mn4, e) / torch.clamp(4.0 * mx4, min=1e-20)
    hit_max = (1.0 - torch.maximum(mx4, e)) / torch.clamp(4.0 * mn4 - 4.0, max=-1e-20)
    lobe_rgb = torch.maximum(-hit_min, hit_max)
    lobe = torch.clamp(
        torch.clamp(lobe_rgb.amax(-1), max=0.0), min=-FSR_RCAS_LIMIT
    ) * gain
    # Resolve (ffx_fsr1.h:761-765).
    rcp_l = 1.0 / (4.0 * lobe + 1.0)
    out = (lobe[..., None] * (b + d + f + h) + e) * rcp_l[..., None]
    if img.shape[-1] > 3:
        out = torch.cat([out, img[..., 3:]], dim=-1)
    return out


def fsr_upscale(img, out_size, sharpness: float = 0.0):
    """EASU upscale + RCAS sharpen; an alpha channel is resampled
    bilinearly (the reference's two dispatches,
    src/post_process.rs:1279-1308)."""
    up = easu(img, out_size)
    if img.shape[-1] > 3:
        alpha = bilinear_sample(img[..., 3:], uv_grid(out_size, img.device))
        up = torch.cat([up, alpha], dim=-1)
    return rcas(up, sharpness)
