"""FXAA 3.11 (console variant, simplified): luma-driven edge anti-alias —
the port of ``hikari_tpu.render.fxaa`` (the equivalent of Bevy's FxaaNode,
src/lib.rs:332-365): a local-contrast gate, the edge direction from the
3x3 luma neighbourhood, a blend across the edge scaled by the subpixel
aliasing amount. Neighbours wrap around the image edges (``torch.roll``),
as the JAX package's ``jnp.roll`` does."""

from __future__ import annotations

import torch

from hikari_tpu_torch.utils import luminance

EDGE_THRESHOLD_MIN = 0.0312
EDGE_THRESHOLD = 0.125
SUBPIXEL_QUALITY = 0.75


def _shift(img, dy: int, dx: int):
    """out[y, x] = img[(y + dy) mod h, (x + dx) mod w]."""
    return torch.roll(torch.roll(img, -dy, dims=0), -dx, dims=1)


def fxaa(color):
    """color (h, w, 3|4) LDR -> anti-aliased, same shape."""
    rgb = color[..., :3]
    luma = luminance(torch.clamp(rgb, 0.0, 1.0))

    l_c = luma
    l_n, l_s = _shift(luma, -1, 0), _shift(luma, 1, 0)
    l_e, l_w = _shift(luma, 0, 1), _shift(luma, 0, -1)
    l_ne, l_nw = _shift(luma, -1, 1), _shift(luma, -1, -1)
    l_se, l_sw = _shift(luma, 1, 1), _shift(luma, 1, -1)

    l_min = torch.minimum(l_c, torch.minimum(torch.minimum(l_n, l_s), torch.minimum(l_e, l_w)))
    l_max = torch.maximum(l_c, torch.maximum(torch.maximum(l_n, l_s), torch.maximum(l_e, l_w)))
    rng = l_max - l_min
    active = rng >= torch.clamp(l_max * EDGE_THRESHOLD, min=EDGE_THRESHOLD_MIN)

    # Edge orientation from second derivatives (FXAA console).
    edge_h = (
        (l_nw + l_ne - 2 * l_n).abs()
        + 2 * (l_w + l_e - 2 * l_c).abs()
        + (l_sw + l_se - 2 * l_s).abs()
    )
    edge_v = (
        (l_nw + l_sw - 2 * l_w).abs()
        + 2 * (l_n + l_s - 2 * l_c).abs()
        + (l_ne + l_se - 2 * l_e).abs()
    )
    horizontal = edge_h >= edge_v

    # Blend amount from the average-neighbourhood contrast (subpixel
    # aliasing).
    l_avg = (2 * (l_n + l_s + l_e + l_w) + l_ne + l_nw + l_se + l_sw) / 12.0
    sub = torch.clamp((l_avg - l_c).abs() / torch.clamp(rng, min=1e-6), 0.0, 1.0)
    blend = torch.square(sub * sub) * SUBPIXEL_QUALITY

    # Average across the edge (perpendicular direction).
    cross_avg = torch.where(
        horizontal[..., None],
        0.5 * (_shift(rgb, -1, 0) + _shift(rgb, 1, 0)),
        0.5 * (_shift(rgb, 0, -1) + _shift(rgb, 0, 1)),
    )
    b = torch.where(active, blend, 0.0)[..., None]
    out = rgb * (1.0 - b) + cross_avg * b
    if color.shape[-1] == 4:
        out = torch.cat([out, color[..., 3:4]], dim=-1)
    return out
