"""Tone mapping: sum the three lighting channels and apply
luminance-space Reinhard (reference src/shaders/tone_mapping.wgsl:21-32) —
the port of ``hikari_tpu.render.tonemap``."""

from __future__ import annotations

import torch

from hikari_bench.reference.utils import luminance


def reinhard_luminance(color):
    """l_new = l/(1+l); scale color by l_new/l_old."""
    l_old = luminance(color)
    l_new = l_old / (1.0 + l_old)
    scale = l_new / torch.clamp(l_old, min=1e-8)
    return color * scale[..., None]


def tone_mapping(direct, emissive, indirect, clear_color):
    """(rh,rw,4) channels in, (rh,rw,4) out. Alpha sums; background
    (a == 0) becomes the clear color; non-finite radiance is scrubbed to 0
    so no NaN reaches cross-frame history."""
    color = direct + emissive + indirect
    color = torch.where(torch.isfinite(color), color, 0.0)
    rgb = reinhard_luminance(torch.clamp(color[..., :3], min=0.0039))
    out = torch.cat([rgb, color[..., 3:4]], dim=-1)
    clear = torch.tensor(clear_color, dtype=torch.float32, device=color.device)
    return torch.where(color[..., 3:4] > 0.0, out, clear)
