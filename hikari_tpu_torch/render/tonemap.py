"""Tone mapping: sum the three lighting channels and apply
luminance-space Reinhard (reference src/shaders/tone_mapping.wgsl:21-32) —
the port of ``hikari_tpu.render.tonemap``."""

from __future__ import annotations

import torch

from hikari_tpu_torch.utils import luminance
from hikari_tpu_torch.utils.profiling import host_read


def reinhard_luminance(color):
    """l_new = l/(1+l); scale color by l_new/l_old."""
    l_old = luminance(color)
    l_new = l_old / (1.0 + l_old)
    scale = l_new / torch.clamp(l_old, min=1e-8)
    return color * scale[..., None]


def inverse_reinhard_luminance(color):
    """The overlay's HDR path (reference src/shaders/overlay.wgsl:27-31):
    luminance clipped to [0.0005, 0.995], l_new = l/(1-l)."""
    l_old = torch.clamp(luminance(color), 0.0005, 0.995)
    l_new = l_old / (1.0 - l_old)
    return color * (l_new / torch.clamp(l_old, min=1e-8))[..., None]


def tone_mapping(direct, emissive, indirect, clear_color):
    """(rh,rw,4) channels in, (rh,rw,4) out. Alpha sums; background
    (a == 0) becomes the clear color; non-finite radiance is scrubbed to 0
    so no NaN reaches cross-frame history."""
    color = direct + emissive + indirect
    color = torch.where(torch.isfinite(color), color, 0.0)
    rgb = reinhard_luminance(torch.clamp(color[..., :3], min=0.0039))
    out = torch.cat([rgb, color[..., 3:4]], dim=-1)
    clear = host_read("tonemap_clear",
                      lambda: torch.tensor(clear_color, dtype=torch.float32, device=color.device))
    return torch.where(color[..., 3:4] > 0.0, out, clear)
