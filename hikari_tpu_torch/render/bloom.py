"""Bloom: threshold + separable-Gaussian mip chain + additive composite —
the port of ``hikari_tpu.render.bloom`` (the equivalent of Bevy's BloomNode,
chained after the reference's overlay, src/lib.rs:332-365).

The blur wraps around the image edges (the JAX package's ``jnp.roll``), and
the chain stops at a mip whose shorter side is below 8. The JAX
``_downsample`` adds ``img[0::2]`` to ``img[1::2]``, which fails on a mip
with an odd side (``hikari_tpu/render/bloom.py:28-31``); the port raises
there instead of rendering a result the reference does not define.
"""

from __future__ import annotations

import torch

from hikari_tpu_torch.render.filters import bilinear_sample
from hikari_tpu_torch.utils import luminance, uv_grid

_GAUSS = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def mip_sizes(size_hw, levels: int = 4):
    """The (h, w) of each downsampled mip of a ``size_hw`` image. Raises
    ValueError where a downsampled side is odd, as the JAX package fails
    there."""
    h, w = size_hw
    sizes = []
    for _ in range(levels):
        if min(h, w) < 8:
            break
        if h % 2 or w % 2:
            raise ValueError(
                f"bloom: a {h}x{w} mip has an odd side; the JAX package's _downsample "
                f"(hikari_tpu/render/bloom.py:28-31) adds img[0::2] to img[1::2] and fails "
                f"there with incompatible shapes, so the port does not define this size"
            )
        h, w = h // 2, w // 2
        sizes.append((h, w))
    return sizes


def _blur_axis(img, axis: int):
    """5-tap Gaussian along ``axis`` with wrap-around addressing."""
    acc = img * _GAUSS[2]
    for k, off in ((0, -2), (1, -1), (3, 1), (4, 2)):
        acc = acc + torch.roll(img, off, dims=axis) * _GAUSS[k]
    return acc


def _downsample(img):
    """2x2 box average of an image with even sides."""
    return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2] + img[1::2, 1::2])


def bloom(color, threshold: float = 1.0, intensity: float = 0.15, levels: int = 4):
    """color: (h, w, 3|4) linear HDR. Returns color + bloom."""
    rgb = color[..., :3]
    lum = luminance(rgb)
    soft = torch.clamp(lum - threshold, min=0.0) / torch.clamp(lum, min=1e-4)
    cur = rgb * soft[..., None]

    mips = []
    for _ in mip_sizes(rgb.shape[:2], levels):
        cur = _blur_axis(_blur_axis(_downsample(cur), 0), 1)
        mips.append(cur)

    uv = uv_grid(rgb.shape[:2], rgb.device)
    acc = torch.zeros_like(rgb)
    for i, m in enumerate(mips):
        acc = acc + bilinear_sample(m, uv) / (i + 1.0)

    out = rgb + intensity * acc
    if color.shape[-1] == 4:
        out = torch.cat([out, color[..., 3:4]], dim=-1)
    return out
