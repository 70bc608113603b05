"""Material textures — the port of ``hikari_tpu.render.texture``. Every
texture is stored row-major at its native resolution (capped at
ATLAS_MAX_SIZE) in one flat buffer of packed RGBA8 texels, with a (T, 3)
[offset, h, w] side table; a sample reads the texture's meta row, computes
repeat-addressed texel indices at that texture's own size and fetches the
four bilinear corners from the flat buffer. Texture id -1 means "no
texture" and samples white. ``resample_to_stack``/``sample_texture_stack``
are the fixed-size stack form the JAX package keeps for its tests."""

from __future__ import annotations

import numpy as np
import torch

from hikari_tpu_torch.utils import gather_channels

TEXTURE_SIZE = 256
ATLAS_MAX_SIZE = 2048


def resample_to_stack(images: list[np.ndarray], size: int = TEXTURE_SIZE) -> np.ndarray:
    """Resize (h, w, 3|4) uint8/float images to a uniform (T, size, size,
    4) float32 stack in [0, 1] (host side)."""
    from PIL import Image

    out = np.ones((max(len(images), 1), size, size, 4), dtype=np.float32)
    for i, img in enumerate(images):
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if arr.shape[-1] == 3:
            arr = np.concatenate([arr, np.ones(arr.shape[:-1] + (1,), dtype=np.float32)], axis=-1)
        pil = Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8), "RGBA")
        out[i] = np.asarray(pil.resize((size, size), Image.BILINEAR), dtype=np.float32) / 255.0
    return out


def _bilinear(fetch, uv, h, w):
    """Bilinear blend at ``uv`` (..., 2) of the four repeat-addressed
    texels of an (h, w) texture (ints, or int tensors per sample);
    ``fetch(yi, xi)`` returns (..., 4)."""
    hf = h.to(torch.float32) if isinstance(h, torch.Tensor) else float(h)
    wf = w.to(torch.float32) if isinstance(w, torch.Tensor) else float(w)
    u = uv[..., 0] * wf - 0.5
    v = uv[..., 1] * hf - 0.5
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = (u - x0)[..., None], (v - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.remainder(y0.to(torch.int32), h)
    y1i = torch.remainder(y0i + 1, h)
    top = fetch(y0i, x0i) * (1 - fx) + fetch(y0i, x1i) * fx
    bot = fetch(y1i, x0i) * (1 - fx) + fetch(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def sample_texture_stack(stack, tex_id, uv):
    """Bilinear sample of a (T, S, S, 4) stack with repeat addressing.
    ``tex_id`` (...,) may be -1 (white). ``uv`` (..., 2). Returns (..., 4)."""
    T, S = stack.shape[0], stack.shape[1]
    safe_id = torch.clamp(tex_id, 0, T - 1)
    flat = stack.reshape(T * S * S, 4)
    result = _bilinear(lambda yi, xi: gather_channels(flat, (safe_id * S + yi) * S + xi), uv, S, S)
    return torch.where((tex_id >= 0)[..., None], result, 1.0)


def sample_texture_atlas(atlas, meta, tex_id, uv):
    """Bilinear sample of the native-resolution atlas with repeat
    addressing. ``atlas`` (N,) packed RGBA8 texels (held in int64),
    ``meta`` (T, 3) [offset, h, w], ``tex_id`` (...,) may be -1 (white),
    ``uv`` (..., 2). Returns (..., 4) float32 in [0, 1]."""
    safe_id = torch.clamp(tex_id, 0, meta.shape[0] - 1)
    m = gather_channels(meta, safe_id)
    off, h, w = m[..., 0], m[..., 1], m[..., 2]

    def fetch(yi, xi):
        texel = atlas[(off + yi * w + xi).long()]
        return torch.stack([(texel >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1).to(
            torch.float32) / 255.0

    result = _bilinear(fetch, uv, h, w)
    return torch.where((tex_id >= 0)[..., None], result, 1.0)


def srgb_to_linear(c):
    """glTF base-color and emissive textures are sRGB-encoded."""
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))


def build_texture_atlas(images: list[np.ndarray], max_size: int = ATLAS_MAX_SIZE):
    """Pack textures into a flat RGBA8-in-u32 atlas (downsampling only
    above ``max_size``). Returns (atlas (N,) uint32, meta (T, 3) int32)."""
    blocks, meta = [], []
    off = 0
    for img in images:
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if arr.shape[-1] == 3:
            arr = np.concatenate(
                [arr, np.full(arr.shape[:-1] + (1,), 255, np.uint8)], axis=-1
            )
        h, w = arr.shape[:2]
        if max(h, w) > max_size:
            from PIL import Image

            s = max_size / max(h, w)
            nh, nw = max(int(h * s), 1), max(int(w * s), 1)
            arr = np.asarray(Image.fromarray(arr, "RGBA").resize((nw, nh), Image.BILINEAR))
            h, w = nh, nw
        a32 = arr.astype(np.uint32)
        packed = a32[..., 0] | (a32[..., 1] << 8) | (a32[..., 2] << 16) | (a32[..., 3] << 24)
        blocks.append(packed.reshape(-1))
        meta.append((off, h, w))
        off += h * w
    if not blocks:
        return np.zeros((1,), dtype=np.uint32), np.zeros((1, 3), dtype=np.int32)
    return np.concatenate(blocks).astype(np.uint32), np.asarray(meta, dtype=np.int32)
