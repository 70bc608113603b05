"""Image output and comparison helpers — a copy of ``hikari_tpu.io.image``
(numpy and PIL; the port keeps its own so that it never imports the JAX
package). Images are (h, w, c) float arrays in [0, 1]; tensors convert
with ``.cpu().numpy()`` first."""

from __future__ import annotations

import numpy as np


def to_srgb_u8(img: np.ndarray) -> np.ndarray:
    """Linear [0,1] -> sRGB-encoded uint8 (the swapchain conversion the
    reference gets from wgpu's Bgra8UnormSrgb surface)."""
    x = np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
    srgb = np.where(x <= 0.0031308, 12.92 * x, 1.055 * np.power(x, 1.0 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray, srgb: bool = True) -> None:
    from PIL import Image

    rgb = img[..., :3]
    data = to_srgb_u8(rgb) if srgb else (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(data, mode="RGB").save(path)


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0


def image_mse(a: np.ndarray, b: np.ndarray) -> float:
    d = np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)
    return float(np.mean(d * d))


def image_psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = image_mse(a, b)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))
