"""Blue-noise texture bank — the port of ``hikari_tpu.render.noise``.

The reference embeds 16 prebuilt 64x64 RGBA blue-noise PNGs
(src/lib.rs:189-219, sampled at light.wgsl:1075-1079 with golden-ratio
temporal scrambling). The bank is generated procedurally with the JAX
package's numpy recipe (FFT-shaped white noise, rank-normalized to exact
uniform [0,1)), so the two packages hold bit-identical banks;
``reference_noise_bank`` loads the reference's own PNGs instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hikari_bench.reference.config import NOISE_TEXTURE_COUNT

NOISE_SIZE = 64


def _blue_noise_channel(rng: np.random.Generator, size: int) -> np.ndarray:
    white = rng.standard_normal((size, size))
    f = np.fft.fft2(white)
    fx = np.fft.fftfreq(size)[None, :]
    fy = np.fft.fftfreq(size)[:, None]
    rad = np.sqrt(fx * fx + fy * fy)
    # High-pass: suppress low frequencies, boost ~ linearly with radius.
    weight = np.minimum(rad / 0.5, 1.0) ** 1.5
    shaped = np.real(np.fft.ifft2(f * weight))
    # Rank-order normalize to exactly uniform [0,1).
    flat = shaped.reshape(-1)
    ranks = np.empty_like(flat, dtype=np.float64)
    ranks[np.argsort(flat, kind="stable")] = (
        np.arange(flat.size, dtype=np.float64) + 0.5
    ) / flat.size
    return ranks.reshape(size, size).astype(np.float32)


@functools.lru_cache(maxsize=1)
def blue_noise_bank(
    count: int = NOISE_TEXTURE_COUNT, size: int = NOISE_SIZE, seed: int = 0x51D
) -> np.ndarray:
    """(count, size, size, 4) float32 in [0,1) — the analogue of the
    reference's ``NoiseTextures`` binding array (src/lib.rs:515-598)."""
    rng = np.random.default_rng(seed)
    return np.stack(
        [
            np.stack([_blue_noise_channel(rng, size) for _ in range(4)], axis=-1)
            for _ in range(count)
        ]
    )


@functools.lru_cache(maxsize=1)
def reference_noise_bank(directory: str, count: int = NOISE_TEXTURE_COUNT) -> np.ndarray:
    """Exact-RNG parity mode (JAX ``reference_noise_bank``): the reference's
    ``count`` embedded 64x64 RGBA blue-noise textures
    (``noise/LDR_RGBA_{i}.png`` in ``directory``, src/lib.rs:189-219, loaded
    non-sRGB) as a (count, 64, 64, 4) float32 bank in [0, 1], so stochastic
    intermediates can be compared one to one with the reference. The
    procedural ``blue_noise_bank`` stays the default. Raises
    FileNotFoundError without the reference checkout."""
    import os

    from PIL import Image

    planes = []
    for i in range(count):
        path = os.path.join(directory, f"LDR_RGBA_{i}.png")
        img = np.asarray(Image.open(path).convert("RGBA"), dtype=np.float32)
        planes.append(img / 255.0)
    return np.stack(planes)


def noise_plane(bank: torch.Tensor, frame_number: int, size_hw, origin=(0, 0)):
    """``sample_noise`` over the (h, w) pixel grid whose first pixel is
    ``origin`` (a sharded frame's block): the index pattern (pixel +
    frame) % noise_size is periodic with the 64-texel tile, so the fetch
    is one texture pick + a roll + a tile."""
    count, size = bank.shape[0], bank.shape[1]
    tile = bank[frame_number % count]
    shift = frame_number % size
    rolled = torch.roll(tile, (-shift, -shift), dims=(0, 1))
    (h, w), (y0, x0) = size_hw, origin
    plane = rolled.repeat(-(-(y0 + h) // size), -(-(x0 + w) // size), 1)
    return plane[y0 : y0 + h, x0 : x0 + w, :]


def sample_noise(bank: torch.Tensor, frame_number: int, coords_y, coords_x):
    """Reference noise fetch (light.wgsl:1075-1079): texture index =
    frame % NOISE_TEXTURE_COUNT; texel = (pixel + frame) % noise_size."""
    count, size = bank.shape[0], bank.shape[1]
    y = torch.remainder(coords_y + frame_number, size)
    x = torch.remainder(coords_x + frame_number, size)
    return bank[frame_number % count][y, x]
