"""The port's fwd+grad tools and the exact-RNG loader: ``render/noise.py
reference_noise_bank`` against the JAX package's on 16 PNGs the test
writes (equal arrays; both raise FileNotFoundError without them), and
``tools/clip_engagement.py`` and ``tools/measure_spatial_grads.py`` run
end to end on the CPU at tiny sizes (finite output, the counters filled,
``HIKARI_COUNT_CLIP`` left as it was)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from hikari_tpu.render import noise as jnoise
from hikari_tpu_torch.render import noise as tnoise

torch.set_num_threads(2)


def test_reference_noise_bank_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    for i in range(16):
        px = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        Image.fromarray(px, "RGBA").save(tmp_path / f"LDR_RGBA_{i}.png")
    got = tnoise.reference_noise_bank(str(tmp_path))
    want = jnoise.reference_noise_bank(str(tmp_path))
    assert got.shape == (16, 64, 64, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_reference_noise_bank_missing_raises(tmp_path):
    missing = str(tmp_path / "noise")
    with pytest.raises(FileNotFoundError):
        jnoise.reference_noise_bank(missing)
    with pytest.raises(FileNotFoundError):
        tnoise.reference_noise_bank(missing)


def test_clip_engagement_tool_cpu(capsys):
    from hikari_tpu_torch.tools import clip_engagement

    before = os.environ.get("HIKARI_COUNT_CLIP")
    res = clip_engagement.main(["--config", "cornell", "--size", "24", "--cpu"])
    assert os.environ.get("HIKARI_COUNT_CLIP") == before
    loss, rep = res["cornell"]
    assert np.isfinite(loss) and loss > 0
    assert {"prepass", "direct_lit", "denoise"} <= set(rep)
    assert all(0 <= e <= t and t > 0 for e, t, _ in rep.values())
    assert "TOTAL" in capsys.readouterr().out


def test_measure_spatial_grads_tool_cpu():
    from hikari_tpu_torch.tools import measure_spatial_grads

    rows = measure_spatial_grads.main(["--cpu", "--size", "16", "-k", "2", "--warm", "1"])
    for flag in (False, True):
        signal, noise, seconds, peak, mean = rows[flag]
        assert np.isfinite(signal) and signal > 0 and np.isfinite(seconds) and peak is None
        assert np.isfinite(mean).all()
