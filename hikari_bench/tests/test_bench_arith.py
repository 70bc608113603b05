"""The yardstick's arithmetic: ray accounting, percentiles and rates over
all samples, the trace layer's least bytes, the roofline share."""

import random

import numpy as np
import pytest

from hikari_bench import arith


def _port_rays(width, height, device="cpu"):
    from hikari_tpu_torch.bench import bench_config, rays_per_frame
    from hikari_tpu_torch.scene import build_scene_buffers

    scene, _, settings = bench_config("cornell", device)
    settings = settings.replace(width=width, height=height)
    return settings, build_scene_buffers(scene, device), rays_per_frame


@pytest.mark.parametrize("size, expected", [((1920, 1080), 5_564_160), ((3840, 2160), 22_256_640)])
def test_rays_per_frame_matches_the_port(size, expected):
    settings, buffers, port_rays = _port_rays(*size)
    ours = arith.rays_per_frame(settings.output_size, settings.render_size,
                                settings.direct_validate_interval,
                                settings.emissive_validate_interval, settings.emissive_lit,
                                buffers.num_emissives, settings.indirect_bounces)
    assert ours == port_rays(settings, buffers)
    assert round(ours) == expected


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_over_all_samples(q):
    rng = random.Random(q)
    xs = [rng.expovariate(1.0) for _ in range(101)]
    assert arith.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)
    # Every sample counts: moving the largest moves the top percentile.
    assert arith.percentile(xs + [1e9], 100) == 1e9


def test_percentile_and_rate_refuse_nothing():
    with pytest.raises(ValueError):
        arith.percentile([], 90)
    with pytest.raises(ValueError):
        arith.rate(10, 0.0)
    assert arith.rate(30, 1.5) == 20


def test_trace_min_bytes_and_roofline():
    # 60 B a ray (44 in, 16 out) and 36 B a triangle a call.
    assert arith.trace_min_bytes(1, 0, 10) == 60
    assert arith.trace_min_bytes(0, 2, 10) == 720
    b = arith.trace_min_bytes(22_256_640, 8, 550_994)
    assert b == 22_256_640 * 60 + 8 * 550_994 * 36
    # A time equal to the least time is 100%; twice it 50%.
    least = b / arith.H100_PEAK_BYTES_PER_S
    assert arith.roofline_pct(b, least) == pytest.approx(100.0)
    assert arith.roofline_pct(b, 2 * least) == pytest.approx(50.0)
    assert arith.roofline_pct(b, 0.0) is None


def test_union_and_idle():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert arith.union_length(iv) == 4.0
    assert arith.idle_pct(iv, 0.0, 10.0) == pytest.approx(60.0)
    assert arith.idle_gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert arith.idle_pct(iv, 1.0, 2.0) == 0.0

