"""Whole frames of the bench configuration in the port against
``hikari_tpu``: SMAA TU4x at 2x, TAA Jasmine, denoise, one indirect bounce
with indirect spatial reuse, ``reservoir_f16``, ``emissive_lit``,
``reproject="shift"``, no remat — the frame of ``bench.py:77-116``, forward
only, at a small size: cornell at 48x62 output (render 24x31). The port
traces every ray with the closest-hit twin, the JAX package with its own
brute force. Each frame starts from the JAX package's state
(``frame_state_from_numpy``). ``test_torch_bench_city.py`` runs the city
frames with these helpers.

Frames 2-4 are compared. Frame 0 resets every reservoir, and a reset
pixel's variance w2_sum/1 - (w_sum/1)^2 is exactly 0 in the port but an
FMA rounding residual in XLA's CPU code, which the denoiser's luminance
weight (variance^0.25) magnifies into visible differences. Frames 0 and 1
also sample at exact pixel centres (Halton point 0 is (0, 0)), where the
even output width puts centres on the box's 45-degree quad diagonals and a
1-ulp difference decides hit or miss (ROADMAP.md section 3).

Tolerances: the images and the next state's G-buffer as the images of
test_torch_pipeline.py (within 1e-3, relative above 1, on >= 99.5% of the
pixels, mean |diff| <= 1e-4; G-buffer ids equal); the lighting channels, which carry
the discrete reservoir decisions of spatial reuse, within 1e-3 on >= 99%
of the pixels with mean <= 2e-3; stats within 2e-3 relative."""

import numpy as np
import pytest
import torch

import hikari_tpu.config as jc
import hikari_tpu_torch.config as tc
from hikari_tpu.render.pipeline import initial_state as j_init
from hikari_tpu.render.pipeline import render_frame_jit as j_render
from hikari_tpu.scene.buffers import to_device as j_dev
from hikari_tpu.scene.compile import compile_scene
from hikari_tpu_torch.render.pipeline import render_frame as t_render
from hikari_tpu_torch.scene.buffers import frame_state_from_numpy
from hikari_tpu_torch.scene.buffers import to_device as t_dev
from test_torch_pipeline import assert_image_close

torch.set_num_threads(2)

BENCH = dict(
    upscale_ratio=2.0, denoise=True, indirect_bounces=1, indirect_spatial_reuse=True,
    emissive_spatial_reuse=False, emissive_lit=True, reservoir_f16=True, reproject="shift",
    remat=False, collect_stats=True,
)


def _settings(mod, width, height, tracer):
    kw = dict(BENCH)
    ratio = kw.pop("upscale_ratio")
    return mod.RenderSettings(width=width, height=height, upscale=mod.Upscale.smaa_tu4x(ratio),
                              taa=mod.Taa.JASMINE, tracer=tracer, **kw)


def _world(arrays, jcam, tcam, width, height, jax_tracer, port_tracer):
    jb = j_dev(arrays)
    js = _settings(jc, width, height, jax_tracer)
    states, outs = [j_init(js)], []
    for _ in range(6):
        out, nxt = j_render(jb, jcam, states[-1], js)
        outs.append(out)
        states.append(nxt)
    return dict(tb=t_dev(arrays, "cpu"), tcam=tcam, ts=_settings(tc, width, height, port_tracer),
                states=states, outs=outs)


@pytest.fixture(scope="module")
def cornell():
    from hikari_tpu.io.scenes import cornell_config as j_cornell
    from hikari_tpu_torch.io.scenes import cornell_config as t_cornell

    scene, jcam, _ = j_cornell()
    return _world(compile_scene(scene), jcam, t_cornell(device="cpu")[1], 62, 48,
                  "bruteforce", "auto")


def _check_frame(w, frame):
    jo = w["outs"][frame]
    with torch.no_grad():
        to, tnext = t_render(w["tb"], w["tcam"], frame_state_from_numpy(w["states"][frame], "cpu"),
                             w["ts"])
    h, wd = w["ts"].output_size
    assert to.image.shape == (h, wd, 4) and bool(torch.isfinite(to.image).all())
    assert float(to.image[..., :3].mean()) > 0.0
    for name in ("image", "tonemapped", "albedo"):
        assert_image_close(getattr(to, name), getattr(jo, name), name)
    for name in ("direct", "emissive", "indirect"):
        assert_image_close(getattr(to, name), getattr(jo, name), name, share=0.99, mean=2e-3)
    for k, v in jo.stats.items():
        if np.isfinite(float(v)):
            np.testing.assert_allclose(float(to.stats[k]), float(v), rtol=2e-3, atol=1e-5,
                                       err_msg=k)
    jnext = w["states"][frame + 1]
    assert tnext.frame_number == frame + 1
    # G-buffer: ids equal; floats on >= 99.5% of the pixels (a grazing
    # primary hit's refined distance moves by FMA-level differences).
    got, want = tnext.prev_gbuffer, jnext.prev_gbuffer
    for f in ("instance", "material"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    for f in ("position", "normal", "depth_gradient", "velocity_uv"):
        assert_image_close(getattr(got, f), getattr(want, f), f)
    for f in ("prev_upscaled", "prev_taa", "prev_tonemapped"):
        assert_image_close(getattr(tnext, f), getattr(jnext, f), f)
    return to


@pytest.mark.parametrize("frame", [2, 3, 4])
def test_cornell_bench_frame_matches(cornell, frame):
    _check_frame(cornell, frame)
