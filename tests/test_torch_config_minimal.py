"""Parity of whole frames of the ``minimal`` config (plane, cube, sun; 2
indirect bounces) with ``hikari_tpu``: two frames at 48x63 without the post
chain (no upscale, TAA or denoise; the config's lighting settings kept),
each from the JAX state it starts from. One scene compile feeds both
packages. ``simple`` and ``scene`` use the same check, each in its own
file (the JAX frame compile takes most of a file's time).

Tolerances: ``test_torch_pipeline.assert_image_close`` on every output
image (within 1e-3, relative above 1, on >= 99.5% of pixels, mean
|diff| <= 1e-4; ReSTIR decisions are discrete); where the config turns
spatial reuse on (``simple``, ``scene``), the lighting channels, which
carry its discrete reservoir decisions, within 1e-3 on >= 99% of pixels
with mean <= 2e-3, as in ``test_torch_bench_frames.py``; stats within
2e-3 relative; the next G-buffer's ids equal, depth gradients and
velocities within 1e-5, normals within 1e-4 (``simple``'s spheres
interpolate vertex normals, where XLA's FMAs move a few by 2e-5), hit
positions within 1e-5 relative + 1e-5 (the ``simple`` camera stands 22
units from its scene, 5x cornell's distance), misses within 0.02.

``scene`` renders at 48x62: its camera looks along x = z, so at an odd
width the center pixel column runs along the edge where the right wall
ends, and a 1-ulp difference decides the refined hit there (ROADMAP.md
section 3, as for the city camera)."""

import numpy as np
import pytest
import torch

import hikari_tpu.config as jc
import hikari_tpu_torch.config as tc

torch.set_num_threads(2)

H, W = 48, 63


def config_world(name, h=H, w=W, **overrides):
    """Both packages' config at h x w without the post chain (and with
    ``overrides``), the JAX states after 0 and 1 frames and the JAX
    outputs of frames 0 and 1."""
    from hikari_tpu.io import scenes as jscenes
    from hikari_tpu.render.pipeline import initial_state, render_frame_jit
    from hikari_tpu.scene.buffers import to_device as jax_to_device
    from hikari_tpu.scene.compile import compile_scene
    from hikari_tpu_torch.io import scenes as tscenes
    from hikari_tpu_torch.scene.buffers import to_device as torch_to_device

    jscene, jcam, js = jscenes.CONFIGS[name](w, h)
    _, tcam, ts = tscenes.CONFIGS[name](w, h, device="cpu")
    post = dict(denoise=False, collect_stats=True, remat=False, **overrides)
    js = js.replace(upscale=jc.Upscale.none(), taa=jc.Taa.NONE, **post)
    ts = ts.replace(upscale=tc.Upscale.none(), taa=tc.Taa.NONE, **post)
    arrays = compile_scene(jscene)
    jb, tb = jax_to_device(arrays), torch_to_device(arrays, "cpu")
    states, outs = [initial_state(js)], []
    for _ in range(2):
        out, nxt = render_frame_jit(jb, jcam, states[-1], js)
        outs.append(out)
        states.append(nxt)
    return dict(tb=tb, tcam=tcam, ts=ts, states=states, outs=outs)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_gbuffer_close(got, want):
    for f in ("instance", "material"):
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)), err_msg=f)
    pos, wpos = _np(got.position), _np(want.position)
    hit = _np(want.instance) >= 0
    np.testing.assert_allclose(pos[hit], wpos[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pos[~hit], wpos[~hit], atol=0.02)
    np.testing.assert_allclose(_np(got.normal), _np(want.normal), atol=1e-4)
    for f in ("depth_gradient", "velocity_uv"):
        np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(want, f)), atol=1e-5, err_msg=f)


def check_frame(world, frame):
    from hikari_tpu_torch.render.pipeline import render_frame
    from hikari_tpu_torch.scene.buffers import frame_state_from_numpy
    from test_torch_pipeline import assert_image_close

    jo, ts = world["outs"][frame], world["ts"]
    with torch.no_grad():
        to, tnext = render_frame(world["tb"], world["tcam"],
                                 frame_state_from_numpy(world["states"][frame], "cpu"), ts)
    assert to.image.shape == (ts.height, ts.width, 4) and bool(torch.isfinite(to.image).all())
    assert float(to.image[..., :3].mean()) > 0.0
    spatial = ts.indirect_spatial_reuse or ts.emissive_spatial_reuse
    for name in ("image", "tonemapped", "albedo"):
        assert_image_close(getattr(to, name), getattr(jo, name), name)
    for name in ("direct", "emissive", "indirect"):
        loose = dict(share=0.99, mean=2e-3) if spatial else {}
        assert_image_close(getattr(to, name), getattr(jo, name), name, **loose)
    for k, v in jo.stats.items():
        np.testing.assert_allclose(float(to.stats[k]), float(v), rtol=2e-3, atol=1e-5, err_msg=k)
    assert_gbuffer_close(tnext.prev_gbuffer, world["states"][frame + 1].prev_gbuffer)


@pytest.fixture(scope="module")
def world():
    return config_world("minimal")


@pytest.mark.parametrize("frame", [0, 1])
def test_minimal_frame_matches(world, frame):
    assert world["ts"].indirect_bounces == 2
    check_frame(world, frame)
