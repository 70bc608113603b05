"""Parity of the port's output options with ``hikari_tpu``: FSR1 (``easu``,
``rcas``, ``fsr_upscale``), ``bloom``, ``fxaa`` and
``inverse_reinhard_luminance``, forward and VJP, on seeded images (an odd
width included); the three fractional-ratio deferred fetches at ratio 1.5
(light, denoise, the pipeline's albedo); one 48x64 cornell frame with FSR1
at 1.5, HDR, bloom and FXAA (TAA off) against ``render_frame_jit`` at
frames 2-3; and the JAX package's failures that the port mirrors (FSR1
under TAA Jasmine, SMAA TU4x at a fractional ratio, bloom on an odd mip),
raised in both packages.

Tolerances: the image functions within 2e-5 absolute forward and their
VJPs within 1e-4 relative (+1e-5 absolute), against the JAX functions run
op by op (jitted, XLA fuses multiply-adds, which moves EASU's cancelling
weights past these bounds and can flip FXAA's edge gates). The fetches are
gathers: equal. The frame: ``assert_image_close`` of
test_torch_pipeline.py (within 1e-3, relative above 1, on >= 99.5% of the
pixels, mean |diff| <= 1e-4).

Bloom needs an even width, and at an even width pixel centres of the
cornell camera fall on the box quads' exact diagonals (the exact-boundary
hazard of test_torch_pipeline.py), which spatial reuse and the denoiser
spread: 0.5986 of the image's pixels within 1e-3. Both packages' cameras
move 0.0137 to the side: 0.9987 (``texel_edge_gap``, without bloom).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu.config as jc
import hikari_tpu.render.bloom as jbloom  # imported outside any jit (its _GAUSS is built at import)
import hikari_tpu_torch.config as tc
from hikari_tpu.render import fsr as jfsr
from hikari_tpu.render import fxaa as jfxaa
from hikari_tpu.render import tonemap as jtone
from hikari_tpu_torch.render import bloom as tbloom
from hikari_tpu_torch.render import fsr as tfsr
from hikari_tpu_torch.render import fxaa as tfxaa
from hikari_tpu_torch.render import tonemap as ttone
from hikari_tpu_torch.render.types import GBuffer
from test_torch_pipeline import assert_image_close

torch.set_num_threads(2)

IMAGE_FUNCTIONS = {
    # name: (jax fn, port fn, input shape, value range)
    "easu": (lambda x: jfsr.easu(x, (19, 28)), lambda x: tfsr.easu(x, (19, 28)), (13, 19, 4), 1.0),
    "rcas": (lambda x: jfsr.rcas(x, 0.2), lambda x: tfsr.rcas(x, 0.2), (13, 19, 4), 1.0),
    "fsr_upscale": (lambda x: jfsr.fsr_upscale(x, (19, 28), 0.0),
                    lambda x: tfsr.fsr_upscale(x, (19, 28), 0.0), (13, 19, 4), 1.0),
    "bloom": (lambda x: jbloom.bloom(x, 1.0, 0.15), lambda x: tbloom.bloom(x, 1.0, 0.15),
              (32, 48, 4), 3.0),
    "fxaa": (jfxaa.fxaa, tfxaa.fxaa, (13, 19, 4), 1.0),
    "inverse_reinhard": (jtone.inverse_reinhard_luminance, ttone.inverse_reinhard_luminance,
                         (13, 19, 3), 1.0),
}


@pytest.mark.parametrize("name", list(IMAGE_FUNCTIONS))
def test_image_function_and_vjp_match_jax(name):
    jfn, tfn, shape, scale = IMAGE_FUNCTIONS[name]
    rng = np.random.default_rng(7)
    x = (rng.random(shape) * scale).astype(np.float32)
    if name == "fxaa":  # hard edges for the edge gate
        x[:, 9:] = x[:, 9:] * 0.1
    # Op by op, as the port rounds; bloom's only gate is the threshold, so
    # it is jitted (op by op it takes ~17 s on the CPU).
    def vjp_fn(a, c):
        out, pull = jax.vjp(jfn, a)
        return out, pull(c)

    if name == "bloom":
        vjp_fn = jax.jit(vjp_fn)
    ct = rng.standard_normal(jax.eval_shape(jfn, jnp.asarray(x)).shape).astype(np.float32)
    want, (want_g,) = vjp_fn(jnp.asarray(x), jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(xt)
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(ct))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=0)
    want_g = np.asarray(want_g)
    finite = np.isfinite(want_g)
    assert bool(torch.isfinite(got_g).all())
    # EASU's VJP is NaN in the JAX package where both taps of a gradient
    # guard clamp to one texel (max(|a|, |b|, 1e-20) with a = b = 0: the
    # JVP of jnp.maximum multiplies the 1/m^2 = inf cotangent by 0); the
    # port's clamp passes 0 there. Elsewhere the two agree.
    assert finite.all() or name in ("easu", "fsr_upscale"), name
    assert finite.mean() > 0.75, finite.mean()
    np.testing.assert_allclose(got_g.numpy()[finite], want_g[finite], rtol=1e-4, atol=1e-5)


def _gbuffer(rng, h, w):
    pos = rng.standard_normal((h, w, 4)).astype(np.float32)
    return dict(
        position=pos,
        normal=rng.standard_normal((h, w, 3)).astype(np.float32),
        depth_gradient=rng.standard_normal((h, w, 2)).astype(np.float32),
        instance=rng.integers(-1, 5, (h, w)).astype(np.int32),
        material=rng.integers(-1, 3, (h, w)).astype(np.int32),
        velocity_uv=rng.standard_normal((h, w, 4)).astype(np.float32),
    )


@pytest.mark.parametrize("frame", [2, 3])
def test_fractional_fetches_match_jax(frame):
    """Ratio 1.5 (24x33 output, 16x22 render): the light passes' G-buffer
    gather, the denoiser's deferred planes and the albedo at render res."""
    from hikari_tpu.render import denoise as jdenoise
    from hikari_tpu.render import light as jlight
    from hikari_tpu.render import pipeline as jpipe
    from hikari_tpu.render.types import GBuffer as JGBuffer
    from hikari_tpu_torch.render import denoise as tdenoise
    from hikari_tpu_torch.render import light as tlight
    from hikari_tpu_torch.render import pipeline as tpipe

    rng = np.random.default_rng(frame)
    h, w = 24, 33
    arrays = _gbuffer(rng, h, w)
    jgb = JGBuffer(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tgb = GBuffer(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    js = jc.RenderSettings(width=w, height=h, upscale=jc.Upscale.fsr1(1.5), taa=jc.Taa.NONE)
    ts = tc.RenderSettings(width=w, height=h, upscale=tc.Upscale.fsr1(1.5), taa=tc.Taa.NONE)
    assert ts.render_size == js.render_size == (16, 22)

    want = jlight.fetch_gbuffer_deferred(jgb, jnp.int32(frame), js)
    got = tlight.fetch_gbuffer_deferred(tgb, frame, ts)
    for k in arrays:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), k)

    depth, normal, grad, inst = jdenoise._deferred_maps(jgb, js, jnp.int32(frame))
    pos, tnormal, tgrad, tinst = tdenoise.deferred_planes(
        (tgb.position, tgb.normal, tgb.depth_gradient, tgb.instance.to(torch.float32)), ts, frame)
    for a, b in ((pos[..., 3], depth), (tnormal, normal), (tgrad, grad), (tinst, inst)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    albedo = rng.random((h, w, 3)).astype(np.float32)
    want_a = jpipe._albedo_at_render_res(jnp.asarray(albedo), jgb, js, jnp.int32(frame))
    got_a = tpipe._albedo_at_render_res(torch.from_numpy(albedo), ts, frame)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


OUT_H, OUT_W = 48, 64
EYE_X = 0.0137


def _output_settings(mod):
    return mod.RenderSettings(
        width=OUT_W, height=OUT_H, upscale=mod.Upscale.fsr1(1.5), taa=mod.Taa.NONE,
        denoise=True, indirect_bounces=1, indirect_spatial_reuse=True, emissive_lit=True,
        reservoir_f16=True, reproject="shift", remat=False, hdr=True, bloom=True, fxaa=True,
        clear_color=(0.0, 0.0, 0.0, 1.0), collect_stats=True,
    )


def test_output_frame_matches_jax():
    """The cornell frame with FSR1 at 1.5 (render 32x42), HDR, bloom and
    FXAA from the JAX package's states at frames 2 and 3."""
    from hikari_tpu.io.scenes import cornell_config as j_cornell
    from hikari_tpu.render.pipeline import initial_state as j_init
    from hikari_tpu.render.pipeline import render_frame_jit as j_render
    from hikari_tpu.scene.buffers import to_device as j_dev
    from hikari_tpu.scene.compile import compile_scene
    from hikari_tpu_torch.render.pipeline import render_frame as t_render
    from hikari_tpu_torch.scene.buffers import frame_state_from_numpy, to_device as t_dev

    from hikari_tpu.render.camera import Camera as JCamera
    from hikari_tpu_torch.render.camera import Camera as TCamera

    scene, _, _ = j_cornell()
    arrays = compile_scene(scene)
    jb, tb = j_dev(arrays), t_dev(arrays, "cpu")
    eye, target = (EYE_X, 1.0, 4.0), (EYE_X, 1.0, 0.0)
    jcam = JCamera.from_lookat(eye=eye, target=target)
    tcam = TCamera.from_lookat(eye=eye, target=target, device="cpu")
    js, ts = _output_settings(jc), _output_settings(tc)
    state = j_init(js)
    for frame in range(4):
        jout, jnext = j_render(jb, jcam, state, js)
        if frame >= 2:
            with torch.no_grad():
                tout, tnext = t_render(tb, tcam, frame_state_from_numpy(state, "cpu"), ts)
            assert tout.image.shape == (OUT_H, OUT_W, 4)
            assert bool(torch.isfinite(tout.image).all())
            assert int(tout.stats["nonfinite_pixels"]) == int(jout.stats["nonfinite_pixels"]) == 0
            for name in ("image", "tonemapped", "albedo"):
                assert_image_close(getattr(tout, name), getattr(jout, name), f"{name} frame {frame}")
            assert tnext.frame_number == frame + 1
        state = jnext


def test_mirrored_jax_failures():
    """Where the JAX package fails, both packages raise: FSR1 under TAA
    Jasmine (taa.py:402), SMAA TU4x at a fractional ratio (smaa.py:162),
    bloom on a mip with an odd side (bloom.py:28-31)."""
    from hikari_tpu.render import smaa as jsmaa
    from hikari_tpu.render import taa as jtaa
    from hikari_tpu.render.types import GBuffer as JGBuffer
    from hikari_tpu_torch.io.scenes import cornell_config as t_cornell
    from hikari_tpu_torch.render.pipeline import initial_state, render_frame
    from hikari_tpu_torch.scene import build_scene_buffers

    rng = np.random.default_rng(0)
    # Output 24x33 at 1.5: render 16x22.
    jgb = JGBuffer(**{k: jnp.asarray(v) for k, v in _gbuffer(rng, 24, 33).items()})
    cur = jnp.asarray(rng.random((16, 22, 4)).astype(np.float32))
    # Traced, not run: each fails at trace time.
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.jit(lambda c, g: jtaa.taa_jasmine(c, c, g, g, (0.0, 0.0, 0.0, 1.0), 1.5))(cur, jgb)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.jit(lambda c, g: jsmaa.smaa_tu4x(c, jnp.zeros((32, 44, 4)), g, g, 0))(cur, jgb)
    odd = rng.random((32, 50, 4)).astype(np.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.jit(jbloom.bloom)(jnp.asarray(odd))
    with pytest.raises(ValueError, match="bloom.py:28-31"):
        tbloom.bloom(torch.from_numpy(odd))

    scene, cam, base = t_cornell(device="cpu")
    buffers = build_scene_buffers(scene, "cpu")
    base = base.replace(width=33, height=24, indirect_bounces=0, emissive_lit=False)
    cases = [
        (base.replace(upscale=tc.Upscale.fsr1(1.5), taa=tc.Taa.JASMINE), "taa.py:402"),
        (base.replace(upscale=tc.Upscale.smaa_tu4x(1.5)), "smaa.py:162"),
        (base.replace(width=50, height=32, bloom=True), "bloom.py:28-31"),
    ]
    for settings, where in cases:
        with torch.no_grad(), pytest.raises(ValueError, match=where):
            render_frame(buffers, cam, initial_state(settings, "cpu"), settings)


def texel_edge_gap():
    """Not a test: the share of the pixels within 1e-3 of the JAX frame at
    frame 2 for the FSR1 cornell frame without bloom at 48x64 on the
    cornell camera and 0.0137 to the side, and at 48x63 on it, where both
    axes are exactly 1.5 (the denoiser's deferred uv, (y + 0.5) * 1.5 +-
    0.25, lands on texel edges); and the NaN entries of JAX's EASU VJP
    (``PYTHONPATH=. python tests/test_torch_output.py``, ~3 min on the
    CPU)."""
    from hikari_tpu.io.scenes import cornell_config as j_cornell
    from hikari_tpu.render.camera import Camera as JCamera
    from hikari_tpu.render.pipeline import initial_state as j_init
    from hikari_tpu.render.pipeline import render_frame_jit as j_render
    from hikari_tpu.scene.buffers import to_device as j_dev
    from hikari_tpu.scene.compile import compile_scene
    from hikari_tpu_torch.render.camera import Camera as TCamera
    from hikari_tpu_torch.render.pipeline import render_frame as t_render
    from hikari_tpu_torch.scene.buffers import frame_state_from_numpy, to_device as t_dev

    x = jnp.asarray(np.random.default_rng(7).random((13, 19, 4)).astype(np.float32))
    g = np.asarray(jax.grad(lambda a: jnp.sum(jfsr.easu(a, (19, 28))))(x))
    print(f"JAX EASU VJP: {np.isnan(g).sum()} of {g.size} entries NaN")
    arrays = compile_scene(j_cornell()[0])
    jb, tb = j_dev(arrays), t_dev(arrays, "cpu")
    for w, eye_x in ((64, 0.0), (64, EYE_X), (63, 0.0)):
        settings = {m: _output_settings(m).replace(width=w, bloom=False) for m in (jc, tc)}
        eye, target = (eye_x, 1.0, 4.0), (eye_x, 1.0, 0.0)
        jcam = JCamera.from_lookat(eye=eye, target=target)
        tcam = TCamera.from_lookat(eye=eye, target=target, device="cpu")
        state = j_init(settings[jc])
        for _ in range(2):
            state = j_render(jb, jcam, state, settings[jc])[1]
        jout = j_render(jb, jcam, state, settings[jc])[0]
        with torch.no_grad():
            tout = t_render(tb, tcam, frame_state_from_numpy(state, "cpu"), settings[tc])[0]
        for name in ("image", "emissive", "indirect", "albedo"):
            a = getattr(tout, name).numpy().astype(np.float64)
            b = np.asarray(getattr(jout, name), np.float64)
            d = (np.abs(a - b) / np.maximum(1.0, np.abs(b))).reshape(a.shape[0], a.shape[1], -1)
            print(f"48x{w}, camera x {eye_x}: {name} {(d.max(-1) <= 1e-3).mean():.4f} of the "
                  f"pixels within 1e-3")


if __name__ == "__main__":
    import conftest  # noqa: F401  (the CPU backend)

    texel_edge_gap()
