"""Parity of the PyTorch port's frame path with ``hikari_tpu`` on
``cornell_path`` (the cornell config without the post chain): the
G-buffer, the albedo, each lighting pass from one shared mid-sequence
state, and three whole frames, each compared from the same input state
(``frame_state_from_numpy``). One scene compile feeds both packages; the
JAX side runs jitted on the CPU, the port runs its plain twin.

Size 48x63: non-square, so an h/w swap fails; the odd width keeps pixel
centers off the box's exact 45-degree quad diagonals, where a 1-ulp
difference (XLA's CPU compiler contracts multiply-adds into FMAs, torch
rounds every operation) decides hit or miss of a primary ray.

Image tolerance: within 1e-3 (relative above 1) on >= 99.5% of pixels
and mean |diff| <= 1e-4 — ReSTIR decisions are discrete, so a 1-ulp difference may flip a
reservoir at an edge pixel. G-buffer: ids equal, floats within 1e-5
(miss positions, 65535 units out along the ray, within 0.02)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu.config as jc
import hikari_tpu_torch.config as tc
from hikari_tpu.render import light as jlight
from hikari_tpu.render.gbuffer import render_gbuffer as j_gbuffer
from hikari_tpu.render.noise import blue_noise_bank
from hikari_tpu.render.pipeline import initial_state as j_init
from hikari_tpu.render.pipeline import render_frame_jit as j_render
from hikari_tpu.render.restir import decompress_reservoir as j_decompress
from hikari_tpu_torch.render import light as tlight
from hikari_tpu_torch.render.gbuffer import render_gbuffer as t_gbuffer
from hikari_tpu_torch.render.pipeline import noise_bank_on
from hikari_tpu_torch.render.pipeline import render_frame as t_render
from hikari_tpu_torch.render.restir import decompress_reservoir as t_decompress
from hikari_tpu_torch.render.types import GBuffer
from hikari_tpu_torch.scene.buffers import frame_state_from_numpy
from hikari_tpu_torch.utils import map_tensors

torch.set_num_threads(2)

H, W = 48, 63
PATH = dict(
    width=W, height=H, denoise=False, indirect_spatial_reuse=False, emissive_lit=True,
    indirect_bounces=1, reservoir_f16=True, reproject="shift", remat=False, collect_stats=True,
)


def _settings(mod, **kw):
    return mod.RenderSettings(
        upscale=mod.Upscale.none(), taa=mod.Taa.NONE, clear_color=(0.0, 0.0, 0.0, 1.0),
        **{**PATH, **kw},
    )


@pytest.fixture(scope="module")
def world():
    from hikari_tpu.io.scenes import cornell_config as j_cornell
    from hikari_tpu.scene.compile import compile_scene
    from hikari_tpu.scene.buffers import to_device as j_dev
    from hikari_tpu_torch.io.scenes import cornell_config as t_cornell
    from hikari_tpu_torch.scene.buffers import to_device as t_dev

    scene, jcam, _ = j_cornell()
    arrays = compile_scene(scene)
    return dict(jb=j_dev(arrays), tb=t_dev(arrays, "cpu"), jcam=jcam, tcam=t_cornell(device="cpu")[1],
                js=_settings(jc), ts=_settings(tc))


@pytest.fixture(scope="module")
def jax_states(world):
    """JAX frame states after 0..5 frames (the port's frames start from
    these through ``frame_state_from_numpy``)."""
    states = [j_init(world["js"])]
    for _ in range(5):
        states.append(j_render(world["jb"], world["jcam"], states[-1], world["js"])[1])
    return states


@pytest.fixture(scope="module")
def jax_gbuffer(world):
    """The JAX G-buffer of ``world`` at a frame, compiled and run once per
    frame however many tests ask for it."""
    cache = {}

    def get(frame):
        if frame not in cache:
            cache[frame] = jax.jit(
                lambda b: j_gbuffer(b, world["jcam"], jnp.int32(frame), world["js"])
            )(world["jb"])
        return cache[frame]

    return get


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_image_close(got, want, name, share=0.995, mean=1e-4):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, name
    d = np.abs(got - want) / np.maximum(1.0, np.abs(want))  # relative above 1
    per_px = d.reshape(d.shape[0], d.shape[1], -1).max(-1)
    assert (per_px <= 1e-3).mean() >= share, (name, (per_px > 1e-3).sum())
    assert d.mean() <= mean, (name, d.mean())


def assert_gbuffer_close(got: GBuffer, want, name=""):
    for f in ("instance", "material"):
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)), err_msg=f)
    pos, wpos = _np(got.position), _np(want.position)
    hit = _np(want.instance) >= 0
    np.testing.assert_allclose(pos[hit], wpos[hit], rtol=1e-6, atol=1e-5)
    # Misses sit at origin + 65535 * direction: one ulp of the direction
    # moves them by ~0.008.
    np.testing.assert_allclose(pos[~hit], wpos[~hit], atol=0.02)
    for f in ("normal", "depth_gradient", "velocity_uv"):
        np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(want, f)), atol=1e-5, err_msg=f)


def _gbuffer_from_jax(gb):
    return GBuffer(**{f.name: torch.from_numpy(np.array(getattr(gb, f.name)))
                      for f in dataclasses.fields(GBuffer)})


@pytest.mark.parametrize("jitter", [False, True])
def test_render_gbuffer_matches(world, jax_gbuffer, jitter):
    """``jitter``: TAA on moves the primary rays by the frame's Halton
    point (frame 3); the G-buffer itself does not depend on TAA."""
    kw = dict(taa=jc.Taa.JASMINE) if jitter else {}
    js = world["js"].replace(**kw)
    ts = world["ts"].replace(**({"taa": tc.Taa.JASMINE} if jitter else {}))
    frame = 3 if jitter else 0
    if jitter:
        want = jax.jit(lambda b: j_gbuffer(b, world["jcam"], jnp.int32(frame), js))(world["jb"])
    else:
        want = jax_gbuffer(frame)
    got = t_gbuffer(world["tb"], world["tcam"], frame, ts)
    assert got.position.shape == (H, W, 4)
    assert_gbuffer_close(got, want)
    # A static scene under a static camera has exactly zero velocity.
    assert float(got.velocity_uv[..., :2].abs().max()) == 0.0
    assert (got.instance >= 0).any() and (got.instance < 0).any()


def test_render_gbuffer_is_thread_count_independent(world):
    """The port's G-buffer is bit for bit the same under 1 and 4 intra-op
    threads (the miss positions included: origin + direction * 65535,
    the direction from elementwise ops)."""
    threads = torch.get_num_threads()
    try:
        got = {}
        for n in (1, 4):
            torch.set_num_threads(n)
            got[n] = t_gbuffer(world["tb"], world["tcam"], 0, world["ts"])
    finally:
        torch.set_num_threads(threads)
    for f in dataclasses.fields(GBuffer):
        assert torch.equal(getattr(got[1], f.name), getattr(got[4], f.name)), f.name


def test_full_screen_albedo_matches(world, jax_gbuffer):
    gb = jax_gbuffer(0)
    want = jax.jit(lambda b: jlight.full_screen_albedo(b, world["jcam"], gb))(world["jb"])
    got = tlight.full_screen_albedo(world["tb"], world["tcam"], _gbuffer_from_jax(gb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _pass_inputs(jax_gbuffer, state):
    """One shared input for both packages: the JAX G-buffer and
    reservoirs of ``state`` (decompressed), converted for the port."""
    frame = int(state.frame_number)
    gb = jax_gbuffer(frame)
    tstate = frame_state_from_numpy(state, "cpu")
    return frame, gb, _gbuffer_from_jax(gb), state, tstate


def _compare_pass(jout, tout, name):
    out, var, temporal, spatial, bg, _ = tout
    assert_image_close(out, jout[0], f"{name} radiance")
    assert_image_close(var[..., None], np.asarray(jout[1])[..., None], f"{name} variance")
    np.testing.assert_array_equal(bg.numpy(), np.asarray(jout[4]))
    # Reservoir internals: >= 99% of pixels. A reset reservoir keeps
    # random = 0, so its next light sample aims exactly at a vertex of the
    # light's triangle, where a 1-ulp difference decides hit or miss of the
    # target ray; such pixels carry w = 0 and do not reach the radiance.
    for label, t_res, j_res in (("temporal", temporal, jout[2]), ("spatial", spatial, jout[3])):
        for f in ("count", "w", "w_sum"):
            assert_image_close(getattr(t_res, f)[..., None], np.asarray(getattr(j_res, f))[..., None],
                               f"{name} {label}.{f}", share=0.99, mean=5e-3)
        assert_image_close(t_res.s.radiance, j_res.s.radiance, f"{name} {label}.radiance",
                           share=0.99, mean=5e-3)


@pytest.mark.parametrize(
    "emissive_lit,frame",
    [(False, 3), (False, 4), (True, 5), (True, 4)],
    ids=["sun-validation", "sun-sampling", "emissive-validation", "emissive-sampling"],
)
def test_direct_lit_pass_matches(world, jax_states, jax_gbuffer, emissive_lit, frame):
    """Both variants of ``direct_lit_pass`` on a validation frame
    (frame % interval == 0) and a sampling frame, from one shared state."""
    frame, jgb, tgb, state, tstate = _pass_inputs(jax_gbuffer, jax_states[frame])
    key = "emissive_temporal" if emissive_lit else "direct_temporal"
    js, ts = world["js"], world["ts"]
    bank = jnp.asarray(blue_noise_bank())

    def jpass(b, temporal, spatial):
        return jlight.direct_lit_pass(
            b, world["jcam"], jgb, temporal, spatial, bank, jnp.int32(frame), js,
            emissive_lit=emissive_lit, render_emissive=not emissive_lit,
        )

    jout = jax.jit(jpass)(world["jb"], j_decompress(getattr(state, key)), j_decompress(state.de_spatial))
    tout = tlight.direct_lit_pass(
        world["tb"], world["tcam"], tgb, t_decompress(getattr(tstate, key)),
        t_decompress(tstate.de_spatial), noise_bank_on("cpu"), frame, ts,
        emissive_lit=emissive_lit, render_emissive=not emissive_lit,
    )
    assert float(tout[0].abs().max()) > 0.0
    _compare_pass(jout, tout, "emissive" if emissive_lit else "sun")


def test_indirect_lit_pass_matches(world, jax_states, jax_gbuffer):
    frame, jgb, tgb, state, tstate = _pass_inputs(jax_gbuffer, jax_states[4])
    bank = jnp.asarray(blue_noise_bank())

    def jpass(b, temporal, spatial):
        return jlight.indirect_lit_pass(
            b, world["jcam"], jgb, temporal, spatial, bank, jnp.int32(frame), world["js"],
        )

    jout = jax.jit(jpass)(world["jb"], j_decompress(state.indirect_temporal),
                          j_decompress(state.indirect_spatial))
    tout = tlight.indirect_lit_pass(
        world["tb"], world["tcam"], tgb, t_decompress(tstate.indirect_temporal),
        t_decompress(tstate.indirect_spatial), noise_bank_on("cpu"), frame, world["ts"],
    )
    assert float(tout[0].abs().max()) > 0.0
    _compare_pass(jout, tout, "indirect")


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_render_frame_matches(world, jax_states, frame):
    """Three frames of ``cornell_path``, each from the JAX state it starts
    from: outputs, stats and the next (f16-packed) state agree."""
    state = jax_states[frame]
    jo, jnext = j_render(world["jb"], world["jcam"], state, world["js"])
    with torch.no_grad():
        to, tnext = t_render(world["tb"], world["tcam"], frame_state_from_numpy(state, "cpu"), world["ts"])
    assert to.image.shape == (H, W, 4) and bool(torch.isfinite(to.image).all())
    for name in ("image", "tonemapped", "albedo", "direct", "emissive", "indirect"):
        assert_image_close(getattr(to, name), getattr(jo, name), name)
    for k, v in jo.stats.items():
        np.testing.assert_allclose(float(to.stats[k]), float(v), rtol=2e-3, atol=1e-5, err_msg=k)
    assert tnext.frame_number == int(jnext.frame_number) == frame + 1
    assert_gbuffer_close(tnext.prev_gbuffer, jnext.prev_gbuffer)
    want, got = jnext.direct_temporal, tnext.direct_temporal
    for f in ("count", "lifetime", "w_sum"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype == np.float16, f
        assert_image_close(b[..., None], a[..., None], f)


@pytest.mark.parametrize(
    "override",
    [
        dict(denoise=True),
        dict(upscale=tc.Upscale.smaa_tu4x(2.0)),
        dict(upscale=tc.Upscale.fsr1(1.5)),
        dict(taa=tc.Taa.JASMINE),
        dict(indirect_spatial_reuse=True),
        dict(emissive_spatial_reuse=True),
        dict(hdr=True),
        dict(bloom=True),
        dict(fxaa=True),
        dict(stop_after="gbuffer"),
    ],
    ids=["denoise", "upscale-smaa", "upscale-fsr", "taa-jasmine", "indirect_spatial_reuse",
         "emissive_spatial_reuse", "hdr", "bloom", "fxaa", "stop_after"],
)
def test_render_frame_rejects_unported(world, override):
    """Every setting of the JAX package renders now: each case renders a
    finite frame of the output size its chain gives (SMAA TU4x doubles the
    render size, FSR1 at 1.5 upscales 32x42 to the output size, a
    ``stop_after`` cut gives (4, 4, 4)), or raises the JAX package's own
    failure: bloom at this odd width (hikari_tpu/render/bloom.py:28-31)."""
    from hikari_tpu_torch.render.pipeline import initial_state

    settings = world["ts"].replace(**override)
    if settings.bloom:
        with pytest.raises(ValueError, match="bloom.py:28-31"):
            t_render(world["tb"], world["tcam"], initial_state(settings, "cpu"), settings)
        return
    with torch.no_grad():
        out, nxt = t_render(world["tb"], world["tcam"], initial_state(settings, "cpu"), settings)
    rh, rw = settings.render_size
    if settings.stop_after is not None:
        want = (4, 4, 4)
    elif settings.upscale.mode == tc.UpscaleMode.SMAA_TU4X:
        want = (2 * rh, 2 * rw, 4)
    else:
        want = (H, W, 4)
    assert out.image.shape == want
    assert bool(torch.isfinite(out.image).all())
    assert nxt.frame_number == 1


def test_state_roundtrip_keeps_device():
    """``map_tensors`` moves a whole frame state and keeps host ints."""
    from hikari_tpu_torch.render.pipeline import initial_state

    st = initial_state(_settings(tc), "cpu")
    moved = map_tensors(lambda x: x.to(torch.float64) if x.is_floating_point() else x, st)
    assert moved.frame_number == 0
    assert moved.prev_gbuffer.position.dtype == torch.float64
    assert moved.direct_temporal.s.visible_instance.dtype == torch.int32


@pytest.mark.parametrize(
    "entry",
    ["initial_state", "build_scene_buffers", "to_device", "frame_state_from_numpy",
     "cornell_config", "city_config", "camera"],
)
def test_entry_points_default_to_card(world, jax_states, entry):
    """The port's entry points run on the CUDA card unless the caller asks
    for another device: without a card, a call that names no device
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default is valid here")
    from hikari_tpu.io.scenes import cornell_box_scene
    from hikari_tpu.scene.compile import compile_scene
    from hikari_tpu_torch.io import scenes
    from hikari_tpu_torch.render.camera import Camera
    from hikari_tpu_torch.render.pipeline import initial_state
    from hikari_tpu_torch.scene.buffers import build_scene_buffers, to_device

    calls = {
        "initial_state": lambda: initial_state(world["ts"]),
        "build_scene_buffers": lambda: build_scene_buffers(scenes.cornell_box_scene()),
        "to_device": lambda: to_device(compile_scene(cornell_box_scene())),
        "frame_state_from_numpy": lambda: frame_state_from_numpy(jax_states[0]),
        "cornell_config": lambda: scenes.cornell_config(),
        "city_config": lambda: scenes.city_config(),
        "camera": lambda: Camera.from_lookat(eye=(0.0, 1.0, 4.0), target=(0.0, 1.0, 0.0)),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
