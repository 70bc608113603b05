"""Parity of the port's post chain with ``hikari_tpu`` function by function:
the sampling helpers of ``render/filters.py``, ``spatial_reuse_pass`` (both
``emissive_lit`` values, the ``"rolls"`` taps and the per-pixel spiral),
``denoise_channel``, ``smaa_tu4x`` and ``taa_jasmine``, each over two
frames: an even frame at zero velocity and an odd frame with a seeded
velocity field of up to ±3 texels.

Inputs are shared: the JAX package's G-buffers of the cornell box at
32x48 output (render 16x24, SMAA TU4x at 2x), seeded numpy reservoirs
built on those surfaces, colours and variances. The JAX functions run
jitted on the CPU with their default transport choice ("adaptive": the
zero-velocity shift accessor or the packed gather), the port with its one
gather transport.

Tolerances (``assert_image_close`` of test_torch_pipeline.py): within
1e-3 (relative above 1) on >= 99.5% of the pixels and mean |diff| <= 1e-4
— XLA's CPU compiler contracts multiply-adds into FMAs and evaluates its
own transcendentals, so a reservoir choice or a disocclusion test may flip
at a few pixels. The filters are exact, the YCoCg and AABB-clip helpers
within 1e-6 relative; reservoir internals of the spatial pass hold on >= 99%
of the pixels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu.config as jc
import hikari_tpu_torch.config as tc
from hikari_tpu.render import denoise as jdenoise
from hikari_tpu.render import filters as jfilters
from hikari_tpu.render import smaa as jsmaa
from hikari_tpu.render import spatial as jspatial
from hikari_tpu.render import taa as jtaa
from hikari_tpu.render.gbuffer import render_gbuffer as j_gbuffer
from hikari_tpu.render.restir import Reservoir as JRes
from hikari_tpu.render.restir import Sample as JSample
from hikari_tpu_torch.render import denoise as tdenoise
from hikari_tpu_torch.render import filters as tfilters
from hikari_tpu_torch.render import smaa as tsmaa
from hikari_tpu_torch.render import spatial as tspatial
from hikari_tpu_torch.render import taa as ttaa
from hikari_tpu_torch.render.restir import Reservoir as TRes
from hikari_tpu_torch.render.restir import Sample as TSample
from hikari_tpu_torch.render.types import GBuffer
from test_torch_pipeline import assert_image_close

torch.set_num_threads(2)

H, W = 32, 48  # output; render 16x24
FRAMES = [(4, False), (5, True)]  # (frame number, moving)
FRAME_IDS = ["even-static", "odd-moving"]


def _settings(mod, **kw):
    return mod.RenderSettings(
        width=W, height=H, upscale=mod.Upscale.smaa_tu4x(2.0), taa=mod.Taa.JASMINE, denoise=True,
        indirect_bounces=1, reservoir_f16=True, remat=False, **kw,
    )


@pytest.fixture(scope="module")
def world():
    from hikari_tpu.io.scenes import cornell_config as j_cornell
    from hikari_tpu.scene.buffers import to_device as j_dev
    from hikari_tpu.scene.compile import compile_scene
    from hikari_tpu_torch.io.scenes import cornell_config as t_cornell
    from hikari_tpu_torch.scene.buffers import to_device as t_dev

    scene, jcam, _ = j_cornell()
    arrays = compile_scene(scene)
    jb = j_dev(arrays)
    js = _settings(jc)
    gb = jax.jit(lambda f: j_gbuffer(jb, jcam, f, js))
    gbuffers = {f: jax.tree_util.tree_map(np.asarray, gb(jnp.int32(f))) for f in (3, 4, 5)}
    return dict(jb=jb, tb=t_dev(arrays, "cpu"), jcam=jcam, tcam=t_cornell(device="cpu")[1],
                js=js, ts=_settings(tc), gbuffers=gbuffers)


def _gbuffers(world, frame, moving):
    """(current, previous) G-buffers as numpy dicts; a moving frame gets a
    seeded velocity field of up to ±3 output texels."""
    cur = dataclasses.asdict(world["gbuffers"][frame])
    prev = dataclasses.asdict(world["gbuffers"][frame - 1])
    if moving:
        rng = np.random.default_rng(frame)
        vel = rng.integers(-3, 4, (H, W, 2)) + rng.uniform(-0.5, 0.5, (H, W, 2))
        cur["velocity_uv"] = cur["velocity_uv"].copy()
        cur["velocity_uv"][..., :2] = (vel / np.array([W, H])).astype(np.float32)
    return cur, prev


def _jgb(d):
    from hikari_tpu.render.types import GBuffer as JGBuffer

    return JGBuffer(**{k: jnp.asarray(v) for k, v in d.items()})


def _tgb(d):
    return GBuffer(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


_JITTED = {}


def _jitted(key, fn):
    """One jitted JAX function per key, shared by both frames (the frame
    number and the G-buffers are arguments), so each compiles once."""
    if key not in _JITTED:
        _JITTED[key] = jax.jit(fn)
    return _JITTED[key]


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------


def test_sampling_helpers_match():
    """nearest/bilinear/textureGather at seeded uvs (some outside [0, 1]),
    clamped shifts, wrapping shifts and the quad interleave: exact."""
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 2, (9, 13, 3)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (7, 5, 2)).astype(np.float32)
    ji, ti = jnp.asarray(img), torch.from_numpy(img)
    ju, tu = jnp.asarray(uv), torch.from_numpy(uv)
    pairs = [
        (jfilters.nearest_sample(ji, ju), tfilters.nearest_sample(ti, tu)),
        (jfilters.bilinear_sample(ji, ju), tfilters.bilinear_sample(ti, tu)),
        (jfilters.bilinear_sample(ji[..., 1], ju), tfilters.bilinear_sample(ti[..., 1], tu)),
        (jfilters.texture_gather(ji, ju, 2), tfilters.texture_gather(ti, tu, 2)),
        (jfilters.interleave2x2(*(ji[..., c] for c in (0, 1, 2, 0))),
         tfilters.interleave2x2(*(ti[..., c] for c in (0, 1, 2, 0)))),
    ]
    for dy, dx in [(0, 0), (2, -3), (-4, 1), (11, 20)]:
        pairs.append((jfilters.edge_shift(ji, dy, dx), tfilters.edge_shift(ti, dy, dx)))
        for a, b in zip(jfilters.shift2d(ji, dy, dx), tfilters.shift2d(ti, dy, dx)):
            pairs.append((a, b))
    for want, got in pairs:
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_ycocg_and_aabb_clip_match():
    """The YCoCg conversions and the AABB clip, on (..., 3) colours and
    on planes, at seeded colours inside, on and outside seeded boxes (some
    flat in one channel)."""
    rng = np.random.default_rng(1)
    prev, cur = rng.uniform(-0.5, 1.5, (2, 6, 7, 3)).astype(np.float32)
    lo = rng.uniform(0.0, 0.5, (6, 7, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.0, 0.5, (6, 7, 3))).astype(np.float32)
    hi[0] = lo[0]  # a zero-extent box
    prev[1] = 0.5 * (lo[1] + hi[1])  # inside
    j = [jnp.asarray(x) for x in (prev, cur, lo, hi)]
    t = [torch.from_numpy(x) for x in (prev, cur, lo, hi)]

    def planes(x):
        return [x[..., c] for c in range(3)]

    pairs = [
        (jtaa.clip_towards_aabb_center(*j), ttaa.clip_towards_aabb_center(*t)),
        *zip(jtaa.clip_aabb_planes(*(planes(x) for x in (j[0], j[2], j[3]))),
             ttaa.clip_aabb_planes(*(planes(x) for x in (t[0], t[2], t[3])))),
        *zip(jtaa.rgb_to_ycocg_planes(*planes(j[0])), ttaa.rgb_to_ycocg_planes(*planes(t[0]))),
        *zip(jtaa.ycocg_to_rgb_planes(*planes(j[0])), ttaa.ycocg_to_rgb_planes(*planes(t[0]))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("frame,moving", FRAMES, ids=FRAME_IDS)
def test_nearest_velocity_and_catmull_match(world, frame, moving):
    """The velocity dilation at the G-buffer's resolution and at half of
    it (the general nearest-sample path), and the 5-tap Catmull-Rom
    resample at reprojected positions."""
    cur, _ = _gbuffers(world, frame, moving)
    jg, tg = _jgb(cur), _tgb(cur)
    from hikari_tpu.utils import uv_grid as j_uv
    from hikari_tpu_torch.utils import uv_grid as t_uv

    for hw in ((H, W), (H // 2, W // 2)):
        want = jtaa.nearest_velocity(jg, j_uv(hw), (1.0 / hw[1], 1.0 / hw[0]))
        got = ttaa.nearest_velocity(tg, t_uv(hw), (1.0 / hw[1], 1.0 / hw[0]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(frame)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    pos = (rng.uniform(-2, 2, (H, W, 2)) + np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)
           + 0.5).astype(np.float32)
    want = jtaa.catmull_rom_5tap(jnp.asarray(img), jnp.asarray(pos), (H, W))
    got = ttaa.catmull_rom_5tap(torch.from_numpy(img), torch.from_numpy(pos), (H, W))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# Spatial reuse
# ---------------------------------------------------------------------------


def _reservoir(world, cur, frame, seed):
    """A seeded reservoir grid on the frame's visible surfaces: visible
    points and normals from the deferred G-buffer, random samples in the
    box, counts, lifetimes (some past the 100-frame limit) and weights."""
    from hikari_tpu_torch.render.light import fetch_gbuffer_deferred

    rh, rw = H // 2, W // 2
    rng = np.random.default_rng(seed)

    g = fetch_gbuffer_deferred(_tgb(cur), frame, world["ts"])
    n = rng.normal(size=(rh, rw, 3))
    sample_pos = np.concatenate([rng.uniform(-1, 1, (rh, rw, 3)) + [0, 1, 0],
                                 (rng.uniform(size=(rh, rw, 1)) < 0.8)], -1)
    rad = np.concatenate([rng.uniform(0, 2, (rh, rw, 3)), np.ones((rh, rw, 1))], -1)
    count = rng.integers(0, 20, (rh, rw)).astype(np.float32)
    w_sum = rng.uniform(0, 3, (rh, rw))
    fields = dict(
        s=dict(
            radiance=rad, random=rng.uniform(size=(rh, rw, 4)),
            visible_position=g.position.numpy(), visible_normal=g.normal.numpy(),
            visible_instance=g.instance.numpy(), sample_position=sample_pos,
            sample_normal=n / np.linalg.norm(n, axis=-1, keepdims=True),
        ),
        count=count, lifetime=rng.integers(0, 120, (rh, rw)), w=rng.uniform(0, 2, (rh, rw)),
        w_sum=w_sum, w2_sum=w_sum * w_sum * rng.uniform(0.5, 1.0, (rh, rw)),
    )

    s = {k: np.asarray(v, np.float32) for k, v in fields["s"].items()}
    s["visible_instance"] = fields["s"]["visible_instance"].astype(np.int32)
    rest = {k: np.asarray(v, np.float32) for k, v in fields.items() if k != "s"}
    jr = JRes(s=JSample(**{k: jnp.asarray(v) for k, v in s.items()}),
              **{k: jnp.asarray(v) for k, v in rest.items()})
    tr = TRes(s=TSample(**{k: torch.from_numpy(v) for k, v in s.items()}),
              **{k: torch.from_numpy(v) for k, v in rest.items()})
    return jr, tr


@pytest.mark.parametrize("taps", ["rolls", "gather"])
@pytest.mark.parametrize("emissive_lit", [False, True], ids=["indirect", "emissive"])
@pytest.mark.parametrize("frame,moving", FRAMES, ids=FRAME_IDS)
def test_spatial_reuse_pass_matches(world, frame, moving, emissive_lit, taps):
    cur, _ = _gbuffers(world, frame, moving)
    js, ts = world["js"].replace(spatial_taps=taps), world["ts"].replace(spatial_taps=taps)
    jt, tt = _reservoir(world, cur, frame, seed=10 + frame)
    jp, tp = _reservoir(world, cur, frame, seed=20 + frame)
    var = np.random.default_rng(frame).uniform(0, 1, (H // 2, W // 2)).astype(np.float32)

    jpass = _jitted(("spatial", emissive_lit, taps), lambda b, cam, g, temporal, prev, v, f:
                    jspatial.spatial_reuse_pass(b, cam, g, temporal, prev, v, f, js,
                                                emissive_lit=emissive_lit))
    jout = jpass(world["jb"], world["jcam"], _jgb(cur), jt, jp, jnp.asarray(var), jnp.int32(frame))
    tout = tspatial.spatial_reuse_pass(world["tb"], world["tcam"], _tgb(cur), tt, tp,
                                       torch.from_numpy(var), frame, ts, emissive_lit=emissive_lit)
    assert float(tout[0].abs().max()) > 0.0
    assert_image_close(tout[0], jout[0], "radiance")
    assert_image_close(tout[1][..., None], np.asarray(jout[1])[..., None], "variance")
    for f in ("count", "w", "w_sum", "lifetime"):
        assert_image_close(getattr(tout[2], f)[..., None], np.asarray(getattr(jout[2], f))[..., None],
                           f, share=0.99, mean=5e-3)
    assert_image_close(tout[2].s.radiance, jout[2].s.radiance, "s.radiance", share=0.99, mean=5e-3)
    # The merges took neighbours: counts grew past the temporal ones.
    assert float((tout[2].count > tt.count).to(torch.float32).mean()) > 0.3


# ---------------------------------------------------------------------------
# Denoise, SMAA, TAA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frame,moving", FRAMES, ids=FRAME_IDS)
def test_denoise_channel_matches(world, frame, moving):
    cur, _ = _gbuffers(world, frame, moving)
    rng = np.random.default_rng(frame)
    rh, rw = H // 2, W // 2
    rad = rng.uniform(0, 2, (rh, rw, 3)).astype(np.float32)
    rad[0, 0] = np.nan  # the NaN scrub
    rad[1, 1] *= 50.0  # a firefly
    var = rng.uniform(0, 0.5, (rh, rw)).astype(np.float32)
    alb = rng.uniform(0, 1, (rh, rw, 3)).astype(np.float32)
    alb[2, :] = 0.005  # dark albedo: no demodulation
    js = world["js"]
    jdn = _jitted(("denoise",), lambda r, v, a, g, f: jdenoise.denoise_channel(r, v, a, g, f, js))
    want = jdn(jnp.asarray(rad), jnp.asarray(var), jnp.asarray(alb), _jgb(cur), jnp.int32(frame))
    got = tdenoise.denoise_channel(torch.from_numpy(rad), torch.from_numpy(var),
                                   torch.from_numpy(alb), _tgb(cur), frame, world["ts"])
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0.0
    assert_image_close(got, want, "denoised")


def _colours(frame, hw, alpha_holes=True):
    rng = np.random.default_rng(100 + frame)
    c = rng.uniform(0, 1, hw + (4,)).astype(np.float32)
    c[..., 3] = 1.0
    if alpha_holes:
        c[..., 3][rng.uniform(size=hw) < 0.1] = 0.0
    return c


@pytest.mark.parametrize("frame,moving", FRAMES, ids=FRAME_IDS)
def test_smaa_tu4x_matches(world, frame, moving):
    cur, prev = _gbuffers(world, frame, moving)
    render, history = _colours(frame, (H // 2, W // 2)), _colours(frame + 1, (H, W))
    jsm = _jitted(("smaa",), jsmaa.smaa_tu4x)
    want = jsm(jnp.asarray(render), jnp.asarray(history), _jgb(cur), _jgb(prev), jnp.int32(frame))
    got = tsmaa.smaa_tu4x(torch.from_numpy(render), torch.from_numpy(history), _tgb(cur),
                          _tgb(prev), frame)
    assert got.shape == (H, W, 4)
    assert_image_close(got, want, "smaa")


@pytest.mark.parametrize("frame,moving", FRAMES, ids=FRAME_IDS)
def test_taa_jasmine_matches(world, frame, moving):
    cur, prev = _gbuffers(world, frame, moving)
    render, history = _colours(frame, (H, W)), _colours(frame + 1, (H, W))
    clear = (0.4, 0.4, 0.4, 1.0)
    jta = _jitted(("taa",), lambda r, p, g, pg: jtaa.taa_jasmine(r, p, g, pg, clear, 2.0))
    want = jta(jnp.asarray(render), jnp.asarray(history), _jgb(cur), _jgb(prev))
    got = ttaa.taa_jasmine(torch.from_numpy(render), torch.from_numpy(history), _tgb(cur),
                           _tgb(prev), clear, 2.0)
    assert got.shape == (H, W, 4)
    assert_image_close(got, want, "taa")
