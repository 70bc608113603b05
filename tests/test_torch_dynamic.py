"""Parity of the port's dynamic-scene layer (``scene/update.py``: the
transform update, the activity mask, ``SceneUpdater``), its lockstep BVH
walk (``trace_rays(method="bvh")``), frames under motion and
``examples/render --stream`` with ``hikari_tpu`` on the CPU.

One host compile of ``simple_scene`` (1,094 triangles, 6 instances,
``refit_depth`` 16) feeds both packages; the moves are those of
``tests/test_dynamic.py``. Every random input comes from this file's own
``np.random.default_rng(seed)``.

Tolerances (each test says which it uses):
* updated fields: within 1e-5 absolute plus 1e-6 relative — the relative
  part covers the plane form's offsets (``tri_cu`` up to ~250, where one
  f32 ulp is 1.5e-5; XLA's CPU compiler contracts the products into FMAs,
  the port rounds each), as ``test_torch_scene.py`` compares the static
  compile; ``tri_valid``, ``inst_prev_model`` and pinned rows exactly;
* traces: prim and inst equal, t within 1e-5;
* frames: image within 1e-3 on >= 99% of pixels, velocity within 1e-5 on
  >= 99.9%, reservoir counts equal on >= 99% (ReSTIR decisions are
  discrete, so a 1-ulp difference can flip an edge pixel).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu.config as jc
import hikari_tpu_torch.config as tc
from hikari_tpu.io.scenes import _euler_xyz_matrix
from hikari_tpu.io.scenes import simple_scene as j_simple_scene
from hikari_tpu.scene import update as jup
from hikari_tpu.scene.buffers import to_device as j_dev
from hikari_tpu.scene.compile import compile_scene
from hikari_tpu.trace import trace_rays as j_trace
from hikari_tpu_torch.io.scenes import simple_scene as t_simple_scene
from hikari_tpu_torch.scene import update as tup
from hikari_tpu_torch.scene.buffers import to_device as t_dev
from hikari_tpu_torch.trace import api as tapi

torch.set_num_threads(2)

# Every field update_transforms writes.
WRITTEN = (
    "tri_world", "tri_n", "tri_eu", "tri_ev", "tri_cn", "tri_cu", "tri_cv", "tri_valid",
    "vert_normal", "node_min", "node_max", "inst_min", "inst_max", "inst_model",
    "inst_prev_model", "inst_inv_model", "em_position", "em_radius", "em_surface_area",
    "enode_min", "enode_max",
)
EXACT = ("tri_valid", "inst_prev_model")
MOVER = 2  # the pink cube
EMISSIVE = 4  # the bright emissive sphere


def _moved_models(models, delta=(0.3, 0.1, -0.2), rot_y=0.4, inst=MOVER):
    """``tests/test_dynamic.py``'s move: translate and turn one instance."""
    models = np.array(models, dtype=np.float32)
    r = np.eye(4, dtype=np.float32)
    r[:3, :3] = _euler_xyz_matrix(0.0, rot_y, 0.0)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = delta
    models[inst] = t @ r @ models[inst]
    return models


@pytest.fixture(scope="module")
def world():
    arrays = compile_scene(j_simple_scene())
    return dict(arrays=arrays, jb=j_dev(arrays), tb=t_dev(arrays, "cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_fields_match(tb, jb, fields=WRITTEN):
    for f in fields:
        a, b = _np(getattr(jb, f)), _np(getattr(tb, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in EXACT or a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5, err_msg=f)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def assert_hits_match(th, jh, t_atol=1e-5):
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    np.testing.assert_array_equal(th.inst.numpy(), np.asarray(jh.inst))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), atol=t_atol)


def test_update_transforms_matches_jax(world):
    """(1) The moved pink cube: every field the JAX update writes, same
    shapes and dtypes; ``tri_valid`` and ``inst_prev_model`` equal."""
    jb, tb = world["jb"], world["tb"]
    models = _moved_models(np.asarray(jb.inst_model))
    ju = jup.update_transforms(jb, jnp.asarray(models))
    tu = tup.update_transforms(tb, models)
    assert_fields_match(tu, ju)
    for f in dataclasses.fields(tb):
        if f.name not in WRITTEN:
            assert getattr(tu, f.name) is getattr(tb, f.name), f.name
    # The moved instance's rows changed, the other instances' did not
    # (padding rows take instance 0's transform of zeros, as in JAX).
    moved = tb.tri_inst == MOVER
    still = (tb.tri_inst >= 0) & ~moved
    assert not torch.equal(tu.tri_world[moved], tb.tri_world[moved])
    assert torch.equal(tu.tri_world[still], tb.tri_world[still])


@pytest.mark.parametrize("reduce", ["amin", "amax", "sum"])
def test_segment_reduce_identity_matches_jax(reduce):
    """``jax.ops.segment_*`` with ``num_segments = I + 1``: an instance
    without triangles holds the identity (+inf, -inf, 0), the padding
    segment ``I`` is dropped by the caller; values exactly equal."""
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(40, 3)).astype(np.float32)
    seg = rng.choice([0, 1, 3, 4], size=40).astype(np.int32)  # segment 2 stays empty
    seg[-5:] = 4  # the padding segment
    jfn = {"amin": jax.ops.segment_min, "amax": jax.ops.segment_max,
           "sum": jax.ops.segment_sum}[reduce]
    want = np.asarray(jfn(jnp.asarray(vals), jnp.asarray(seg), num_segments=5))
    got = tup._segment_reduce(torch.from_numpy(vals), torch.from_numpy(seg), 5, reduce).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    identity = {"amin": np.inf, "amax": -np.inf, "sum": 0.0}[reduce]
    assert (got[2] == identity).all() and (want[2] == identity).all()


@pytest.mark.parametrize("mesh,inst", [(False, False), (True, False), (False, True)])
def test_universal_settings_pin_refit(world, mesh, inst):
    """(2) ``UniversalSettings`` gates the refit halves: pinned node rows
    equal JAX's and the old rows exactly, the rest within the update's
    tolerance. The TLAS's leaves are the BLAS roots, so with the BLAS
    pinned the TLAS refit keeps its old rows too."""
    jb, tb = world["jb"], world["tb"]
    models = _moved_models(np.asarray(jb.inst_model), delta=(2.0, 0.0, 0.0), rot_y=0.0)
    ju = jup.update_transforms(jb, jnp.asarray(models), universal=jc.UniversalSettings(
        build_mesh_acceleration_structure=mesh, build_instance_acceleration_structure=inst))
    tu = tup.update_transforms(tb, models, universal=tc.UniversalSettings(
        build_mesh_acceleration_structure=mesh, build_instance_acceleration_structure=inst))
    assert_fields_match(tu, ju)
    T = tb.num_tlas_nodes
    pinned = np.zeros(tb.node_entry.shape[0], dtype=bool)
    if not mesh:
        pinned[T:] = True
    if not inst:
        pinned[:T] = True
    for f in ("node_min", "node_max"):
        got, want, old = _np(getattr(tu, f)), _np(getattr(ju, f)), _np(getattr(tb, f))
        np.testing.assert_array_equal(got[pinned], want[pinned], err_msg=f)
        np.testing.assert_array_equal(got[pinned], old[pinned], err_msg=f)
        if mesh:
            assert not np.array_equal(got[~pinned], old[~pinned]), f


def test_update_activity_matches_jax(world):
    """(3) The pink cube and the bright emissive sphere streamed out: the
    fields equal JAX's; "bruteforce" and "bvh" trace as JAX's same method
    (prim, inst equal, t within 1e-5); the port's "pallas" twin agrees
    with its "bruteforce" apart from exact ties (prims differ only where
    t is equal); the light walk never picks the inactive sphere."""
    from hikari_tpu.render.sampling import _emissive_walk as j_walk
    from hikari_tpu_torch.render.sampling import _emissive_walk as t_walk

    jb, tb = world["jb"], world["tb"]
    active = np.ones(tb.num_instances, dtype=bool)
    active[[MOVER, EMISSIVE]] = False
    ju = jup.update_activity(jb, jnp.asarray(active))
    tu = tup.update_activity(tb, active)
    assert_fields_match(tu, ju)
    np.testing.assert_array_equal(tu.inst_active.numpy(), active)
    slot = int(np.nonzero(_np(tb.em_instance) == EMISSIVE)[0][0])
    assert float(tu.em_radius[slot]) == 0.0
    assert (tu.em_position[slot] == torch.tensor(1e30)).all()

    o, d = _rays(512, 11)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    for method in ("bruteforce", "bvh"):
        th = tapi.trace_rays(tu, to, td, method=method)
        assert_hits_match(th, j_trace(ju, jnp.asarray(o), jnp.asarray(d), method=method))
        assert not bool((th.inst == MOVER).any()) and bool((th.prim >= 0).any())
    brute = tapi.trace_rays(tu, to, td, method="bruteforce")
    pallas = tapi.trace_rays(tu, to, td, method="pallas")
    assert torch.equal(pallas.t, brute.t)

    pos = np.random.default_rng(3).uniform(-1, 1, (64, 3)).astype(np.float32) + [0.0, 4.0, 0.0]
    rand = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    excl = np.full((64,), -1, np.int32)
    for scene_t, scene_j in ((tb, jb), (tu, ju)):
        tc_, tn = t_walk(scene_t, torch.from_numpy(pos), torch.from_numpy(excl),
                         torch.from_numpy(rand))
        jc_, jn = j_walk(scene_j, jnp.asarray(pos), jnp.asarray(excl), jnp.asarray(rand))
        np.testing.assert_array_equal(tc_.numpy(), np.asarray(jc_))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    picked = _np(tb.em_instance)[np.maximum(tc_.numpy(), 0)]
    assert not (picked[tc_.numpy() >= 0] == EMISSIVE).any()


BVH_CASES = {
    # > BVH_RAY_CHUNK rays: the octant sort and two chunks, the last one
    # filled with inert rays; exclusion, a prim range and early_distance.
    "chunked": dict(n=70000, max_steps=0),
    # a cap below the walk's length: rays past it keep their best so far.
    "max_steps": dict(n=2048, max_steps=24),
}


@pytest.mark.parametrize("case", list(BVH_CASES))
def test_bvh_walk_matches_jax(world, case):
    """(4) ``method="bvh"`` on the moved scene against JAX's
    ``_trace_bvh``: per ray an excluded instance (or none), a prim range
    (the whole scene, one instance's, or an empty one) and an early
    distance; prim and inst equal, t within 1e-5."""
    n, max_steps = BVH_CASES[case]["n"], BVH_CASES[case]["max_steps"]
    jb, tb = world["jb"], world["tb"]
    models = _moved_models(np.asarray(jb.inst_model), delta=(0.0, 0.8, 0.0), rot_y=0.9)
    ju = jup.update_transforms(jb, jnp.asarray(models))
    tu = tup.update_transforms(tb, models)
    rng = np.random.default_rng(17)
    o, d = _rays(n, 13)
    excl = rng.integers(-1, tb.num_instances, n).astype(np.int32)
    po, pc = _np(tb.inst_prim_offset), _np(tb.inst_prim_count)
    pick = rng.integers(0, 3, n)
    lo = np.where(pick == 1, po[MOVER], 0).astype(np.int32)
    hi = np.where(pick == 0, tb.num_tris, np.where(pick == 1, po[MOVER] + pc[MOVER], 0))
    hi = hi.astype(np.int32)
    early = np.where(rng.random(n) < 0.5, rng.uniform(0.0, 20.0, n), 0.0).astype(np.float32)
    maxd = rng.uniform(1.0, 100.0, n).astype(np.float32)
    kw = dict(max_distance=maxd, early_distance=early, exclude_instance=excl, range_lo=lo,
              range_hi=hi, method="bvh", max_steps=max_steps)
    th = tapi.trace_rays(tu, torch.from_numpy(o), torch.from_numpy(d),
                         **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                            for k, v in kw.items()})
    jh = j_trace(ju, jnp.asarray(o), jnp.asarray(d),
                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    assert_hits_match(th, jh)
    assert int((th.prim >= 0).sum()) > n // 10


def test_scene_updater_matches_jax(world):
    """(5) ``SceneUpdater``: a translation of the bright sphere leaves its
    alias rows untouched; a scale rebuilds them equal to JAX's; the
    buffers after each step, ``set_active`` and an intensity change of
    ``set_material`` match JAX's (spheres refreshed); a toggle of emissive
    membership raises ``ValueError``, an unknown field ``KeyError``."""
    arrays = world["arrays"]
    ju = jup.SceneUpdater(j_simple_scene(), j_dev(arrays))
    tu = tup.SceneUpdater(t_simple_scene(), t_dev(arrays, "cpu"))
    before = tu.buffers.alias_prob.clone()
    t = np.asarray(ju.buffers.inst_model)[EMISSIVE].copy()
    t[:3, 3] += [0.5, 0.0, 0.0]
    ju.set_transforms({EMISSIVE: t})
    tu.set_transforms({EMISSIVE: t})
    assert torch.equal(tu.buffers.alias_prob, before)
    assert_fields_match(tu.buffers, ju.buffers)

    s = t.copy()
    s[:3, :3] = s[:3, :3] @ np.diag([2.0, 1.0, 1.0]).astype(np.float32)
    ju.set_transforms({EMISSIVE: s})
    tu.set_transforms({EMISSIVE: s})
    assert not torch.equal(tu.buffers.alias_prob, before)
    np.testing.assert_array_equal(tu.buffers.alias_prob.numpy(), np.asarray(ju.buffers.alias_prob))
    np.testing.assert_array_equal(tu.buffers.alias_index.numpy(),
                                  np.asarray(ju.buffers.alias_index))
    assert_fields_match(tu.buffers, ju.buffers)
    np.testing.assert_array_equal(tu.scene.instances[EMISSIVE].transform, s)

    ju.set_active({MOVER: False})
    tu.set_active({MOVER: False})
    assert_fields_match(tu.buffers, ju.buffers)
    np.testing.assert_array_equal(tu.buffers.inst_active.numpy(),
                                  np.asarray(ju.buffers.inst_active))

    mat = int(_np(tu.buffers.inst_material)[EMISSIVE])
    radius = tu.buffers.em_radius.clone()
    ju.set_material(mat, emissive=(1.0, 1.0, 1.0, 2.0))
    tu.set_material(mat, emissive=(1.0, 1.0, 1.0, 2.0))
    assert not torch.equal(tu.buffers.em_radius, radius)
    assert_fields_match(tu.buffers, ju.buffers)
    np.testing.assert_array_equal(tu.buffers.mat_emissive.numpy(),
                                  np.asarray(ju.buffers.mat_emissive))
    for up in (ju, tu):
        with pytest.raises(ValueError, match="emissive-set membership"):
            up.set_material(mat, emissive=(0.0, 0.0, 0.0, 0.0))
        with pytest.raises(KeyError, match="unsupported dynamic material field"):
            up.set_material(0, sheen=0.5)


MOTION_HW = (48, 62)
STATIC_FRAMES, MOVING_FRAMES = 2, 2
EYE, PAN = (-10.0, 2.5, 20.0), 0.15


def _motion_settings(mod, reproject):
    """``tests/test_dynamic.py``'s motion settings at 48x62 (the scene
    config's camera looks along x = z: an odd width puts the centre
    column on that plane)."""
    return mod.RenderSettings(
        width=MOTION_HW[1], height=MOTION_HW[0], upscale=mod.Upscale.none(), taa=mod.Taa.NONE,
        denoise=False, indirect_bounces=0, emissive_lit=False, temporal_reuse=True,
        reproject=reproject,
    )


def _motion_plan():
    """Per frame (eye, prev_eye, the pink cube's move or None): static
    frames, then the camera pans along x and the cube moves 0.1 a frame."""
    plan = [(EYE, EYE, None)] * STATIC_FRAMES
    for k in range(1, MOVING_FRAMES + 1):
        eye = (EYE[0] + PAN * k, EYE[1], EYE[2])
        prev = (EYE[0] + PAN * (k - 1), EYE[1], EYE[2])
        plan.append((eye, prev, dict(delta=(0.1, 0.0, 0.0), rot_y=0.05)))
    return plan


def _port_motion_frames(tb, reproject):
    from hikari_tpu_torch.render import initial_state, render_frame
    from hikari_tpu_torch.render.camera import Camera

    settings = _motion_settings(tc, reproject)
    state = initial_state(settings, "cpu")
    frames = []
    with torch.no_grad():
        for eye, prev, move in _motion_plan():
            if move is not None:
                tb = tup.update_transforms(tb, _moved_models(tb.inst_model.numpy(), **move))
            cam = Camera.from_lookat(eye=eye, target=(0.0, 0.0, 0.0), prev_eye=prev,
                                     prev_target=(0.0, 0.0, 0.0), device="cpu")
            out, state = render_frame(tb, cam, state, settings)
            frames.append((out, state))
    return frames


@pytest.fixture(scope="module")
def motion_frames(world):
    """Both packages' frames under motion, each on its own chain from its
    initial state; JAX with ``reproject="adaptive"`` (its ``"shift"``
    promises zero velocity and reads reservoirs at the pixel itself)."""
    from hikari_tpu.render import initial_state, render_frame_jit
    from hikari_tpu.render.camera import Camera

    jb = world["jb"]
    settings = _motion_settings(jc, "adaptive")
    state = initial_state(settings)
    jframes = []
    for eye, prev, move in _motion_plan():
        if move is not None:
            jb = jup.update_transforms(jb, jnp.asarray(_moved_models(np.asarray(jb.inst_model),
                                                                     **move)))
        cam = Camera.from_lookat(eye=eye, target=(0.0, 0.0, 0.0), prev_eye=prev,
                                 prev_target=(0.0, 0.0, 0.0))
        out, state = render_frame_jit(jb, cam, state, settings)
        jframes.append((out, state))
    return jframes, _port_motion_frames(world["tb"], "adaptive")


@pytest.mark.parametrize("frame", range(STATIC_FRAMES, STATIC_FRAMES + MOVING_FRAMES))
def test_frames_under_motion_match_jax(motion_frames, frame):
    """(6) A camera pan and a moving cube after two static frames: image
    within 1e-3 on >= 99% of pixels; velocity within 1e-5 on >= 99.9% and
    not zero on the cube; direct temporal counts equal on >= 99%; the
    static instances keep exactly zero object motion (the G-buffer's
    static snap holds after the update)."""
    jframes, tframes = motion_frames
    (jo, js), (to, ts) = jframes[frame], tframes[frame]
    img_ok = np.abs(to.image.numpy() - np.asarray(jo.image)).max(-1) <= 1e-3
    assert img_ok.mean() >= 0.99, img_ok.mean()
    tvel = ts.prev_gbuffer.velocity_uv[..., :2].numpy()
    jvel = np.asarray(js.prev_gbuffer.velocity_uv[..., :2])
    vel_ok = np.abs(tvel - jvel).max(-1) <= 1e-5
    assert vel_ok.mean() >= 0.999, vel_ok.mean()
    inst = ts.prev_gbuffer.instance.numpy()
    mover = inst == MOVER
    assert mover.sum() > 5 and np.abs(tvel[mover]).max() > 1e-4
    counts_ok = ts.direct_temporal.count.numpy() == np.asarray(js.direct_temporal.count)
    assert counts_ok.mean() >= 0.99, counts_ok.mean()
    assert np.isfinite(to.image.numpy()).all()


def test_temporal_counts_survive_motion(motion_frames):
    """Temporal accumulation survives the first moving frame on most
    pixels (``tests/test_dynamic.py``'s criterion), in both packages."""
    jframes, tframes = motion_frames
    k = STATIC_FRAMES
    for frames, arr in ((jframes, np.asarray), (tframes, lambda x: x.numpy())):
        before = arr(frames[k - 1][1].direct_temporal.count)
        after = arr(frames[k][1].direct_temporal.count)
        assert (after >= before).mean() > 0.5


def test_port_ignores_reproject(world, motion_frames):
    """The port has one reprojection transport, the clamped gather: a
    frame under motion with ``reproject="shift"`` equals the same frame
    with ``"adaptive"`` bit for bit (the JAX package's ``"shift"`` reads
    reservoirs at the pixel itself and is not mirrored)."""
    _, adaptive = motion_frames
    shift = _port_motion_frames(world["tb"], "shift")
    for (a, sa), (b, sb) in zip(adaptive, shift):
        assert torch.equal(a.image, b.image)
        assert torch.equal(sa.direct_temporal.count, sb.direct_temporal.count)
        assert torch.equal(sa.prev_gbuffer.velocity_uv, sb.prev_gbuffer.velocity_uv)


def _jax_stream_rule(num_instances, frames):
    """The JAX entry point's ``--stream`` loop (examples/render.py:51-76),
    step for step: the activity mask each frame renders with."""
    active = np.zeros(num_instances, dtype=bool)
    active[0] = True
    batch = max(1, (num_instances - 1) // max(frames - 1, 1) + 1)
    masks = []
    for i in range(frames):
        nxt = active.copy()
        lo = 1 + i * batch
        nxt[lo: lo + batch] = True
        if not np.array_equal(nxt, active):
            active = nxt
        masks.append(active.copy())
    return masks


@pytest.mark.parametrize("num_instances,frames", [(2, 4), (6, 4), (343, 16), (8, 1)])
def test_stream_masks_follow_jax_rule(num_instances, frames):
    from hikari_tpu_torch.examples.render import stream_masks

    got = stream_masks(num_instances, frames)
    want = _jax_stream_rule(num_instances, frames)
    assert len(got) == len(want) == frames
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_render_stream_entry_point(tmp_path):
    """(7) ``examples/render minimal --stream`` on the CPU at 32 px: the
    masks the frames rendered with follow the JAX rule (minimal's second
    instance, the cube, streams in at frame 0) and the image is finite
    and lit."""
    from hikari_tpu_torch.examples import render

    res = render.main(["minimal", "--frames", "3", "--size", "32", "--cpu", "--stream", "--out",
                       str(tmp_path / "m.png")])
    want = _jax_stream_rule(2, 3)
    assert len(res["masks"]) == 3
    for g, w in zip(res["masks"], want):
        np.testing.assert_array_equal(g, w)
    assert np.isfinite(res["image"]).all() and res["image"].mean() > 0.0
