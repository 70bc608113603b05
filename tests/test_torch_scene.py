"""Parity of the PyTorch port's host scene compile and device upload with
``hikari_tpu``: numpy BVH and alias builders, ``compile_scene`` on the
procedural Cornell box, ``to_device`` fed the JAX package's compile
output, the blue-noise bank and the frame-state bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _jax_numpy_builders(monkeypatch):
    """Triangle order follows the BVH, so the JAX side must use the same
    (numpy) builder as the port: switch its C++ builder off."""
    import hikari_tpu.scene.native as native

    monkeypatch.setattr(native, "get_builder", lambda: None)


@pytest.mark.parametrize("n", [1, 5, 64, 300])
def test_bvh_numpy_equal(n):
    """Tolerance: exact — the same numpy code on the same inputs."""
    from hikari_tpu.scene.bvh import build_flat_bvh_numpy as jbuild
    from hikari_tpu_torch.scene.bvh import build_flat_bvh, validate_flat_bvh

    rng = np.random.default_rng(n)
    lo = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 1.0, (n, 3)).astype(np.float32)
    want, got = jbuild(lo, hi), build_flat_bvh(lo, hi, "numpy")
    validate_flat_bvh(got, n)
    for f in ("mins", "maxs", "entry", "exit", "inst"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_alias_table_numpy_equal():
    from hikari_tpu.scene.alias import build_alias_table_numpy as jalias
    from hikari_tpu_torch.scene.alias import alias_sample_pdf, build_alias_table

    areas = np.random.default_rng(2).uniform(0.01, 3.0, 97).astype(np.float32)
    prob, index = build_alias_table(areas, "numpy")
    jprob, jindex = jalias(areas)
    np.testing.assert_array_equal(prob, jprob)
    np.testing.assert_array_equal(index, jindex)
    np.testing.assert_allclose(alias_sample_pdf(prob, index), areas / areas.sum(), rtol=1e-5)


def test_compile_scene_matches(monkeypatch):
    """The port's compile of its own procedural Cornell box equals the JAX
    package's field by field (exact: host numpy in both)."""
    _jax_numpy_builders(monkeypatch)
    from hikari_tpu.io.scenes import cornell_box_scene as jscene
    from hikari_tpu.scene.compile import compile_scene as jcompile
    from hikari_tpu_torch.io.scenes import cornell_box_scene as tscene
    from hikari_tpu_torch.scene.compile import compile_scene as tcompile

    want, got = jcompile(jscene()), tcompile(tscene(), "numpy")
    names = [f.name for f in dataclasses.fields(want)]
    assert names == [f.name for f in dataclasses.fields(got)]
    for name in names:
        a, b = getattr(want, name), getattr(got, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.fixture(scope="module")
def cornell_arrays():
    from hikari_tpu.io.scenes import cornell_box_scene
    from hikari_tpu.scene.compile import compile_scene

    return compile_scene(cornell_box_scene())


def test_to_device_matches_jax_buffers(cornell_arrays):
    """``to_device`` fed the JAX package's ``SceneArrays`` gives the JAX
    package's ``SceneBuffers``: same fields, shapes and integer contents;
    the precomputed plane form within 1e-6 relative (XLA's CPU compiler
    contracts the cross products into FMAs)."""
    from hikari_tpu.scene.buffers import to_device as jdev
    from hikari_tpu_torch.scene.buffers import to_device as tdev

    jb, tb = jdev(cornell_arrays), tdev(cornell_arrays, "cpu")
    for f in dataclasses.fields(jb):
        a, b = getattr(jb, f.name), getattr(tb, f.name)
        if not isinstance(a, jax.Array):
            assert a == b, f.name
            continue
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape, f.name
        if a.dtype.kind == "f":
            assert b.dtype == a.dtype, f.name
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7, err_msg=f.name)
        else:
            np.testing.assert_array_equal(b.astype(np.int64), a.astype(np.int64), err_msg=f.name)


def test_blue_noise_bank_bitwise():
    from hikari_tpu.render.noise import blue_noise_bank as jbank
    from hikari_tpu_torch.render.noise import blue_noise_bank as tbank

    np.testing.assert_array_equal(tbank(), jbank())


@pytest.mark.parametrize("frame", [0, 5, 70])
def test_noise_plane_matches(frame):
    """The tiled fetch equals the JAX package's (and the per-pixel
    ``sample_noise``) exactly: it only moves values."""
    from hikari_tpu.render.noise import noise_plane as jplane
    from hikari_tpu_torch.render.noise import blue_noise_bank, noise_plane, sample_noise

    bank = torch.from_numpy(blue_noise_bank())
    got = noise_plane(bank, frame, (48, 130))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jplane(blue_noise_bank(), frame, (48, 130))))
    ys, xs = torch.meshgrid(torch.arange(48), torch.arange(130), indexing="ij")
    np.testing.assert_array_equal(sample_noise(bank, frame, ys, xs).numpy(), got.numpy())


def test_frame_state_from_numpy_roundtrip():
    """The bridge keeps every leaf's values and dtypes (f16 storage too)."""
    from hikari_tpu.config import RenderSettings as JS
    from hikari_tpu.render.pipeline import initial_state as jinit
    from hikari_tpu_torch.config import RenderSettings as TS
    from hikari_tpu_torch.render.pipeline import initial_state as tinit
    from hikari_tpu_torch.scene.buffers import frame_state_from_numpy
    from hikari_tpu_torch.utils import map_tensors

    kw = dict(width=20, height=12, reservoir_f16=True)
    jstate = jinit(JS(**kw))
    jstate = jax.tree_util.tree_map(lambda x: x + jnp.ones((), x.dtype), jstate)
    got = frame_state_from_numpy(jstate, "cpu")
    assert got.frame_number == 1
    leaves = []
    map_tensors(leaves.append, got)
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)][1:]
    assert len(leaves) == len(jleaves)
    for a, b in zip(jleaves, leaves):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(b.numpy(), a)
    # The port's own initial state has the JAX shapes and dtypes.
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jinit(JS(**kw)))][1:]
    mine = []
    map_tensors(mine.append, tinit(TS(**kw), "cpu"))
    assert [(a.shape, a.dtype) for a in want] == [(tuple(b.shape), b.numpy().dtype) for b in mine]
