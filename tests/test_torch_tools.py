"""Parity of the port's tools and I/O surface with ``hikari_tpu``: the
image helpers (``io/image``), the frame-state checkpoint in both
directions (``io/checkpoint``), the profiling helpers
(``utils/profiling``), the ``minimal``/``simple``/``scene`` configs
(``io/scenes``) compiled to the same arrays, and the entry points
``examples/render`` and ``examples/dissect`` on the CPU.

Tolerances: none — the image helpers are the same numpy code, the
checkpoint moves arrays bit for bit, and the scene compiles run the same
host numpy on both sides (both on the numpy builders)."""

import dataclasses
import enum
import json

import jax
import numpy as np
import pytest
import torch

import hikari_tpu.config as jc
import hikari_tpu_torch.config as tc
from hikari_tpu.io import checkpoint as jckpt
from hikari_tpu.io import image as jimage
from hikari_tpu.render.pipeline import initial_state as j_init
from hikari_tpu_torch.io import checkpoint as tckpt
from hikari_tpu_torch.io import image as timage
from hikari_tpu_torch.render.pipeline import initial_state as t_init

torch.set_num_threads(2)


def _images(seed, shape=(6, 9, 4)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.2, 1.2, shape).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


def test_image_helpers_match_jax(tmp_path):
    a, b = _images(0)
    np.testing.assert_array_equal(timage.to_srgb_u8(a), jimage.to_srgb_u8(a))
    assert timage.image_mse(a, b) == jimage.image_mse(a, b)
    assert timage.image_psnr(a, b) == jimage.image_psnr(a, b)
    assert timage.image_psnr(a, a) == jimage.image_psnr(a, a) == float("inf")
    for srgb in (True, False):
        timage.write_png(str(tmp_path / "t.png"), a, srgb=srgb)
        jimage.write_png(str(tmp_path / "j.png"), a, srgb=srgb)
        got = timage.read_png(str(tmp_path / "t.png"))
        want = jimage.read_png(str(tmp_path / "j.png"))
        assert got.shape == (6, 9, 3)
        np.testing.assert_array_equal(got, want)


SETTINGS = dict(width=12, height=8, reservoir_f16=True)


def _randomized(leaves, seed):
    """Fresh values of each leaf's dtype and shape."""
    rng = np.random.default_rng(seed)
    out = []
    for x in leaves:
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            out.append(rng.normal(size=x.shape).astype(x.dtype))
        else:
            out.append(rng.integers(-3, 1000, x.shape).astype(x.dtype))
    return out


def test_checkpoint_port_to_jax(tmp_path):
    """A state saved by the port loads in the JAX package's ``load_state``
    with every leaf equal (dtypes included: f16 reservoir storage)."""
    like = j_init(jc.RenderSettings(**SETTINGS))
    jleaves, treedef = jax.tree_util.tree_flatten(like)
    state = tckpt.state_from_leaves(_randomized(jleaves, 1), "cpu")
    path = str(tmp_path / "port_state.npz")
    tckpt.save_state(path, state)
    back = jax.tree_util.tree_leaves(jckpt.load_state(path, like))
    mine = tckpt.state_leaves(state)
    assert len(back) == len(mine) == len(jleaves) == 70
    for got, want, ref in zip(back, mine, jleaves):
        got = np.asarray(got)
        assert got.dtype == want.dtype == np.asarray(ref).dtype and got.shape == np.shape(ref)
        np.testing.assert_array_equal(got, want)
    assert int(np.asarray(mine[0])) == state.frame_number


def test_checkpoint_jax_to_port(tmp_path):
    """A JAX-layout npz (``leaf_i`` in ``tree_flatten`` order, the JAX
    package's fallback format) loads in the port with every leaf equal;
    the port's state has the port's own initial shapes and dtypes."""
    like = j_init(jc.RenderSettings(**SETTINGS))
    leaves = _randomized(jax.tree_util.tree_leaves(like), 2)
    path = str(tmp_path / "jax_state.npz")
    np.savez(path, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    state = tckpt.load_state(path, "cpu")
    assert state.frame_number == int(leaves[0])
    for got, want in zip(tckpt.state_leaves(state), leaves):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    own = tckpt.state_leaves(t_init(tc.RenderSettings(**SETTINGS), "cpu"))
    assert [(x.shape, x.dtype) for x in own] == [(x.shape, x.dtype) for x in leaves]
    np.savez(path, **{f"leaf_{i}": x for i, x in enumerate(leaves[:-1])})
    with pytest.raises(ValueError, match="fewer leaves"):
        tckpt.load_state(path, "cpu")


def test_profiling_spans_in_trace(tmp_path):
    """``pass_scope`` spans appear in the Chrome trace ``trace_to``
    writes; ``FrameTimer`` records one sample per step."""
    from hikari_tpu_torch.utils.profiling import FrameTimer, pass_scope, trace_to

    timer = FrameTimer()
    with trace_to(str(tmp_path)):
        for _ in range(2):
            with timer.time(True), pass_scope("hikari_test_pass"):
                torch.ones(64).cumsum(0)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert sum(e.get("name") == "hikari_test_pass" for e in events) == 2
    assert len(timer.samples) == 2 and timer.mean > 0.0 and timer.last > 0.0


def _settings_fields(s):
    def plain(v):
        if isinstance(v, enum.Enum):
            return v.value
        if dataclasses.is_dataclass(v):
            return tuple(plain(getattr(v, f.name)) for f in dataclasses.fields(v))
        return v

    return {f.name: plain(getattr(s, f.name)) for f in dataclasses.fields(s)}


@pytest.mark.parametrize("name", ["minimal", "simple", "scene"])
def test_config_compiles_like_jax(monkeypatch, name):
    """The config at 48x63 gives the JAX package's scene (compiled field by
    field, both on the numpy builders), camera and settings. ``scene`` is
    the procedural Cornell box under the sun, the JAX package's
    FlightHelmet config without the asset."""
    import hikari_tpu.scene.native as native
    from hikari_tpu.io import scenes as jscenes
    from hikari_tpu.scene.compile import compile_scene as jcompile
    from hikari_tpu_torch.io import scenes as tscenes
    from hikari_tpu_torch.scene.compile import compile_scene as tcompile

    monkeypatch.setattr(native, "get_builder", lambda: None)
    jscene, jcam, js = jscenes.CONFIGS[name](63, 48)
    tscene, tcam, ts = tscenes.CONFIGS[name](63, 48, device="cpu")
    want, got = jcompile(jscene), tcompile(tscene, "numpy")
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), err_msg=f.name)
    np.testing.assert_array_equal(tcam.world_from_view.numpy(), np.asarray(jcam.world_from_view))
    assert _settings_fields(ts) == _settings_fields(js)


def test_scene_config_with_asset_raises(tmp_path):
    """With the FlightHelmet glTF present, ``scene_config`` loads it (a
    small textured glTF written into ``tmp_path``); an incomplete asset
    (a glTF without its scene) falls back to the procedural stand-in, as
    the JAX package's ``gltf_scene`` does on ``KeyError``."""
    from hikari_tpu_torch.io import scenes
    from hikari_tpu_torch.io.gltf import write_textured_demo

    write_textured_demo(str(tmp_path / scenes.FLIGHT_HELMET))
    scene, _, settings = scenes.scene_config(device="cpu", assets=str(tmp_path))
    assert len(scene.textures) == 4 and len(scene.instances) == 3
    assert settings.indirect_spatial_reuse and settings.emissive_spatial_reuse
    broken = tmp_path / "broken"
    (broken / scenes.FLIGHT_HELMET).parent.mkdir(parents=True)
    (broken / scenes.FLIGHT_HELMET).write_text("{}")
    stand_in, _, _ = scenes.scene_config(device="cpu", assets=str(broken))
    assert not stand_in.textures and len(stand_in.instances) == 8


def test_render_entry_point(tmp_path):
    """``examples/render`` on the CPU: 2 frames at 24x24 into a finite,
    lit PNG; ``--stream`` streams the instances in (instance 0 first, all
    of cornell's 8 over 3 frames, 4 a frame) into a finite image."""
    from hikari_tpu_torch.examples import render

    out = tmp_path / "cornell.png"
    res = render.main(["cornell", "--frames", "2", "--size", "24", "--cpu", "--out", str(out)])
    img = timage.read_png(str(out))
    assert img.shape == (24, 24, 3) and np.isfinite(res["image"]).all()
    assert img.mean() > 0.0 and len(res["frame_seconds"]) == 2
    res = render.main(["cornell", "--frames", "3", "--size", "24", "--cpu", "--stream", "--out",
                       str(tmp_path / "stream.png")])
    assert [m.sum() for m in res["masks"]] == [5, 8, 8] and np.isfinite(res["image"]).all()


def test_dissect_entry_point(tmp_path):
    """``examples/dissect`` on the CPU: the eight pass PNGs of 2 frames at
    30x30, each finite."""
    from hikari_tpu_torch.examples import dissect

    res = dissect.main(["cornell", "--frames", "2", "--size", "30", "--cpu",
                        "--out-dir", str(tmp_path)])
    written = res["images"]
    assert len(res["frame_seconds"]) == 2
    assert sorted(written) == sorted(["albedo", "direct", "emissive", "indirect", "tone-mapping",
                                      "render", "depth", "normal"])
    for path, img in written.values():
        assert np.isfinite(img).all()
        assert timage.read_png(path).shape == (30, 30, 3)
