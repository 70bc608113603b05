"""Gradient tests of the port alone (the patterns of ``tests/test_diff.py``)
on cornell at 24x24 on the CPU: finite, nonzero gradients through the full
pipeline, light and vertex gradients, emissive AD against central finite
differences on the smooth path, the firewall's bias, the
``spatial_radiance_grads`` switch and the clip-engagement counter; then the
train step's contract, the port bench's ray accounting against
``bench.py``'s and the ``examples/train.py`` port.

``test_diff.py::test_base_color_grads_match_fd`` has no counterpart here:
its finite differences at eps 3e-3 step across discrete ReSTIR decisions
and it fails in the JAX package itself (ROADMAP.md section 3); AD against
AD is the port's gate (``test_torch_grad_*.py``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hikari_tpu_torch import diff
from hikari_tpu_torch.config import RenderSettings, Taa, Upscale
from hikari_tpu_torch.diff import finite_difference_grad, replace_scene_field
from hikari_tpu_torch.io.scenes import cornell_config
from hikari_tpu_torch.parallel import DIFF_LEAVES, make_train_step
from hikari_tpu_torch.render import initial_state, render_frame
from hikari_tpu_torch.scene import build_scene_buffers
from hikari_tpu_torch.utils import map_tensors

torch.set_num_threads(2)


def _settings(**kw):
    return RenderSettings(**{**dict(width=24, height=24, upscale=Upscale.none(), taa=Taa.NONE,
                                    indirect_bounces=1), **kw})


@pytest.fixture(scope="module")
def setup():
    """Spatial reuse off and f32 reservoirs, as ``test_diff.py``'s setup:
    the fully differentiable temporal path."""
    scene, cam, _ = cornell_config(size=24, device="cpu")
    settings = _settings(denoise=True, indirect_spatial_reuse=False, emissive_spatial_reuse=False,
                         reservoir_f16=False)
    return build_scene_buffers(scene, "cpu"), cam, initial_state(settings, "cpu"), settings


def _loss_fn(buffers, cam, state, settings, field):
    def f(value):
        out, _ = render_frame(replace_scene_field(buffers, **{field: value}), cam, state, settings)
        return torch.mean(out.image[..., :3])

    return f


def _grad(f, x0):
    x = x0.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(x), x)
    return g.numpy()


def test_full_pipeline_grads_finite(setup):
    """Spatial reuse and denoise on: finite and nonzero where FD is not
    meaningful."""
    buffers, cam, _, _ = setup
    settings = _settings(denoise=True)
    state = initial_state(settings, "cpu")
    for field in ["mat_emissive", "mat_base_color"]:
        g = _grad(_loss_fn(buffers, cam, state, settings, field), getattr(buffers, field))
        assert np.isfinite(g).all(), field
        assert np.abs(g).sum() > 0, field


def test_light_grads(setup):
    buffers, cam, state, settings = setup
    g = _grad(_loss_fn(buffers, cam, state, settings, "ambient_color"), buffers.ambient_color)
    assert np.isfinite(g).all()
    assert (g != 0).any()


def test_vertex_grads_nonzero(setup):
    """Fixed-topology gradients flow through the hit refinement."""
    buffers, cam, state, settings = setup
    g = _grad(_loss_fn(buffers, cam, state, settings, "tri_world"), buffers.tri_world)
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0


def test_emissive_grads_match_fd(setup):
    """FD on the continuous emissive path: with the emissive channel and
    the bounces off, the image depends on mat_emissive only through the
    surface self-emission, which is smooth; off the tonemapper's 0.0039
    floor (emissive + 0.001)."""
    buffers, cam, _, _ = setup
    settings = _settings(denoise=False, indirect_bounces=0, emissive_lit=False,
                         temporal_reuse=False)
    state = initial_state(settings, "cpu")
    f = _loss_fn(buffers, cam, state, settings, "mat_emissive")
    x0 = buffers.mat_emissive + torch.tensor([0.001, 0.001, 0.001, 0.0])
    g = _grad(f, x0)
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0
    flat_idx = np.argsort(-np.abs(g).reshape(-1))[:3]
    with torch.no_grad():
        fd = finite_difference_grad(lambda x: f(torch.from_numpy(x)), x0.numpy(), eps=1e-4,
                                    indices=flat_idx)
    for i in flat_idx:
        a, b = g.reshape(-1)[i], fd.reshape(-1)[i]
        assert b == pytest.approx(a, rel=0.15, abs=1e-4), (i, a, b)


def test_firewall_bias_quantified(setup, monkeypatch):
    """The pass-boundary firewall's clipping bias against exact gradients
    (HIKARI_NO_GRAD_CLIP=1): < 1% relative on the material gradients."""
    buffers, cam, state, settings = setup
    f = _loss_fn(buffers, cam, state, settings, "mat_base_color")
    g_clip = _grad(f, buffers.mat_base_color)
    monkeypatch.setenv("HIKARI_NO_GRAD_CLIP", "1")
    g_exact = _grad(f, buffers.mat_base_color)
    assert np.isfinite(g_clip).all()
    assert np.isfinite(g_exact).all(), "exact grads non-finite; firewall load-bearing"
    rel = np.abs(g_clip - g_exact).max() / max(np.abs(g_exact).max(), 1e-12)
    assert rel < 1e-2, f"firewall bias {rel:.3e} exceeds 1% bound"


def test_spatial_radiance_grads_flag():
    """``spatial_radiance_grads`` keeps reservoir radiance attached through
    the spatial-reuse merge: the emissive gradient stays finite and changes
    against the detached policy."""
    scene, cam, _ = cornell_config(size=24, device="cpu")
    base = _settings(denoise=False, indirect_spatial_reuse=True, emissive_spatial_reuse=True,
                     reservoir_f16=False)
    buffers = build_scene_buffers(scene, "cpu")
    state = initial_state(base, "cpu")
    with torch.no_grad():  # two frames so the spatial reservoirs carry samples
        for _ in range(2):
            _, state = render_frame(buffers, cam, state, base)

    def grad_for(settings):
        return _grad(_loss_fn(buffers, cam, state, settings, "mat_emissive"), buffers.mat_emissive)

    g_detached = grad_for(base)
    g_attached = grad_for(base.replace(spatial_radiance_grads=True))
    assert np.isfinite(g_detached).all() and np.isfinite(g_attached).all()
    assert np.abs(g_attached).sum() > 0
    assert not np.allclose(g_attached, g_detached)


def test_clip_engagement_counter(monkeypatch):
    """HIKARI_COUNT_CLIP=1 counts per site, in the backward, the cotangents
    the clamp engages; counts add up over backwards until a reset."""
    monkeypatch.setenv("HIKARI_COUNT_CLIP", "1")
    diff.reset_clip_engagement()
    x = torch.arange(4.0, requires_grad=True)

    def g():
        return torch.autograd.grad(torch.sum(diff.clip_gradient(x**2, 1e4, "test_site") * 1e9), x)[0]

    grad = g()
    engaged, total, rate = diff.clip_engagement_report()["test_site"]
    assert (engaged, total, rate) == (4, 4, 1.0)  # every cotangent is 1e9 > 1e4
    assert float(grad.abs().max()) <= 1e4 * 2 * 3 + 1e-3  # the clip still applies
    g()
    assert diff.clip_engagement_report()["test_site"][:2] == (8, 8)
    diff.reset_clip_engagement()
    assert diff.clip_engagement_report() == {}


def test_train_step_detaches_outputs(setup):
    """``make_train_step`` returns a detached loss, outputs and next state
    (no graph is carried into the next frame) and a gradient tensor of the
    field's shape for every leaf."""
    buffers, cam, state, settings = setup
    step = make_train_step(settings)
    loss, grads, out, new_state = step(buffers, cam, state, torch.zeros(24, 24, 3))
    attached = []
    map_tensors(lambda t: attached.append(t) if t.requires_grad or t.grad_fn else t,
                (loss, out, new_state))
    assert not attached
    assert set(grads) == set(DIFF_LEAVES)
    for k in DIFF_LEAVES:
        assert grads[k].shape == getattr(buffers, k).shape and torch.isfinite(grads[k]).all(), k
    loss2, _, _, _ = step(buffers, cam, new_state, torch.zeros(24, 24, 3))
    assert new_state.frame_number == 1 and torch.isfinite(loss2)


def test_train_step_zeros_for_unread_leaf(setup, monkeypatch):
    """A leaf no path reads gets zeros, as ``jax.grad`` gives, not None."""
    from hikari_tpu_torch.parallel import sharding
    from hikari_tpu_torch.render.types import RenderOutputs

    buffers, cam, state, settings = setup

    def emissive_only(scene, camera, st, s):
        rgb = scene.mat_emissive[3, :3].expand(24, 24, 3)  # the light: emissive 1
        image = torch.cat([rgb, torch.ones(24, 24, 1)], dim=-1)
        return RenderOutputs(image=image, albedo=rgb, direct=rgb, emissive=rgb, indirect=rgb,
                             tonemapped=image), st

    monkeypatch.setattr(sharding, "render_frame", emissive_only)
    _, grads, _, _ = make_train_step(settings)(buffers, cam, state, torch.zeros(24, 24, 3))
    assert float(grads["mat_emissive"].abs().sum()) > 0
    for k in DIFF_LEAVES:
        if k != "mat_emissive":
            assert grads[k] is not None and not grads[k].any(), k


def test_sharded_step_raises(setup):
    """``make_train_step(sharded=True)`` without a mesh no longer raises: it
    is the JAX package's GSPMD step over its inputs' placement, here one
    rank's unsharded step under ``_xla_tracer``'s settings (``tracer="auto"``
    -> ``"auto_xla"``, which the port dispatches alike), so it gives the
    unsharded step's loss and gradients bit for bit. The sharded step with
    a mesh: ``tests/test_torch_parallel.py``."""
    buffers, cam, state, settings = setup
    target = torch.zeros(24, 24, 3)
    got = make_train_step(settings, sharded=True)(buffers, cam, state, target)
    want = make_train_step(settings)(buffers, cam, state, target)
    assert torch.equal(got[0], want[0])
    for k in DIFF_LEAVES:
        assert torch.equal(got[1][k], want[1][k]), k


@pytest.mark.parametrize("config", ["cornell", "city"])
@pytest.mark.parametrize("num_emissives", [0, 1, 86])
def test_bench_rays_per_frame_matches(config, num_emissives, monkeypatch):
    """The port bench's settings and ray accounting are ``bench.py``'s:
    the same settings per config, the same rays per frame for a scene
    with that many emissive instances (the scene compile is stubbed on
    both sides: the accounting reads only ``num_emissives``)."""
    import dataclasses

    import bench
    import hikari_tpu.scene
    from hikari_tpu_torch import bench as tbench

    stub = SimpleNamespace(num_emissives=num_emissives)
    monkeypatch.setattr(hikari_tpu.scene, "build_scene_buffers", lambda scene: stub)
    _, _, js = bench.build_bench_case(config, 8)
    _, _, ts = tbench.bench_config(config, "cpu")

    def plain(s):
        return {f.name: getattr(getattr(s, f.name), "value", getattr(s, f.name))
                for f in dataclasses.fields(s) if f.name != "upscale"}

    assert plain(ts) == plain(js)
    assert (ts.upscale.mode.value, ts.upscale.ratio) == (js.upscale.mode.value, js.upscale.ratio)
    assert tbench.rays_per_frame(ts, stub) == bench.rays_per_frame(js, stub)


def test_train_example_lowers_loss():
    """``examples/train.py``'s port, 3 steps at 24 px on the CPU: the loss
    falls at every step."""
    from hikari_tpu_torch.examples.train import train

    losses, est, true = train(3, 24, 0.5, "cpu", log=lambda _: None)
    assert losses[2] < losses[1] < losses[0]
    assert np.abs(est - true).max() < np.abs(0.5 - true).max()


@pytest.mark.parametrize("accs, finite", [
    ((0.5, 0.5, 0.5), True),
    ((0.5, float("nan"), 0.5), False),  # a timed run
    ((float("inf"), 0.5, 0.5), False),  # the warm-up run
])
def test_bench_marks_non_finite_runs(accs, finite, monkeypatch, capsys):
    """The port bench reports whether every run's accumulator was finite,
    so that a time from a run with non-finite gradients is marked."""
    from hikari_tpu_torch import bench as tbench

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    runs = iter(accs)
    best, got = tbench.time_case(lambda: (torch.tensor(next(runs)), None), (), 2, "stub")
    assert got is finite and best >= 0.0
    assert capsys.readouterr().err.count("# stub rep") == 2
