"""The port's fwd+grad train step against ``hikari_tpu``'s on cornell
without the post chain: ``hikari_tpu_torch.parallel.make_train_step``
against ``jax.jit(jax.value_and_grad(render_loss))`` over ``DIFF_LEAVES``
(target zeros), on the CPU, at frames 2 and 3, each from the JAX
package's state (``frame_state_from_numpy``). Cornell at 63x48 with
temporal reuse only (no spatial reuse), f32 reservoirs, denoise, no
upscale or TAA; both packages trace with ``"bruteforce"`` (the lowest
prim among equal t). ``test_torch_grad_bench.py`` runs the bench settings
with these helpers.

Tolerance: the loss within rtol 1e-5 and every leaf's gradient within a
relative L2 error ||g_port - g_jax|| / ||g_jax|| of 1e-5 (measured <=
1.2e-6). ``sun_color``'s gradient is ~1e-6 in norm in both packages
(cornell's sun is black), so it is held by an absolute bound,
||g_port - g_jax|| <= 1e-8.

Frames 0 and 1 are not compared (ROADMAP.md section 3): a reset
reservoir's variance w2_sum - w_sum^2 is exactly 0 in the port but an FMA
residual in XLA's CPU code, which the denoiser magnifies, and Halton point
0 puts frame 0's samples on pixel centres. Even widths are avoided: at 24
px the pixel centres lie on the box's 45-degree quad diagonals, where a
1-ulp difference decides hit or miss (gradients there differ by 1-10%).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu.config as jc
import hikari_tpu_torch.config as tc
from hikari_tpu.parallel.sharding import DIFF_LEAVES as J_LEAVES
from hikari_tpu.parallel.sharding import render_loss as j_render_loss
from hikari_tpu.render.pipeline import initial_state as j_init
from hikari_tpu.scene.buffers import to_device as j_dev
from hikari_tpu.scene.compile import compile_scene
from hikari_tpu_torch.parallel import DIFF_LEAVES, make_train_step
from hikari_tpu_torch.scene.buffers import frame_state_from_numpy
from hikari_tpu_torch.scene.buffers import to_device as t_dev

torch.set_num_threads(2)

TEMPORAL = dict(
    denoise=True, indirect_bounces=1, indirect_spatial_reuse=False, emissive_spatial_reuse=False,
    emissive_lit=True, reservoir_f16=False, reproject="shift", remat=False,
    clear_color=(0.0, 0.0, 0.0, 1.0),
)


def temporal_settings(mod, width, height, tracer):
    return mod.RenderSettings(width=width, height=height, upscale=mod.Upscale.none(),
                              taa=mod.Taa.NONE, tracer=tracer, **TEMPORAL)


def grad_world(arrays, jcam, tcam, js, ts, frames=(2, 3)):
    """Both packages' inputs and the JAX package's (loss, grads) at each of
    ``frames``. The JAX states come from its own train steps (the aux of
    ``value_and_grad``), so one compile serves the states and the
    gradients."""
    jb = j_dev(arrays)
    oh, ow = js.output_size
    target = jnp.zeros((oh, ow, 3), jnp.float32)

    def loss_fn(params, b, st):
        return j_render_loss(dataclasses.replace(b, **params), jcam, st, target, js)

    params = {k: getattr(jb, k) for k in J_LEAVES}
    states, want = [j_init(js)], {}
    # LLVM's expensive passes off: the bench settings' gradient compiles in
    # 48 s instead of 65 s on one CPU core, and its steps run as fast.
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(params, jb, states[0]).compile(
        compiler_options={"xla_llvm_disable_expensive_passes": True})
    for f in range(max(frames) + 1):
        (loss, (_, new_state)), grads = vg(params, jb, states[f])
        states.append(new_state)
        if f in frames:
            want[f] = (float(loss), {k: np.asarray(v) for k, v in grads.items()})
    return dict(tb=t_dev(arrays, "cpu"), tcam=tcam, ts=ts, states=states, want=want,
                target=torch.zeros((oh, ow, 3)))


def check_grads(w, frame, loss_rtol, leaf_rel, sun_abs=1e-8):
    """Port step at ``frame`` against the JAX (loss, grads); returns the
    relative L2 error of each leaf."""
    loss, grads, out, new_state = make_train_step(w["ts"])(
        w["tb"], w["tcam"], frame_state_from_numpy(w["states"][frame], "cpu"), w["target"])
    want_loss, want = w["want"][frame]
    assert out.image.grad_fn is None and new_state.prev_taa.grad_fn is None
    assert new_state.frame_number == frame + 1
    np.testing.assert_allclose(float(loss), want_loss, rtol=loss_rtol)
    errs = {}
    for k in DIFF_LEAVES:
        g, gw = grads[k].numpy().astype(np.float64), want[k].astype(np.float64)
        assert g.shape == gw.shape and np.isfinite(g).all(), k
        diff, norm = np.linalg.norm(g - gw), np.linalg.norm(gw)
        if k == "sun_color":
            # cornell's sun is black: ~1e-6 in both packages, an absolute bound.
            assert diff <= sun_abs, (k, norm, diff)
            continue
        errs[k] = diff / norm
    bad = {k: e for k, e in errs.items() if not e <= leaf_rel}
    assert not bad, (frame, bad, errs)
    print(f"frame {frame}: loss {float(loss)} vs {want_loss}; relative L2 {errs}")
    return errs


@pytest.fixture(scope="module")
def cornell():
    from hikari_tpu.io.scenes import cornell_config as j_cornell
    from hikari_tpu_torch.io.scenes import cornell_config as t_cornell

    scene, jcam, _ = j_cornell()
    return grad_world(compile_scene(scene), jcam, t_cornell(device="cpu")[1],
                      temporal_settings(jc, 63, 48, "bruteforce"),
                      temporal_settings(tc, 63, 48, "bruteforce"))


@pytest.mark.parametrize("frame", [2, 3])
def test_cornell_train_step_matches_jax(cornell, frame):
    check_grads(cornell, frame, loss_rtol=1e-5, leaf_rel=1e-5)
