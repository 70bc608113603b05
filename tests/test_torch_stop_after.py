"""``RenderSettings.stop_after`` in the port (``render/stops.py``): every
stop point of the JAX package on the port alone — the cut frame's outputs
are (4, 4, 4) images holding one finite sum, the input state comes back
with its frame number advanced, and the coarse prefix sums add up the
leaves the JAX ``_truncate`` names (each later coarse cut adds the next
pass's outputs to the earlier cut's sum) — a string that is no stop point
raises, and four stop points against the JAX package, one compile each;
and ``tools/profile_prefix`` on the CPU, forward and fwd+grad.

Tolerances: the prefix identities within 1e-5 relative (float32 sums of
the same values in another order); the JAX parity within 1e-4 relative:
the cut sums run over tens of thousands of values of which a few
(reservoir choices, exact-boundary rays) may differ by float32 rounding.
"""

import numpy as np
import pytest
import torch

import hikari_tpu.config as jc
import hikari_tpu_torch.config as tc
from hikari_tpu_torch.render.stops import STOP_POINTS, prefix_sum

torch.set_num_threads(2)


def _settings(mod, w, h, **kw):
    """The bench frame's options at a small size (SMAA TU4x at 2, TAA,
    denoise, one bounce, both spatial reuses off but the indirect one)."""
    base = dict(
        width=w, height=h, upscale=mod.Upscale.smaa_tu4x(2.0), taa=mod.Taa.JASMINE, denoise=True,
        indirect_bounces=1, emissive_lit=True, reservoir_f16=True, reproject="shift", remat=False,
        clear_color=(0.0, 0.0, 0.0, 1.0),
    )
    return mod.RenderSettings(**{**base, **kw})


@pytest.fixture(scope="module")
def port():
    from hikari_tpu_torch.io.scenes import cornell_config
    from hikari_tpu_torch.render.pipeline import initial_state, render_frame
    from hikari_tpu_torch.scene import build_scene_buffers

    scene, cam, _ = cornell_config(device="cpu")
    buffers = build_scene_buffers(scene, "cpu")
    settings = _settings(tc, 32, 24)
    state = initial_state(settings, "cpu")
    with torch.no_grad():
        for _ in range(2):  # reservoirs with history, frame 2 next
            _, state = render_frame(buffers, cam, state, settings)
        full, full_state = render_frame(buffers, cam, state, settings)

    def cut(stop):
        s = settings.replace(stop_after=stop)
        with torch.no_grad():
            return render_frame(buffers, cam, state, s)

    return dict(cut=cut, state=state, full=full, full_state=full_state)


@pytest.mark.parametrize("stop", STOP_POINTS)
def test_every_stop_point_cuts_the_frame(port, stop):
    out, new_state = port["cut"](stop)
    acc = out.image
    assert acc.shape == (4, 4, 4)
    assert bool(torch.isfinite(acc).all()) and bool((acc == acc[0, 0, 0]).all())
    for name in ("albedo", "direct", "emissive", "indirect", "tonemapped"):
        assert getattr(out, name) is acc
    assert out.stats is None
    state = port["state"]
    assert new_state.frame_number == state.frame_number + 1
    assert new_state.direct_temporal is state.direct_temporal  # carried as it came in
    assert new_state.prev_taa is state.prev_taa


def test_coarse_prefix_sums_grow_with_the_stage(port):
    """Each coarse cut sums the G-buffer, then the albedo, ..., as the JAX
    ``_truncate`` calls name them: the cut after the albedo is the cut
    after the G-buffer plus the albedo's sum, and so on, with the passes'
    values from the whole frame."""
    full, st = port["full"], port["full_state"]
    s = {k: float(port["cut"](k)[0].image[0, 0, 0]) for k in ("gbuffer", "albedo", "denoise",
                                                               "tonemap")}
    gb = float(prefix_sum(st.prev_gbuffer))
    lit = float(prefix_sum(full.direct, full.emissive, full.indirect))
    for got, want in (
        (s["gbuffer"], gb),
        (s["albedo"], gb + float(full.albedo.sum())),
        (s["denoise"], gb + float(full.albedo.sum()) + lit),
        (s["tonemap"], gb + float(full.albedo.sum()) + float(full.tonemapped.sum())),
    ):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert s["albedo"] > s["gbuffer"] and s["denoise"] > s["albedo"]


def test_unknown_stop_point_raises(port):
    with pytest.raises(ValueError, match="not a stop point"):
        port["cut"]("direct:shade")


PARITY = ["gbuffer:trace", "direct:candidate", "emissive:restir", "indirect:nee"]


@pytest.mark.parametrize("stop", PARITY)
def test_stop_point_matches_jax(stop):
    """The cut frame's sum against ``render_frame_jit`` from one state
    (frame 0), cornell at 48x63 without upscaling (odd width: the
    exact-boundary hazard of test_torch_pipeline.py)."""
    from hikari_tpu.io.scenes import cornell_config as j_cornell
    from hikari_tpu.render.pipeline import initial_state as j_init
    from hikari_tpu.render.pipeline import render_frame_jit as j_render
    from hikari_tpu.scene.buffers import to_device as j_dev
    from hikari_tpu.scene.compile import compile_scene
    from hikari_tpu_torch.io.scenes import cornell_config as t_cornell
    from hikari_tpu_torch.render.pipeline import render_frame as t_render
    from hikari_tpu_torch.scene.buffers import frame_state_from_numpy
    from hikari_tpu_torch.scene.buffers import to_device as t_dev

    scene, jcam, _ = j_cornell()
    arrays = compile_scene(scene)
    js, ts = (_settings(m, 63, 48, upscale=m.Upscale.none(), taa=m.Taa.NONE, stop_after=stop,
                        tracer="bruteforce") for m in (jc, tc))
    state = j_init(js)
    jout, jnext = j_render(j_dev(arrays), jcam, state, js)
    with torch.no_grad():
        tout, tnext = t_render(t_dev(arrays, "cpu"), t_cornell(device="cpu")[1],
                               frame_state_from_numpy(state, "cpu"), ts)
    want = np.asarray(jout.image)
    assert tout.image.shape == want.shape == (4, 4, 4)
    np.testing.assert_allclose(tout.image.numpy(), want, rtol=1e-4)
    assert tnext.frame_number == int(jnext.frame_number) == 1
    np.testing.assert_array_equal(tnext.direct_temporal.w_sum.numpy(),
                                  np.asarray(jnext.direct_temporal.w_sum))


@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "grad"])
def test_profile_prefix_tool_on_cpu(grad, capsys):
    """``tools/profile_prefix`` on the CPU at 16x16: one row per stage in
    order, the host deltas add up to the untruncated prefix (within 1e-9
    ms), no device time, one printed line per stage."""
    from hikari_tpu_torch.tools import profile_prefix

    argv = ["--cpu", "--size", "16", "--frames", "2", "--stages", "gbuffer,denoise,FULL"]
    res = profile_prefix.main(argv + (["--grad"] if grad else []))
    rows = res["rows"]
    assert [r["stage"] for r in rows] == ["gbuffer", "denoise", "FULL"]
    assert all(len(r["samples"]) == 1 and r["samples"][0] > 0.0 for r in rows)
    assert abs(sum(r["delta_ms"] for r in rows) - rows[-1]["ms"]) <= 1e-9
    assert res["device_again"] is None and all(r["device_ms"] is None for r in rows)
    assert len(res["full_again"]) == 1
    mode = "grad" if grad else "fwd"
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(f"{mode} after")]
    assert len(lines) == 3
