"""Pass-level remat in the port (``settings.remat``, ``settings.channel_remat``:
``render/pipeline.py`` ``_pass``, ``render/light.py``, ``trace/api.py``
``remat``/``trace_tape``), the counterpart of the JAX package's
``jax.checkpoint`` around each pass (``hikari_tpu/render/pipeline.py:110-121``)
and around the direct/emissive channels' taken branch
(``hikari_tpu/render/light.py:599-610``).

Two fwd+grad steps (frames 0 and 1: the direct channel's validation branch,
then its sampling branch) of cornell at 64x48 output with the bench
settings and both spatial reuses on, so every wrapped pass runs, from one
state: with ``remat=True`` and with ``channel_remat=True`` against
``remat=False``. The loss, every leaf's gradient and the next state are
equal bit for bit on the CPU: the rerun in the backward computes the
forward's values (the port draws no torch random numbers, and the trace
hits are replayed), and the backward runs the same autograd graph. The
search is called in the forward only: its twin is counted between each
step's forward end and its return, and must be 0 there."""

import pytest
import torch

from hikari_tpu_torch.bench import bench_config
from hikari_tpu_torch.parallel import DIFF_LEAVES, make_train_step, sharding
from hikari_tpu_torch.render.pipeline import initial_state, render_frame
from hikari_tpu_torch.scene import build_scene_buffers
from hikari_tpu_torch.trace import api as tapi
from hikari_tpu_torch.utils import map_tensors, same_bits

torch.set_num_threads(2)

W, H = 64, 48


@pytest.fixture(scope="module")
def world():
    scene, cam, settings = bench_config("cornell", "cpu")
    settings = settings.replace(width=W, height=H, emissive_spatial_reuse=True)
    return build_scene_buffers(scene, "cpu"), cam, settings


def _steps(world, monkeypatch, **flags):
    """Two train steps under ``flags``; returns per step (loss, grads, next
    state), the search calls (forward, backward) of each step and the hits
    replayed from a tape."""
    buffers, cam, settings = world
    settings = settings.replace(**flags)
    calls, replayed = [0], [0]
    real_hit, real_loss, real_replay = tapi.closest_hit, sharding.render_loss, tapi._replayed_hit

    def counted_replay():
        hit = real_replay()
        replayed[0] += hit is not None
        return hit

    def counted_hit(*args):
        calls[0] += 1
        return real_hit(*args)

    fwd_end = []

    def marked_loss(*args):
        res = real_loss(*args)
        fwd_end.append(calls[0])
        return res

    monkeypatch.setattr(tapi, "closest_hit", counted_hit)
    monkeypatch.setattr(tapi, "_replayed_hit", counted_replay)
    monkeypatch.setattr(sharding, "render_loss", marked_loss)
    step = make_train_step(settings)
    state = initial_state(settings, "cpu")
    target = torch.full((H, W, 3), 0.25)
    out, counts = [], []
    for _ in range(2):
        start = calls[0]
        loss, grads, _, state = step(buffers, cam, state, target)
        counts.append((fwd_end[-1] - start, calls[0] - fwd_end[-1]))
        out.append((loss, grads, state))
    monkeypatch.undo()
    return out, counts, replayed[0]


@pytest.fixture(scope="module")
def baseline(world):
    mp = pytest.MonkeyPatch()
    try:
        return _steps(world, mp, remat=False)[:2]
    finally:
        mp.undo()


def _assert_equal(got, want):
    for (loss, grads, state), (loss0, grads0, state0) in zip(got, want):
        assert same_bits(loss, loss0)
        for k in DIFF_LEAVES:
            assert same_bits(grads[k], grads0[k]), k
        flat, flat0 = [], []
        map_tensors(flat.append, state)
        map_tensors(flat0.append, state0)
        assert len(flat) == len(flat0) and all(same_bits(a, b) for a, b in zip(flat, flat0))


@pytest.mark.parametrize("flags", [dict(remat=True), dict(remat=False, channel_remat=True),
                                   dict(remat=True, channel_remat=True)],
                         ids=["remat", "channel_remat", "both"])
def test_remat_equals_no_remat(world, baseline, monkeypatch, flags):
    got, counts, replayed = _steps(world, monkeypatch, **flags)
    assert replayed > 0  # the backward reran passes and replayed their hits
    _assert_equal(got, baseline[0])
    assert counts == baseline[1]
    assert all(f > 0 and b == 0 for f, b in counts), counts
    assert float(got[0][1]["mat_base_color"].abs().sum()) > 0


def test_no_grad_frame_skips_remat(world, monkeypatch):
    """Without grad (a viewer's frame) the remat flag changes nothing and
    nothing is checkpointed."""
    buffers, cam, settings = world
    ran = []
    monkeypatch.setattr("torch.utils.checkpoint.checkpoint",
                        lambda *a, **k: ran.append(1))
    outs = []
    for remat in (True, False):
        s = settings.replace(remat=remat, channel_remat=remat)
        with torch.no_grad():
            out, _ = render_frame(buffers, cam, initial_state(s, "cpu"), s)
        outs.append(out.image)
    assert not ran and same_bits(outs[0], outs[1])


def test_replay_raises_past_the_tape():
    """A replaying run that traces more often than its first run raises."""
    tape = tapi.TraceTape()
    with tapi.trace_tape(tape):
        pass
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    scene = object()
    with tapi.trace_tape(tape), pytest.raises(RuntimeError, match="remat replay"):
        tapi.trace_rays(scene, o, d)
