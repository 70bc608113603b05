"""The spatial reuse's tap kernel (``csrc/spatial_reuse.cu``) against its
plain twin (``render/spatial.spatial_taps_reference``).

On the CPU: the by-value tap table the kernel takes holds exactly the
offsets and march offsets the rolled loop builds, for every tap and
variant, both channels and eight frame phases; the wrapper runs the twin
for CPU tensors and raises, without a launch, on what the kernel does not
take; ``recording`` hands back the calls of a frame's passes. On the
card (``-m cuda``), from real frames of the benchmark cell's settings
(``hikari_bench/configs/cornell_tu4x_1080p.json``, 1920x1080 from
960x540): every output field and the winner bit for bit, in both channels
and in a 2-block sharded frame; the fwd+grad step's loss, state and
gradients; one launch and 96 fewer host syncs a frame, none outside
``host_read``. No JAX."""

import copy
import ctypes
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from hikari_bench import scenes
from hikari_tpu_torch.config import (
    GOLDEN_RATIO,
    SPATIAL_REUSE_COUNT_DIRECT,
    SPATIAL_REUSE_COUNT_EMISSIVE,
    SPATIAL_REUSE_RANGE_DIRECT,
    SPATIAL_REUSE_RANGE_EMISSIVE,
    SPATIAL_REUSE_TAPS,
)
from hikari_tpu_torch.parallel import DIFF_LEAVES, make_train_step
from hikari_tpu_torch.render import initial_state, render_frame, spatial
from hikari_tpu_torch.render.camera import Camera
from hikari_tpu_torch.render.pipeline import noise_bank_on
from hikari_tpu_torch.render.restir import Reservoir, Sample
from hikari_tpu_torch.scene import build_scene_buffers
from hikari_tpu_torch.utils import TAU, map_tensors, random_float, same_bits
from hikari_tpu_torch.utils import profiling

CONFIG = Path(__file__).resolve().parents[1] / "hikari_bench/configs/cornell_tu4x_1080p.json"
CHANNELS = [(False, SPATIAL_REUSE_COUNT_DIRECT, SPATIAL_REUSE_RANGE_DIRECT),
            (True, SPATIAL_REUSE_COUNT_EMISSIVE, SPATIAL_REUSE_RANGE_EMISSIVE)]
FRAME_NUMBERS = [0, 1, 2, 5, 17, 64, 1000, 3141601711]
# A Reservoir's tensors in ``map_tensors`` order.
FIELDS = ["s.radiance", "s.random", "s.visible_position", "s.visible_normal",
          "s.visible_instance", "s.sample_position", "s.sample_normal", "count", "lifetime", "w",
          "w_sum", "w2_sum"]
_f32 = np.float32

torch.set_num_threads(2)


def leaves(tree):
    out = []
    map_tensors(out.append, tree)
    return out


# ---------------------------------------------------------------------------
# 1. The tap table (CPU)
# ---------------------------------------------------------------------------


def rolled_tables(i, K, reuse_count, reuse_range, frame_phase):
    """Tap i's offset and march tables as the rolled loop built them
    before the kernel (its own float32 arithmetic, written out here)."""
    radius = np.sqrt(_f32(i) / _f32(reuse_count)) * _f32(reuse_range)
    interval = max(_f32(1.0), radius / _f32(SPATIAL_REUSE_TAPS + 1))
    tap_count = int(radius / interval)
    offs, march = [], []
    for k in range(K):
        a = _f32(i) * _f32(GOLDEN_RATIO) + (_f32(k) + _f32(frame_phase)) / _f32(K)
        ang = _f32(TAU) * (a - np.floor(a))
        ox, oy = radius * np.cos(ang), radius * np.sin(ang)
        offs.append((int(np.floor(oy)), int(np.floor(ox))))
        taps = []
        for j in range(1, min(tap_count, SPATIAL_REUSE_TAPS + 1) + 1):
            f = interval * _f32(j) / max(radius, _f32(1e-8))
            taps.append((int(np.floor(oy * f)), int(np.floor(ox * f))))
        march.append(taps)
    fracs = [float(_f32(j) / (_f32(tap_count) + _f32(1.0))) for j in range(1, len(march[0]) + 1)]
    return offs, march, fracs


@pytest.mark.parametrize("frame_number", FRAME_NUMBERS)
@pytest.mark.parametrize("emissive,reuse_count,reuse_range", CHANNELS, ids=["indirect", "emissive"])
def test_tap_table_packs_the_rolled_offsets(emissive, reuse_count, reuse_range, frame_number):
    K = 4
    phase = float(random_float(frame_number))
    table = spatial.pack_spiral(spatial.Spiral(reuse_count, reuse_range, K, phase), emissive)
    assert ctypes.sizeof(table) < 4096
    assert (table.taps, table.variants, table.emissive) == (reuse_count, K, int(emissive))
    for i in range(1, reuse_count + 1):
        offs, march, fracs = rolled_tables(i, K, reuse_count, reuse_range, phase)
        t = i - 1
        assert table.march_count[t] == len(march[0]) == len(fracs)
        assert [table.march_frac[t][j] for j in range(len(fracs))] == fracs
        for k in range(K):
            assert (table.offset[t][k][0], table.offset[t][k][1]) == offs[k], (i, k)
            got = [(table.march[t][k][j][0], table.march[t][k][j][1])
                   for j in range(table.march_count[t])]
            assert got == march[k], (i, k)


def test_tap_table_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError, match="variants"):
        spatial.pack_spiral(spatial.Spiral(16, 20.0, spatial.MAX_VARIANTS + 1, 0.5), False)
    with pytest.raises(ValueError, match="taps"):
        spatial.pack_spiral(spatial.Spiral(spatial.MAX_TAPS + 1, 20.0, 4, 0.5), False)


# ---------------------------------------------------------------------------
# 2. The wrapper (CPU)
# ---------------------------------------------------------------------------


def _random_call(device="cpu", lh=12, lw=16, seed=0):
    """A seeded call of the tap loop on a whole (unsharded) image: random
    reservoirs on a floor of equal depth, so taps pass the rejections."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(device)

    def reservoir():
        up = torch.zeros(lh, lw, 3)
        up[..., 1] = 1.0
        pos = torch.cat([u(lh, lw, 3, lo=-1, hi=1), torch.full((lh, lw, 1), 2.0)], -1)
        return Reservoir(
            s=Sample(radiance=u(lh, lw, 4), random=u(lh, lw, 4), visible_position=pos.to(device),
                     visible_normal=up.to(device),
                     visible_instance=torch.arange(lh * lw, dtype=torch.int32).reshape(lh, lw)
                     .to(device),
                     sample_position=torch.cat([u(lh, lw, 3, lo=-1, hi=1) + torch.tensor(
                         [0.0, 2.0, 0.0]).to(device), (u(lh, lw, 1) > 0.3).float()], -1),
                     sample_normal=-up.to(device)),
            count=u(lh, lw, hi=5), lifetime=u(lh, lw, hi=9), w=u(lh, lw), w_sum=u(lh, lw),
            w2_sum=u(lh, lw))

    r, grid = reservoir(), reservoir()
    depth = torch.full((lh, lw), 2.0, device=device)
    variant = (u(lh, lw) * 4).to(torch.int32).clamp(max=3)
    spiral = spatial.Spiral(8, 10.0, 4, 0.37)
    return dict(r=r, s=grid.s, depth=depth, variant=variant, grid=grid, grid_depth=depth,
                spiral=spiral, shade=None, origin=(0, 0))


def test_wrapper_runs_the_twin_on_the_cpu():
    """CPU tensors: the twin's result, taps taken, no launch."""
    call = _random_call()
    launches = spatial.launches
    got, winner = spatial.spatial_taps(**call)
    want, want_winner = spatial.spatial_taps_reference(**call)
    assert spatial.launches == launches
    assert torch.equal(winner, want_winner) and int((winner >= 0).sum()) > 0
    assert all(same_bits(a, b) for a, b in zip(leaves(got), leaves(want)))


def test_wrapper_raises_off_the_cpu_without_a_twin(monkeypatch):
    """On a device other than the CPU the wrapper never runs the twin: a
    non-contiguous plane or a wrong dtype raises before any launch, and a
    device without the kernel raises NotImplementedError."""

    def fail(*args, **kwargs):
        raise AssertionError("the twin ran on a device that is not the CPU")

    monkeypatch.setattr(spatial, "spatial_taps_reference", fail)
    launches = spatial.launches
    call = map_tensors(lambda t: t.to("meta"), _random_call())
    with pytest.raises(NotImplementedError, match="spatial_taps"):
        spatial.spatial_taps(**call)
    strided = torch.empty((12, 16, 8), device="meta")[..., :4]
    bad = dict(call, r=replace(call["r"], s=replace(call["r"].s, radiance=strided)))
    with pytest.raises(ValueError, match="r.radiance must be contiguous"):
        spatial.spatial_taps(**bad)
    with pytest.raises(TypeError, match="variant must be torch.int32"):
        spatial.spatial_taps(**dict(call, variant=call["variant"].to(torch.int64)))
    with pytest.raises(ValueError, match="outside"):
        spatial.spatial_taps(**dict(call, origin=(1, 0)))
    assert spatial.launches == launches


def test_recording_replays_the_passes_calls():
    """``recording`` hands back every call of a frame's two spatial passes
    (indirect 16 taps, emissive 8) by argument name, ready to replay
    through the wrapper; on the CPU no pass counts in ``passes`` and
    nothing launches; the wrapper is restored after."""
    buffers, camera, s = cell("cpu", 48, 32, emissive_spatial_reuse=True)
    state = initial_state(s, "cpu")
    passes, launches, real = spatial.passes, spatial.launches, spatial.spatial_taps
    with spatial.recording() as calls, torch.no_grad():
        for _ in range(2):
            _, state = render_frame(buffers, camera, state, s)
    assert spatial.spatial_taps is real
    assert (spatial.passes, spatial.launches) == (passes, launches)
    assert [(c["spiral"].count, c["shade"] is None) for c in calls] == [(8, True), (16, False)] * 2
    assert all(list(c) == list(spatial.TAP_ARGS) for c in calls)
    got, winner = spatial.spatial_taps(**calls[-1])
    want, want_winner = spatial.spatial_taps_reference(**calls[-1])
    assert torch.equal(winner, want_winner)
    assert all(same_bits(a, b) for a, b in zip(leaves(got), leaves(want)))


# ---------------------------------------------------------------------------
# 3. The kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the spatial kernel has no CPU mode")
    return torch.device("cuda", 0)


def cell(device, width=1920, height=1080, **settings):
    """(buffers, camera, settings) of the cell's configuration at a size."""
    config = copy.deepcopy(json.loads(CONFIG.read_text()))
    config["settings"].update(width=width, height=height, **settings)
    scene, camera, s = scenes.build(config, "hikari_tpu_torch", device)
    noise_bank_on(device)
    return build_scene_buffers(scene, device), camera, s


def moved_camera(device):
    """The cell's camera moved a little, its previous pose the cell's."""
    return Camera.from_lookat(eye=(0.3, 1.1, 3.8), target=(0.05, 1.0, 0.0), prev_eye=(0.0, 1.0, 4.0),
                              prev_target=(0.0, 1.0, 0.0), device=device)


@pytest.fixture(scope="module")
def recorded(card):
    """The tap loop's calls of real frames (both channels: emissive spatial
    reuse on): frames 0, 1 and 5 under the fixed camera, then frame 6 from a
    moved pose. {(label, emissive): call kwargs}."""
    buffers, camera, s = cell(card, emissive_spatial_reuse=True)
    state = initial_state(s, card)
    labels = {0: "frame 0", 1: "frame 1", 5: "frame 5", 6: "frame 6 moved"}
    out = {}
    with spatial.recording() as calls, torch.no_grad():
        for f in range(7):
            first = len(calls)
            cam = moved_camera(card) if f == 6 else camera
            _, state = render_frame(buffers, cam, state, s)
            for call in calls[first:] if f in labels else []:
                out[(labels[f], call["shade"] is None)] = call
    return out


def differing(got, want):
    """{field: pixels that differ in any bit}, for the reservoirs and the
    winners (got, want: (reservoir, winner))."""
    out = {}
    for name, a, b in zip(FIELDS + ["winner"], leaves(got[0]) + [got[1]],
                          leaves(want[0]) + [want[1]]):
        if same_bits(a, b):
            continue
        if a.is_floating_point():
            diff = (a.view(torch.int32) != b.view(torch.int32)) & ~(a.isnan() & b.isnan())
        else:
            diff = a != b
        out[name] = int(diff.reshape(a.shape[0], a.shape[1], -1).any(-1).sum())
    return out


@pytest.mark.cuda
def test_kernel_matches_twin_bitwise_on_real_frames(recorded):
    """Every field and the winner, both channels (indirect 16 taps,
    emissive 8), frames 0, 1, 5 and a moved pose: bit for bit."""
    assert len(recorded) == 8
    off = {}
    for (label, emissive), call in sorted(recorded.items()):
        launches = spatial.launches
        got = spatial.spatial_taps(**call)
        want = spatial.spatial_taps_reference(**call)
        torch.cuda.synchronize()
        assert spatial.launches == launches + 1
        taken = int((got[1] >= 0).sum())
        channel = "emissive" if emissive else "indirect"
        print(f"{label} {channel}: {taken} pixels took a neighbour, differing {differing(got, want)}")
        assert taken > 0
        if differing(got, want):
            off[(label, channel)] = differing(got, want)
    assert not off, off


@pytest.mark.cuda
def test_kernel_serves_a_sharded_frame(recorded):
    """Two blocks of rows, origins (0, 0) and (270, 0), each reading the
    whole gathered grid: the unsharded call's rows, bit for bit (and the
    twin's under the same block)."""
    call = recorded[("frame 5", False)]
    whole = spatial.spatial_taps(**call)
    lh = call["depth"].shape[0] // 2
    for y0 in (0, lh):
        rows = slice(y0, y0 + lh)

        def take(x):
            return x[rows]

        block = dict(call, r=map_tensors(take, call["r"]), s=map_tensors(take, call["s"]),
                     depth=take(call["depth"]), variant=take(call["variant"]),
                     shade=spatial.Shade(take(call["shade"].view),
                                         map_tensors(take, call["shade"].surface),
                                         call["shade"].ambient_color),
                     origin=(y0, 0))
        got = spatial.spatial_taps(**block)
        assert not differing(got, map_tensors(take, whole)), y0
        assert not differing(got, spatial.spatial_taps_reference(**block)), y0


def _steps(card, grads, taps_fn, monkeypatch):
    buffers, camera, s = cell(card, 64, 48, spatial_radiance_grads=grads)
    monkeypatch.setattr(spatial, "spatial_taps", taps_fn)
    state = initial_state(s, card).replace(frame_number=3)
    step = make_train_step(s)
    out = []
    for _ in range(3):
        loss, g, _, state = step(buffers, camera, state, torch.full((48, 64, 3), 0.5, device=card))
        out.append((loss, g, state))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("grads", [False, True], ids=["detached", "radiance_grads"])
def test_train_step_gradients_match_twin(card, grads, monkeypatch):
    """fwd+grad of ``make_train_step`` at 64x48, three steps: the loss and
    the next state bit for bit, and every leaf's gradient as the twin's
    within ten times the twin's own run-to-run difference or a millionth
    of the gradient. The gradients cannot be held bit for bit: the
    backward's atomic adds (``index_add``) take any order, so two runs of
    the twin differ too (on an H100 up to ~1e-10 of gradients ~1e-3 and
    ~1e-7 of one ~0.4, and one pair of twin runs may agree exactly on a
    leaf where a third run does not, hence the floor). Detached, the loop
    takes no part in the backward; with ``spatial_radiance_grads`` both
    take the radiance under autograd with the one gather of the winner,
    so the two backward graphs are the same."""
    kernel = _steps(card, grads, spatial.spatial_taps, monkeypatch)
    plain = _steps(card, grads, spatial.spatial_taps_reference, monkeypatch)
    plain2 = _steps(card, grads, spatial.spatial_taps_reference, monkeypatch)
    for k, ((lk, gk, sk), (lp, gp, sp), (_, gp2, _)) in enumerate(zip(kernel, plain, plain2)):
        assert same_bits(lk, lp), (k, float(lk), float(lp))
        assert all(same_bits(a, b) for a, b in zip(leaves(sk), leaves(sp))), k
        for leaf in DIFF_LEAVES:
            own = float((gp2[leaf] - gp[leaf]).abs().max())
            scale = float(gp[leaf].abs().max())
            got = float((gk[leaf] - gp[leaf]).abs().max())
            print(f"step {k} {leaf}: kernel-twin {got:.3e}, twin-twin {own:.3e}, |g| {scale:.3e}")
            assert got <= max(10 * own, 1e-6 * scale), (k, leaf, got, own, scale)


@pytest.mark.cuda
def test_frame_launches_once_and_syncs_96_fewer(card, monkeypatch):
    """One ``render_frame`` at the cell's settings (indirect spatial reuse
    only): one pass and one launch, no sync outside ``host_read`` (sync
    debug mode "error"), and 96 host syncs fewer than the twin's frame (16
    taps x 6 tables)."""
    buffers, camera, s = cell(card)
    state = initial_state(s, card).replace(frame_number=5)
    with torch.no_grad():
        for _ in range(2):  # builds, uploads and caches: set-up
            _, state = render_frame(buffers, camera, state, s)
        torch.cuda.synchronize()
        launches, passes, syncs = spatial.launches, spatial.passes, profiling.host_syncs
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, kernel_state = render_frame(buffers, camera, state, s)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        kernel_syncs = profiling.host_syncs - syncs
        assert (spatial.launches, spatial.passes) == (launches + 1, passes + 1)
        monkeypatch.setattr(spatial, "spatial_taps", spatial.spatial_taps_reference)
        syncs = profiling.host_syncs
        _, plain_state = render_frame(buffers, camera, state, s)
        plain_syncs = profiling.host_syncs - syncs
        torch.cuda.synchronize()
    print(f"host syncs a frame: kernel {kernel_syncs}, twin {plain_syncs}")
    assert plain_syncs - kernel_syncs == 96
    assert torch.isfinite(out.image).all()
    assert all(same_bits(a, b) for a, b in zip(leaves(kernel_state), leaves(plain_state)))
