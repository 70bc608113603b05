"""The port's profiler ranges inside the frame, at the settings of the
benchmark's cell ``cornell1080_view`` (``hikari_bench/configs/
cornell_tu4x_1080p.json``) cut to 64x48 on the CPU: ``render_frame``
around each frame, one ``pass:<name>`` range a pass that ran, in frame
order, covering every leaf ATen op of the frame; ``trace_rays`` around
each search; ``host_sync:<site>`` around each blocking read, counted in
``utils.profiling.host_syncs``; and results bitwise equal with the
profiler on and off. No JAX: the card runs the ``cuda`` case here."""

import bisect
import copy
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hikari_bench import profiling as bench_profiling
from hikari_bench import scenes, spans
from hikari_tpu_torch.render import initial_state, render_frame
from hikari_tpu_torch.render.pipeline import noise_bank_on
from hikari_tpu_torch.scene import build_scene_buffers
from hikari_tpu_torch.trace import api as trace_api
from hikari_tpu_torch.trace import closest_hit as closest_hit_mod
from hikari_tpu_torch.utils import map_tensors
from hikari_tpu_torch.utils import profiling

CONFIG = Path(__file__).resolve().parents[1] / "hikari_bench/configs/cornell_tu4x_1080p.json"
PASSES = ["unpack", "prepass", "albedo", "direct_lit", "emissive_lit", "emissive_spatial",
          "indirect_lit", "indirect_spatial", "denoise", "tonemap", "smaa", "taa", "overlay",
          "pack"]
FRAMES = 2

torch.set_num_threads(2)


def cell(device, width=64, height=48, **settings):
    """(buffers, camera, settings) of the cell's configuration at a size,
    with the blue-noise bank uploaded (once a process: set-up, outside any
    frame's passes)."""
    config = copy.deepcopy(json.loads(CONFIG.read_text()))
    config["settings"].update(width=width, height=height, **settings)
    scene, camera, s = scenes.build(config, "hikari_tpu_torch", device)
    noise_bank_on(device)
    return build_scene_buffers(scene, device), camera, s


def profiled_frames(emissive_spatial: bool, frames: int = FRAMES, **settings):
    """Host event records of ``frames`` frames under ``torch.profiler``,
    each frame inside the benchmark's frame range, and the outputs."""
    buffers, camera, s = cell("cpu", emissive_spatial_reuse=emissive_spatial, **settings)
    state = initial_state(s, "cpu").replace(frame_number=5)
    outs = []
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(frames):
            with record_function(bench_profiling.FRAME_RANGE):
                out, state = render_frame(buffers, camera, state, s)
            outs.append((out, state))
    return bench_profiling.kineto_records(prof), outs


@pytest.fixture(scope="module", params=[False, True], ids=["emissive_spatial_off",
                                                           "emissive_spatial_on"])
def frames(request):
    records, _ = profiled_frames(request.param)
    return request.param, records


def named(records, pred):
    return sorted((r for r in records if r["device"] == "cpu" and pred(r["name"])),
                  key=lambda r: r["start"])


def test_pass_ranges_once_a_frame_in_order(frames):
    emissive_spatial, records = frames
    want = [p for p in PASSES if emissive_spatial or p != "emissive_spatial"]
    frame_spans = named(records, "render_frame".__eq__)
    passes = named(records, lambda n: n.startswith("pass:"))
    assert len(frame_spans) == FRAMES
    for f in frame_spans:
        inside = [p["name"] for p in passes if f["start"] <= p["start"] and p["end"] <= f["end"]]
        assert inside == [f"pass:{p}" for p in want]
    assert len(passes) == FRAMES * len(want)


def test_every_leaf_op_lies_in_one_pass(frames):
    _, records = frames
    frame_spans = named(records, "render_frame".__eq__)
    thread = frame_spans[0]["thread"]
    ops = sorted((r for r in records if r["device"] == "cpu" and r["thread"] == thread
                  and r["name"].startswith("aten::") and not r["annotation"]),
                 key=lambda r: (r["start"], -r["end"]))
    # An op is a leaf when no other op opens inside it.
    leaves, stack = [], []
    for op in ops:
        while stack and stack[-1][0]["end"] < op["start"]:
            parent, has_child = stack.pop()
            if not has_child:
                leaves.append(parent)
        if stack:
            stack[-1][1] = True
        stack.append([op, False])
    leaves += [op for op, has_child in stack if not has_child]
    in_frame = [op for op in leaves
                if any(f["start"] <= op["start"] <= f["end"] for f in frame_spans)]
    assert len(in_frame) > 1000
    passes = named(records, lambda n: n.startswith("pass:"))
    starts = [p["start"] for p in passes]
    for op in in_frame:
        opened = passes[:bisect.bisect_right(starts, op["start"])]
        owners = [p["name"] for p in opened if op["end"] <= p["end"]]
        assert len(owners) == 1, (op["name"], owners)


def test_trace_rays_ranges_hold_every_search(monkeypatch):
    calls = {"search": 0}
    search, twin = trace_api._search, closest_hit_mod.closest_hit_reference

    def counted_search(*args, **kwargs):
        calls["search"] += 1
        return search(*args, **kwargs)

    def marked_twin(*args, **kwargs):
        with record_function("k1_twin"):
            return twin(*args, **kwargs)

    monkeypatch.setattr(trace_api, "_search", counted_search)
    monkeypatch.setattr(closest_hit_mod, "closest_hit_reference", marked_twin)
    records, _ = profiled_frames(False)
    searches = named(records, "trace_rays".__eq__)
    twins = named(records, "k1_twin".__eq__)
    assert calls["search"] == len(searches) > 0
    assert len(twins) == len(searches)
    for t in twins:
        assert sum(s["start"] <= t["start"] and t["end"] <= s["end"] for s in searches) == 1


def test_host_read_counts_and_labels_its_read():
    before = profiling.host_syncs
    x = torch.arange(5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = profiling.host_read("test_site", lambda: int(x.sum()))
    assert got == 10
    assert profiling.host_syncs == before + 1
    names = [r["name"] for r in bench_profiling.kineto_records(prof)]
    assert names.count("host_sync:test_site") == 1


def test_host_syncs_per_frame_reads_the_counter():
    """Frames whose searches sync each step (``tracer="bvh"``): the
    benchmark's reader counts the ranges the counter counts."""
    before = profiling.host_syncs
    records, _ = profiled_frames(False, tracer="bvh")
    counted = profiling.host_syncs - before
    trace = bench_profiling.reduce_events(records)
    assert counted > 0
    assert spans.host_syncs_per_frame(trace) == counted / FRAMES
    assert spans.host_sync_ms(trace) > 0


def leaves(tree):
    out = []
    map_tensors(lambda t: out.append(t), tree)
    return out


def test_profiler_changes_no_result():
    buffers, camera, s = cell("cpu")
    state = initial_state(s, "cpu").replace(frame_number=5)
    with torch.no_grad():
        plain = render_frame(buffers, camera, state, s)
        with profile(activities=[ProfilerActivity.CPU]):
            traced = render_frame(buffers, camera, state, s)
    a, b = leaves(plain), leaves(traced)
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.is_floating_point():
            x, y = x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_frame_syncs_only_in_host_read_on_card():
    """Every blocking read or copy of the cell's frame at its full size
    goes through ``host_read``: in sync debug mode "error" any other
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    buffers, camera, s = cell(dev, 1920, 1080)
    state = initial_state(s, dev).replace(frame_number=5)
    with torch.no_grad():
        for _ in range(2):  # builds, uploads and caches: set-up
            _, state = render_frame(buffers, camera, state, s)
        torch.cuda.synchronize()
        before = profiling.host_syncs
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(2):
                out, state = render_frame(buffers, camera, state, s)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert torch.isfinite(out.image).all()
    print(f"host syncs a frame: {(profiling.host_syncs - before) / 2:g}")
