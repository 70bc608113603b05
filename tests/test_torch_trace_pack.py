"""The trace layer's own ranges and counter around the tile walk, on the
``many_cubes`` configuration at a grid of 20 (15,564 triangles, so
``tracer="auto"`` walks tiles) cut to 32x24 on the CPU: ``trace_pack``
ranges open only inside ``trace_rays`` and hold the walk's torch work (the
clusters, the rays' tile sort, the scatter back), which with
``tile_entries`` and ``tile_walk`` covers every op of the search;
``trace_api.clusters_tested`` moves with the walk's calls only and adds no
host sync. No JAX: the card runs the ``cuda`` case here."""

import copy
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hikari_bench import profiling as bench_profiling
from hikari_bench import scenes
from hikari_tpu_torch.render import initial_state, render_frame
from hikari_tpu_torch.render.pipeline import noise_bank_on
from hikari_tpu_torch.scene import build_scene_buffers
from hikari_tpu_torch.trace import api as trace_api
from hikari_tpu_torch.utils import profiling

CONFIG = Path(__file__).resolve().parents[1] / "hikari_bench/configs/many_cubes_tu4x_1080p.json"
K2_PARTS = ("trace_pack", "tile_entries", "tile_walk")

torch.set_num_threads(2)


def cell(device, width=32, height=24, grid=20):
    config = copy.deepcopy(json.loads(CONFIG.read_text()))
    config["settings"].update(width=width, height=height)
    if grid is not None:
        config["geometry"] = {"fn": "many_cubes_scene", "kwargs": {"grid": grid}}
    scene, camera, s = scenes.build(config, "hikari_tpu_torch", device)
    noise_bank_on(device)
    return build_scene_buffers(scene, device), camera, s


@pytest.fixture(scope="module")
def frame():
    """Host event records of one profiled frame, each walk inside a
    ``k2_call`` range of the test's own."""
    buffers, camera, s = cell("cpu")
    assert buffers.num_tris == 15564 > s.bruteforce_max_tris
    walk = trace_api._trace_tile_walk
    calls = []

    def marked(*args, **kwargs):
        calls.append(1)
        with record_function("k2_call"):
            return walk(*args, **kwargs)

    trace_api._trace_tile_walk = marked
    try:
        state = initial_state(s, "cpu").replace(frame_number=5)
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
            render_frame(buffers, camera, state, s)
    finally:
        trace_api._trace_tile_walk = walk
    return bench_profiling.kineto_records(prof), len(calls)


def named(records, pred):
    return sorted((r for r in records if r["device"] == "cpu" and pred(r["name"])),
                  key=lambda r: r["start"])


def inside(x, spans):
    return sum(s["start"] <= x["start"] and x["end"] <= s["end"] for s in spans)


def test_trace_pack_ranges_nest_in_trace_rays(frame):
    records, n_calls = frame
    searches = named(records, "trace_rays".__eq__)
    packs = named(records, "trace_pack".__eq__)
    assert n_calls > 0 and len(packs) == 2 * n_calls  # the clusters and sort, the scatter back
    for p in packs:
        assert inside(p, searches) == 1


def test_walk_ops_lie_in_its_ranges(frame):
    """Every leaf ATen op of a walk's call lies in one of trace_pack,
    tile_entries and tile_walk; the tile sort and the scatter back lie in
    trace_pack."""
    records, _ = frame
    calls = named(records, "k2_call".__eq__)
    parts = {n: named(records, n.__eq__) for n in K2_PARTS}
    ops = sorted((r for r in records if r["device"] == "cpu" and r["name"].startswith("aten::")
                  and inside(r, calls)), key=lambda r: (r["start"], -r["end"]))
    leaves = [op for i, op in enumerate(ops)
              if not (i + 1 < len(ops) and ops[i + 1]["start"] <= op["end"]
                      and ops[i + 1]["end"] <= op["end"])]
    assert len(leaves) > 100
    for op in leaves:
        owners = [n for n, spans in parts.items() if inside(op, spans)]
        assert len(owners) == 1, (op["name"], owners)
    pack = parts["trace_pack"]
    for name in ("aten::argsort", "aten::index_put_"):  # the tile sort, the scatter back
        assert any(op["name"] == name and inside(op, pack) for op in ops), name


def test_clusters_tested_moves_with_the_walk_only():
    buffers, camera, s = cell("cpu")
    o = torch.tensor([[200.0, 200.0, 200.0]]).expand(2048, 3).contiguous()
    g = torch.Generator().manual_seed(3)
    d = torch.nn.functional.normalize(
        torch.rand(2048, 3, generator=g) * torch.tensor([0.6, 0.6, 0.0]) - torch.tensor(
            [0.3, 0.3, 1.0]), dim=1)
    before = trace_api.clusters_tested
    trace_api.trace_rays(buffers, o, d, method="pallas")
    trace_api.trace_rays(buffers, o, d, method="scatter")
    assert trace_api.clusters_tested is before
    seen = []
    walk = trace_api.trace_tile_walk

    def kept(*args, **kwargs):
        out = walk(*args, **kwargs)
        seen.append(int(out[4].sum()))
        return out

    trace_api.trace_tile_walk = kept
    syncs = profiling.host_syncs
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            trace_api.trace_rays(buffers, o, d, method="pallas_tiled")
    finally:
        trace_api.trace_tile_walk = walk
    assert int(trace_api.clusters_tested - before) == seen[0] > 0
    # The walk's only host syncs are its CPU twin's steps.
    sites = [r["name"] for r in bench_profiling.kineto_records(prof)
             if r["name"].startswith("host_sync:")]
    assert set(sites) <= {"host_sync:tile_walk_twin"}
    assert profiling.host_syncs - syncs == len(sites)


@pytest.mark.cuda
def test_walk_frames_sync_only_in_host_read_on_card():
    """The cell's frame at its full size and scene on the card: every
    blocking read goes through ``host_read`` (sync debug mode "error"), the
    walk's as any other, and ``clusters_tested`` grows on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    buffers, camera, s = cell(dev, 1920, 1080, grid=None)
    state = initial_state(s, dev).replace(frame_number=5)
    with torch.no_grad():
        for _ in range(2):
            _, state = render_frame(buffers, camera, state, s)
        torch.cuda.synchronize()
        before = int(trace_api.clusters_tested)
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, state = render_frame(buffers, camera, state, s)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert int(trace_api.clusters_tested) > before
