"""The readers of the program's ranges inside the frame (``spans.py``) on
a synthetic event list: the pass groups partition the device work outside
``trace_rays``, launches count kernels alone, a device gap counts as a
sync's when it opens inside a ``host_sync:*`` range, and each reader
reads nothing from a trace without the ranges."""

import json

import pytest

from hikari_bench import layers, profiling, spans, spec

from hikari_bench.tests.test_bench_profiling import ev, kernel, launch

GROUP_METRICS = {g: f"{g}_device_ms.view" for g in spans.PASS_GROUPS}


def rng(name, start, end, thread=1):
    return ev(name, "cpu", start, end, thread, 0, "user_annotation", True)


@pytest.fixture
def trace():
    """One frame, 0-10 s on the main thread 1: a range per pass group and
    a search inside the lighting pass, one sync and a launch outside any
    pass."""
    events = [
        ev(profiling.FRAME_RANGE, "cpu", 0.0, 10.0, 1, 100, "user_annotation", True),
        rng("render_frame", 0.0, 10.0),
        rng("pass:prepass", 0.1, 1.0),
        rng("pass:direct_lit", 1.0, 2.0),
        rng("trace_rays", 1.2, 1.5),
        rng("pass:indirect_spatial", 2.0, 3.0),
        rng("pass:denoise", 3.0, 5.0),
        rng("host_sync:emissive_walk", 3.5, 4.5),
        rng("pass:taa", 5.0, 6.0),
        launch(1, 0.2, 1), kernel("gbuffer_k", 1, 0.2, 0.4),
        launch(2, 1.1, 1), kernel("light_k", 2, 1.1, 1.2),
        launch(3, 1.3, 1), kernel("closest_hit", 3, 1.3, 1.4),
        launch(4, 1.4, 1), kernel("light_in_search_k", 4, 1.4, 1.5),
        launch(5, 2.1, 1), kernel("spatial_k", 5, 2.1, 2.4),
        launch(6, 2.5, 1), ev("Memcpy DtoH", "cuda", 2.5, 2.6, 0, 6, "gpu_memcpy"),
        launch(7, 3.1, 1), kernel("denoise_k", 7, 3.1, 3.6),
        launch(8, 4.7, 1), kernel("denoise_k", 8, 4.7, 4.8),
        launch(9, 5.1, 1), kernel("taa_k", 9, 5.1, 5.2),
        launch(10, 7.0, 1), kernel("stray_k", 10, 7.0, 7.5),
    ]
    return profiling.reduce_events(events, {}, 0)


def test_groups_partition_the_work_outside_trace_rays(trace):
    got = {g: spans.group_device_ms(trace, g) for g in spans.PASS_GROUPS}
    assert got == pytest.approx({"gbuffer": 200.0, "lighting": 100.0, "spatial": 400.0,
                                 "denoise": 600.0, "post": 100.0})
    assert spans.unscoped_device_ms(trace) == pytest.approx(500.0)
    outside = sum(o.end - o.start for o in trace.ops if "trace_rays" not in o.ranges)
    assert sum(got.values()) + spans.unscoped_device_ms(trace) == pytest.approx(1e3 * outside)
    # With the kernels that run under trace_rays, the groups and the guard
    # make up what passes_device_ms reads, and trace_device_ms reads K1.
    assert layers.trace_device_ms(trace) == pytest.approx(100.0)


def test_launches_count_kernels_alone(trace):
    # The copy under pass:indirect_spatial is no kernel; the search's
    # kernels inside pass:direct_lit count with the lighting group.
    assert spans.group_launches(trace, "spatial") == 1
    assert spans.group_launches(trace, "denoise") == 2
    assert spans.group_launches(trace, "lighting") == 3


def test_syncs_and_the_gaps_they_open(trace):
    assert spans.host_syncs_per_frame(trace) == 1
    assert spans.host_sync_ms(trace) == pytest.approx(1000.0)
    # The gap 3.6-4.7 opens inside the sync (3.5-4.5) and counts whole;
    # 4.8-5.1 and 5.2-7.0 open outside it and do not.
    assert spans.sync_idle_ms(trace) == pytest.approx(1100.0)


def test_syncs_of_other_threads_do_not_count(trace):
    trace.host.append(profiling.HostSpan("host_sync:other", 5.25, 5.5, 7))
    assert spans.host_syncs_per_frame(trace) == 1
    assert spans.sync_idle_ms(trace) == pytest.approx(1100.0)


def test_no_ranges_no_reading():
    """A program without the ranges (the parent's) leaves every metric
    out; so does an empty trace."""
    events = [
        ev(profiling.FRAME_RANGE, "cpu", 0.0, 1.0, 1, 100, "user_annotation", True),
        rng("tile_walk", 0.1, 0.2),
        launch(1, 0.1, 1), kernel("k", 1, 0.1, 0.3),
    ]
    for t in (profiling.reduce_events(events, {}, 0), profiling.reduce_events([], {}, 0)):
        for g in spans.PASS_GROUPS:
            assert spans.group_device_ms(t, g) is None
            assert spans.group_launches(t, g) is None
        for f in (spans.unscoped_device_ms, spans.host_syncs_per_frame, spans.host_sync_ms,
                  spans.sync_idle_ms):
            assert f(t) is None


def test_every_new_metric_has_its_reader(trace):
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer"]}
    new = set(GROUP_METRICS.values()) | {
        "unscoped_device_ms.view", "denoise_launches_per_frame.view",
        "spatial_launches_per_frame.view", "host_syncs_per_frame.view", "host_sync_ms.view",
        "sync_idle_ms.view"}
    assert new <= names
    ctx = type("Ctx", (), {"trace": trace})()
    for name in new:
        assert spec.metric_reader(name)(ctx) is not None, name
    for group, name in GROUP_METRICS.items():
        assert spec.metric_reader(name)(ctx) == spans.group_device_ms(trace, group)


@pytest.mark.cuda
def test_sync_reading_is_the_counter_on_card():
    """The cell's frames on the card, profiled as a traced run profiles
    them: ``host_syncs_per_frame`` reads the program's counter
    ``host_syncs`` over the profiled frames, divided by the frames."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from hikari_bench import harness
    from hikari_tpu_torch.utils import profiling as program_profiling

    cell = spec.find_cell("cornell1080_view")
    dev = torch.device("cuda", 0)
    program = harness.Program(cell.config, dev)
    box = {"state": program.initial_state(5)}

    def one(n):
        _, box["state"] = program.render(box["state"])

    for n in range(2):
        one(n)

    def counters():
        return {**program.counters(), "host_syncs": program_profiling.host_syncs}

    win = harness.run_window(dev, 0.0, 2, one, min_frames=5, profile_at=2, profile_frames=3,
                             counters=counters)
    trace = win.trace
    assert spans.host_syncs_per_frame(trace) == trace.counters["host_syncs"] / trace.n_frames
    ctx = type("Ctx", (), {"trace": trace})()
    readings = {m["name"]: spec.metric_reader(m["name"])(ctx) for m in cell.per_layer
                if m["name"] != "frame_wall_ms.view" and m["name"] != "frame_p90_ms.view"}
    print(json.dumps(readings))
    assert all(readings[name] is not None for name in GROUP_METRICS.values())
