"""The traced run's reduction on a synthetic event list: the idle share,
the backward attribution by launching thread, the trace layer by kernel
name and by range, launches per frame and the breakdown."""

import pytest

from hikari_bench import layers, profiling


def ev(name, device, start, end, thread=1, correlation=0, activity="cpu_op", annotation=False):
    return {"name": name, "device": device, "activity": activity, "start": start, "end": end,
            "thread": thread, "correlation": correlation, "annotation": annotation}


def launch(corr, at, thread):
    return ev("cudaLaunchKernel", "cpu", at, at + 0.001, thread, corr, "cuda_runtime")


def kernel(name, corr, start, end):
    return ev(name, "cuda", start, end, 0, corr, "kernel")


@pytest.fixture
def trace():
    events = [
        # Two frames on the main thread 1.
        ev(profiling.FRAME_RANGE, "cpu", 0.0, 1.0, 1, 100, "user_annotation", True),
        ev(profiling.FRAME_RANGE, "cpu", 1.0, 2.0, 1, 101, "user_annotation", True),
        ev("tile_walk", "cpu", 0.2, 0.4, 1, 102, "user_annotation", True),
        ev("aten::add", "cpu", 0.5, 0.9, 1, 103),
        # A pass kernel, a K1 kernel, a kernel under the tile_walk range,
        # and a backward kernel launched from the autograd thread 7.
        launch(1, 0.1, 1), kernel("pass_kernel", 1, 0.1, 0.3),
        launch(2, 0.15, 1), kernel("closest_hit_kernel", 2, 0.3, 0.4),
        launch(3, 0.3, 1), kernel("tile_walk_kernel", 3, 0.4, 0.6),
        launch(4, 1.1, 7), kernel("backward_kernel", 4, 1.2, 1.5),
        ev("Memcpy HtoD", "cuda", 1.6, 1.7, 0, 5, "gpu_memcpy"),
        # A GPU-side annotation is no device work.
        ev("tile_walk", "cuda", 0.4, 0.6, 0, 6, "gpu_user_annotation"),
    ]
    return profiling.reduce_events(events, {"rays_traced": 1000, "trace_calls": 2}, num_tris=10)


def test_ops_and_threads(trace):
    assert trace.n_frames == 2 and trace.main_thread == 1
    assert len(trace.ops) == 5 and len(trace.kernels) == 4
    by = {o.name: o for o in trace.ops}
    assert by["tile_walk_kernel"].ranges == ("tile_walk",)
    assert by["backward_kernel"].thread == 7
    assert by["Memcpy HtoD"].thread is None


def test_busy_idle_and_span(trace):
    assert trace.span == (0.0, 2.0)
    # Busy: 0.1-0.6, 1.2-1.5, 1.6-1.7 = 0.9 s of 2 s.
    assert trace.busy_s() == pytest.approx(0.9)
    assert layers.device_idle_pct(trace) == pytest.approx(55.0)


def test_layer_times(trace):
    assert layers.launches_per_frame(trace) == 2.0
    assert layers.trace_device_ms(trace) == pytest.approx(1e3 * 0.3 / 2)
    assert layers.backward_device_ms(trace) == pytest.approx(1e3 * 0.3 / 2)
    # The pass kernel and the copy: 0.3 s over 2 frames.
    assert layers.passes_device_ms(trace) == pytest.approx(1e3 * 0.3 / 2)
    rf = layers.trace_roofline(trace)
    assert rf == pytest.approx(100 * (1000 * 60 + 2 * 10 * 36) / 3.35e12 / 0.3)


def test_breakdown(trace):
    b = profiling.breakdown(trace)
    assert b["device_ops"][0][0] in ("pass_kernel", "tile_walk_kernel", "backward_kernel")
    assert len(b["device_ops"]) == 5
    # The longest gap, 0.6-1.2, began inside aten::add on the main thread.
    name, secs = b["idle_gaps"][0]
    assert secs == pytest.approx(0.6) and name == "aten::add"


def test_nothing_to_read():
    empty = profiling.reduce_events([], {}, 0)
    for f in (layers.launches_per_frame, layers.trace_device_ms, layers.backward_device_ms,
              layers.passes_device_ms, layers.trace_roofline, layers.device_idle_pct):
        assert f(empty) is None


class FakeKinetoEvent:
    def __init__(self, name, device, start_ns, dur_ns, activity):
        self._n, self._d, self._s, self._t, self._a = name, device, start_ns, dur_ns, activity

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t

    def activity_type(self):
        return self._a


def test_device_intervals_keep_device_work_alone():
    """The busy meter's reading: kernels, copies and fills; no host event
    and no GPU-side annotation."""
    events = [FakeKinetoEvent("cudaLaunchKernel", "CPU", 0, 5, "cuda_runtime"),
              FakeKinetoEvent("k", "CUDA", 10, 20, "kernel"),
              FakeKinetoEvent("Memcpy DtoH", "CUDA", 40, 10, "gpu_memcpy"),
              FakeKinetoEvent("Memset", "CUDA", 50, 5, "gpu_memset"),
              FakeKinetoEvent("range", "CUDA", 0, 100, "gpu_user_annotation")]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    got = [t for iv in profiling.device_intervals(Prof) for t in iv]
    assert got == pytest.approx([10e-9, 30e-9, 40e-9, 50e-9, 50e-9, 55e-9])
