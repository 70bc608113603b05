"""Per-layer quantities from a ``profiling.Trace``, shared by the readers
under ``metrics/``. Each returns None where the trace holds nothing to
read, and the harness then leaves the metric out."""

from __future__ import annotations

from hikari_bench import arith

# The trace layer: the closest-hit kernels by name (K1 runs outside any
# range) and every device operation launched inside the program's ranges
# around the large-scene searches.
TRACE_KERNEL_NAMES = ("closest_hit",)
TRACE_RANGES = ("tile_entries", "tile_walk", "scatter_plan", "scatter_items", "segment_min")


def is_trace(op) -> bool:
    return any(k in op.name for k in TRACE_KERNEL_NAMES) or any(r in TRACE_RANGES
                                                                for r in op.ranges)


def is_backward(trace, op) -> bool:
    """Launched from a host thread other than the one that ran the step:
    the autograd engine's device thread."""
    return op.thread is not None and trace.main_thread is not None and (
        op.thread != trace.main_thread)


def _ms_per_frame(trace, ops):
    if not trace.n_frames:
        return None
    return 1e3 * sum(o.end - o.start for o in ops) / trace.n_frames


def launches_per_frame(trace):
    if not trace.n_frames or not trace.kernels:
        return None
    return len(trace.kernels) / trace.n_frames


def trace_device_ms(trace):
    ops = [o for o in trace.ops if is_trace(o)]
    return _ms_per_frame(trace, ops) if ops else None


def backward_device_ms(trace):
    ops = [o for o in trace.ops if is_backward(trace, o)]
    return _ms_per_frame(trace, ops) if ops else None


def passes_device_ms(trace):
    """Device ms per frame of every operation outside the trace layer and
    the backward: in a train step, the forward's passes."""
    ops = [o for o in trace.ops if not is_trace(o) and not is_backward(trace, o)]
    return _ms_per_frame(trace, ops) if ops else None


def trace_roofline(trace):
    """The trace layer's least time (``arith.trace_min_bytes`` over the
    peak bandwidth) over its device time, in %: rays and calls from the
    program's counters over the profiled frames."""
    ms = trace_device_ms(trace)
    rays, calls = trace.counters.get("rays_traced"), trace.counters.get("trace_calls")
    if ms is None or not rays or not calls:
        return None
    seconds = ms * 1e-3 * trace.n_frames
    return arith.roofline_pct(arith.trace_min_bytes(rays, calls, trace.num_tris), seconds)


def device_idle_pct(trace):
    if not trace.ops or trace.window_s() <= 0:
        return None
    lo, hi = trace.span
    return arith.idle_pct([(o.start, o.end) for o in trace.ops], lo, hi)
