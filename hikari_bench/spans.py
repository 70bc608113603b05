"""Per-layer quantities from the program's own ranges inside the frame,
shared by the readers under ``metrics/``: ``render_frame`` opens one range
a frame, ``pass:<name>`` one a render pass, ``trace_rays`` one a search
and ``host_sync:<site>`` one a blocking read of the card
(``hikari_tpu_torch/utils/profiling.py``). Device operations are put down
to the ranges open on their launching thread at the launch
(``profiling.DeviceOp.ranges``). Each function returns None where the
trace holds none of the ranges it reads (a program without them), and
the harness then leaves the metric out."""

from __future__ import annotations

import bisect

from hikari_bench import arith, layers

FRAME_SPAN = "render_frame"
PASS_PREFIX = "pass:"
TRACE_SPAN = "trace_rays"
SYNC_PREFIX = "host_sync:"

# The render passes layer, cut into groups whose device ms are read one
# metric each. With ``unscoped`` (no pass range) they partition every
# device operation outside ``trace_rays`` and the backward. The f16
# reservoirs' unpack and pack are the lighting passes' state, so they
# count with them; ``fsr`` is the post chain's upscale where FSR1 runs.
PASS_GROUPS = {
    "gbuffer": ("prepass", "albedo"),
    "lighting": ("direct_lit", "emissive_lit", "indirect_lit", "unpack", "pack"),
    "spatial": ("emissive_spatial", "indirect_spatial"),
    "denoise": ("denoise",),
    "post": ("tonemap", "smaa", "taa", "fsr", "overlay"),
}


def _names(passes) -> set:
    return {PASS_PREFIX + p for p in passes}


def _has_span(trace, pred) -> bool:
    return any(pred(h.name) for h in trace.host)


def _in_frame(trace, op) -> bool:
    """Launched outside ``trace_rays`` and the backward."""
    return TRACE_SPAN not in op.ranges and not layers.is_backward(trace, op)


def _ms(trace, ops):
    if not trace.n_frames or not trace.ops:
        return None
    return 1e3 * sum(o.end - o.start for o in ops) / trace.n_frames


def group_device_ms(trace, group: str):
    """Device ms a frame of the operations launched under a pass range of
    ``group`` and outside ``trace_rays``."""
    names = _names(PASS_GROUPS[group])
    if not _has_span(trace, names.__contains__):
        return None
    return _ms(trace, [o for o in trace.ops if _in_frame(trace, o) and names & set(o.ranges)])


def unscoped_device_ms(trace):
    """Device ms a frame of the operations launched under no pass range,
    outside ``trace_rays`` and the backward: the coverage guard, ~0 when
    the ranges cover the frame."""
    if not _has_span(trace, lambda n: n.startswith(PASS_PREFIX)):
        return None
    return _ms(trace, [o for o in trace.ops if _in_frame(trace, o) and not any(
        r.startswith(PASS_PREFIX) for r in o.ranges)])


def group_launches(trace, group: str):
    """Kernels a frame launched under a pass range of ``group``, the
    searches' inside them included."""
    names = _names(PASS_GROUPS[group])
    if not trace.n_frames or not trace.kernels or not _has_span(trace, names.__contains__):
        return None
    return sum(bool(names & set(o.ranges)) for o in trace.kernels) / trace.n_frames


def _syncs(trace):
    """The ``host_sync:*`` ranges of the main thread, or None where the
    program opens no ``render_frame`` range (it has no such ranges)."""
    if not trace.n_frames or not _has_span(trace, FRAME_SPAN.__eq__):
        return None
    return [h for h in trace.host
            if h.thread == trace.main_thread and h.name.startswith(SYNC_PREFIX)]


def host_syncs_per_frame(trace):
    syncs = _syncs(trace)
    return None if syncs is None else len(syncs) / trace.n_frames


def host_sync_ms(trace):
    """Host ms a frame inside the main thread's sync ranges."""
    syncs = _syncs(trace)
    return None if syncs is None else 1e3 * sum(h.end - h.start for h in syncs) / trace.n_frames


def sync_idle_ms(trace):
    """Device-idle ms a frame in the gaps that open while the main thread
    is inside a sync range: a sync drains the card's queue, so the gap it
    causes opens during the host's wait."""
    syncs = _syncs(trace)
    if syncs is None or not trace.ops:
        return None
    lo, hi = trace.span
    syncs.sort(key=lambda h: h.start)
    starts = [h.start for h in syncs]
    idle = 0.0
    for s, e in arith.idle_gaps([(o.start, o.end) for o in trace.ops], lo, hi):
        k = bisect.bisect_right(starts, s) - 1  # the last sync opened by s
        if k >= 0 and s <= syncs[k].end:
            idle += e - s
    return 1e3 * idle / trace.n_frames
