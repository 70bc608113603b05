"""Metric arithmetic: the ray accounting, percentiles and rates over all
samples, the trace layer's least bytes, and the device's busy time from
event intervals. Plain Python: no torch, so the CPU tests reach all of it."""

from __future__ import annotations

import math


# Published peaks of one NVIDIA H100 SXM (data sheet; at its 700 W limit).
H100_PEAK_BYTES_PER_S = 3.35e12

# The trace layer's least traffic: each ray's inputs read once (origin and
# direction 24 B; max distance, early distance, excluded instance, prim
# range lo and hi 4 B each) and its hit written once (t, prim, u, v), plus
# each triangle's three f32 vertices read once a call.
RAY_IN_BYTES = 24 + 5 * 4
HIT_OUT_BYTES = 4 * 4
TRIANGLE_BYTES = 3 * 3 * 4


def rays_per_frame(output_size, render_size, direct_validate_interval: int,
                   emissive_validate_interval: int, emissive_lit: bool, num_emissives: int,
                   indirect_bounces: int) -> float:
    """Forward rays of one frame (a frozen copy of the port's
    ``bench.rays_per_frame``, which follows ``bench.py:30-42``): primary
    rays at the output size, then per render pixel the direct shadow ray
    with the amortized validation retrace, the emissive target and shadow
    rays with theirs, and per bounce the bounce, NEE target and NEE shadow
    rays. The backward of a train step traces none."""
    oh, ow = output_size
    rh, rw = render_size
    per_px = 1.0 * (1.0 + 1.0 / max(direct_validate_interval, 1))
    if emissive_lit and num_emissives > 0:
        per_px += 2.0 * (1.0 + 1.0 / max(emissive_validate_interval, 1))
    nee = 3.0 if num_emissives > 0 else 2.0
    per_px += nee * max(indirect_bounces, 1)
    return oh * ow + per_px * rh * rw


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linear between the two
    nearest ranks (numpy's default), over all samples: no sample is left
    out and nothing is a median of pieces."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"rate over a window of {seconds} s")
    return count / seconds


def trace_min_bytes(rays: int, calls: int, num_tris: int) -> int:
    """The least bytes the trace layer moves for ``rays`` rays in ``calls``
    calls over a scene of ``num_tris`` triangles."""
    return rays * (RAY_IN_BYTES + HIT_OUT_BYTES) + calls * num_tris * TRIANGLE_BYTES


def roofline_pct(min_bytes: float, seconds: float, peak_bytes_per_s: float = H100_PEAK_BYTES_PER_S):
    """The share of the least time (bytes over the peak bandwidth) in the
    time taken, in %; None where nothing was timed."""
    if seconds <= 0 or min_bytes <= 0:
        return None
    return 100.0 * (min_bytes / peak_bytes_per_s) / seconds


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def clip(intervals, lo: float, hi: float):
    """The parts of the intervals inside [lo, hi]."""
    out = []
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append((s, e))
    return out


def idle_gaps(intervals, lo: float, hi: float):
    """The (start, end) gaps in [lo, hi] that no interval covers, in time
    order."""
    gaps, cur = [], lo
    for s, e in sorted(clip(intervals, lo, hi)):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def idle_pct(intervals, lo: float, hi: float) -> float:
    """100 x (1 - the union of the intervals inside [lo, hi] / its length)."""
    span = hi - lo
    if span <= 0:
        raise ValueError("an empty span")
    return 100.0 * (1.0 - union_length(clip(intervals, lo, hi)) / span)
