"""Device time under one of the program's named ranges, for the readers
under ``metrics/`` of the trace layer's own parts (``tile_entries``,
``tile_walk``, ``trace_pack``, all inside ``trace_rays``)."""

from __future__ import annotations


def device_ms(trace, name: str):
    """Device ms a frame of the operations launched while the range
    ``name`` was open on their thread; None where no operation was (a
    cell without the tile walk, or a program without the range)."""
    ops = [o for o in trace.ops if name in o.ranges]
    if not ops or not trace.n_frames:
        return None
    return 1e3 * sum(o.end - o.start for o in ops) / trace.n_frames
