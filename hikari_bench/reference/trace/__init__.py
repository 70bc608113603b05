"""Ray tracing: closest-hit queries and hit reconstruction (port of
``hikari_tpu.trace``)."""

from hikari_bench.reference.trace.api import (
    Hit,
    HitInfo,
    hit_info,
    occlude_hit_info,
    refine_hit,
    trace_rays,
)

__all__ = ["Hit", "HitInfo", "hit_info", "occlude_hit_info", "refine_hit", 
           "trace_rays"]
