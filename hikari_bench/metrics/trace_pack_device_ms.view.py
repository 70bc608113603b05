"""Device ms per frame of the trace layer's own torch work around the tile walk (the clusters' rows and boxes, the rays' tile sort and the scatter back): every device operation launched under the program's `trace_pack` range (trace layer): moves gpu_frame_ms."""

from hikari_bench import ranges


def read(ctx):
    return ranges.device_ms(ctx.trace, "trace_pack")
