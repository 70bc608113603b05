"""Device ms per frame of the tile walk's phase 1 (K2·p1) and its sort: every device operation launched under the program's `tile_entries` range (trace layer): moves gpu_frame_ms."""

from hikari_bench import ranges


def read(ctx):
    return ranges.device_ms(ctx.trace, "tile_entries")
