"""Device ms per frame of the tile walk (K2): every device operation launched under the program's `tile_walk` range (trace layer): moves gpu_frame_ms."""

from hikari_bench import ranges


def read(ctx):
    return ranges.device_ms(ctx.trace, "tile_walk")
