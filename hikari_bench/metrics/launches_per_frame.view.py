"""Kernel launches per frame of the viewer (host / dispatch): moves gpu_frame_ms (fewer, fused launches), and the host's pace."""

from hikari_bench import layers


def read(ctx):
    return layers.launches_per_frame(ctx.trace)
