"""Kernels launched per frame under `pass:denoise` (host / dispatch): moves gpu_frame_ms (fewer, fused launches)."""

from hikari_bench import spans


def read(ctx):
    return spans.group_launches(ctx.trace, "denoise")
