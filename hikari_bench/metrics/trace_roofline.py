"""The trace layer's share of its bandwidth roofline, in % (kernels): moves gpu_frame_ms."""

from hikari_bench import layers


def read(ctx):
    return layers.trace_roofline(ctx.trace)
