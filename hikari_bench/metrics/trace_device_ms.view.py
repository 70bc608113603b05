"""Device ms per frame of the trace layer (the closest-hit kernels and the ranges around the large-scene searches): moves gpu_frame_ms."""

from hikari_bench import layers


def read(ctx):
    return layers.trace_device_ms(ctx.trace)
