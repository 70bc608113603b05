"""Device ms per frame outside the trace layer (render passes): moves gpu_frame_ms."""

from hikari_bench import layers


def read(ctx):
    return layers.passes_device_ms(ctx.trace)
