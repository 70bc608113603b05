"""Device ms per train step of the trace layer (the closest-hit kernels and the ranges around the large-scene searches): moves train_rays_per_s."""

from hikari_bench import layers


def read(ctx):
    return layers.trace_device_ms(ctx.trace)
