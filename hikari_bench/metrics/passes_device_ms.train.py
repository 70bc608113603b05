"""Device ms per train step of the forward outside the trace layer (render passes): moves train_rays_per_s."""

from hikari_bench import layers


def read(ctx):
    return layers.passes_device_ms(ctx.trace)
