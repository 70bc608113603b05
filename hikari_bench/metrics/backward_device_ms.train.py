"""Device ms per train step launched by the autograd engine's thread (autograd backward): moves train_rays_per_s."""

from hikari_bench import layers


def read(ctx):
    return layers.backward_device_ms(ctx.trace)
