"""Kernel launches per train step (host / dispatch): moves train_rays_per_s where the host paces the step."""

from hikari_bench import layers


def read(ctx):
    return layers.launches_per_frame(ctx.trace)
