"""Share of the profiled steps' span in which the device ran nothing, in % (device): moves train_rays_per_s."""

from hikari_bench import layers


def read(ctx):
    return layers.device_idle_pct(ctx.trace)
