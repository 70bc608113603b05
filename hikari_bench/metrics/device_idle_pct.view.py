"""Share of the profiled frames' span in which the device ran nothing, in % (device): moves gpu_frame_ms."""

from hikari_bench import layers


def read(ctx):
    return layers.device_idle_pct(ctx.trace)
