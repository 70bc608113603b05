"""Device-idle ms per frame in gaps that open while the main thread is inside a `host_sync:*` range (host / dispatch): moves gpu_frame_ms."""

from hikari_bench import spans


def read(ctx):
    return spans.sync_idle_ms(ctx.trace)
