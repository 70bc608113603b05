"""Host ms per frame inside the main thread's `host_sync:*` ranges (host / dispatch, host clock): moves gpu_frame_ms."""

from hikari_bench import spans


def read(ctx):
    return spans.host_sync_ms(ctx.trace)
