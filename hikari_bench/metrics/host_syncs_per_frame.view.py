"""Blocking reads of the card per frame, the main thread's `host_sync:*` ranges (host / dispatch): moves gpu_frame_ms."""

from hikari_bench import spans


def read(ctx):
    return spans.host_syncs_per_frame(ctx.trace)
