"""Device ms per frame of the spatial reuse passes, `pass:emissive_spatial` and `pass:indirect_spatial`, outside `trace_rays` (render passes): moves gpu_frame_ms."""

from hikari_bench import spans


def read(ctx):
    return spans.group_device_ms(ctx.trace, "spatial")
