"""Device ms per frame of the lighting passes, `pass:direct_lit`, `pass:emissive_lit` and `pass:indirect_lit`, with the f16 reservoirs' `pass:unpack` and `pass:pack`, outside `trace_rays` (render passes): moves gpu_frame_ms."""

from hikari_bench import spans


def read(ctx):
    return spans.group_device_ms(ctx.trace, "lighting")
