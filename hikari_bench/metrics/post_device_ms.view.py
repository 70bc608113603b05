"""Device ms per frame of the post chain, `pass:tonemap`, `pass:smaa`, `pass:taa`, `pass:fsr` and `pass:overlay` (render passes): moves gpu_frame_ms."""

from hikari_bench import spans


def read(ctx):
    return spans.group_device_ms(ctx.trace, "post")
