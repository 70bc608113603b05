"""Device ms per frame of the G-buffer passes, `pass:prepass` and `pass:albedo`, outside `trace_rays` (render passes): moves gpu_frame_ms."""

from hikari_bench import spans


def read(ctx):
    return spans.group_device_ms(ctx.trace, "gbuffer")
