"""Device ms per frame of the denoiser, `pass:denoise` (render passes): moves gpu_frame_ms."""

from hikari_bench import spans


def read(ctx):
    return spans.group_device_ms(ctx.trace, "denoise")
