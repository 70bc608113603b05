"""Device ms per frame launched under no `pass:*` range and outside `trace_rays` (render passes): the coverage guard of the pass metrics, ~0; moves gpu_frame_ms."""

from hikari_bench import spans


def read(ctx):
    return spans.unscoped_device_ms(ctx.trace)
