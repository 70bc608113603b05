"""The 90th percentile of every frame's latency in the window, in ms
(host clock): moves gpu_frame_ms. A frame's latency runs from the host's
start of its enqueue to the device's completion of its last operation. Its
runs spread too widely for a bound on this host-paced cell, so it stands
here beside frame_wall_ms.view."""

from hikari_bench import arith


def read(ctx):
    lat = ctx.window.latencies
    return 1e3 * arith.percentile(lat, 90) if lat else None
