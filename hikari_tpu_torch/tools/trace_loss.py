"""Repeat ``torch.profiler`` traces of one bench frame and print what each
trace holds, to find traces that lose device time.

    python -m hikari_tpu_torch.tools.trace_loss [--grad]

The frame is ``tools/profile_prefix``'s (the port bench's cornell frame,
untruncated, fwd or fwd+grad). After two warm-up frames, each of 12
frames is traced with the host and the device activity, then each of 30
frames with the device activity alone. One line a
trace: the device ms as ``profile_prefix.device_ms`` sums it, the number of
device events, the span from the first device event's start to the last
one's end, and the frame's span between two CUDA events recorded around it.
A trace that reads low with fewer events has lost records; one with as many
events but a shorter sum has lost time in them. On the card only.
"""

from __future__ import annotations

import argparse

import torch

# Consecutive frames traced with the host and the device activity, then
# with the device activity alone.
HOST_TRACES, DEVICE_TRACES = 12, 30


def trace_one(frame, scene, camera, state, activities):
    """Trace one frame; return (next state, device ms, device events,
    device span ms, CUDA-event span ms)."""
    from torch.profiler import profile

    from hikari_tpu_torch.tools.profile_prefix import RANGES

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        start.record()
        state = frame(scene, camera, state)
        end.record()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type.name == "CUDA" and e.name not in RANGES]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3
    return state, busy, len(dev), span, start.elapsed_time(end)


def main(argv=None) -> list[dict]:
    """Print one line a trace; return the rows."""
    from torch.profiler import ProfilerActivity

    from hikari_tpu_torch.bench import bench_config
    from hikari_tpu_torch.render.pipeline import initial_state
    from hikari_tpu_torch.scene import build_scene_buffers
    from hikari_tpu_torch.tools.profile_prefix import make_frame
    from hikari_tpu_torch.utils import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grad", action="store_true", help="trace the fwd+grad frame")
    args = ap.parse_args(argv)

    device = resolve_device()
    scene, camera, settings = bench_config("cornell", device)
    buffers = build_scene_buffers(scene, device)
    frame = make_frame(settings, args.grad)
    state = initial_state(settings, device)
    for _ in range(2):
        state = frame(buffers, camera, state)
    rows = []
    modes = [("host+device", [ProfilerActivity.CPU, ProfilerActivity.CUDA], HOST_TRACES),
             ("device", [ProfilerActivity.CUDA], DEVICE_TRACES)]
    for mode, activities, n in modes:
        for i in range(n):
            state, busy, events, span, wall = trace_one(frame, buffers, camera, state, activities)
            rows.append({"mode": mode, "trace": i, "device_ms": busy, "events": events,
                         "span_ms": span, "event_span_ms": wall})
            print(f"[trace_loss] {mode:11s} {i:3d}: device {busy:9.3f} ms, {events:7d} events, "
                  f"device span {span:9.3f} ms, CUDA-event span {wall:9.3f} ms", flush=True)
    return rows


if __name__ == "__main__":
    main()
