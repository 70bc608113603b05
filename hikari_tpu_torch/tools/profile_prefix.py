"""Per-stage cost inside the real frame — the port of the repository's
``tools/profile_prefix.py``: the pipeline cut after each stage
(``settings.stop_after``, ``render/stops.py``) is timed with the state
carried from frame to frame, so consecutive-prefix deltas price each stage
with its glue.

    python -m hikari_tpu_torch.tools.profile_prefix [--config cornell] [--size N]
        [--frames 4] [--grad] [--stages gbuffer,albedo,...,FULL] [--cpu]

Each prefix runs ``--frames`` frames from a fresh state: frame 1 warms up,
frames 2..N are each timed on the host clock between two synchronizes
(the median is the prefix's ms/frame); after every prefix's host time and
the untruncated frame timed again, each prefix runs once more, its
frames 3-5 each under its own ``torch.profiler`` trace, for its device
time a frame (the median of the three, printed beside each frame's ms and
device events; on the card only), and the untruncated frame is profiled
once more at the same frames, so that each of its readings can be held
against the untruncated prefix's reading of the same frame: the work of a
fwd+grad frame differs from frame to frame (29,499-30,654 device events
and 176.752-185.205 ms in 42 traces of consecutive frames on an H100 80GB
HBM3 at 700 W, ``tools/trace_loss``), but not between two runs of the
same frame.
``--grad`` times the fwd+grad frame instead: the loss is the image's mean
and the gradients are taken with respect to ``parallel.DIFF_LEAVES``, as
the JAX tool does. The settings are the port bench's
(``bench.bench_config``: 1920x1080 for cornell, 512x512 otherwise, SMAA
TU4x at 2, TAA Jasmine, denoise, one bounce); ``--size`` makes the frame
square. One line per stage goes to standard output; ``main`` returns the
rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

STAGES = ["gbuffer", "albedo", "direct", "emissive", "indirect", "denoise", "tonemap", "smaa",
          "taa", None]


# record_function ranges of the large-scene tracers: they also appear as
# device-side annotations, which would count their kernels twice.
RANGES = ("tile_entries", "tile_walk", "scatter_plan", "scatter_items", "segment_min")


def make_frame(settings, grad: bool):
    """``frame(scene, camera, state) -> state'``: one forward frame, or
    one fwd+grad frame (loss = the image's mean, gradients with respect to
    ``DIFF_LEAVES``, the next state detached)."""
    from hikari_tpu_torch.parallel import DIFF_LEAVES
    from hikari_tpu_torch.render.pipeline import render_frame
    from hikari_tpu_torch.utils import map_tensors

    def frame(scene, camera, state):
        if not grad:
            with torch.no_grad():
                return render_frame(scene, camera, state, settings)[1]
        params = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in DIFF_LEAVES}
        with torch.enable_grad():
            out, new_state = render_frame(dataclasses.replace(scene, **params), camera, state,
                                          settings)
            loss = out.image.mean()
            if loss.requires_grad:
                torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return map_tensors(torch.Tensor.detach, new_state)

    return frame


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def host_ms(scene, camera, settings, frames: int, grad: bool, device) -> list[float]:
    """Host ms of frames 2..``frames`` from a fresh state, each between two
    synchronizes (frame 1 warms up)."""
    from hikari_tpu_torch.render.pipeline import initial_state

    frame = make_frame(settings, grad)
    state = frame(scene, camera, initial_state(settings, device))
    samples = []
    for _ in range(frames - 1):
        _sync(device)
        t0 = time.perf_counter()
        state = frame(scene, camera, state)
        _sync(device)
        samples.append((time.perf_counter() - t0) * 1e3)
    return samples


# Frames traced for a prefix's device time, after two warm-up frames.
DEVICE_TRACES = 3


def device_ms(scene, camera, settings, grad: bool, device) -> list[tuple[float, int]]:
    """Device time of frames 3 to ``2 + DEVICE_TRACES`` on the card, each
    in its own ``torch.profiler`` trace of the device activity alone: for
    each frame, the ms of its CUDA kernels and copies and the number of
    device events (a trace of the host activity too costs ~8 s a fwd+grad
    frame)."""
    from torch.profiler import ProfilerActivity, profile

    from hikari_tpu_torch.render.pipeline import initial_state

    frame = make_frame(settings, grad)
    state = initial_state(settings, device)
    for _ in range(2):
        state = frame(scene, camera, state)
    readings = []
    for _ in range(DEVICE_TRACES):
        _sync(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state = frame(scene, camera, state)
            _sync(device)
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and e.key not in RANGES]
        readings.append((sum(e.self_device_time_total for e in events) / 1e3,
                         sum(e.count for e in events)))
    return readings


def _readings_text(readings) -> str:
    return (f"frames 3-{2 + DEVICE_TRACES} {' / '.join(f'{ms:.3f}' for ms, _ in readings)} ms, "
            f"{' / '.join(str(n) for _, n in readings)} events")


def main(argv=None) -> dict:
    """Time each prefix; print one line per stage, then the untruncated
    frame timed and profiled again beside the sums of the stage deltas.
    Host times are all taken before the first profiled frame. Returns
    {"rows": [{"stage", "ms", "delta_ms", "device_ms", "delta_device_ms",
    "device_readings", "samples"}], "full_again": host samples of the
    untruncated frame timed again, "device_again": its device ms (the
    median of its readings), "device_again_readings": its (ms, events) at
    frames 3-5}; the device entries are None on the CPU."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="cornell")
    ap.add_argument("--size", type=int, default=0, help="square frame size (default: the bench's)")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--grad", action="store_true", help="time the fwd+grad frame")
    ap.add_argument("--stages", default="",
                    help="comma-separated stop_after points in order (FULL: the whole frame); "
                         "default: the coarse stages, then FULL")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the plain twins)")
    args = ap.parse_args(argv)
    if args.frames < 2:
        ap.error("--frames must be at least 2 (frame 1 warms up)")

    from hikari_tpu_torch.bench import bench_config
    from hikari_tpu_torch.scene import build_scene_buffers
    from hikari_tpu_torch.utils import resolve_device

    device = torch.device("cpu") if args.cpu else resolve_device()
    scene, camera, settings = bench_config(args.config, device)
    if args.size:
        settings = settings.replace(width=args.size, height=args.size)
    buffers = build_scene_buffers(scene, device)
    stages = STAGES
    if args.stages:
        stages = [None if s == "FULL" else s for s in args.stages.split(",")]
    mode = "grad" if args.grad else "fwd"
    print(f"# {args.config} {settings.width}x{settings.height} from {settings.render_size[1]}x"
          f"{settings.render_size[0]}, frames={args.frames}, {mode}, {device}", flush=True)

    cuts = [settings.replace(stop_after=st) for st in stages]
    samples = [host_ms(buffers, camera, s, args.frames, args.grad, device) for s in cuts]
    full_again = host_ms(buffers, camera, settings, args.frames, args.grad, device)
    on_card = device.type == "cuda"
    dev = [device_ms(buffers, camera, s, args.grad, device) if on_card else None for s in cuts]
    again = device_ms(buffers, camera, settings, args.grad, device) if on_card else None
    device_again = None if again is None else float(np.median([ms for ms, _ in again]))
    rows, prev, prev_dev = [], 0.0, 0.0
    for stage, smp, readings in zip(stages, samples, dev):
        ms = float(np.median(smp))
        dev_ms = None if readings is None else float(np.median([m for m, _ in readings]))
        row = {"stage": stage or "FULL", "ms": ms, "delta_ms": ms - prev, "device_ms": dev_ms,
               "delta_device_ms": None if dev_ms is None else dev_ms - prev_dev,
               "device_readings": readings, "samples": smp}
        rows.append(row)
        dev_txt = ("device not measured (CPU)" if dev_ms is None else
                   f"device {dev_ms:9.3f} ms/frame (+{row['delta_device_ms']:8.3f}); "
                   f"{_readings_text(readings)}")
        print(f"{mode} after {row['stage']:16s} {ms:10.3f} ms/frame (+{row['delta_ms']:9.3f}); "
              f"{dev_txt}", flush=True)
        prev, prev_dev = ms, dev_ms or 0.0
    print(f"{mode} stage deltas sum to {sum(r['delta_ms'] for r in rows):.3f} ms/frame; the "
          f"untruncated frame timed again {float(np.median(full_again)):.3f} ms/frame (samples "
          f"{', '.join(f'{m:.1f}' for m in full_again)})", flush=True)
    if on_card:
        print(f"{mode} stage device deltas sum to {sum(r['delta_device_ms'] for r in rows):.3f} "
              f"ms/frame; the untruncated frame profiled again {device_again:.3f} ms/frame "
              f"({_readings_text(again)})", flush=True)
    return {"rows": rows, "full_again": full_again, "device_again": device_again,
            "device_again_readings": again}


if __name__ == "__main__":
    main()
