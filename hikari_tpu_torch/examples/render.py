"""Render a benchmark scene config to a PNG — the port of
``examples/render.py``, the headless counterpart of the reference's example
binaries (examples/{cornell,minimal,simple,scene,city}.rs).

Usage:
  python -m hikari_tpu_torch.examples.render cornell --frames 16 --size 256 --out cornell.png

It runs on the CUDA card; ``--cpu`` runs the plain twins on the CPU.
``--stream`` streams the scene's instances in over the frames, as
examples/city.rs:23 loads models over time: the first instance is active
from the start, the others are switched on in batches, one batch a frame,
through ``scene.update_activity`` (a device-side refit, no recompile).
``--trace DIR`` writes a ``torch.profiler`` Chrome trace of the frames to
``DIR/trace.json``: each frame is the range ``render_frame``, each pass a
``pass:<name>`` range, each search a ``trace_rays`` range and each host
sync a ``host_sync:<site>`` range.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

CONFIG_NAMES = ("cornell", "minimal", "simple", "scene", "city")


def make_config(name: str, size: int, device, assets=None):
    """(scene, camera, settings) of a config at ``size`` (square; cornell's
    constructor takes one size)."""
    from hikari_tpu_torch.io.scenes import CONFIGS

    if name == "cornell":
        return CONFIGS[name](size, device=device, assets=assets)
    if name == "scene":
        return CONFIGS[name](size, size, device=device, assets=assets)
    return CONFIGS[name](size, size, device=device)


def stream_masks(num_instances: int, frames: int) -> list[np.ndarray]:
    """The per-frame activity masks of ``--stream`` (the JAX entry point's
    rule, examples/render.py:51-76): instance 0 is active from the start,
    and frame i switches on instances ``1 + i*batch`` up to
    ``1 + (i+1)*batch`` with ``batch = max(1, (I-1)//max(frames-1, 1) + 1)``."""
    active = np.zeros(num_instances, dtype=bool)
    active[0] = True
    batch = max(1, (num_instances - 1) // max(frames - 1, 1) + 1)
    masks = []
    for i in range(frames):
        active = active.copy()
        lo = 1 + i * batch
        active[lo: lo + batch] = True
        masks.append(active)
    return masks


def render(name: str, frames: int, size: int, device, assets=None, stream: bool = False):
    """Render ``frames`` frames of a config from a fresh state; with
    ``stream`` the instances stream in (``stream_masks``), each change
    applied by ``update_activity`` inside the frame's timing. Returns
    (last RenderOutputs, last FrameState, FrameTimer of the frames, the
    activity mask of each frame)."""
    from hikari_tpu_torch.render import initial_state, render_frame
    from hikari_tpu_torch.scene import build_scene_buffers, update_activity
    from hikari_tpu_torch.utils.profiling import FrameTimer

    scene, cam, settings = make_config(name, size, device, assets)
    buffers = build_scene_buffers(scene, device)
    state = initial_state(settings, device)
    masks = [buffers.inst_active.cpu().numpy()] * frames
    if stream:
        first = np.zeros(buffers.num_instances, dtype=bool)
        first[0] = True
        buffers = update_activity(buffers, first)
        masks = stream_masks(buffers.num_instances, frames)
    timer = FrameTimer()
    out = None
    active = buffers.inst_active.cpu().numpy()
    with torch.no_grad():
        for mask in masks:
            with timer.time(True):
                if not np.array_equal(mask, active):
                    buffers = update_activity(buffers, mask)
                    active = mask
                out, state = render_frame(buffers, cam, state, settings)
    return out, state, timer, masks


def parse(argv, description):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("config", choices=CONFIG_NAMES)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the plain twins)")
    ap.add_argument("--assets", default=None,
                    help="the reference's asset directory (default: $HIKARI_REFERENCE_ASSETS)")
    return ap


def main(argv=None) -> dict:
    """Returns {"path", "image" (h, w, 3), "frame_seconds", "outputs": the
    last RenderOutputs, "masks": each frame's instance activity}."""
    ap = parse(argv, __doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the frames to DIR/trace.json")
    ap.add_argument(
        "--stream", action="store_true",
        help="city.rs-style model streaming: start with most instances inactive and "
        "activate a batch per frame via the device-side visibility mask "
        "(scene/update.py update_activity) — no recompile",
    )
    args = ap.parse_args(argv)
    from hikari_tpu_torch.io.image import write_png
    from hikari_tpu_torch.utils import profiling, resolve_device

    device = torch.device("cpu") if args.cpu else resolve_device()
    syncs = profiling.host_syncs
    with profiling.trace_to(args.trace) if args.trace else contextlib.nullcontext():
        out, _, timer, masks = render(args.config, args.frames, args.size, device, args.assets,
                                      args.stream)
    seconds = sum(timer.samples)
    print(f"{args.frames} frames in {seconds:.2f}s ({args.frames / seconds:.1f} fps) on {device}, "
          f"{(profiling.host_syncs - syncs) / args.frames:g} host syncs a frame")
    if args.trace:
        print(f"wrote {args.trace}/trace.json")
    path = args.out or f"{args.config}_{args.size}.png"
    img = out.image[..., :3].cpu().numpy()
    write_png(path, img)
    print(f"wrote {path}  range=[{img.min():.4f},{img.max():.4f}]")
    return dict(path=path, image=img, frame_seconds=timer.samples, outputs=out, masks=masks)


if __name__ == "__main__":
    main()
