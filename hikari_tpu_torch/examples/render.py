"""Render a benchmark scene config to a PNG — the port of
``examples/render.py``, the headless counterpart of the reference's example
binaries (examples/{cornell,minimal,simple,scene,city}.rs).

Usage:
  python -m hikari_tpu_torch.examples.render cornell --frames 16 --size 256 --out cornell.png

It runs on the CUDA card; ``--cpu`` runs the plain twins on the CPU.
``--stream`` (instances streamed in frame by frame, examples/city.rs)
needs ``scene/update.update_activity``, which is not ported yet: it raises.
"""

from __future__ import annotations

import argparse

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


def render(name: str, frames: int, size: int, device, assets=None):
    """Render ``frames`` frames of a config from a fresh state. Returns
    (last RenderOutputs, last FrameState, FrameTimer of the frames)."""
    from hikari_tpu_torch.render import initial_state, render_frame
    from hikari_tpu_torch.scene import build_scene_buffers
    from hikari_tpu_torch.utils.profiling import FrameTimer, pass_scope

    scene, cam, settings = make_config(name, size, device, assets)
    buffers = build_scene_buffers(scene, device)
    state = initial_state(settings, device)
    timer = FrameTimer()
    out = None
    with torch.no_grad():
        for _ in range(frames):
            with timer.time(True), pass_scope("render_frame"):
                out, state = render_frame(buffers, cam, state, settings)
    return out, state, timer


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
    last RenderOutputs}."""
    ap = parse(argv, __doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--stream", action="store_true",
        help="city.rs-style model streaming (scene/update.py update_activity; not ported yet)",
    )
    args = ap.parse_args(argv)
    if args.stream:
        raise NotImplementedError(
            "--stream needs scene/update.update_activity, which is not ported yet "
            "(ROADMAP.md queue 1 item 6, 'Dynamic scenes')"
        )
    from hikari_tpu_torch.io.image import write_png
    from hikari_tpu_torch.utils import resolve_device

    device = torch.device("cpu") if args.cpu else resolve_device()
    out, _, timer = render(args.config, args.frames, args.size, device, args.assets)
    seconds = sum(timer.samples)
    print(f"{args.frames} frames in {seconds:.2f}s ({args.frames / seconds:.1f} fps) on {device}")
    path = args.out or f"{args.config}_{args.size}.png"
    img = out.image[..., :3].cpu().numpy()
    write_png(path, img)
    print(f"wrote {path}  range=[{img.min():.4f},{img.max():.4f}]")
    return dict(path=path, image=img, frame_seconds=timer.samples, outputs=out)


if __name__ == "__main__":
    main()
