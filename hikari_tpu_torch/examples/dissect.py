"""Render the per-pass dissection set of a scene config — the port of
``examples/dissect.py``: albedo, direct, emissive, indirect, tone-mapping,
render, depth and normal as PNGs, for eyeballing each stage.

Usage:
  python -m hikari_tpu_torch.examples.dissect cornell --frames 32 --size 256 --out-dir dissect

It runs on the CUDA card; ``--cpu`` runs the plain twins on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hikari_tpu_torch.examples.render import parse, render

# (name, RenderOutputs field, scale) of the pass images.
PASSES = (
    ("albedo", "albedo", 1.0),  # full_screen_albedo
    ("direct", "direct", 1.0),  # direct-temporal/denoised
    ("emissive", "emissive", 4.0),  # emissive-spatial (boosted)
    ("indirect", "indirect", 2.0),  # indirect-denoised (boosted)
    ("tone-mapping", "tonemapped", 1.0),  # tone_mapping output
    ("render", "image", 1.0),  # final (post TAA/upscale)
)


def main(argv=None) -> dict:
    """Returns {"images": {pass: (path, image)}, "frame_seconds",
    "outputs": the last RenderOutputs}."""
    ap = parse(argv, __doc__.splitlines()[0])
    ap.set_defaults(frames=32)
    ap.add_argument("--out-dir", default="dissect")
    args = ap.parse_args(argv)
    from hikari_tpu_torch.io.image import write_png
    from hikari_tpu_torch.utils import resolve_device

    device = torch.device("cpu") if args.cpu else resolve_device()
    out, state, timer, _ = render(args.config, args.frames, args.size, device, args.assets)
    os.makedirs(args.out_dir, exist_ok=True)
    written = {}

    def dump(name, img, scale=1.0):
        img = np.asarray(img)[..., :3] * scale
        path = os.path.join(args.out_dir, f"{args.config}-{name}.png")
        write_png(path, img)
        written[name] = (path, img)
        print(f"wrote {path}")

    for name, field, scale in PASSES:
        dump(name, getattr(out, field).cpu().numpy(), scale)
    gb = state.prev_gbuffer
    depth = gb.position[..., 3].cpu().numpy()
    dump("depth", np.repeat(depth[..., None], 3, axis=-1) * 2.0)
    dump("normal", gb.normal.cpu().numpy() * 0.5 + 0.5)
    return dict(images=written, frame_seconds=timer.samples, outputs=out)


if __name__ == "__main__":
    main()
