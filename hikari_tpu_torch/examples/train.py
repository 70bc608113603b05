"""Inverse rendering demo: recover a material's base color from a target image
by gradient descent through the full renderer — the port of
``examples/train.py``.

Usage:
  python -m hikari_tpu_torch.examples.train --steps 40 --size 48

It runs on the CUDA card; ``--cpu`` runs the plain twins on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def train(steps: int, size: int, lr: float, device, log=print):
    """Gradient descent on the base colour of material row 3 from grey,
    towards the frame rendered with the true colours, as
    ``examples/train.py`` does (which calls row 3 the left wall; in the
    procedural Cornell box it is the light quad's material, 0.78 grey).
    Returns (the loss of each step, the final colour row, the true row)."""
    from hikari_tpu_torch.config import RenderSettings, Taa, Upscale
    from hikari_tpu_torch.diff import replace_scene_field
    from hikari_tpu_torch.io.scenes import cornell_config
    from hikari_tpu_torch.render import initial_state, render_frame
    from hikari_tpu_torch.scene import build_scene_buffers

    scene, cam, _ = cornell_config(size=size, device=device)
    settings = RenderSettings(
        width=size, height=size, upscale=Upscale.none(),
        taa=Taa.NONE, denoise=True, indirect_bounces=1,
        indirect_spatial_reuse=False,
    )
    buffers = build_scene_buffers(scene, device)
    state = initial_state(settings, device)

    # Ground truth: the true colours. Start row 3 from grey.
    true_colors = buffers.mat_base_color
    with torch.no_grad():
        target, _ = render_frame(buffers, cam, state, settings)
    target_img = target.image[..., :3]

    colors = true_colors.clone()
    colors[3, :3] = 0.5
    # Optimize only the unknown material (row 3).
    mask = torch.zeros_like(colors)
    mask[3, :3] = 1.0

    def step(colors):
        c = colors.detach().requires_grad_(True)
        out, _ = render_frame(replace_scene_field(buffers, mat_base_color=c), cam, state, settings)
        loss = torch.mean((out.image[..., :3] - target_img) ** 2)
        (g,) = torch.autograd.grad(loss, c)
        with torch.no_grad():
            return loss.detach(), torch.clamp(colors - lr * g * mask, 0.0, 1.0)

    true_np = true_colors[3, :3].cpu().numpy()
    losses = []
    for i in range(steps):
        loss, colors = step(colors)
        losses.append(float(loss))
        if i % 5 == 0 or i == steps - 1:
            est = colors[3, :3].cpu().numpy()
            log(
                f"step {i:3d}  loss {losses[-1]:.6f}  "
                f"estimate {est.round(3)}  true {true_np.round(3)}"
            )
    return losses, colors[3, :3].cpu().numpy(), true_np


def main(argv=None) -> float:
    """Returns the final max-abs error of the recovered colour."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the plain twins)")
    args = ap.parse_args(argv)

    from hikari_tpu_torch.utils import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    _, est, true = train(args.steps, args.size, args.lr, device)
    err = float(np.abs(est - true).max())
    print(f"final max-abs error: {err:.4f}")
    return err


if __name__ == "__main__":
    main()
