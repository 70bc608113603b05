"""How often the ``clip_gradient`` firewall binds — the port of the
repository's ``tools/clip_engagement.py``: three fwd+grad train steps per
config with ``HIKARI_COUNT_CLIP=1`` and, per clip site, the cotangents
that were NaN or past the site's limit out of those seen
(``diff.clip_engagement_report``).

    python -m hikari_tpu_torch.tools.clip_engagement [--config cornell scene] [--size 256] [--cpu]

Each config runs at ``--size`` square output from half that with SMAA
TU4x at 2, TAA Jasmine, denoise and one bounce (the JAX tool's
settings; ``remat`` at its default, on) against a zero target. The
report goes to standard output; ``main`` returns {config: (last loss,
report)}.
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None) -> dict:
    from hikari_tpu_torch.config import Taa, Upscale
    from hikari_tpu_torch.diff import clip_engagement_report, reset_clip_engagement
    from hikari_tpu_torch.io.scenes import CONFIGS
    from hikari_tpu_torch.parallel import make_train_step
    from hikari_tpu_torch.render.pipeline import initial_state
    from hikari_tpu_torch.scene import build_scene_buffers
    from hikari_tpu_torch.utils import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", nargs="*", default=["cornell", "scene"])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    counting = os.environ.get("HIKARI_COUNT_CLIP")
    os.environ["HIKARI_COUNT_CLIP"] = "1"  # read by each backward of clip_gradient
    results = {}
    try:
        for name in args.config:
            scene, camera, settings = CONFIGS[name](device=device)
            settings = settings.replace(
                width=args.size, height=args.size, upscale=Upscale.smaa_tu4x(2.0),
                taa=Taa.JASMINE, denoise=True, indirect_bounces=1,
            )
            buffers = build_scene_buffers(scene, device)
            state = initial_state(settings, device)
            target = torch.zeros(settings.output_size + (3,), device=device)
            step = make_train_step(settings)
            reset_clip_engagement()
            # A few frames so temporal reuse carries real state.
            for _ in range(3):
                loss, _, _, state = step(buffers, camera, state, target)
            print(f"\n# {name} {args.size}x{args.size}, 3 fwd+grad steps, last loss "
                  f"{float(loss):.6g}")
            rep = clip_engagement_report()
            total_e = total_t = 0
            for site, (e, t, rate) in rep.items():
                print(f"  {site:20s} engaged {e:>12,} / {t:>15,}  ({rate:.3e})")
                total_e += e
                total_t += t
            if total_t:
                print(f"  {'TOTAL':20s} engaged {total_e:>12,} / {total_t:>15,}"
                      f"  ({total_e / total_t:.3e})")
            results[name] = (float(loss), rep)
    finally:
        if counting is None:
            os.environ.pop("HIKARI_COUNT_CLIP", None)
        else:
            os.environ["HIKARI_COUNT_CLIP"] = counting
    return results


if __name__ == "__main__":
    main()
