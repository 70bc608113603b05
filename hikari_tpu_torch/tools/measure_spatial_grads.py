"""Cost and benefit of ``settings.spatial_radiance_grads`` — the port of the
repository's ``tools/measure_spatial_grads.py``. With the flag on,
reservoir radiance stays attached through the spatial-reuse merge (the
selection stays detached), so material and light gradients pick up the
radiance-through-reuse term; off (the default), the spatial pass is a
constant with respect to the scene.

    python -m hikari_tpu_torch.tools.measure_spatial_grads [--cpu] [--size 64] [-k 6] [--warm 4]

Cornell at ``--size`` without upscale, TAA or denoise, one bounce, both
spatial reuses, f32 reservoirs. After ``--warm`` frames it keeps K states
at consecutive frame counters (K realizations of the same estimator) and
reports for each policy the gradient of the image's mean with respect to
``mat_emissive``: its mean magnitude (signal), the across-realization
relative std on the significant entries (estimator noise), the wall time
per gradient (the best of K, between synchronizes on the card) and the
peak device memory (``torch.cuda.max_memory_allocated``; on the card
only). Lines go to standard error; ``main`` returns {flag: (signal,
noise, seconds, peak bytes or None, mean gradient)}.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    from hikari_tpu_torch.config import RenderSettings, Taa, Upscale
    from hikari_tpu_torch.diff import replace_scene_field
    from hikari_tpu_torch.io.scenes import cornell_config
    from hikari_tpu_torch.render.pipeline import initial_state, render_frame
    from hikari_tpu_torch.scene import build_scene_buffers
    from hikari_tpu_torch.utils import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("-k", type=int, default=6)
    ap.add_argument("--warm", type=int, default=4)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    scene, cam, _ = cornell_config(size=args.size, device=device)
    base = RenderSettings(
        width=args.size, height=args.size, upscale=Upscale.none(), denoise=False,
        taa=Taa.NONE, indirect_bounces=1, indirect_spatial_reuse=True,
        emissive_spatial_reuse=True, reservoir_f16=False,
    )
    buffers = build_scene_buffers(scene, device)

    # Warm, then keep K states at consecutive frame counters: each is a
    # different realization of the same stationary estimator.
    states = []
    state = initial_state(base, device)
    with torch.no_grad():
        for _ in range(args.warm):
            state = render_frame(buffers, cam, state, base)[1]
        for _ in range(args.k):
            state = render_frame(buffers, cam, state, base)[1]
            states.append(state)

    def measure(settings, field="mat_emissive"):
        x0 = getattr(buffers, field).detach()

        def grad(st):
            x = x0.clone().requires_grad_(True)
            with torch.enable_grad():
                out, _ = render_frame(replace_scene_field(buffers, **{field: x}), cam, st,
                                      settings)
                return torch.autograd.grad(out.image[..., :3].mean(), x)[0]

        grad(states[0])  # warm-up
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        grads, dts = [], []
        for st in states:
            sync()
            t0 = time.perf_counter()
            g = grad(st)
            _ = float(g.abs().sum())
            sync()
            dts.append(time.perf_counter() - t0)
            grads.append(g.cpu().numpy())
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        G = np.stack(grads)  # (K, ...)
        mean = G.mean(0)
        std = G.std(0)
        signal = float(np.abs(mean).sum())
        sig = np.abs(mean) > 0.05 * np.abs(mean).max()  # the significant entries
        rel_noise = float((std[sig] / np.abs(mean)[sig]).mean())
        return signal, rel_noise, min(dts), peak, mean

    rows = {}
    for flag in (False, True):
        rows[flag] = measure(base.replace(spatial_radiance_grads=flag))
        sig, noise, dt, peak, _ = rows[flag]
        peak_s = f"{peak / 2**20:.0f} MiB" if peak is not None else "n/a"
        print(f"spatial_radiance_grads={flag!s:5}  |grad|={sig:.4e}  rel-noise={noise:.3f}  "
              f"t/grad={dt * 1e3:.1f} ms  peak={peak_s}", file=sys.stderr)

    m_off, m_on = rows[False][4], rows[True][4]
    extra = np.abs(m_on - m_off).sum() / max(np.abs(m_off).sum(), 1e-30)
    print(f"# radiance-through-reuse term adds {100 * extra:.1f}% extra |grad| mass vs detached",
          file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
