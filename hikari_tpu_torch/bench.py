"""The port's benchmark: rays/sec fwd+grad, 1080p Cornell, on the CUDA card
— the counterpart of the repository's ``bench.py``.

    python -m hikari_tpu_torch.bench [--config cornell]

It times what ``bench.py`` times: 8 frames of the fwd+grad train step
(``parallel.make_train_step``) at the bench settings, the state carried
from frame to frame detached and the gradients coupled into a carried
scalar (``acc + loss + 1e-12 * sum |g|``), after one warm-up run; the best
of 3 runs, each closed by ``torch.cuda.synchronize()`` and a fetch of the
scalar. It prints one JSON line with ``bench.py``'s keys and metric names,
and ``finite``: whether every run's scalar was finite (a false one means
the time is that of a run with non-finite gradients); for cornell the
``scene`` and ``city`` configs at 512p follow under ``extra`` within a
900 s budget (``HIKARI_BENCH_NO_EXTRA=1`` leaves them out). The city's
550,994 triangles take the tile walk (``tracer="auto"``).
Standard error gets each run's ms/frame, the peak device memory and the
card's name and power limit. It needs the card: a device benchmark has no
CPU fallback.

Ray accounting (``rays_per_frame``) is ``bench.py``'s: primary rays at the
output size, then per render pixel the direct shadow ray (+ validation
retrace), the emissive target and shadow rays, and per bounce the bounce,
NEE target and NEE shadow rays. The backward traces no ray, so rays/s
divides the forward's rays by the whole fwd+grad time.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch

BASELINE_RAYS_PER_SEC = 1.0e9  # bench.py's nominal target: 1 Grays/s fwd+grad
FRAMES = 8
REPS = 3
EXTRA_REPS = 2
EXTRA_BUDGET_S = 900.0


def rays_per_frame(settings, scene_buffers) -> float:
    oh, ow = settings.output_size
    rh, rw = settings.render_size
    primary = oh * ow
    per_px = 0.0
    # direct channel (+ amortized validation retrace)
    per_px += 1.0 * (1.0 + 1.0 / max(settings.direct_validate_interval, 1))
    if settings.emissive_lit and scene_buffers.num_emissives > 0:
        per_px += 2.0 * (1.0 + 1.0 / max(settings.emissive_validate_interval, 1))
    bounces = max(settings.indirect_bounces, 1)
    nee = 3.0 if scene_buffers.num_emissives > 0 else 2.0
    per_px += nee * bounces
    return primary + per_px * rh * rw


def bench_config(config: str, device=None):
    """(scene, camera, settings) of the bench case for ``config``: 1920x1080
    for cornell, 512x512 otherwise, SMAA TU4x at ratio 2, TAA Jasmine,
    denoise, one indirect bounce, ``reproject="shift"``, no remat — the
    settings of ``bench.py:77-116``."""
    from hikari_tpu_torch.config import Taa, Upscale
    from hikari_tpu_torch.io.scenes import CONFIGS

    width, height = (1920, 1080) if config == "cornell" else (512, 512)
    scene, camera, settings = CONFIGS[config](device=device)
    settings = settings.replace(
        width=width, height=height, upscale=Upscale.smaa_tu4x(2.0), taa=Taa.JASMINE,
        denoise=True, indirect_bounces=1, reproject="shift", remat=False,
    )
    return scene, camera, settings


def make_run_frames(settings, frames: int):
    """``run_frames(scene, camera, state, target) -> (acc, state)``:
    ``frames`` train steps from ``state``, each frame's loss and gradients
    added into ``acc`` on the device (no host sync inside)."""
    from hikari_tpu_torch.parallel import make_train_step

    step = make_train_step(settings)

    def run_frames(scene, camera, state, target):
        acc = torch.zeros((), device=target.device)
        for _ in range(frames):
            loss, grads, _, state = step(scene, camera, state, target)
            gsum = sum(g.abs().sum() for g in grads.values())
            acc = acc + loss + 1e-12 * gsum
        return acc, state

    return run_frames


def build_bench_case(config: str, frames: int, device=None):
    """The workload the bench times. Returns (run_frames, (buffers, camera,
    state, target), settings)."""
    from hikari_tpu_torch.render import initial_state
    from hikari_tpu_torch.scene import build_scene_buffers
    from hikari_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    scene, camera, settings = bench_config(config, device)
    buffers = build_scene_buffers(scene, device)
    state = initial_state(settings, device)
    target = torch.zeros(settings.output_size + (3,), device=device)
    return make_run_frames(settings, frames), (buffers, camera, state, target), settings


def time_case(run_frames, ops, reps: int, label: str):
    """One warm-up run, then ``reps`` timed runs of ``run_frames``, each
    closed by a synchronize and a value fetch. Returns (best seconds,
    whether every run's acc was finite)."""
    acc, _ = run_frames(*ops)
    finite = math.isfinite(float(acc))
    times = []
    for rep in range(reps):
        t0 = time.perf_counter()
        acc, _ = run_frames(*ops)
        torch.cuda.synchronize()
        v = float(acc)
        dt = time.perf_counter() - t0
        times.append(dt)
        finite = finite and math.isfinite(v)
        print(f"# {label} rep {rep}: {FRAMES} frames in {dt:.4f}s "
              f"({dt / FRAMES * 1e3:.2f} ms/frame, acc={v:.6f})", file=sys.stderr)
    return min(times), finite


def run_extras(device):
    """The ``scene`` and ``city`` configs at 512p within the time budget;
    an extra that fails is recorded with its error, as ``bench.py`` does,
    so that the cornell record is always printed."""
    extra = []
    t_start = time.perf_counter()
    for cfg in ("scene", "city"):
        remaining = EXTRA_BUDGET_S - (time.perf_counter() - t_start)
        if remaining < 60.0:
            extra.append({"config": cfg, "skipped": "time budget"})
            continue
        try:
            xrun, xops, xsettings = build_bench_case(cfg, FRAMES, device)
            xbest, xfinite = time_case(xrun, xops, EXTRA_REPS, f"extra {cfg}")
            xrays = rays_per_frame(xsettings, xops[0]) * FRAMES
            extra.append({
                "config": cfg,
                "metric": f"rays/sec/chip fwd+grad, 512p {cfg}",
                "value": xrays / xbest,
                "unit": "rays/s",
                "ms_per_frame": xbest / FRAMES * 1e3,
                "tracer": xsettings.tracer,
                "finite": xfinite,
            })
            print(f"# extra {cfg}: {xbest / FRAMES * 1e3:.1f} ms/frame fwd+grad "
                  f"({xrays / xbest / 1e6:.2f} Mrays/s)"
                  + ("" if xfinite else "; NOT FINITE: a run with non-finite gradients"),
                  file=sys.stderr)
        except Exception as e:  # an extra never stops the cornell record
            traceback.print_exc()
            extra.append({"config": cfg, "error": repr(e)[:200]})
        finally:
            torch.cuda.empty_cache()
    return extra


def main(argv=None) -> dict:
    """Run the bench; print and return its record."""
    import argparse

    from hikari_tpu_torch.io.scenes import CONFIGS
    from hikari_tpu_torch.utils import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="cornell", choices=sorted(CONFIGS),
                    help="cornell at 1080p (the north-star metric) adds the scene and city "
                         "extras at 512p; any other config runs alone at 512p")
    args = ap.parse_args(argv)

    device = resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"# device={torch.cuda.get_device_name(device)}; nvidia-smi: {smi}", file=sys.stderr)

    run_frames, ops, settings = build_bench_case(args.config, FRAMES, device)
    torch.cuda.reset_peak_memory_stats(device)
    best, finite = time_case(run_frames, ops, REPS, args.config)
    peak = torch.cuda.max_memory_allocated(device)
    rays_per_sec = rays_per_frame(settings, ops[0]) * FRAMES / best
    del run_frames, ops
    torch.cuda.empty_cache()

    extra = None
    if args.config == "cornell" and os.environ.get("HIKARI_BENCH_NO_EXTRA", "0") in ("0", ""):
        extra = run_extras(device)

    record = {
        "metric": (
            "rays/sec/chip fwd+grad, 1080p Cornell" if args.config == "cornell"
            else f"rays/sec/chip fwd+grad, {settings.output_size[0]}p {args.config}"
        ),
        "value": rays_per_sec,
        "unit": "rays/s",
        "vs_baseline": rays_per_sec / BASELINE_RAYS_PER_SEC,
        "finite": finite,
    }
    if extra is not None:
        record["extra"] = extra
    print(json.dumps(record), flush=True)
    print(f"# peak device memory ({args.config}): {peak / 2**30:.3f} GiB", file=sys.stderr)
    print(f"# frames={FRAMES} best={best:.4f}s ({best / FRAMES * 1e3:.2f} ms/frame) "
          f"finite={finite} device={torch.cuda.get_device_name(device)}; {smi}",
          file=sys.stderr, flush=True)
    return record


if __name__ == "__main__":
    main()
