"""Tracer-backend benchmark: rays/s of each ``trace_rays`` backend at several
scene sizes — the port of the repository's ``bench_trace.py``.

    python -m hikari_tpu_torch.bench_trace [--rays 1048576] [--cpu]
        [--backends bruteforce,bvh,pallas,tiled,pallas_tiled,scatter] [--stress]

Scenes (``build_scenes``):
  cornell          36 triangles                — the closest-hit kernel (K1)
  city-8           ~8k triangles               — K1's streamed regime (K1b)
  city-24 | helmet ~30k triangles              — the tile walk's class
  city-551k        550,994 triangles           — the reference-scale city
  terrain-1m       1,002,528 triangles         — ``--stress`` only

(the FlightHelmet glTF takes city-24's place when
``$HIKARI_REFERENCE_ASSETS`` holds it, as in the JAX bench).

Backends: "bruteforce" and "pallas" run K1 (K1b above 2,048 triangles)
with the brute force's and the JAX kernel's tie rule, "pallas_tiled" the
tile walk (K2), "scatter" the scatter kernel (K3); "bvh" and "tiled" are
plain torch (the JAX package's XLA backends) and launch no kernel.

Each backend traces the first ``n`` of the bench's rays (``make_rays``:
half a coherent camera grid, half random rays inside the scene's box),
``n`` capped per backend by the JAX bench's budgets (``ray_budget``). On the
card a measurement warms up, probes one call, then takes the best of 3
windows of ``inner`` calls between ``torch.cuda.synchronize()`` calls
(``inner`` up to 64, about 0.5 s a window). One JSON line per (scene,
backend) goes to standard output, ``{"metric": "trace rays/s
[scene/method]", "value", "unit", "tris"}`` with the kernel launches and
``trace_calls`` of the measurement beside them; each scene's host compile
time and the summary table go to standard error, after the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

BACKENDS = ("bruteforce", "bvh", "pallas", "tiled", "pallas_tiled", "scatter")
KERNEL_BACKENDS = ("bruteforce", "pallas", "pallas_tiled", "scatter")


def build_scenes(stress: bool = False) -> dict:
    """name -> Scene: the JAX bench's scene set, or with ``stress`` the
    million-triangle terrain alone."""
    from hikari_tpu_torch.io.scenes import (
        FLIGHT_HELMET,
        _asset,
        _sun_from_euler,
        cornell_box_scene,
        procedural_city,
        procedural_terrain,
    )
    from hikari_tpu_torch.scene.compile import Scene

    def empty():
        return Scene(materials=[], directional_light=_sun_from_euler(-1.0, 0.6, 0.0))

    if stress:
        return {"terrain-1m": procedural_terrain(empty(), n=708)}
    scenes = {"cornell": cornell_box_scene(), "city-8": procedural_city(empty(), blocks=8)}
    helmet = _asset(None, FLIGHT_HELMET)
    if helmet is not None:
        from hikari_tpu_torch.io.gltf import load_gltf

        scenes["helmet"] = load_gltf(helmet, empty())
    else:
        scenes["city-24"] = procedural_city(empty(), blocks=24)
    # The reference-scale geometry: 16x16 blocks of window-facade towers.
    scenes["city-551k"] = procedural_city(empty(), blocks=16, detail=True)
    return scenes


def make_rays(buffers, n: int, seed: int = 0, device=None):
    """(o, d), each (n, 3) f32: half coherent (a camera grid into the
    scene), half incoherent (random origins in the scene's box, random
    directions) — the JAX bench's numpy rays, on ``device``."""
    rng = np.random.default_rng(seed)
    lo = buffers.inst_min.cpu().numpy().min(0)
    hi = buffers.inst_max.cpu().numpy().max(0)
    center = 0.5 * (lo + hi)
    diag = float(np.linalg.norm(hi - lo))

    nc = n // 2
    side = int(np.sqrt(nc))
    nc = side * side
    ys, xs = np.meshgrid(np.linspace(-0.5, 0.5, side), np.linspace(-0.5, 0.5, side), indexing="ij")
    eye = center + np.array([0.0, 0.25 * diag, 1.2 * diag], np.float32)
    d_coh = np.stack([xs.ravel(), ys.ravel() - 0.2, -np.ones(nc)], axis=-1).astype(np.float32)
    d_coh /= np.linalg.norm(d_coh, axis=-1, keepdims=True)
    o_coh = np.broadcast_to(eye, (nc, 3)).astype(np.float32)

    ni = n - nc
    o_inc = rng.uniform(lo, hi, (ni, 3)).astype(np.float32)
    d_inc = rng.normal(size=(ni, 3)).astype(np.float32)
    d_inc /= np.linalg.norm(d_inc, axis=-1, keepdims=True)

    o = torch.from_numpy(np.concatenate([o_coh, o_inc])).to(device)
    d = torch.from_numpy(np.concatenate([d_coh, d_inc])).to(device)
    return o, d


def ray_budget(method: str, num_tris: int, rays: int) -> int:
    """The rays a backend traces: the JAX bench's per-backend budget
    (``bench_trace.py:148-167``), rounded down to a power of two, at least
    16,384 and at most ``rays``."""
    if method == "bvh":
        budget = rays if num_tris <= 10_000 else 1 << 16
    elif method == "pallas_tiled":
        budget = max(1 << 16, int(5.1e11) // max(num_tris, 1))
    elif method == "scatter":
        budget = 1 << 18
    else:
        budget = max(1 << 16, int(4e10) // max(num_tris, 1))
    n_rays = min(rays, 1 << max(budget, 2).bit_length() - 1)
    return max(n_rays, 1 << 14)


def _reset_counts():
    """Set the trace kernels' launch counts and ``trace_calls`` to 0."""
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.trace import scatter as sc
    from hikari_tpu_torch.trace import tile_walk as tw

    ch.launches = ch.streamed_launches = tw.launches = sc.launches = api.trace_calls = 0


def _counts():
    """(kernel launches, K1b launches, trace_calls) since ``_reset_counts``."""
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.trace import scatter as sc
    from hikari_tpu_torch.trace import tile_walk as tw

    return (ch.launches + tw.launches + sc.launches, ch.streamed_launches, api.trace_calls)


def measure(buffers, o, d, method: str, windows: int = 3, max_inner: int = 64) -> dict:
    """Rays/s of ``trace_rays(buffers, o, d, method=method)``: one warm-up
    call, one probe, then the best of ``windows`` windows of ``inner`` calls
    (``inner`` = 0.5 s over the probe, within [1, max_inner]), each window
    between synchronizes on the card. The launch counts and ``trace_calls``
    are set to 0 just before the first call and read just after the last.
    Returns the rate, the window's per-call seconds, ``inner``, the
    warm-up call's hit, and the kernel launches, K1b (streamed) launches
    and ``trace_calls`` made by all the calls."""
    from hikari_tpu_torch.trace import api

    cuda = o.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(o.device)

    _reset_counts()
    hit = api.trace_rays(buffers, o, d, method=method)  # build + warm
    sync()
    t0 = time.perf_counter()
    api.trace_rays(buffers, o, d, method=method)
    sync()
    probe = time.perf_counter() - t0
    inner = int(max(1, min(max_inner, 0.5 / max(probe, 1e-3))))
    best = float("inf")
    for _ in range(windows):
        sync()
        t0 = time.perf_counter()
        for _ in range(inner):
            api.trace_rays(buffers, o, d, method=method)
        sync()
        best = min(best, (time.perf_counter() - t0) / inner)
    launches, streamed, calls = _counts()
    return {"rays_per_s": o.shape[0] / best, "seconds": best, "inner": inner, "hit": hit,
            "launches": launches, "k1b_launches": streamed, "trace_calls": calls}


def main(argv=None) -> dict:
    """Run the bench; return {"rows": [...], "failed": [...]}: one row per
    measured (scene, backend) with its record and counts."""
    from hikari_tpu_torch.scene import compile_scene, to_device
    from hikari_tpu_torch.utils import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--backends", default=",".join(BACKENDS))
    ap.add_argument("--stress", action="store_true",
                    help="bench the ~1M-triangle terrain instead of the 4-scene set")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        print(f"# device={torch.cuda.get_device_name(device)}; nvidia-smi: {smi}",
              file=sys.stderr)
    else:
        print("# device=cpu", file=sys.stderr)

    rows, failed = [], []
    for name, scene in build_scenes(stress=args.stress).items():
        t0 = time.perf_counter()
        buffers = to_device(compile_scene(scene), device)
        compile_s = time.perf_counter() - t0
        o, d = make_rays(buffers, args.rays, device=device)
        print(f"# {name}: {buffers.num_tris} triangles, host compile {compile_s:.2f} s",
              file=sys.stderr)
        for method in args.backends.split(","):
            n_rays = ray_budget(method, buffers.num_tris, args.rays)
            try:
                m = measure(buffers, o[:n_rays], d[:n_rays], method)
            except Exception as e:  # one backend's failure does not stop the others
                print(f"# {name}/{method} FAILED: {e!r}", file=sys.stderr)
                failed.append((name, method, repr(e)))
                continue
            record = {"metric": f"trace rays/s [{name}/{method}]", "value": m["rays_per_s"],
                      "unit": "rays/s", "tris": buffers.num_tris, "rays": n_rays,
                      "launches": m["launches"], "k1b_launches": m["k1b_launches"],
                      "trace_calls": m["trace_calls"]}
            print(json.dumps(record), flush=True)
            rows.append(dict(record, scene=name, method=method, compile_s=compile_s,
                             seconds=m["seconds"], inner=m["inner"]))
        del buffers, o, d
        if device.type == "cuda":
            torch.cuda.empty_cache()

    print(f"\n# {'scene':<10} {'tris':>8} {'backend':<12} {'rays':>8} {'Mrays/s':>10} "
          f"{'launches':>8} {'calls':>6}", file=sys.stderr)
    for r in rows:
        print(f"# {r['scene']:<10} {r['tris']:>8} {r['method']:<12} {r['rays']:>8} "
              f"{r['value'] / 1e6:>10.3f} {r['launches']:>8} {r['trace_calls']:>6}",
              file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    return {"rows": rows, "failed": failed}


if __name__ == "__main__":
    sys.exit(1 if main()["failed"] else 0)
