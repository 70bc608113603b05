"""Microbenchmark of the post chain's candidate primitives on the card —
the port of ``tools/bench_pallas_prims.py``, with its cases, sizes and
checks:

1. the window-table pack: 8 planes of 1080 x 1920 and 16 column taps into
   a (2,073,600, 128) row table, consumed by the same row gather the
   pipeline does (a sum alone could skip building the table), once by the
   plain twin (``window_pack_reference``, the tool's XLA pack) and once by
   the kernel (``window_pack``, T1), checked against the plain value;
2. the gathers: ``take_along_sum`` (T2/T3) at the TPU tool's shapes
   ((512, 128) along axis 1 with 32, 128 and 1 repeats; (8, 1024) along
   axis 0 with 32), each checked against its closed-form sum, and T2's
   single gather at (512, 512) along both axes, which the TPU tool defines
   (``make_g``) but does not time.

Timing as in the TPU tool: each case runs ``REPS`` invocations folded into
one carried sum, synced by reading the value; the best of three runs over
``REPS`` is printed per invocation. The row indices of the consuming
gather are a seeded torch draw (the TPU tool's came from ``jax.random``),
so the values differ from the TPU tool's; each check is internal.

Usage: python -m hikari_tpu_torch.tools.bench_pallas_prims [--cpu] [--pack-size HxW]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from hikari_tpu_torch.tools import prims
from hikari_tpu_torch.utils import resolve_device

REPS = 16
PACK_HW = (1080, 1920)
PLANES = 8
DXS = list(range(16))
# The TPU tool's check: |value - check| <= |check| * 1e-4 + 1e-3.
REL_TOL, ABS_TOL = 1e-4, 1e-3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scan_of(body):
    """``REPS`` invocations ``body(k)`` summed into one f32 scalar."""

    def run():
        acc = None
        for k in range(REPS):
            v = body(k)
            acc = v if acc is None else acc + v
        return acc

    return run


def main(argv=None) -> dict:
    """Run every case; print one line each; return {name: {"ms", "value",
    "check", "ok", "window_pack", "take_along"}} (the last two: the
    kernels' launches during the case)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run the plain twins on the CPU")
    ap.add_argument("--pack-size", default=f"{PACK_HW[0]}x{PACK_HW[1]}",
                    help="image size of the pack case, HxW")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu else resolve_device()
    H, W = (int(v) for v in args.pack_size.split("x"))
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU (plain twins)"
    print(f"bench_pallas_prims on {where}", flush=True)
    results = {}

    def timed(name, fn, check=None):
        before = (prims.window_pack_launches, prims.take_along_launches)
        value = float(fn())
        ok = check is None or abs(value - check) <= abs(check) * REL_TOL + ABS_TOL
        best = 1e30
        if ok:
            for _ in range(3):
                _sync(device)
                t0 = time.perf_counter()
                _ = float(fn())
                best = min(best, (time.perf_counter() - t0) / REPS)
            print(f"{name:44s} {best * 1e3:9.3f} ms", flush=True)
        else:
            print(f"{name:44s} WRONG: {value} != {check}", flush=True)
        results[name] = dict(
            ms=best * 1e3 if ok else None, value=value, check=check, ok=ok,
            window_pack=prims.window_pack_launches - before[0],
            take_along=prims.take_along_launches - before[1],
        )

    # 1. Window-table pack + row gather.
    N = H * W
    ramp = torch.arange(N, dtype=torch.float32, device=device)
    planes = torch.stack([torch.sin(ramp * 1e-5 * (1 + c)).reshape(H, W) for c in range(PLANES)])
    gen = torch.Generator().manual_seed(0)
    jitter = torch.randint(-3000, 3000, (N,), generator=gen)
    gidx = torch.clamp(torch.arange(N) + jitter, 0, N - 1).to(device)

    def consume(table, k):
        return table[(gidx + k) % N].sum()

    def plain_pack(k):
        return consume(prims.window_pack_reference(planes + k, DXS), k)

    def kernel_pack(k):
        return consume(prims.window_pack(planes + k, DXS), k)

    name = f"torch pack {PLANES}x{len(DXS)} -> ({N},{PLANES * len(DXS)}) + gather"
    timed(name, scan_of(plain_pack))
    timed("cuda pack (window_pack.cu) + gather", scan_of(kernel_pack),
          check=results[name]["value"])
    del planes, ramp, gidx, jitter

    # 2. Gathers along one axis.
    def gather_case(x, idx, axis, reps):
        def body(k):
            return prims.take_along_sum(x + k, idx, axis, reps).sum()

        base = float(torch.take_along_dim(x, idx.long(), dim=axis).double().sum())
        want = (REPS * sum(base + r * idx.numel() for r in range(reps))
                + sum(range(REPS)) * reps * idx.numel())
        return scan_of(body), want

    def grid(m, n):
        return (torch.arange(m * n, dtype=torch.float32, device=device) * 1e-4).reshape(m, n)

    def draw(shape, high):
        return torch.randint(0, high, shape, generator=gen, dtype=torch.int32).to(device)

    x, M = grid(512, 512), 512
    for axis in (0, 1):
        body, want = gather_case(x, draw((M, M), M), axis, 1)
        timed(f"in-kernel gather axis={axis} (512x512)", body, check=want)
    x1, j1 = grid(512, 128), draw((512, 128), 128)
    for reps in (32, 128, 1):
        body, want = gather_case(x1, j1, 1, reps)
        timed(f"in-kernel {reps}x gather axis=1 (512x128)", body, check=want)
    x0, j0 = grid(8, 1024), draw((8, 1024), 8)
    body, want = gather_case(x0, j0, 0, 32)
    timed("in-kernel 32x gather axis=0 (8x1024)", body, check=want)
    return results


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main().values()) else 1)
