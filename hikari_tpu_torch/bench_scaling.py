"""Multi-rank scaling benchmark: rays/s at 1 and N ranks, and the scaling
efficiency — the port of the repository's ``bench_scaling.py``.

    python -m hikari_tpu_torch.bench_scaling --procs 2 [--chips C] [--size 256] [--frames 6] [--cpu]

The workload is ``bench_scaling.py``'s: cornell at ``--size`` (output, from
half that under SMAA TU4x at 2), TAA Jasmine, denoise, one bounce, through
``multihost.make_multihost_train_step`` on a ("hosts", "chips") mesh with
``--chips`` ranks a host (default: all on one), the state host-local, one
warm-up step then ``--frames`` timed steps (closed by a synchronize). The
rays are ``bench.rays_per_frame`` (``bench.py``'s accounting) x frames.

One rank per device: ``--cpu`` runs the ranks on the CPU over gloo; else
each rank takes its own card over NCCL when there are enough cards, and
the ranks share ``cuda:0`` over gloo when there are not. The line says
which (``backend``, ``devices``, ``ranks_per_device``): with ranks sharing
one device its "efficiency" is that of ranks sharing a device, not
scaling. Prints one JSON line with ``bench_scaling.py``'s keys.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def worker(rank, size: int, frames: int, chips: int):
    """One rank's timed steps; rank 0 returns its numbers."""
    import torch.distributed as dist

    from hikari_tpu_torch.bench import rays_per_frame
    from hikari_tpu_torch.config import Taa, Upscale
    from hikari_tpu_torch.io.scenes import cornell_config
    from hikari_tpu_torch.parallel import multihost
    from hikari_tpu_torch.scene import build_scene_buffers

    dev = multihost.rank_device()
    scene, camera, settings = cornell_config(size=size, device=dev)
    settings = settings.replace(upscale=Upscale.smaa_tu4x(2.0), taa=Taa.JASMINE, denoise=True,
                                indirect_bounces=1)
    buffers = build_scene_buffers(scene, dev)
    mesh = multihost.host_mesh(ranks_per_host=chips)
    buffers = multihost.replicate_host_local(buffers, mesh)
    state = multihost.host_local_state(settings, mesh)
    target = multihost.host_local_image(
        mesh, settings.output_size + (3,),
        lambda lo, hi: torch.zeros((hi - lo, settings.width, 3)))
    step = multihost.make_multihost_train_step(settings, mesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    loss, _, _, state = step(buffers, camera, state, target)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(frames):
        loss, _, _, state = step(buffers, camera, state, target)
    sync()
    dist.barrier()
    dt = time.perf_counter() - t0
    # The distinct cards the ranks run on; CPU ranks count one each.
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(dev))
    devices = len(set(names)) if dev.type == "cuda" else len(names)
    rays = rays_per_frame(settings, buffers) * frames
    return {"procs": dist.get_world_size(), "devices": devices, "rays_per_sec": rays / dt,
            "dt": dt, "loss": float(loss), "backend": dist.get_backend()}


def backend_and_device(procs: int, cpu: bool):
    """(backend, device) of ``procs`` ranks: the CPU over gloo, a card a
    rank over NCCL, or ``cuda:0`` shared over gloo."""
    if cpu:
        return "gloo", "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run the ranks on the CPU")
    if procs <= torch.cuda.device_count():
        return "nccl", "cuda"
    return "gloo", "cuda:0"


def run_group(procs: int, args) -> dict:
    from hikari_tpu_torch.parallel.multihost import run_ranks

    backend, device = backend_and_device(procs, args.cpu)
    chips = args.chips or procs
    return run_ranks(worker, procs, backend, device, args.size, args.frames, chips)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--chips", type=int, default=None, help="ranks a host (default: all)")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    base = run_group(1, argparse.Namespace(**{**vars(args), "chips": 1}))
    multi = run_group(args.procs, args)
    # Linear-scaling efficiency: rays/s per device, N ranks vs 1.
    eff = (multi["rays_per_sec"] / multi["devices"]) / (base["rays_per_sec"] / base["devices"])
    ranks_per_device = args.procs / multi["devices"]
    result = {
        "metric": f"scaling efficiency {args.procs} ranks vs 1",
        "value": eff,
        "unit": "fraction of linear",
        "rays_per_sec_1host": base["rays_per_sec"],
        f"rays_per_sec_{args.procs}host": multi["rays_per_sec"],
        "backend": multi["backend"],
        "devices": multi["devices"],
        "ranks_per_device": ranks_per_device,
    }
    if args.cpu:
        result["note"] = "cpu ranks oversubscribe the same cores: mechanism validation only"
    elif ranks_per_device > 1:
        result["note"] = (f"{args.procs} ranks share {multi['devices']} device(s): the value is "
                          "ranks sharing a device, not scaling")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
