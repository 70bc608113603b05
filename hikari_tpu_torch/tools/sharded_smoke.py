"""The sharded paths against the unsharded port, on ranks that share one
device over gloo: the ``[sharded]`` phase of ``chip_smoke.py``.

    python -m hikari_tpu_torch.tools.sharded_smoke [--cpu] [--size W H] [--small W H]

Cases (every rank on the same device, ``backend="gloo"``):

* (s1) ``make_sharded_render`` on 2 ranks, ``frames`` frames from
  ``initial_state``, the halo denoiser off and on, against the unsharded
  ``render_frame`` from the same state: the share of pixels within 1e-3,
  the bitwise pixels, the max abs difference; each rank's closest-hit
  launches (= its trace calls, > 0) and the rays traced summed over the
  ranks (= the unsharded frames').
* (s2) ``make_train_step(sharded=True, mesh)`` on 2 ranks, 2 steps, remat
  off and on: loss and gradients against the unsharded step, 0
  closest-hit launches in the backward.
* (s3) ``trace.shard_tracing`` over 2 ranks on the cornell primary rays
  (K1, bit for bit) and the city's (K2, bit for bit but for counted ties).
* (s4) 4 ranks: a frame on ``make_mesh_2d((2, 2))`` with
  ``shard_state_2d`` and a ``make_multihost_train_step`` step on
  ``host_mesh`` (2, 2), against the unsharded port.

Per case each rank reports host ms/frame (median of the frames after the
first; each collective is timed between synchronizes, which the frame
time includes), its peak device memory, and the time and bytes of its
collectives by kind (``parallel/halo.stats``). One device shared by the
ranks measures no scaling.
"""

from __future__ import annotations

import time

import numpy as np
import torch

IMAGE_ATOL = 1e-3
IMAGE_SHARE = 0.99
LOSS_RTOL = 1e-6
LEAF_REL = 1e-5


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset(dev):
    from hikari_tpu_torch.parallel import halo
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.trace import tile_walk as tw

    _sync(dev)
    ch.launches = tw.launches = api.trace_calls = api.rays_traced = 0
    halo.reset_stats()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _counts(dev):
    from hikari_tpu_torch.parallel import halo
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.trace import tile_walk as tw

    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return {"closest_hit": ch.launches, "tile_walk": tw.launches, "trace_calls": api.trace_calls,
            "rays": api.rays_traced, "peak": peak, "card": dev.type == "cuda",
            "collectives": {k: dict(v) for k, v in halo.stats.items()}}


def _image_diff(got, want):
    d = np.abs(got.astype(np.float64) - want.astype(np.float64)).max(-1)
    return {"within": float((d <= IMAGE_ATOL).mean()), "bitwise": int((got == want).all(-1).sum()),
            "pixels": int(d.size), "max_abs": float(d.max())}


def _whole(x, block):
    """The whole image of the blocks ``x`` (a check's gather, counted apart
    from the frame's collectives)."""
    from hikari_tpu_torch.parallel import halo

    if not block.sharded:
        return x
    parts = halo.all_gather_plain(x, block.transport.tiles, "check")
    rows = [torch.cat(parts[i * block.nx:(i + 1) * block.nx], 1) for i in range(block.ny)]
    return torch.cat(rows)


def _local_state_ok(state, block, settings):
    """No leaf of ``state`` holds more rows than the block's."""
    from hikari_tpu_torch.utils import map_tensors

    big = []
    full_rows = block.ny * min(settings.render_size[0], settings.output_size[0])

    def check(t):
        if t.dim() >= 2 and block.sharded and t.shape[0] >= full_rows:
            big.append(tuple(t.shape))
        return t

    map_tensors(check, state)
    return not big


def _frames(rank, scene, cam, settings, step, state, frames, block, dev, ref_images):
    """``frames`` sharded frames; rank 0 holds them against ``ref_images``."""
    from hikari_tpu_torch.parallel import halo

    _reset(dev)
    halo.timing = True
    ms, diffs = [], []
    with torch.no_grad():
        for f in range(frames):
            _sync(dev)
            t0 = time.perf_counter()
            out, state = step(scene, cam, state)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            halo.timing = False
            image = _whole(out.image, block)
            halo.timing = True
            if rank == 0:
                diffs.append(_image_diff(image.cpu().numpy(), ref_images[f]))
    halo.timing = False
    counts = _counts(dev)
    counts["collectives"].pop("check", None)
    return {"ms": ms, "diffs": diffs, "counts": counts,
            "local_state": _local_state_ok(state, block, settings),
            "finite": bool(torch.isfinite(out.image).all())}


def _reference_frames(scene, cam, settings, frames, dev):
    from hikari_tpu_torch.render import initial_state, render_frame

    _reset(dev)
    state, images = initial_state(settings, dev), []
    with torch.no_grad():
        for _ in range(frames):
            out, state = render_frame(scene, cam, state, settings)
            images.append(out.image.cpu().numpy())
    return images, _counts(dev)


def _train(step, scene, cam, state, target, steps, dev):
    """``steps`` train steps; the closest-hit launches split at each
    forward's end (``sharding.render_frame`` wrapped, looked up when the
    step runs)."""
    from hikari_tpu_torch.parallel import DIFF_LEAVES, halo, sharding
    from hikari_tpu_torch.trace import closest_hit as ch

    real, ends = sharding.render_frame, []

    def marked(*args, **kw):
        res = real(*args, **kw)
        ends.append(ch.launches)
        return res

    _reset(dev)
    halo.timing = True
    sharding.render_frame = marked
    ms, losses, grads, fwd, bwd = [], [], [], 0, 0
    try:
        for _ in range(steps):
            start = ch.launches
            _sync(dev)
            t0 = time.perf_counter()
            loss, g, out, state = step(scene, cam, state, target)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            fwd += ends[-1] - start
            bwd += ch.launches - ends[-1]
            losses.append(float(loss))
            grads.append({k: g[k].double().cpu().numpy() for k in DIFF_LEAVES})
    finally:
        sharding.render_frame = real
        halo.timing = False
    counts = _counts(dev)
    counts.update(k1_forward=fwd, k1_backward=bwd)
    return {"ms": ms, "losses": losses, "grads": grads, "counts": counts}


def _grad_diffs(got, want):
    out = []
    for (lg, gg), (lw, gw) in zip(zip(got["losses"], got["grads"]),
                                  zip(want["losses"], want["grads"])):
        rel = {k: float(np.linalg.norm(gg[k] - gw[k]) / max(np.linalg.norm(gw[k]), 1e-30))
               for k in gw}
        out.append({"loss_rel": abs(lg - lw) / max(abs(lw), 1e-30), "leaf_rel": rel})
    return out


def two_rank_cases(rank, arrays, cam, settings, frames, steps, trace_cases):
    """(s1), (s2), (s3) on 2 ranks; rank 0 also runs the unsharded port."""
    import torch.distributed as dist

    from hikari_tpu_torch.parallel import (
        make_mesh,
        make_sharded_render,
        make_train_step,
        shard_state,
    )
    from hikari_tpu_torch.parallel.multihost import rank_device
    from hikari_tpu_torch.render import initial_state
    from hikari_tpu_torch.scene import to_device
    from hikari_tpu_torch.trace import shard_tracing, trace_rays

    dev = rank_device()
    scene, cam = to_device(arrays, dev), cam.to(dev)
    mesh = make_mesh()
    block = None
    res = {"backend": dist.get_backend(), "device": str(dev)}

    # (s1)
    ref_images = None
    if rank == 0:
        ref_images, res["s1_reference"] = _reference_frames(scene, cam, settings, frames, dev)
    dist.barrier()
    for manual in (False, True):
        step = make_sharded_render(settings, mesh, manual_halo_denoise=manual)
        from hikari_tpu_torch.parallel.sharding import frame_placement

        block = frame_placement(mesh).block()
        state = shard_state(initial_state(settings, dev), mesh)
        res[f"s1_halo_{manual}"] = _frames(rank, scene, cam, settings, step, state, frames, block,
                                           dev, ref_images)
        del state
    dist.barrier()

    # (s2)
    train_settings = settings.replace(collect_stats=False)
    target = torch.zeros(settings.output_size + (3,), device=dev)
    for remat in (False, True):
        s = train_settings.replace(remat=remat)
        if rank == 0:
            ref = _train(make_train_step(s), scene, cam, initial_state(s, dev), target, steps, dev)
        dist.barrier()
        got = _train(make_train_step(s, sharded=True, mesh=mesh), scene, cam,
                     shard_state(initial_state(s, dev), mesh), target, steps, dev)
        got["grads_last"] = got["grads"][-1]
        if rank == 0:
            got["diffs"] = _grad_diffs(got, ref)
            got["reference_counts"] = ref["counts"]
        del got["grads"]
        res[f"s2_remat_{remat}"] = got
        dist.barrier()

    # (s3)
    for label, tarrays, tcam, size, kernel in trace_cases:
        tscene, tcam = to_device(tarrays, dev), tcam.to(dev)
        o, d = tcam.pixel_rays(size)
        kw = dict(max_distance=65535.0)
        want = trace_rays(tscene, o, d, **kw) if rank == 0 else None
        _reset(dev)
        from hikari_tpu_torch.parallel import halo

        halo.timing = True
        _sync(dev)
        t0 = time.perf_counter()
        with shard_tracing(mesh):
            got = trace_rays(tscene, o, d, **kw)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        halo.timing = False
        entry = {"ms": ms, "counts": _counts(dev), "rays": o.shape[0] * o.shape[1],
                 "kernel": kernel}
        if rank == 0:
            prim_eq = got.prim == want.prim
            t_eq = got.t == want.t
            same = prim_eq & t_eq & (got.u == want.u) & (got.v == want.v)
            entry.update(bitwise=int(same.sum()), ties=int((~prim_eq & t_eq).sum()),
                         other=int((~same & ~(~prim_eq & t_eq)).sum()))
        res[f"s3_{label}"] = entry
        del tscene
        dist.barrier()
    return res


def four_rank_cases(rank, arrays, cam, settings):
    """(s4) on 4 ranks: a frame on the 2D tile mesh, a step on the host mesh."""
    import torch.distributed as dist

    from hikari_tpu_torch.parallel import (
        make_mesh_2d,
        make_sharded_render,
        make_train_step,
        shard_state_2d,
    )
    from hikari_tpu_torch.parallel import multihost
    from hikari_tpu_torch.parallel.sharding import frame_placement
    from hikari_tpu_torch.render import initial_state
    from hikari_tpu_torch.scene import to_device

    dev = multihost.rank_device()
    scene, cam = to_device(arrays, dev), cam.to(dev)
    mesh2 = make_mesh_2d((2, 2))
    hosts = multihost.host_mesh(ranks_per_host=2)
    res = {"backend": dist.get_backend()}
    ref_images = None
    if rank == 0:
        ref_images, res["s4_reference"] = _reference_frames(scene, cam, settings, 1, dev)
    dist.barrier()
    step = make_sharded_render(settings, mesh2, axis="ty", cols="tx")
    block = frame_placement(mesh2, "ty", "tx").block()
    res["s4_tiles"] = _frames(rank, scene, cam, settings, step,
                              shard_state_2d(initial_state(settings, dev), mesh2), 1, block, dev,
                              ref_images)
    dist.barrier()
    s = settings.replace(collect_stats=False)
    target = torch.zeros(settings.output_size + (3,), device=dev)
    if rank == 0:
        ref = _train(make_train_step(s), scene, cam, initial_state(s, dev), target, 1, dev)
    dist.barrier()
    got = _train(multihost.make_multihost_train_step(s, hosts), scene, cam,
                 multihost.host_local_state(s, hosts), target, 1, dev)
    if rank == 0:
        got["diffs"] = _grad_diffs(got, ref)
    del got["grads"]
    res["s4_hosts"] = got
    return res


def _mib(b):
    return f"{b / 2**20:.1f} MiB"


def _collectives(c):
    parts = []
    for kind, v in sorted(c.items()):
        parts.append(f"{kind} {v['calls']} calls {_mib(v['bytes'])}"
                     + (f" {v['seconds'] * 1e3:.1f} ms" if v["seconds"] else ""))
    return "; ".join(parts) or "none"


def _median_after_first(ms):
    return float(np.median(ms[1:] if len(ms) > 1 else ms))


def _check_frames(label, ranks, reference_rays, log):
    """Prints and checks one sharded-frame case; returns its failures."""
    bad = []
    rays = sum(r["counts"]["rays"] for r in ranks)
    for i, r in enumerate(ranks):
        c = r["counts"]
        log(f"[sharded] {label} rank {i}: host ms/frame {_median_after_first(r['ms']):.2f} "
            f"(all: {', '.join(f'{m:.1f}' for m in r['ms'])}); peak {c['peak'] / 2**30:.3f} GiB; "
            f"trace calls {c['trace_calls']} = closest-hit launches {c['closest_hit']}; rays "
            f"{c['rays']}; collectives: {_collectives(c['collectives'])}")
        if c["card"] and not c["closest_hit"] == c["trace_calls"] > 0:
            bad.append(f"{label} rank {i}: launches {c['closest_hit']}, trace calls "
                       f"{c['trace_calls']}")
        if not r["local_state"]:
            bad.append(f"{label} rank {i}: a state leaf holds the whole image's rows")
        if not r["finite"]:
            bad.append(f"{label} rank {i}: non-finite image")
    for f, d in enumerate(ranks[0]["diffs"]):
        log(f"[sharded] {label} frame {f}: {d['within']:.6f} of pixels within {IMAGE_ATOL:g}, "
            f"{d['bitwise']} of {d['pixels']} bitwise, max abs {d['max_abs']:.3g}")
        if d["within"] < IMAGE_SHARE:
            bad.append(f"{label} frame {f}: {d['within']:.6f} within {IMAGE_ATOL:g}")
    log(f"[sharded] {label}: rays traced over the ranks {rays}, unsharded {reference_rays}")
    if rays != reference_rays:
        bad.append(f"{label}: {rays} rays traced over the ranks, {reference_rays} unsharded")
    return bad


def _check_train(label, ranks, log):
    bad = []
    for i, r in enumerate(ranks):
        c = r["counts"]
        log(f"[sharded] {label} rank {i}: host ms/step {_median_after_first(r['ms']):.2f} (all: "
            f"{', '.join(f'{m:.1f}' for m in r['ms'])}); peak {c['peak'] / 2**30:.3f} GiB; "
            f"closest-hit launches forward {c['k1_forward']} (trace calls {c['trace_calls']}), "
            f"backward {c['k1_backward']}; collectives: {_collectives(c['collectives'])}")
        if c["k1_backward"] or (c["card"] and not c["k1_forward"] == c["trace_calls"] > 0):
            bad.append(f"{label} rank {i}: launches {c}")
        if r["losses"] != ranks[0]["losses"]:
            bad.append(f"{label}: the ranks' losses differ")
    for s, d in enumerate(ranks[0]["diffs"]):
        worst = max(d["leaf_rel"].items(), key=lambda kv: kv[1])
        log(f"[sharded] {label} step {s}: loss {ranks[0]['losses'][s]:.8g} relative difference "
            f"{d['loss_rel']:.3g} (limit {LOSS_RTOL:g}); leaves' relative L2 max "
            f"{worst[1]:.3g} ({worst[0]}; limit {LEAF_REL:g})")
        if d["loss_rel"] > LOSS_RTOL or worst[1] > LEAF_REL:
            bad.append(f"{label} step {s}: {d}")
    return bad


def run(device, cornell_arrays, cornell_cam, settings, small_settings, trace_cases, log=print,
        frames=4, steps=2):
    """Runs (s1)-(s4) and prints them; raises AssertionError on a failed
    check. ``trace_cases``: (label, arrays, camera, size, kernel) for
    (s3). Returns the closest-hit and tile-walk launches over the ranks."""
    from hikari_tpu_torch.parallel.multihost import run_ranks

    t0 = time.perf_counter()
    two = run_ranks(two_rank_cases, 2, "gloo", device, cornell_arrays, cornell_cam.to("cpu"),
                    settings, frames, steps,
                    [(lb, a, c.to("cpu"), s, k) for lb, a, c, s, k in trace_cases])
    log(f"[sharded] 2 ranks on {two[0]['device']} and {two[1]['device']}, backend "
        f"{two[0]['backend']} (CUDA tensors staged through host memory by gloo); "
        f"{time.perf_counter() - t0:.1f} s")
    bad = []
    ref = two[0]["s1_reference"]
    log(f"[sharded] (s1) unsharded {settings.width}x{settings.height} from "
        f"{settings.render_size[1]}x{settings.render_size[0]}: {frames} frames, trace calls "
        f"{ref['trace_calls']}, rays {ref['rays']}, peak {ref['peak'] / 2**30:.3f} GiB")
    launches = {"closest_hit": 0, "tile_walk": 0}

    def add(*counts):
        for c in counts:
            for k in launches:
                launches[k] += c[k]

    for manual in (False, True):
        ranks = [r[f"s1_halo_{manual}"] for r in two]
        add(*(r["counts"] for r in ranks))
        bad += _check_frames(f"(s1) manual_halo_denoise={manual}", ranks, ref["rays"], log)
    for remat in (False, True):
        ranks = [r[f"s2_remat_{remat}"] for r in two]
        add(*(r["counts"] for r in ranks))
        bad += _check_train(f"(s2) train step remat={remat}", ranks, log)
        for k, g in ranks[0]["grads_last"].items():
            if not np.array_equal(g, ranks[1]["grads_last"][k]):
                bad.append(f"(s2) remat={remat}: the ranks' {k} gradients differ")
    for label, _, _, size, kernel in trace_cases:
        e0, e1 = two[0][f"s3_{label}"], two[1][f"s3_{label}"]
        log(f"[sharded] (s3) shard_tracing {label} ({e0['rays']} rays, {kernel}): bitwise "
            f"{e0['bitwise']}, ties {e0['ties']}, other {e0['other']}; rank ms {e0['ms']:.2f} / "
            f"{e1['ms']:.2f}; launches {e0['counts'][kernel]} / {e1['counts'][kernel]}; "
            f"rays searched {e0['counts']['rays']} / {e1['counts']['rays']}; collectives "
            f"{_collectives(e0['counts']['collectives'])}")
        if e0["other"] or (kernel == "closest_hit" and e0["ties"]):
            bad.append(f"(s3) {label}: {e0['other']} hits differ, {e0['ties']} ties")
        if e0["counts"]["rays"] + e1["counts"]["rays"] < e0["rays"]:
            bad.append(f"(s3) {label}: the shards miss rays")
        add(e0["counts"], e1["counts"])

    t0 = time.perf_counter()
    four = run_ranks(four_rank_cases, 4, "gloo", device, cornell_arrays, cornell_cam.to("cpu"),
                     small_settings)
    log(f"[sharded] (s4) 4 ranks, backend {four[0]['backend']}: "
        f"{time.perf_counter() - t0:.1f} s")
    bad += _check_frames(f"(s4) 2x2 tiles {small_settings.width}x{small_settings.height}",
                         [r["s4_tiles"] for r in four], four[0]["s4_reference"]["rays"], log)
    bad += _check_train("(s4) host mesh (2, 2) train step", [r["s4_hosts"] for r in four], log)
    add(*(r[k]["counts"] for r in four for k in ("s4_tiles", "s4_hosts")))
    if bad:
        raise AssertionError("[sharded] " + "; ".join(bad))
    return launches


def bench_frame(settings, width, height):
    """The bench frame's settings (``bench.py:77-116``, forward) on
    cornell's: SMAA TU4x at 2, TAA Jasmine, denoise, one bounce, the
    config's indirect spatial reuse and f16 reservoirs."""
    from hikari_tpu_torch.config import Taa, Upscale

    return settings.replace(width=width, height=height, upscale=Upscale.smaa_tu4x(2.0),
                            taa=Taa.JASMINE, denoise=True, indirect_bounces=1, reproject="shift",
                            remat=False, collect_stats=True, tracer="auto")


def phase(device, city, city_cam, log=print, size=(1920, 1080), small=(512, 512),
          city_size=512, frames=4):
    """(s1)-(s4) on cornell at ``size`` (s4: ``small``) and ``city`` (compiled
    arrays) at ``city_size`` for (s3). Returns ``run``'s launches."""
    from hikari_tpu_torch.io.scenes import cornell_box_scene, cornell_config
    from hikari_tpu_torch.scene import compile_scene

    _, cam, base = cornell_config(device="cpu")
    arrays = compile_scene(cornell_box_scene())
    cases = [("cornell", arrays, cam, (size[1], size[0]), "closest_hit"),
             ("city", city, city_cam, (city_size, city_size), "tile_walk")]
    return run(device, arrays, cam, bench_frame(base, *size), bench_frame(base, *small), cases,
               log, frames=frames)


def main(argv=None):
    import argparse

    from hikari_tpu_torch.io.scenes import city_scene
    from hikari_tpu_torch.render import Camera
    from hikari_tpu_torch.scene import compile_scene

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="ranks on the CPU (else cuda:0)")
    ap.add_argument("--size", type=int, nargs=2, default=(1920, 1080), metavar=("W", "H"))
    ap.add_argument("--small", type=int, nargs=2, default=(512, 512), metavar=("W", "H"))
    ap.add_argument("--city-blocks", type=int, default=16)
    ap.add_argument("--city-size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args(argv)
    if not args.cpu:
        from hikari_tpu_torch.trace import closest_hit, tile_walk

        closest_hit.build()
        tile_walk.build()
    city = compile_scene(city_scene(blocks=args.city_blocks))
    city_cam = Camera.from_lookat(eye=(30.0, 20.0, 30.0), target=(0.0, 0.0, 0.0), device="cpu")
    phase("cpu" if args.cpu else "cuda:0", city, city_cam, size=tuple(args.size),
          small=tuple(args.small), city_size=args.city_size, frames=args.frames)


if __name__ == "__main__":
    main()
