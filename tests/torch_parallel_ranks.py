"""The rank side of ``tests/test_torch_parallel.py``: every scenario of the
sharded port, run on 4 spawned CPU ranks (gloo) by one ``run_ranks`` call.
The module imports no JAX, so the ranks start fast; the test module holds
the results against the unsharded port and JAX.

Ranks 0-1 and 2-3 first run two sets of 2-rank cases side by side on
their own meshes, then all 4 ranks run the 4-rank cases."""

from __future__ import annotations

import numpy as np
import torch

from hikari_tpu_torch.config import RenderSettings, Taa, Upscale
from hikari_tpu_torch.io.scenes import cornell_config
from hikari_tpu_torch.render import initial_state
from hikari_tpu_torch.render.types import GBuffer
from hikari_tpu_torch.utils import ATROUS_KERNEL, map_tensors

FRAMES = 3
STEPS = 2
TRACE_RAYS = 1001  # not a multiple of 2 or 4 ranks: the last shard is padded


def frame_settings(**kw):
    """``tests/test_sharding.py``'s settings at 32x32."""
    return RenderSettings(**{**dict(width=32, height=32, upscale=Upscale.none(), denoise=True,
                                    taa=Taa.NONE, indirect_bounces=1), **kw})


def bench_frame_settings(**kw):
    """The bench frame's post chain at 48x64 (SMAA TU4x at 2, TAA Jasmine,
    denoise, 1 bounce, spatial reuse, f16 reservoirs)."""
    return RenderSettings(**{**dict(width=64, height=48, upscale=Upscale.smaa_tu4x(2.0),
                                    taa=Taa.JASMINE, denoise=True, indirect_bounces=1,
                                    reproject="shift"), **kw})


def world_arrays():
    """The compiled cornell scene both packages render (the numpy builder:
    no rank builds the C++ one)."""
    from hikari_tpu_torch.io.scenes import cornell_box_scene
    from hikari_tpu_torch.scene import compile_scene

    return compile_scene(cornell_box_scene(), builder="numpy")


def world(settings):
    from hikari_tpu_torch.scene import to_device

    _, cam, _ = cornell_config(device="cpu")
    return to_device(world_arrays(), "cpu"), cam


def halo_input(h, w):
    return torch.from_numpy(np.random.default_rng(7).normal(size=(h, w)).astype(np.float32))


def level_inputs(h=64, w=32):
    rng = np.random.default_rng(11)
    irr = torch.from_numpy(rng.uniform(size=(h, w, 3)).astype(np.float32))
    depth = torch.from_numpy(rng.uniform(0.2, 1.0, size=(h, w)).astype(np.float32))
    return irr, depth


LEVEL_STEP = 4


def level_weight(center, tap, dy, dx):
    return torch.exp(-(center["depth"] - tap["depth"]).abs())


def denoise_inputs(settings):
    """A channel denoiser's inputs at ``settings``' render size: random
    radiance, variance and albedo, and a G-buffer of random planes."""
    rng = np.random.default_rng(5)
    rh, rw = settings.render_size
    h, w = settings.output_size

    def t(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, size=shape).astype(np.float32))

    normal = t(h, w, 3, lo=-1.0)
    gb = GBuffer(position=t(h, w, 4), normal=normal / normal.norm(dim=-1, keepdim=True),
                 depth_gradient=t(h, w, 2, lo=-0.01, hi=0.01),
                 instance=torch.from_numpy(rng.integers(-1, 3, size=(h, w)).astype(np.int32)),
                 material=torch.zeros((h, w), dtype=torch.int32), velocity_uv=t(h, w, 4))
    return t(rh, rw, 3), t(rh, rw), t(rh, rw, 3, lo=0.0, hi=0.9), gb


def trace_inputs(buffers):
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.uniform(-0.8, 0.8, (TRACE_RAYS, 3)).astype(np.float32))
    d = rng.normal(size=(TRACE_RAYS, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    lo = torch.zeros(TRACE_RAYS, dtype=torch.int32)
    hi = torch.full((TRACE_RAYS,), min(12, buffers.num_tris), dtype=torch.int32)
    excl = torch.full((TRACE_RAYS,), 2, dtype=torch.int32)
    return o, d, dict(range_lo=lo, range_hi=hi, exclude_instance=excl)


TRACE_CASES = (("bruteforce", False), ("pallas", False), ("scatter", False),
               ("pallas_tiled", True))


def _np(tree):
    return map_tensors(lambda t: t.detach().numpy().copy(), tree)


def _counters():
    from hikari_tpu_torch.parallel import halo
    from hikari_tpu_torch.trace import api

    api.rays_traced = 0
    halo.reset_stats()


def _frames(step, buffers, cam, state, frames=FRAMES):
    """Sharded frames: each frame's local image, the final local state and
    the rays this rank traced."""
    from hikari_tpu_torch.parallel import halo
    from hikari_tpu_torch.trace import api

    _counters()
    images = []
    with torch.no_grad():
        for _ in range(frames):
            out, state = step(buffers, cam, state)
            images.append(out.image.numpy().copy())
    return {"images": images, "state": _np(state), "rays": api.rays_traced,
            "stats": {k: dict(v) for k, v in halo.stats.items()}}


def _frame_cases(mesh, settings, prefix, **kw):
    from hikari_tpu_torch.parallel import make_sharded_render, shard_state, shard_state_2d
    from hikari_tpu_torch.parallel.multihost import host_local_state

    buffers, cam = world(settings)
    out = {}
    for manual in (False, True):
        step = make_sharded_render(settings, mesh, manual_halo_denoise=manual, **kw)
        if kw.get("cols"):
            state = shard_state_2d(initial_state(settings, "cpu"), mesh)
        elif kw.get("axis", "tiles") is None:
            state = host_local_state(settings, mesh)
        else:
            state = shard_state(initial_state(settings, "cpu"), mesh)
        out[f"{prefix}/halo={manual}"] = _frames(step, buffers, cam, state)
    return out


def _train_cases(mesh, settings, prefix):
    from hikari_tpu_torch.parallel import DIFF_LEAVES, make_train_step, shard_state
    from hikari_tpu_torch.trace import api

    buffers, cam = world(settings)
    target = torch.full(settings.output_size + (3,), 0.25)
    out = {}
    for remat in (False, True):
        s = settings.replace(remat=remat)
        step = make_train_step(s, sharded=True, mesh=mesh)
        state = shard_state(initial_state(s, "cpu"), mesh)
        res = []
        _counters()
        for _ in range(STEPS):
            loss, grads, _, state = step(buffers, cam, state, target)
            res.append((float(loss), {k: grads[k].numpy().copy() for k in DIFF_LEAVES}))
        out[f"{prefix}/remat={remat}"] = {"steps": res, "rays": api.rays_traced}
    return out


def _halo_cases(mesh, prefix):
    from hikari_tpu_torch.parallel.halo import halo_exchange_rows, sharded_atrous_level
    from hikari_tpu_torch.utils.block import Block

    k, n = mesh.index(("tiles",))
    out = {}
    for h, w, r in ((64, 16, 3), (16, 8, 6)):
        x = Block(k, n).take(halo_input(h, w))
        padded, valid = halo_exchange_rows(x, r, mesh)
        out[f"{prefix}/halo_exchange_rows/{h}x{w}/r={r}"] = (padded.numpy(), valid.numpy())
    irr, depth = level_inputs()
    blk = Block(k, n)
    got = sharded_atrous_level(blk.take(irr), {"depth": blk.take(depth)}, LEVEL_STEP, mesh,
                               ATROUS_KERNEL, level_weight)
    out[f"{prefix}/sharded_atrous_level"] = got.numpy()
    return out


def _denoise_cases(mesh, settings, prefix):
    """``denoise_channel_sharded`` and the gathered denoiser on this
    rank's block, with the bytes each moved."""
    from hikari_tpu_torch.parallel import halo
    from hikari_tpu_torch.parallel.sharding import frame_placement
    from hikari_tpu_torch.render.denoise import denoise_channel
    from hikari_tpu_torch.utils.block import rendering

    rad, var, alb, gb = denoise_inputs(settings)
    blk = frame_placement(mesh).block()
    args = (blk.take(rad), blk.take(var), blk.take(alb), map_tensors(blk.take, gb), 3, settings)
    out = {}
    halo.reset_stats()
    out[f"{prefix}/halo"] = halo.denoise_channel_sharded(*args, mesh=mesh).numpy()
    out[f"{prefix}/halo bytes"] = {k: dict(v) for k, v in halo.stats.items()}
    halo.reset_stats()
    with rendering(blk):
        out[f"{prefix}/gathered"] = denoise_channel(*args).numpy()
    out[f"{prefix}/gathered bytes"] = {k: dict(v) for k, v in halo.stats.items()}
    return out


def _trace_cases(mesh, mesh2d, prefix):
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import shard_tracing, trace_rays

    buffers, _ = world(frame_settings())
    o, d, restricted = trace_inputs(buffers)
    out = {}
    for method, two_d in TRACE_CASES:
        if two_d and mesh2d is None:
            continue
        for query, kw in (("plain", {}), ("restricted", restricted)):
            api.rays_traced = 0
            with shard_tracing(mesh2d if two_d else mesh):
                hit = trace_rays(buffers, o, d, method=method, **kw)
            out[f"{prefix}/{method}/{query}"] = (_np(hit), api.rays_traced)
    return out


STOP_POINTS = ("gbuffer:trace", "direct:restir", "smaa:clip", "taa")


def _stop_cases(mesh, settings, prefix):
    """Frames cut by ``stop_after``: each rank's (4, 4, 4) image holds the
    whole frame's sum (a cross-rank sum)."""
    from hikari_tpu_torch.parallel import make_sharded_render, shard_state

    buffers, cam = world(settings)
    out = {}
    for point in STOP_POINTS:
        s = settings.replace(stop_after=point)
        with torch.no_grad():
            image = make_sharded_render(s, mesh)(
                buffers, cam, shard_state(initial_state(s, "cpu"), mesh))[0].image
        out[f"{prefix}/{point}"] = image.numpy().copy()
    return out


def _multihost_case(hosts, settings):
    """``make_multihost_train_step``: the context it enters and every
    trace of its frame (the kernel backend, this rank's rays only)."""
    import contextlib

    from hikari_tpu_torch.parallel import multihost
    from hikari_tpu_torch.trace import api

    seen, calls = {}, []
    real_ctx, real_search = api.shard_tracing, api.closest_hit

    @contextlib.contextmanager
    def spy(mesh_arg, axis=None):
        seen["mesh_axes"] = tuple(mesh_arg.axis_names)
        with real_ctx(mesh_arg, axis):
            seen["ctx_axes"] = tuple(api._SHARD_CTX[-1][1])
            yield

    def search(o, *args):
        calls.append(o.shape[0])
        return real_search(o, *args)

    api.shard_tracing, api.closest_hit = spy, search
    try:
        step = multihost.make_multihost_train_step(settings, hosts)
        state = multihost.host_local_state(settings, hosts)
        target = multihost.host_local_image(
            hosts, settings.output_size + (3,),
            lambda lo, hi: np.full((hi - lo, settings.width, 3), 0.25, np.float32))
        buffers, cam = world(settings)
        buffers = multihost.replicate_host_local(buffers, hosts)
        loss, grads, out, _ = step(buffers, cam, state, target)
    finally:
        api.shard_tracing, api.closest_hit = real_ctx, real_search
    return {"seen": seen, "calls": calls, "loss": float(loss),
            "grads": {k: v.numpy().copy() for k, v in grads.items()},
            "image": out.image.numpy().copy(), "target_rows": tuple(target.shape)}


def scenarios(rank):
    """Every rank builds every mesh in one order (``dist.new_group`` is
    collective), then runs its cases."""
    import torch.distributed as dist

    from hikari_tpu_torch.parallel import make_mesh, make_mesh_2d
    from hikari_tpu_torch.parallel import multihost

    pair = [make_mesh([0, 1]), make_mesh([2, 3])][rank // 2]
    mesh4 = make_mesh()
    mesh2d = make_mesh_2d((2, 2))
    hosts = multihost.host_mesh(ranks_per_host=2)
    res = {}
    if rank < 2:
        res.update(_halo_cases(pair, "2"))
        res.update(_frame_cases(pair, frame_settings(), "frame/1d-2"))
        res.update(_train_cases(pair, frame_settings(), "train/1d-2"))
    else:
        res.update(_frame_cases(pair, bench_frame_settings(), "frame/bench-1d-2"))
        res.update(_denoise_cases(pair, frame_settings(), "denoise/2"))
        res.update(_trace_cases(pair, None, "trace/2"))
        res.update(_stop_cases(pair, bench_frame_settings(), "stop/2"))
    dist.barrier()
    res.update(_halo_cases(mesh4, "4"))
    res.update(_frame_cases(mesh4, frame_settings(), "frame/1d-4"))
    res.update(_frame_cases(mesh4, frame_settings(width=63, height=48), "frame/1d-4-48x63"))
    res.update(_frame_cases(mesh2d, frame_settings(), "frame/2d-2x2", axis="ty", cols="tx"))
    res.update(_frame_cases(hosts, frame_settings(), "frame/hosts-2x2", axis=None))
    res.update(_trace_cases(mesh4, mesh2d, "trace/4"))
    res["multihost"] = _multihost_case(hosts, frame_settings())
    return res


def fail_on_rank_1(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    return rank
