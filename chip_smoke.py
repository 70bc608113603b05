#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hikari_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each reported on its own line:
  1. [device] require CUDA; print the card and its power limit.
  2. [build] compile the eight kernels from csrc/ with nvcc
     (closest_hit.cu, tile_walk.cu, scatter_items.cu, window_pack.cu,
     take_along.cu, tile_entries.cu, scatter_plan.cu, spatial_reuse.cu)
     and the C++ BVH
     builder with g++, all at once; print each build time and ptxas'
     registers, shared memory and spills.
  3. cornell. [kernel]/[time]: the closest-hit kernel against its plain
     twin on the card, (a) on the 1080p cornell primary rays, (b) on a
     random 5120-triangle soup with exclusion and prim ranges; prim equal,
     t/u/v within ATOL; CUDA-event times at (a) beside the bound. [main]:
     8 frames of ``cornell_path`` (1920x1080 without the post chain) and of
     ``cornell_bench`` (the bench frame: 1920x1080 output from 960x540 with
     spatial reuse, denoise, SMAA TU4x and TAA) through ``render_frame``;
     every trace must go through the closest-hit kernel, the image must be
     finite and lit. [check]: 48x63 frames without the post chain on the
     card and on the CPU (the plain twins) from one state.
  4. city. [city]: host compile of the procedural city (550,994
     triangles). [kernel]/[time]: the tile-walk kernel against its twin,
     (c) on the city's 262,144 primary rays at 512x512, (d) on 65,536
     random rays in the city with random max/early distance, exclusion and
     one instance's prim range on half of them; prim and the clusters
     tested per tile equal, t/u/v within ATOL; CUDA-event times at (c) of
     the kernel, phase 1 with the sort, the whole ``trace_rays`` and the
     twin, beside the kernel's bound; the clusters tested per tile (max,
     p50, p90) and the longest tile's own bound; the kernel's SASS
     instructions per pair on the pair loop's common path, where no ray of
     the warp takes the pair (``cuobjdump``), and the issue floor they give.
     The phase-1 kernel (K2·p1, ``tile_entries.cu``) against its twin at
     (c), (d) and (c) with warps that mix clean and NaN rays over clusters
     with non-finite bounds (``slab_hazards``), with and without the rays'
     prim ranges: entries, per-ray max entries and the sorted order bit for
     bit; its CUDA-event ms, its twin's, its bound and its SASS
     instructions a slab test with the issue floor at (c) (the earlier
     designs' times are in PERF.md §6), and the stable sort's ms on its
     own line. The plan kernel (K3·pAB,
     ``scatter_plan.cu``: the staged table, the count launch with one slab
     test a pair, the place launch from the ballot masks) against its twin
     at (e), (f), (e) with ``items_per_ray=2`` (drops), (e) with one
     instance's prim range a ray and (e) with the hazards: meta, items and
     the dropped count bit for bit; at (e) its kernels' device ms, the
     whole call's ms, its twin's, its bound, its SASS a test with
     the issue floor and the bytes of its masks. The cluster counts at (c)
     and (e), 2,153 and 4,305, are no multiple of the kernels' stage of
     128 clusters.
     The scatter kernel against its twin on every item, (e) on the (c)
     rays, with its hits against the tile walk's, (f) on the (d) rays;
     CUDA-event times at (e) of the kernel, phases A+B, the segment-min, the
     whole ``trace_rays(method="scatter")`` and the twin, beside the
     kernel's bound and issue floor. The scatter kernel's count of blocks
     naming a cluster outside the table must stay 0 after every case and
     every path. [main]: 8 frames of
     ``city_path`` (512x512 without the post chain, every trace through the
     tile walk) and of ``city_bench_scatter`` (the city bench frame: 512x512
     output from 256x256 with the post chain and ``tracer="scatter"``,
     every trace through the scatter kernel); on each path the phase
     kernels launch with every trace kernel launch (K2·p1's two with the
     tile walk, K3·pAB's three with the scatter kernel), on the cornell
     paths never; both paths' peaks beside the memory live before each. [check]: a small city
     (blocks=3, 18,422 triangles), card against CPU, at 48x63 without the
     post chain and at 48x60 with the bench settings and the scatter tracer.
  5. primitives. [kernel]: (g) the window-table pack (T1) at the TPU
     tool's shape (8 planes of 1080x1920, 16 taps) equal to its twin;
     (h) the single gather (T2) at (512, 512), both axes, each index mode;
     (i) the repeated gathers (T3) at the tool's four shapes, equal to the
     twin and to the tool's closed-form sum. [time]: each against its twin,
     its bound and a PyTorch yardstick. [prims]: the port's
     ``tools/bench_pallas_prims`` on the card, every case checked.
  6. entry points. [render]: ``examples/render`` for cornell (24 frames at
     128, 16 at 256), minimal, simple and scene (256) and
     ``examples/dissect`` for cornell (256), into a temporary directory:
     ms/frame, peak memory, non-finite pixels (must be 0), mean luminance
     (must be > 0), trace calls = closest-hit launches.
  7. fwd+grad. [grad]: 8 frames of ``cornell_bench`` fwd+grad (the bench
     frame, 1920x1080 from 960x540) through ``parallel.make_train_step``
     against a zero target: ms/frame, peak memory, per leaf of
     ``DIFF_LEAVES`` whether its gradient is finite (every frame), its L2
     norm and whether it is nonzero (every leaf but ``sun_color`` must be),
     trace calls = closest-hit launches in the forward, and 0 closest-hit
     launches in the backward. [grad check]: the train step on the card
     against the CPU twins at frames 2 and 3 from one state, cornell at
     63x48 (temporal reuse only, f32 reservoirs) and at 62x48 with the
     bench settings: the loss and each leaf's relative L2 error within the
     stated bounds (``GRAD_LOSS_RTOL``, ``GRAD_LEAF_REL``). [bench]:
     ``hikari_tpu_torch.bench`` for cornell with its scene and city
     extras, its JSON line echoed prefixed; every extra must run, the
     city's traces through the tile walk, and cornell's accumulator must
     be finite; an extra whose accumulator is not finite is named on a
     line of its own. [train]: ``examples/train`` for 10 steps at 48 px;
     its loss must fall. Each phase prints its seconds.
  8. output options (after 3). [output]: 8 frames of ``cornell_output``
     (the cornell config at 1280x720 from 853x480 with FSR1 at 1.5, TAA
     off, denoise, one bounce, indirect spatial reuse, f16 reservoirs,
     HDR, bloom and FXAA) through ``render_frame``: ms/frame, peak memory,
     non-finite pixels (must be 0), mean luminance (must be > 0); the card
     against the CPU twins at 48x64 output, frames 2-3; one
     ``make_train_step`` frame at 48x64, every leaf finite and the
     ``gb_gather`` clip site counted.
  9. passes (after [grad check]). [passes]: the port's
     ``tools/profile_prefix`` on the bench frame, forward and fwd+grad:
     per coarse stage the prefix's ms/frame and device ms/frame with
     their deltas; the untruncated prefix's device time within 3% of the
     untruncated frame profiled again, frame by frame (frames 3-5), the
     host sum printed beside the frame timed again.
  10. textured glTF (after [render]). [textured]: ``examples/render
     scene --assets DIR`` at 512x512 on a small textured glTF written into
     a temporary asset directory, against the untextured stand-in; the
     card against the CPU twins on that scene at 48x62, frames 2-3.
  11. dynamic scenes (after 4's [check]). [dynamic]: (a)
     ``cornell_dynamic``, 8 frames of the bench frame's settings with both
     spatial reuses and ``reproject="adaptive"`` (1920x1080 from 960x540)
     under an orbiting camera while ``scene.SceneUpdater`` turns and moves
     the tall box every frame after the first, moves the light at frame 4
     (0-based; its alias rows stay) and scales it at frame 6 (they are
     rebuilt): ms/frame (update +
     render), the updates' host ms and ``update_transforms``' device ms,
     peak memory, non-finite pixels (must be 0), mean luminance (must be
     > 0), trace calls = closest-hit launches, the largest |velocity| on
     the box (must be > 0), the share of pixels whose temporal count did
     not fall (must be > 0.5 every frame), the unmoved instances' static
     snap; then the card against the CPU twins on the same path at 48x64,
     frames 0-3. (b) ``city_stream``: ``examples/render city --stream
     --frames 16 --size 512`` (trace calls = tile-walk launches, finite and
     lit), ``update_activity``'s device ms on the full city, and the small
     city with every other instance inactive through the tile walk against
     its twin and against a compile without those instances. (c)
     ``update_transforms`` on the card against the CPU on the city with
     10% of its instances moved. (d) ``trace_rays(method="bvh")`` against
     the closest-hit kernel on the moved cornell (1080p primary rays) and
     against the tile walk on a moved small city (256x256), ties counted.
  12. the XLA tiled tracer (after 4's [check]). [tiled]:
     ``trace_rays(method="tiled")`` (plain torch, no kernel) on the card at
     (c) and (d): host ms of one call, its steps and the clusters of 512
     tested per tile (max, p50, p90); the CPU's ``trace_tiled`` on every
     ``TILED_CPU_STRIDE``-th whole tile of the same sorted, padded rays
     must give those rays the card's t, prim, u, v bit for bit; against
     K2 there and against K1 on the cornell 1080p primary rays, prims
     equal but for counted ties and (at (d)) any-hit answers;
     ``city_tiled``, 2 frames of ``city_path``'s settings with
     ``tracer="tiled"``: finite, lit, no trace kernel launch, one K2·p1
     launch a tiled call; the small city's tiled frames at 48x63, card
     against CPU.
  13. [bench_trace] (after 12): ``hikari_tpu_torch.bench_trace`` on
     cornell, city-8, city-24 and city-551k with its six backends at
     1,048,576 rays, then ``--stress`` (terrain-1m) with pallas, tiled,
     pallas_tiled and scatter; every kernel backend's launches equal its
     trace calls (each measurement's counts set to 0 just before it), and
     its K1b launches join the kernel line; K1b against its twin on the
     card, bit for bit, at every bench row that launched it (city-8 on all
     1,048,576 rays, the larger tables on every k-th ray), and K1b's
     kernel-line times at city-8's shape; then K2·p1 and K3·pAB against
     their twins on city-8's 1,048,576 rays, with their [time] lines
     (kernel, twin, bound; the sort).
  14. [remat] (after [train]): from one state, one ``cornell_bench``
     fwd+grad step with ``remat=True``, two with ``remat=False`` and one
     with ``channel_remat=True``: loss and every leaf within
     ``REMAT_FACTOR`` times the two no-remat steps' own difference
     (floor ``REMAT_FLOOR``), peak memory (remat's below no remat's), host
     and device ms, 0 closest-hit launches in each backward; the
     repeatability readings (the two no-remat steps, and
     ``cornell_dynamic`` frames 0-3 run twice from one state).
  15. [tools]: ``tools/clip_engagement --size 256`` and
     ``tools/measure_spatial_grads --size 64 -k 2`` on the card, finite.
  16. [sharded]: the parallel layer, ranks that share the card over gloo
     (``tools/sharded_smoke.py``): (s1) ``make_sharded_render`` on the
     bench frame at 1920x1080 (spatial reuse on), 2 ranks, 4 frames, the
     halo denoiser off and on, against the unsharded frames (>= 99% of
     pixels within 1e-3; bitwise pixels and max abs printed), each rank's
     closest-hit launches = its trace calls > 0, the rays summed over the
     ranks = the unsharded frames'; (s2) the sharded train step, 2 ranks,
     2 steps, remat off and on, within the [grad check] limits, 0
     backward launches; (s3) ``shard_tracing`` on the 1080p cornell rays
     (K1, bitwise) and the city's (c) rays (K2, bitwise but for counted
     ties); (s4) 4 ranks: a frame on a 2x2 tile mesh and a
     ``make_multihost_train_step`` step on the (2, 2) host mesh at 512x512.
     Per case and rank: host ms/frame, peak memory, collective calls,
     bytes and ms by kind (halo, gather, reduce). Then
     ``python -m hikari_tpu_torch.bench_scaling --procs 2``.
  17. [spatial] (after [passes]): the spatial reuse's tap kernel
     (``csrc/spatial_reuse.cu``) on the main path: 6 frames of the
     benchmark cell's settings (the bench frame: 518,400 pixels, indirect
     16 taps), counts set to 0 just before, one launch a spatial pass (the
     kernel table's launches); 6 more with the emissive reuse on too (8
     taps). The last frame's recorded calls of both channels: bit for bit
     against the twin; the kernel's CUDA-event ms (one call's launch made
     again) beside the bound, the call's CUDA-event ms and the host ms of
     the spiral's table, the twin's device ms; the taps taken; ptxas'
     registers and spills.
  Each of 8-11 sets the counts to 0 just before each run and requires
  every trace of its main paths to go through the kernel of that path,
  and every spatial reuse pass to launch the spatial tap kernel once.
Every kernel case has a tie case: one triangle duplicated at prims 1, 4 and
8 (for the tile walk, 1 and 4 of one cluster and the next cluster's row
8), where the JAX kernels' per-sublane rule keeps the sublane-0 prim and
the brute-force rule the lowest. The closest-hit kernel also meets (j)
rays whose lanes mix prim ranges (the whole table, the emissive instance,
empty, a part), NaN/+inf/0 max distances, exclusion of their own hit and
invalid rows, and (k) the tie across its 256-row tiles (prims 1, 4 and
2,056), each bitwise equal to the twin under both tie modes; its [time]
line gives its SASS instructions a pair (common path), issue floors,
registers and resident warps per SM. The gathers meet ON % 4 != 0, an unaligned idx,
larger grids, reps 0 and each index mode; their [time] lines give the
launch floor (an empty kernel of the same grid) and torch.gather at the
single gathers.
``--profile`` adds a torch.profiler breakdown of two more frames of each
main path (``cornell_dynamic``'s with their moves), and of two fwd+grad
frames of ``cornell_bench`` (device time of
the forward against the backward's autograd nodes). The second-to-last
lines are the kernel table as JSON and the
card's nvidia-smi name/power limit; the last line is the result JSON. Any
failed phase raises, so the exit code is non-zero and no result line is
printed.
"""

import json
import subprocess
import sys
import time

# t/u/v tolerance of kernel vs twin. The kernels evaluate the twins'
# operations in the twins' order without FMA contraction, so the expected
# difference is exactly 0; the measured maximum is printed.
ATOL = 1e-5
FRAMES = 8
# [spatial]: frames of each run of the cell's settings.
SPATIAL_FRAMES = 6
CORNELL_HW = (1080, 1920)
CITY_HW = (512, 512)
SMALL_HW = (48, 63)
SMALL_BENCH_HW = (48, 60)
# K3 against K2 on the city primary rays: both are exact closest-hit
# searches, but their tie rules differ (ROADMAP.md section 3).
K2_K3_SHARE = 0.999
# Peaks of one H100 SXM at 700 W (NVIDIA's data sheet): FP32 outside the
# tensor cores and HBM3 bandwidth. A ray/triangle pair test is ~30 flops.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PAIR_FLOPS = 30
# A ray/cluster-AABB slab test (K2·p1, K3·pAB): 6 subtractions, 6
# multiplications, 12 min/max and the compares, ~30 FP32 operations.
SLAB_FLOPS = 30
# The kernels of one scatter_plan call (K3·pAB): the staged table, the
# count launch, the place launch.
PLAN_KERNELS = ("slab_table", "scatter_plan_count", "scatter_plan_place")
# The primitives' shapes: the TPU tool's (tools/bench_pallas_prims.py).
PACK_PLANES, PACK_HW, PACK_DXS = 8, (1080, 1920), list(range(16))
GATHER_CASES = (((512, 128), 1, 32), ((512, 128), 1, 128), ((512, 128), 1, 1), ((8, 1024), 0, 32))
RENDER_CASES = (("cornell", 128, 24), ("cornell", 256, 16), ("minimal", 256, 16),
                ("simple", 256, 16), ("scene", 256, 16))
DISSECT_CASE = ("cornell", 256, 16)
# [grad check]: the train step on the card against the CPU twins at frames
# 2 and 3. The kernels are bitwise to their twins, but CUDA's ATen
# reductions, transcendental functions and atomic scatter-adds in the
# backward round otherwise than the CPU's. Two H100 runs measured every
# leaf within 1.03e-6 relative L2 and the loss within 1.04e-7 in both
# settings (PERF.md); the bounds leave ten times that.
GRAD_LOSS_RTOL, GRAD_LEAF_REL = 1e-6, 1e-5
# [output]: cornell_output at 1280x720 (a size the JAX bloom defines:
# its mip chain halves 720x1280 four times without an odd side) and the
# card-vs-CPU check at 48x64; [passes]: frames a prefix (frame 1 warms up);
# [textured]: scene_textured at 512 and its check at 48x62.
OUTPUT_HW = (720, 1280)
OUTPUT_SMALL_HW = (48, 64)
# At an even width cornell's pixel centres fall on the box quads' exact
# diagonals: the card's and the CPU's 1-ulp different ray directions hit
# or miss there, and spatial reuse and the denoiser spread those pixels
# past the check's share. [output]'s small check and train step move the
# camera 0.0137 to the side.
OUTPUT_SMALL_EYE_X = 0.0137
PASSES_FRAMES = 4
TEXTURED_SIZE = 512
TEXTURED_SMALL_HW = (48, 62)
GRAD_CHECKS = (
    ("cornell temporal only, f32 reservoirs",
     lambda s: grad_small_settings(s, 63, 48, bench=False)),
    ("cornell bench settings", lambda s: grad_small_settings(s, 62, 48, bench=True)),
)

# [dynamic]: cornell_dynamic's camera orbits (0, 1, 0) at the config's
# radius of 4, 0.5 degrees a frame; from frame 1 each frame turns the tall
# box (instance 7) 2 degrees about y and moves it 0.01 along x; frame 4
# moves the light quad (instance 5) 0.02 along x (its alias rows stay),
# frame 6 scales it by 1.1 (its rows are rebuilt).
DYN_ORBIT_DEG = 0.5
DYN_BOX, DYN_LIGHT = 7, 5
DYN_BOX_TURN_DEG, DYN_BOX_STEP = 2.0, 0.01
DYN_LIGHT_MOVE_FRAME, DYN_LIGHT_MOVE = 4, 0.02
DYN_LIGHT_SCALE_FRAME, DYN_LIGHT_SCALE = 6, 1.1
DYN_SMALL_HW = (48, 64)
DYN_CHECK_FRAMES = (0, 1, 2, 3)
# A static instance keeps exactly zero object motion while its
# prev_model @ inv(model) lies within this of I (render/gbuffer.py).
STATIC_SNAP = 1e-6
# city_stream: examples/render city --stream at the config's full size.
STREAM_FRAMES, STREAM_SIZE = 16, 512
# [dynamic] (c): the card's update_transforms against the CPU's, each
# written field within this share of the field's largest magnitude (an
# absolute bound would sit near one f32 ulp at the city's coordinates).
DYN_UPDATE_REL = 1e-5
DYN_CITY_MOVED = 0.1
# Two searches of one scene agree on a ray's hit where the prims are
# equal; where they differ and both t lie within this relative distance,
# the ray met two triangles at one distance (a tie, counted). The bvh
# walk computes t by Moller-Trumbore, the kernels by the plane form.
TIE_REL = 1e-5
# [tiled]: the card's full calls are held to the CPU on every k-th tile at
# (c) and (d) (tiles are independent): 32 of 512 tiles at (c), 16 of 128 at
# (d), the only rays with early distance, exclusion and prim ranges. The
# CPU takes ~0.3 s a tile at (c) and ~2 s at (d). city_tiled renders this
# many frames.
TILED_CPU_STRIDE = (16, 8)
TILED_FRAMES = 2
# [bench_trace]: the rays of the default scene set (the JAX bench's default).
BENCH_TRACE_RAYS = 1 << 20
# [bench_trace]: K1b's twin tests at most this many (ray, triangle) pairs a
# row (city-8's 1,048,576 rays x 3,290 triangles); larger tables take every
# k-th ray of the row.
K1B_TWIN_PAIRS = 3_500_000_000
# [remat]: remat against no remat within this factor of the larger of the
# two no-remat steps' own difference and the floor (relative L2).
REMAT_FACTOR, REMAT_FLOOR = 10.0, 1e-6
# Every field update_transforms writes.
UPDATE_FIELDS = (
    "tri_world", "tri_n", "tri_eu", "tri_ev", "tri_cn", "tri_cu", "tri_cv", "tri_valid",
    "vert_normal", "node_min", "node_max", "inst_min", "inst_max", "inst_model",
    "inst_prev_model", "inst_inv_model", "em_position", "em_radius", "em_surface_area",
    "enode_min", "enode_max",
)


def log(msg):
    print(msg, flush=True)


def path_settings(settings, width, height):
    """The main paths' settings: the config at the given size with the
    post chain off."""
    from hikari_tpu_torch.config import Taa, Upscale

    return settings.replace(
        width=width, height=height, upscale=Upscale.none(), taa=Taa.NONE, denoise=False,
        indirect_spatial_reuse=False, emissive_spatial_reuse=False, emissive_lit=True,
        indirect_bounces=1, reservoir_f16=True, reproject="shift", remat=False,
        collect_stats=True, tracer="auto",
    )


def bench_settings(settings, width, height, tracer):
    """The bench frame's post chain (bench.py:77-116) on ``settings``: the
    output size, SMAA TU4x at 2x, TAA Jasmine, denoise, one bounce. The
    spatial reuses and the reservoir precision stay those of ``settings``
    (``path_settings`` turns both reuses off, ``bench_config`` keeps the
    config's)."""
    from hikari_tpu_torch.config import Taa, Upscale

    return settings.replace(
        width=width, height=height, upscale=Upscale.smaa_tu4x(2.0), taa=Taa.JASMINE, denoise=True,
        indirect_bounces=1, reproject="shift", remat=False, collect_stats=True, tracer=tracer,
    )


def grad_small_settings(settings, width, height, bench):
    """[grad check]'s settings: the bench frame's (``bench=True``) or
    cornell with temporal reuse only and f32 reservoirs, no upscale or TAA
    (``tests/test_torch_grad_cornell.py``)."""
    from hikari_tpu_torch.config import Taa, Upscale

    if bench:
        return bench_settings(settings, width, height, "auto")
    return settings.replace(
        width=width, height=height, upscale=Upscale.none(), taa=Taa.NONE, denoise=True,
        indirect_bounces=1, indirect_spatial_reuse=False, emissive_spatial_reuse=False,
        emissive_lit=True, reservoir_f16=False, reproject="shift", remat=False, tracer="bruteforce",
        clear_color=(0.0, 0.0, 0.0, 1.0),
    )


def cuda_time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, warmup=2, names=None):
    """Device time per call of ``fn``: the CUDA kernels' time in a
    torch.profiler trace of ``iters`` calls, over ``iters``; with
    ``names``, only the kernels whose names hold one of them. For calls so
    short that the host's launch loop, not the card, sets the pace of
    ``cuda_time_ms``, and for the kernels among a call's other work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and (names is None or any(n in e.key for n in names)))
    if names is not None and not busy_us > 0:
        raise AssertionError(f"no device time of {names} in the profile")
    return busy_us / iters / 1e3


def bound_ms(flops, nbytes):
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate."""
    ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def compare(name, got, want):
    """Kernel (t, prim, u, v[, tested]) against the twin's; returns the
    max |t,u,v| error."""
    t, prim, u, v = got[:4]
    t_r, prim_r, u_r, v_r = want[:4]
    n_diff = int((prim != prim_r).sum())
    if n_diff:
        raise AssertionError(f"{name}: prim differs from the twin on {n_diff} rays")
    extra = ""
    if len(got) > 4:
        n_tiles = int((got[4] != want[4]).sum())
        if n_tiles:
            raise AssertionError(f"{name}: clusters tested differ from the twin on {n_tiles} tiles")
        extra = f", tested clusters equal on {got[4].numel()} tiles (sum {int(got[4].sum())})"
    err = max(float((a - b).abs().max()) for a, b in ((t, t_r), (u, u_r), (v, v_r)))
    if not err <= ATOL:
        raise AssertionError(f"{name}: t/u/v differ from the twin by {err} > {ATOL}")
    hits = int((prim >= 0).sum())
    log(f"[kernel] {name}: {prim.numel()} rays/items, {hits} hits, prim equal{extra}, "
        f"max |t,u,v| err {err}")
    return err


def soup_case(device):
    """5120 random triangles in 8 instances and 65536 random rays with
    random exclusion and prim ranges (spans several shared-memory tiles)."""
    import numpy as np
    import torch
    from types import SimpleNamespace

    from hikari_tpu_torch.trace.closest_hit import pack_triangles
    from hikari_tpu_torch.trace.intersect import precompute_triangles

    rng = np.random.default_rng(7)
    P, R = 5120, 65536
    centers = rng.uniform(-1.0, 1.0, (P, 1, 3))
    tris = (centers + rng.normal(scale=0.15, size=(P, 3, 3))).astype(np.float32)
    pre = precompute_triangles(torch.from_numpy(tris).to(device))
    inst = torch.from_numpy(rng.integers(0, 8, P).astype(np.int32)).to(device)
    table = pack_triangles(SimpleNamespace(
        num_tris=P, tri_inst=inst, tri_n=pre["n"], tri_eu=pre["eu"], tri_ev=pre["ev"],
        tri_cn=pre["cn"], tri_cu=pre["cu"], tri_cv=pre["cv"], tri_valid=pre["valid"],
    ))
    o = rng.uniform(-1.5, 1.5, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lo = rng.integers(0, P, R)
    hi = lo + rng.integers(0, P, R)
    full = rng.uniform(size=R) < 0.5
    lo[full], hi[full] = 0, P

    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x).astype(dtype)).to(device)

    return (
        dev(o, np.float32), dev(d, np.float32),
        dev(rng.uniform(0.5, 4.0, R), np.float32),
        dev(rng.integers(-1, 8, R), np.int32),
        dev(lo, np.int32), dev(np.minimum(hi, P), np.int32), table,
    )


def walk_case(scene, o, d, maxd, early, excl, lo, hi):
    """The tile walk's arguments for flat rays, as ``trace_rays`` builds
    them: the scene's cluster rule, rays sorted into tiles (the ray count
    is a multiple of 512 here, so no padding), phase 1 and the sort.
    Returns (walk arguments, phase-1 arguments)."""
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import tile_walk as tw

    cluster, use_skip = api.tile_cluster_rule(scene.tri_n.shape[0])
    if o.shape[0] % 512:
        raise ValueError("walk_case takes whole tiles")
    order = api.ray_sort_order(scene, o, d)
    o, d, maxd, early, excl, lo, hi = (x[order].contiguous() for x in (o, d, maxd, early, excl, lo, hi))
    packed, cmin, cmax, cvalid = tw.pack_clusters(scene, cluster)
    phase1 = (cmin, cmax, cvalid, o, d, maxd, lo, hi, cluster)
    sorted_, entry, maxent = tw.tile_entries(*phase1)
    walk = (packed, cmin, cmax, o, d, maxd, early, excl, lo, hi, sorted_, entry, maxent,
            cluster, use_skip)
    return walk, phase1


def city_random_rays(scene, device, R=65536, seed=11):
    """Random rays in the city with the whole contract: random max
    distance (or none), exclusion, early distance on a third of them and
    one instance's prim range on half of them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-96, 96, R), rng.uniform(0.5, 30, R), rng.uniform(-96, 96, R)], -1)
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxd = np.where(rng.uniform(size=R) < 0.5, rng.uniform(1, 200, R), 3.0e38)
    early = np.where(rng.uniform(size=R) < 0.35, rng.uniform(0, 100, R), 0.0)
    n_inst = scene.num_instances
    excl = rng.integers(-1, n_inst, R)
    offset = scene.inst_prim_offset.cpu().numpy()
    count = scene.inst_prim_count.cpu().numpy()
    inst = rng.integers(0, n_inst, R)
    half = rng.uniform(size=R) < 0.5
    lo = np.where(half, offset[inst], 0)
    hi = np.where(half, offset[inst] + count[inst], scene.num_tris)

    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x).astype(dtype)).to(device)

    return (dev(o, np.float32), dev(d, np.float32), dev(maxd, np.float32), dev(early, np.float32),
            dev(excl, np.int32), dev(lo, np.int32), dev(hi, np.int32))


def check_cluster_errors(where):
    """The scatter kernel writes misses for a block whose cluster id lies
    outside the table, and counts it: fail if any did."""
    from hikari_tpu_torch.trace import scatter as sc

    n = sc.cluster_errors()
    if n:
        raise AssertionError(f"{where}: the scatter kernel met {n} blocks with a cluster id "
                             f"outside the table")


def run_main_path(name, scene, cam, settings, device, tag="[main]"):
    """``FRAMES`` frames through ``render_frame`` with every launch count
    set to 0 just before and read just after. Checks that every trace went
    through a kernel and that the image is finite and lit; returns (final
    state, launches per kernel)."""
    import numpy as np
    import torch

    from hikari_tpu_torch.render.pipeline import image_size, initial_state, render_frame
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.trace import scatter as sc
    from hikari_tpu_torch.trace import tile_walk as tw
    from hikari_tpu_torch.trace import tiled as ttiled
    from hikari_tpu_torch.utils import luminance

    state = initial_state(settings, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    frame_ms, dropped = [], []
    with torch.no_grad():
        for _ in range(FRAMES):
            before = sc.dropped
            t0 = time.perf_counter()
            out, state = render_frame(scene, cam, state, settings)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            dropped.append(sc.dropped - before)
    launches = {"closest_hit": ch.launches, "tile_walk": tw.launches, "scatter_items": sc.launches}
    traces = api.trace_calls
    spatial_counts = {k: v for k, v in read_counts().items() if k.startswith("spatial")}
    require_spatial_kernel(name, spatial_counts)
    check_cluster_errors(name)
    # Closest-hit launches over tables above one TPU tile (K1b's regime),
    # part of the closest-hit count.
    launches_k1b = ch.streamed_launches
    peak = torch.cuda.max_memory_allocated(device)
    if not (traces > 0 and sum(launches.values()) == traces):
        raise AssertionError(f"{name}: kernel launches {launches} for {traces} CUDA trace calls")
    # The slab-test phases before the tile walk and the scatter kernel:
    # K2·p1 launches two kernels a call (table, tests), K3·pAB three
    # (table, count, place).
    phases = {"tile_entries": ttiled.launches, "scatter_plan": sc.plan_launches}
    if phases != {"tile_entries": 2 * launches["tile_walk"],
                  "scatter_plan": 3 * launches["scatter_items"]}:
        raise AssertionError(f"{name}: phase kernel launches {phases} for trace kernel launches "
                             f"{launches}")
    stats = {k: float(v) for k, v in out.stats.items()}
    img = out.image
    rh, rw = settings.render_size
    want_hw = image_size(settings)
    if tuple(img.shape) != (*want_hw, 4):
        raise AssertionError(f"{name}: image shape {tuple(img.shape)}")
    if stats["nonfinite_pixels"] != 0 or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{name}: non-finite image: {stats}")
    mean_lum = float(luminance(img[..., :3]).mean())
    if not mean_lum > 0.0:
        raise AssertionError(f"{name}: black image: mean luminance {mean_lum}")
    # Where the lighting channels and the f16 reservoir storage hold
    # non-finite values (the image itself must be finite, checked above).
    nonfinite = {k: int((~torch.isfinite(getattr(out, k))).sum())
                 for k in ("direct", "emissive", "indirect")}
    f16_inf = {}
    for k in ("direct_temporal", "emissive_temporal", "indirect_temporal"):
        res = getattr(state, k)
        f16_inf[k] = sum(int(torch.isinf(x).sum()) for x in (
            res.w, res.w_sum, res.w2_sum, res.s.radiance) if x.dtype == torch.float16)
    median_ms = float(np.median(frame_ms[1:]))
    log(f"{tag} {name} {settings.width}x{settings.height}, {FRAMES} frames: {traces} trace calls, "
        f"kernel launches {launches}, phase kernels {phases}; ms/frame median(frames 2-{FRAMES}) {median_ms:.2f} "
        f"(all: {', '.join(f'{m:.1f}' for m in frame_ms)}); peak memory "
        f"{peak / 2**30:.3f} GiB; mean luminance {mean_lum:.4f}; stats {stats}")
    log(f"{tag} {name} last frame: non-finite values per channel {nonfinite}; inf entries in "
        f"the f16 reservoir state (w, w_sum, w2_sum, radiance) {f16_inf}; scatter items "
        f"dropped per frame {dropped}; closest-hit launches over tables above 2,048 "
        f"triangles {launches_k1b}")
    return state, dict(launches, closest_hit_k1b=launches_k1b, **phases, **spatial_counts)


def check_small(name, scene_gpu, scene_cpu, cam, settings, device, frames=(0, 1, 2)):
    """The card (kernels) against the CPU (twins), frame by frame from one
    state, compared at ``frames`` (the CPU runs the frames before them).
    Discrete ReSTIR choices may flip a few edge pixels on 1-ulp
    differences of transcendental functions, hence a share-of-pixels
    bound."""
    import torch

    from hikari_tpu_torch.render.pipeline import initial_state, render_frame
    from hikari_tpu_torch.utils import map_tensors

    cam_cpu = cam.to("cpu")
    st_cpu = initial_state(settings, "cpu")
    with torch.no_grad():
        for frame in range(max(frames) + 1):
            if frame not in frames:
                _, st_cpu = render_frame(scene_cpu, cam_cpu, st_cpu, settings)
                continue
            st_gpu = map_tensors(lambda x: x.to(device), st_cpu)
            o_gpu, _ = render_frame(scene_gpu, cam_cpu.to(device), st_gpu, settings)
            o_cpu, st_cpu = render_frame(scene_cpu, cam_cpu, st_cpu, settings)
            check_frame(name, settings, frame, o_gpu.image, o_cpu.image)


def check_frame(name, settings, frame, img_gpu, img_cpu):
    """Fail unless >= 99% of the card's pixels lie within 1e-3 of the CPU
    twin's."""
    import torch

    diff = (img_gpu.cpu() - img_cpu).abs().amax(-1)
    share = float((diff <= 1e-3).to(torch.float32).mean())
    if share < 0.99:
        raise AssertionError(f"{name} frame {frame}: only {share:.4f} of pixels within 1e-3")
    log(f"[check] {name} {settings.width}x{settings.height} frame {frame}: card vs CPU "
        f"twin, {share:.4f} of pixels within 1e-3, max |diff| {float(diff.max()):.3g}")


def profile_frames(name, advance, state, frames=2, top=12):
    """``--profile``: trace ``frames`` more frames, ``state = advance(state)``
    each, with torch.profiler; print the device busy share (kernel time over
    wall time), the device time under the tile walk's and the scatter
    tracer's ranges, the kernels with the most device time and the device
    time of the autograd backward (the kernels under the autograd engine's
    ``evaluate_function`` events; 0 for a forward-only path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            state = advance(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    ranges = ("tile_entries", "tile_walk", "scatter_plan", "scatter_items", "segment_min")
    # The ranges also appear as device-side annotations: keep them out of
    # the kernel sums, which would count their kernels twice.
    kernels = [e for e in events if e.device_type.name == "CUDA" and e.key not in ranges]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    bwd = [e for e in events if e.device_type.name == "CPU"
           and e.key.startswith("autograd::engine::evaluate_function")]
    bwd_us = sum(e.device_time_total for e in bwd)
    log(f"[profile] {name}, {frames} frames: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({busy_us / wall_us:.3f} of wall), {n_launch} kernel launches; "
        f"device time forward {(busy_us - bwd_us) / 1e3:.2f} ms, backward {bwd_us / 1e3:.2f} ms "
        f"({sum(e.count for e in bwd)} autograd nodes)")
    for e in events:
        if e.key in ranges:
            log(f"[profile]   range {e.key} ({e.device_type.name}): {e.count}x, device "
                f"{e.device_time_total / 1e3:.3f} ms, cpu {e.cpu_time_total / 1e3:.3f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")
    if bwd:
        log("[profile]   backward nodes by device time: " + ", ".join(
            f"{e.key.split(':')[-1].strip()} {e.device_time_total / 1e3:.3f} ms ({e.count}x)"
            for e in sorted(bwd, key=lambda e: -e.device_time_total)[:top]))
    ours = [e for e in kernels
            if any(k in e.key for k in ("closest_hit", "tile_walk", "scatter_items",
                                        "tile_entries_kernel", "scatter_plan_", "slab_table"))]
    log(f"[profile]   the trace kernels: " + (", ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms in {e.count} launches" for e in ours)
        or "none"))


def render_advance(scene, cam, settings):
    """One forward frame, for ``profile_frames``."""
    import torch

    from hikari_tpu_torch.render.pipeline import render_frame

    def advance(state):
        with torch.no_grad():
            return render_frame(scene, cam, state, settings)[1]

    return advance


def duplicate_rows(rows, dup, device):
    """(rows, 16) packed rows of one triangle in the z = 0 plane, valid only
    at the prims ``dup`` (instance 0): an exact tie among those prims."""
    import torch

    from hikari_tpu_torch.trace.intersect import precompute_triangles

    tri = torch.tensor([[[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]]])
    pre = precompute_triangles(tri.repeat(rows, 1, 1))
    valid = torch.zeros(rows)
    valid[list(dup)] = 1.0
    packed = torch.cat([pre["n"], pre["eu"], pre["ev"], pre["cn"][:, None], pre["cu"][:, None],
                        pre["cv"][:, None], valid[:, None], torch.zeros((rows, 3))], dim=1)
    return packed.contiguous().to(device)


def tie_rays(R, hi, device):
    """R rays through the duplicated triangle, half from each side, with
    the whole contract's other arguments at their defaults."""
    import torch

    g = torch.Generator().manual_seed(3)
    xy = torch.rand((R, 2), generator=g) * 0.6 - 0.3
    front = torch.arange(R) % 2 == 0
    o = torch.cat([xy, torch.where(front, -5.0, 4.0)[:, None]], dim=1)
    d = torch.zeros((R, 3))
    d[:, 2] = torch.where(front, 1.0, -1.0)
    return [x.to(device).contiguous() for x in (
        o, d, torch.full((R,), 3.0e38), torch.zeros(R), torch.full((R,), -1, dtype=torch.int32),
        torch.zeros(R, dtype=torch.int32), torch.full((R,), hi, dtype=torch.int32))]


def tie_cases(device):
    """The JAX kernels' tie rule on the card. K1: a triangle duplicated at
    prims 1, 4 and 8 returns prim 8 under "pallas" (sublane 0 wins the
    halving) and prim 1 under "bruteforce". K2: duplicates at prims 1 and 4
    of cluster 0 and 72 (row 8) of cluster 1 return prim 72: the eight
    sublane bests carry across the clusters; duplicates at prims 8 and 16 of
    cluster 0 and 64 (row 0) of cluster 1, all on sublane 0, return prim 8,
    the first found, though the kernel's two halves of rows hold 16 and 64
    (row groups 2 and 8) and 8 (group 1) apart. Each kernel equals its
    twin."""
    import torch

    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.trace import tile_walk as tw

    o, d, maxd, early, excl, lo, hi = tie_rays(1024, 16, device)
    packed = duplicate_rows(16, (1, 4, 8), device)
    for tie, want in (("pallas", 8), ("bruteforce", 1)):
        got = ch.closest_hit(o, d, maxd, excl, lo, hi, packed, tie)
        ref = ch.closest_hit_reference(o, d, maxd, excl, lo, hi, packed, tie)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"tie case K1 {tie}: kernel differs from its twin")
        if not bool((got[1] == want).all()):
            raise AssertionError(f"tie case K1 {tie}: prims {got[1].unique().tolist()}, want {want}")
        log(f"[kernel] tie K1 tie={tie!r}: duplicates at prims 1, 4, 8 -> prim {want} on all "
            f"{o.shape[0]} rays, kernel = twin")
    cluster = 64
    o, d, maxd, early, excl, lo, hi = tie_rays(512, 2 * cluster, device)
    packed = duplicate_rows(2 * cluster, (1, 4, cluster + 8), device)
    bmin = torch.tensor([[-1.0, -1.0, 0.0]] * 2, device=device)
    bmax = torch.tensor([[1.0, 1.0, 0.0]] * 2, device=device)
    cvalid = torch.ones(2, dtype=torch.bool, device=device)
    order, entry, maxent = tw.tile_entries(bmin, bmax, cvalid, o, d, maxd, lo, hi, cluster)
    walk = (packed, bmin, bmax, o, d, maxd, early, excl, lo, hi, order, entry, maxent, cluster,
            False)
    for prims, want in (((1, 4, cluster + 8), cluster + 8), ((8, 16, cluster), 8)):
        walk = (duplicate_rows(2 * cluster, prims, device), *walk[1:])
        got, ref = tw.tile_walk(*walk), tw.tile_walk_reference(*walk)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"tie case K2 {prims}: kernel differs from its twin")
        if not bool((got[1] == want).all()) or got[4].tolist() != [2]:
            raise AssertionError(f"tie case K2 {prims}: prims {got[1].unique().tolist()}, "
                                 f"tested {got[4].tolist()}")
        log(f"[kernel] tie K2: duplicates at prims {', '.join(map(str, prims))} (cluster "
            f"{cluster}) -> prim {want} on all 512 rays, 2 clusters tested, kernel = twin")


def k1_edge_cases(cornell, device):
    """K1 against its twin, torch.equal on prim, t, u, v under both tie
    modes: (j) rays in the cornell box whose lanes mix the whole table, the
    emissive instance's prims, an empty range and a random part (per lane,
    and per warp of 32), max distances of NaN, +inf, 0, F32_MAX and random,
    the instance of their own closest hit excluded on a third of them, on
    the table and on a copy with every fifth row invalid; 300,000 rays (a
    ragged last block) and their first 65,536; (k) one triangle
    duplicated at prims 1, 4 and 2,056 of a 2,064-row table, across the
    kernel's 256-row tiles (and the TPU kernel's 2,048-row ones): prim 2,056
    under "pallas" (sublane 0 wins), 1 under "bruteforce"."""
    import numpy as np
    import torch

    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.utils import same_bits

    rng = np.random.default_rng(17)
    R, P = 300000, cornell.num_tris
    packed = ch.pack_triangles(cornell)
    invalid = packed.clone()
    invalid[2::5, 12] = 0.0
    em = int(cornell.em_instance[0])
    em_lo = int(cornell.inst_prim_offset[em])
    em_hi = em_lo + int(cornell.inst_prim_count[em])
    o = rng.uniform(-0.9, 0.9, (R, 3)) + np.array([0.0, 1.0, 0.0])
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # Range kinds per lane for the first half, per warp of 32 for the rest.
    kind = rng.integers(0, 4, R)
    kind[R // 2:] = np.repeat(rng.integers(0, 4, -(-R // 64)), 32)[: R - R // 2]
    part_lo = rng.integers(0, P, R)
    part_hi = part_lo + rng.integers(0, P, R)
    lo = np.select([kind == 0, kind == 1, kind == 2], [0, em_lo, 7], part_lo)
    hi = np.select([kind == 0, kind == 1, kind == 2], [P, em_hi, 7], np.minimum(part_hi, P))
    maxd = rng.uniform(0.1, 3.0, R)
    pick = rng.integers(0, 5, R)
    maxd = np.select([pick == 0, pick == 1, pick == 2, pick == 3], [np.nan, np.inf, 0.0, 3.0e38],
                     maxd)

    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x).astype(dtype)).to(device)

    args = [dev(o, np.float32), dev(d, np.float32), dev(maxd, np.float32),
            torch.full((R,), -1, dtype=torch.int32, device=device), dev(lo, np.int32),
            dev(hi, np.int32)]
    inst = packed[:, 13].contiguous().view(torch.int32)
    first = ch.closest_hit_reference(*args, packed)[1]
    own = torch.where(first >= 0, inst[first.clamp(min=0)], -1)
    args[3] = torch.where(torch.from_numpy(rng.uniform(size=R) < 1 / 3).to(device), own,
                          args[3]).to(torch.int32).contiguous()
    for table_name, table in (("table", packed), ("every fifth row invalid", invalid)):
        for n in (R, 65536):
            for tie in ("pallas", "bruteforce"):
                case = [x[:n] for x in args] + [table, tie]
                got, want = ch.closest_hit(*case), ch.closest_hit_reference(*case)
                if not all(same_bits(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"(j) K1 {table_name}, {n} rays, tie={tie!r}: kernel "
                                         f"differs from its twin")
                if n == R and tie == "pallas":
                    hits, nans = int((got[1] >= 0).sum()), int(torch.isnan(got[0]).sum())
        log(f"[kernel] (j) K1 mixed lanes ({table_name}): {R} and 65536 rays, both tie modes, "
            f"kernel = twin bit for bit; {hits} hits and {nans} NaN t (NaN max distance) of "
            f"{R}")
    rows, dup, far = 2064, (1, 4, 2056), 2056
    o, d, maxd, _, excl, lo, hi = tie_rays(1024, rows, device)
    table = duplicate_rows(rows, dup, device)
    for n in (1024, 300032):
        big = [x.repeat((n // 1024,) + (1,) * (x.dim() - 1)) for x in (o, d, maxd, excl, lo, hi)]
        for tie, want in (("pallas", far), ("bruteforce", 1)):
            got = ch.closest_hit(*big, table, tie)
            ref = ch.closest_hit_reference(*big, table, tie)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"(k) K1 tile-spanning tie {tie}: kernel differs from its "
                                     "twin")
            if not bool((got[1] == want).all()):
                raise AssertionError(f"(k) K1 tile-spanning tie {tie}: prims "
                                     f"{got[1].unique().tolist()}, want {want}")
    log(f"[kernel] (k) K1 tie across tiles: duplicates at prims {dup} of {rows} rows -> prim {far} "
        f"('pallas'), 1 ('bruteforce') on 1,024 and 300,032 rays, kernel = twin")


def prim_cases(device):
    """(g)-(i) and their [time] lines: T1-T3 against their twins on the
    card. Returns {kernel: (max_abs_err, ms, plain_ms, bound, bound_by,
    library_ms)} and the pack's composition time."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hikari_tpu_torch.tools import prims
    from hikari_tpu_torch.utils import same_bits

    out = {}
    # (g) T1 at the TPU tool's shape.
    H, W = PACK_HW
    N = H * W
    ramp = torch.arange(N, dtype=torch.float32, device=device)
    planes = torch.stack([torch.sin(ramp * 1e-5 * (1 + c)).reshape(H, W) for c in range(PACK_PLANES)])
    del ramp
    got = prims.window_pack(planes, PACK_DXS)
    want = prims.window_pack_reference(planes, PACK_DXS)
    if not torch.equal(got, want):
        raise AssertionError("(g) window_pack differs from its twin")
    err_g = float((got - want).abs().max())
    del want
    taps = len(PACK_DXS)

    def composition():
        padded = F.pad(planes, (0, taps - 1), mode="replicate")
        return padded.unfold(2, taps, 1).permute(1, 2, 0, 3).contiguous().view(N, -1)

    if not torch.equal(composition(), got):
        raise AssertionError("(g) the pad + unfold composition differs from the table")
    log(f"[kernel] (g) window_pack {PACK_PLANES} planes {H}x{W}, {taps} taps -> {tuple(got.shape)}: "
        f"kernel = twin (torch.equal), max |err| {err_g}")
    del got
    torch.cuda.synchronize()
    pack_ms = cuda_time_ms(lambda: prims.window_pack(planes, PACK_DXS), 20)
    pack_plain_ms = cuda_time_ms(lambda: prims.window_pack_reference(planes, PACK_DXS), 3)
    comp_ms = cuda_time_ms(composition, 5)
    pack_bytes = planes.numel() * 4 + N * PACK_PLANES * taps * 4
    pack_bound, pack_by = bound_ms(0, pack_bytes)
    log(f"[time] (g) window_pack: kernel {pack_ms:.4f} ms, twin {pack_plain_ms:.4f} ms, bound "
        f"{pack_bound:.4f} ms ({pack_by}: {pack_bytes / 1e6:.1f} MB); nearest PyTorch composition "
        f"(replicate pad + unfold + contiguous, 3 calls) {comp_ms:.4f} ms")
    out["window_pack"] = (err_g, pack_ms, pack_plain_ms, pack_bound, pack_by, None)
    del planes
    torch.cuda.empty_cache()

    def grid(m, n):
        return (torch.arange(m * n, dtype=torch.float32, device=device) * 1e-4).reshape(m, n)

    g = torch.Generator().manual_seed(5)

    def draw(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32).to(device)

    def compare_take(name, x, idx, axis, reps, mode=None):
        got = prims.take_along_sum(x, idx, axis, reps, mode)
        want = prims.take_along_sum_reference(x, idx, axis, reps, mode)
        if not same_bits(got, want):
            raise AssertionError(f"{name}: kernel differs from its twin")
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max())
        return got, err, int((~fin).sum())

    # (h) T2 at (512, 512): both axes, in-range indices, then each mode on
    # indices in [-2n, 2n).
    x = grid(512, 512)
    errs = []
    for axis in (0, 1):
        _, err, _ = compare_take(f"(h) axis {axis}", x, draw((512, 512), 0, 512), axis, 1)
        errs.append(err)
        for mode in (None, "clip", "fill"):
            _, err, nan = compare_take(f"(h) axis {axis} mode {mode}", x, draw((512, 512), -1024, 1024),
                                       axis, 1, mode)
            errs.append(err)
            if (nan > 0) != (mode != "clip"):
                raise AssertionError(f"(h) axis {axis} mode {mode}: {nan} fill values")
    log(f"[kernel] (h) take_along (512, 512), axes 0 and 1, in range and modes None/clip/fill on "
        f"indices in [-1024, 1024): kernel = twin (NaN where the twin fills), max |err| {max(errs)}")
    # Edge cases: ON % 4 != 0, an idx not 16-byte aligned, larger grids,
    # reps 0, 1 and 3, indices in [-2n, 2n) in each mode.
    n_edge = 0
    for (m, n), (om, on), axis, shift in (
            ((512, 128), (512, 130), 1, False), ((64, 130), (50, 130), 0, False),
            ((8, 1024), (8, 1024), 0, True), ((2048, 2048), (2048, 2048), 1, False),
            ((2048, 2048), (2048, 2048), 1, True), ((2048, 1030), (2048, 1030), 0, False)):
        xe = grid(m, n)
        size = (m, n)[axis]
        idx = draw((om, on), -2 * size, 2 * size)
        if shift:  # the same values at an address 4 bytes past a 16-byte boundary
            shifted = torch.empty(om * on + 1, dtype=torch.int32, device=device)[1:].view(om, on)
            idx = shifted.copy_(idx)
        for reps in (0, 1, 3):
            for mode in (None, "clip", "fill"):
                compare_take(f"(h) edge {(om, on)} axis {axis} x{reps} {mode}", xe, idx, axis, reps,
                             mode)
                n_edge += 1
    log(f"[kernel] (h) take_along edge cases: idx (512, 130) axis 1, (50, 130) axis 0, an "
        f"unaligned (8, 1024) axis 0, (2048, 2048) axis 1 aligned and not, (2048, 1030) axis 0; "
        f"reps 0, 1, 3; each mode on indices in [-2n, 2n): {n_edge} cases, "
        f"kernel = twin bitwise (NaN where the twin fills)")
    idx0 = draw((512, 512), 0, 512)
    idx0_64 = idx0.long()
    calls = {"kernel": lambda: prims.take_along_sum(x, idx0, 0),
             "twin": lambda: prims.take_along_sum_reference(x, idx0, 0),
             "torch.gather": lambda: torch.gather(x, 0, idx0_64)}
    dev_us = {k: device_ms(f, 200) * 1e3 for k, f in calls.items()}
    call_us = {k: cuda_time_ms(f, 200) * 1e3 for k, f in calls.items()}
    t2_bound, t2_by = bound_ms(2 * x.numel(), 3 * 4 * x.numel())
    floor_us = device_ms(lambda: prims.take_along_empty(idx0.shape, device), 200) * 1e3
    log(f"[time] (h) take_along (512, 512) axis 0, device time per call (torch.profiler): "
        + ", ".join(f"{k} {v:.2f} us" for k, v in dev_us.items())
        + f"; per call in a host launch loop (CUDA events): "
        + ", ".join(f"{k} {v:.2f} us" for k, v in call_us.items())
        + f"; bound {t2_bound * 1e3:.3f} us ({t2_by}); launch floor (an empty kernel of the same "
        f"grid, device time) {floor_us:.2f} us")
    out["take_along_T2"] = (max(errs), dev_us["kernel"] / 1e3, dev_us["twin"] / 1e3, t2_bound, t2_by,
                            dev_us["torch.gather"] / 1e3)

    # (i) T3 at the tool's four shapes: twin and the tool's closed form.
    errs, t3 = [], None
    for (m, n), axis, reps in GATHER_CASES:
        x, idx = grid(m, n), draw((m, n), 0, (m, n)[axis])
        got, err, _ = compare_take(f"(i) {m}x{n} axis {axis} x{reps}", x, idx, axis, reps)
        errs.append(err)
        base = float(torch.take_along_dim(x, idx.long(), dim=axis).double().sum())
        want = sum(base + r * idx.numel() for r in range(reps))
        value = float(got.double().sum())
        if abs(value - want) > abs(want) * 1e-4 + 1e-3:
            raise AssertionError(f"(i) {m}x{n} x{reps}: sum {value} != closed form {want}")
        ms = device_ms(lambda: prims.take_along_sum(x, idx, axis, reps), 200)
        call = cuda_time_ms(lambda: prims.take_along_sum(x, idx, axis, reps), 200)
        plain = device_ms(lambda: prims.take_along_sum_reference(x, idx, axis, reps), 5)
        bound, by = bound_ms(2 * reps * idx.numel(), 3 * 4 * idx.numel())
        library = ""
        if reps == 1:  # a single gather: torch.gather computes the same function
            idx_64 = idx.long()
            gather_us = device_ms(lambda: torch.gather(x, axis, idx_64), 200) * 1e3
            library = f"; torch.gather {gather_us:.2f} us device"
        floor_us = device_ms(lambda: prims.take_along_empty(idx.shape, device), 200) * 1e3
        log(f"[kernel] (i) take_along {m}x{n} axis {axis} x{reps}: kernel = twin, sum {value:.6g} vs "
            f"closed form {want:.6g}; [time] device time per call: kernel {ms * 1e3:.2f} us, twin "
            f"{plain * 1e3:.2f} us; kernel per call in a host loop {call * 1e3:.2f} us; bound "
            f"{bound * 1e3:.3f} us ({by}); launch floor {floor_us:.2f} us{library}")
        if t3 is None:
            t3 = (ms, plain, bound, by)
    out["take_along_T3"] = (max(errs), *t3, None)
    return out


def run_prims(device):
    """[prims]: the port's bench_pallas_prims on the card with the
    primitives' counts set to 0 just before; every case must meet its
    check. Returns (T1, T2, T3) launches."""
    from hikari_tpu_torch.tools import bench_pallas_prims, prims

    prims.window_pack_launches = prims.take_along_launches = 0
    t0 = time.perf_counter()
    results = bench_pallas_prims.main([])
    seconds = time.perf_counter() - t0
    bad = [name for name, r in results.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"[prims] cases failed their checks: {bad}")
    t1, taken = prims.window_pack_launches, prims.take_along_launches
    t2 = sum(r["take_along"] for name, r in results.items() if "(512x512)" in name)
    if not (t1 > 0 and t2 > 0 and taken - t2 > 0):
        raise AssertionError(f"[prims] launches: window_pack {t1}, take_along {taken} (T2 {t2})")
    log(f"[prims] {len(results)} cases in {seconds:.1f} s, every check met; launches: window_pack "
        f"{t1}, take_along {taken} (T2 cases {t2}, T3 cases {taken - t2})")
    return t1, t2, taken - t2


def run_render(device):
    """[render]: the port's examples/render and examples/dissect on the
    card into a temporary directory, each with the trace counts set to 0
    just before; every trace must go through the closest-hit kernel and
    the image must be finite and lit. Returns the closest-hit launches."""
    import tempfile

    import numpy as np
    import torch

    from hikari_tpu_torch.examples import dissect, render
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.trace import scatter as sc
    from hikari_tpu_torch.trace import tile_walk as tw
    from hikari_tpu_torch.utils import luminance

    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        cases = [(f"render {name}", size, frames, render.main,
                  [name, "--frames", str(frames), "--size", str(size), "--out",
                   f"{tmp}/{name}_{size}.png"]) for name, size, frames in RENDER_CASES]
        name, size, frames = DISSECT_CASE
        cases.append((f"dissect {name}", size, frames, dissect.main,
                      [name, "--frames", str(frames), "--size", str(size), "--out-dir",
                       f"{tmp}/dissect"]))
        for label, size, frames, entry, argv in cases:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            reset_counts()
            res = entry(argv)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device)
            traces, k1 = api.trace_calls, ch.launches
            if not (traces > 0 and k1 == traces and tw.launches == sc.launches == 0):
                raise AssertionError(f"{label}: {traces} trace calls, closest-hit {k1}, tile walk "
                                     f"{tw.launches}, scatter {sc.launches}")
            require_spatial_kernel(f"[render] {label}", read_counts())
            img = res["outputs"].image
            nonfinite = int((~torch.isfinite(img)).sum())
            mean_lum = float(luminance(img[..., :3]).mean())
            if nonfinite or not mean_lum > 0.0:
                raise AssertionError(f"{label}: {nonfinite} non-finite pixels, mean luminance {mean_lum}")
            if "images" in res:
                bad = [k for k, (_, im) in res["images"].items() if not np.isfinite(im).all()]
                if bad:
                    raise AssertionError(f"{label}: non-finite pass images {bad}")
            ms = float(np.median(res["frame_seconds"][1:])) * 1e3
            log(f"[render] {label} {size}x{size}, {frames} frames: ms/frame median(frames 2-{frames}) "
                f"{ms:.2f}, peak memory {peak / 2**30:.3f} GiB, non-finite pixels {nonfinite}, mean "
                f"luminance {mean_lum:.4f}, trace calls {traces} = closest-hit launches {k1}")
            launches += k1
    return launches


def reset_counts():
    """Set every trace and kernel launch count to 0."""
    from hikari_tpu_torch.render import spatial
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.trace import scatter as sc
    from hikari_tpu_torch.trace import tile_walk as tw
    from hikari_tpu_torch.trace import tiled as ttiled

    ch.launches = ch.streamed_launches = tw.launches = sc.launches = api.trace_calls = 0
    ttiled.launches = sc.plan_launches = spatial.launches = spatial.passes = 0


def read_counts():
    """The launch counts of the three trace kernels and the trace calls;
    the spatial tap kernel's launches and the spatial passes on the card."""
    from hikari_tpu_torch.render import spatial
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.trace import scatter as sc
    from hikari_tpu_torch.trace import tile_walk as tw

    return {"closest_hit": ch.launches, "tile_walk": tw.launches, "scatter_items": sc.launches,
            "trace_calls": api.trace_calls, "spatial_reuse": spatial.launches,
            "spatial_passes": spatial.passes}


def require_spatial_kernel(label, counts):
    """Every spatial reuse pass on the card launched the tap kernel once."""
    if counts["spatial_reuse"] != counts["spatial_passes"]:
        raise AssertionError(f"{label}: {counts['spatial_reuse']} spatial tap kernel launches for "
                             f"{counts['spatial_passes']} spatial reuse passes")


def grad_advance(scene, cam, settings, device):
    """One fwd+grad frame through ``make_train_step`` against a zero
    target, for ``profile_frames``."""
    import torch

    from hikari_tpu_torch.parallel import make_train_step

    step = make_train_step(settings)
    target = torch.zeros(settings.output_size + (3,), device=device)

    def advance(state):
        return step(scene, cam, state, target)[3]

    return advance


def run_grad_path(name, scene, cam, settings, device):
    """[grad]: ``FRAMES`` fwd+grad frames through ``parallel.make_train_step``
    against a zero target, every count set to 0 just before and read just
    after. The step's forward is ``sharding.render_loss``, looked up when
    the step runs: wrapped here, it marks where each frame's forward ends,
    so the closest-hit launches split into the forward's and the
    backward's (which must be 0: the searches are detached). Checks that
    every trace went through the kernel, that each leaf's gradient is
    finite in every frame and nonzero (``sun_color`` may be 0: cornell's
    sun is black) and that the image is finite. Returns (final state,
    forward closest-hit launches)."""
    import numpy as np
    import torch

    from hikari_tpu_torch.parallel import DIFF_LEAVES, make_train_step, sharding
    from hikari_tpu_torch.render.pipeline import initial_state
    from hikari_tpu_torch.trace import closest_hit as ch

    step = make_train_step(settings)
    state = initial_state(settings, device)
    target = torch.zeros(settings.output_size + (3,), device=device)
    real_loss = sharding.render_loss
    fwd_end = []

    def marked_loss(*args):
        res = real_loss(*args)
        fwd_end.append(ch.launches)
        return res

    frame_ms, norms, finite, k1_fwd, k1_bwd = [], [], [], 0, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    sharding.render_loss = marked_loss
    try:
        for _ in range(FRAMES):
            k1_start = ch.launches
            t0 = time.perf_counter()
            loss, grads, out, state = step(scene, cam, state, target)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            k1_fwd += fwd_end[-1] - k1_start
            k1_bwd += ch.launches - fwd_end[-1]
            norms.append(torch.stack([grads[k].double().norm() for k in DIFF_LEAVES]))
            finite.append(torch.stack([torch.isfinite(grads[k]).all() for k in DIFF_LEAVES]))
    finally:
        sharding.render_loss = real_loss
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    traces = counts["trace_calls"]
    if not (traces > 0 and counts["closest_hit"] == traces == k1_fwd and k1_bwd == 0
            and counts["tile_walk"] == counts["scatter_items"] == 0):
        raise AssertionError(f"{name}: {counts}, closest-hit launches in the forward {k1_fwd}, "
                             f"in the backward {k1_bwd}")
    require_spatial_kernel(f"[grad] {name}", counts)
    norms = torch.stack(norms).cpu().numpy()  # (frames, leaves)
    finite = torch.stack(finite).cpu().numpy()
    median_ms = float(np.median(frame_ms[1:]))
    log(f"[grad] {name} {settings.width}x{settings.height} from {settings.render_size[1]}x"
        f"{settings.render_size[0]}, {FRAMES} fwd+grad frames: ms/frame median(frames 2-{FRAMES}) "
        f"{median_ms:.2f} (all: {', '.join(f'{m:.1f}' for m in frame_ms)}); peak memory "
        f"{peak / 2**30:.3f} GiB; last loss {float(loss):.6g}")
    log(f"[grad] {name}: {traces} trace calls = closest-hit launches in the forward {k1_fwd}; "
        f"closest-hit launches in the backward {k1_bwd}")
    bad = []
    for j, k in enumerate(DIFF_LEAVES):
        all_finite, nonzero = bool(finite[:, j].all()), bool((norms[:, j] > 0).all())
        log(f"[grad]   {k}: finite in every frame {all_finite}, L2 norm (last frame) "
            f"{norms[-1, j]:.6g}, nonzero in every frame {nonzero}")
        if not all_finite or not (nonzero or k == "sun_color"):
            bad.append(k)
    if bad:
        raise AssertionError(f"{name}: non-finite or zero gradients in {bad}")
    if not bool(torch.isfinite(out.image).all()):
        raise AssertionError(f"{name}: non-finite image")
    return state, k1_fwd


def check_grad_small(name, scene_gpu, scene_cpu, cam_cpu, settings, device, loss_rtol, leaf_rel):
    """[grad check]: the train step on the card (kernels, CUDA ATen)
    against the CPU (twins) at frames 2 and 3 from one state: the loss
    within ``loss_rtol`` and each leaf within a relative L2 error of
    ``leaf_rel`` (``sun_color``, ~1e-6 in norm on cornell, within 1e-8
    absolute)."""
    import torch

    from hikari_tpu_torch.parallel import DIFF_LEAVES, make_train_step
    from hikari_tpu_torch.render.pipeline import initial_state, render_frame
    from hikari_tpu_torch.utils import map_tensors

    step = make_train_step(settings)
    state = initial_state(settings, "cpu")
    with torch.no_grad():
        for _ in range(2):
            _, state = render_frame(scene_cpu, cam_cpu, state, settings)
    target = torch.zeros(settings.output_size + (3,))
    cam_gpu = cam_cpu.to(device)
    for frame in (2, 3):
        loss_g, grads_g, _, _ = step(scene_gpu, cam_gpu, map_tensors(lambda x: x.to(device), state),
                                     target.to(device))
        loss_c, grads_c, _, state = step(scene_cpu, cam_cpu, state, target)
        loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
        errs = {}
        for k in DIFF_LEAVES:
            g, gc = grads_g[k].cpu().double(), grads_c[k].double()
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"[grad check] {name} frame {frame}: non-finite {k}")
            d, n = float((g - gc).norm()), float(gc.norm())
            errs[k] = d if k == "sun_color" else d / n
        bad = {k: e for k, e in errs.items() if not e <= (1e-8 if k == "sun_color" else leaf_rel)}
        if not loss_err <= loss_rtol or bad:
            raise AssertionError(f"[grad check] {name} frame {frame}: loss rel err {loss_err}, "
                                 f"leaves past the bound {bad}")
        log(f"[grad check] {name} {settings.width}x{settings.height} frame {frame}: card vs CPU "
            f"twin, loss rel err {loss_err:.3g} (<= {loss_rtol}), relative L2 per leaf (<= "
            f"{leaf_rel}; sun_color absolute) " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))


def run_bench_phase(device):
    """[bench]: ``hikari_tpu_torch.bench``'s main for cornell with its
    extras (scene and city at 512p), counts set to 0 just before; its JSON
    line and its standard-error lines are echoed, prefixed. Every extra must
    have run, the city through the tile walk. Returns the launch counts."""
    import contextlib
    import io
    import json as _json

    from hikari_tpu_torch import bench

    out, err = io.StringIO(), io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        bench.main([])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    for line in err.getvalue().splitlines():
        log(f"[bench] {line}")
    line = out.getvalue().strip()
    record = _json.loads(line)  # the bench prints exactly one JSON line
    log(f"[bench] {line}")
    extra = record.get("extra", [])
    failed = [x for x in extra if "value" not in x]
    if failed or not record["value"] > 0 or record["finite"] is not True:
        raise AssertionError(f"[bench] failed: {record}")
    for x in extra:
        if x["finite"] is not True:
            log(f"[bench] extra {x['config']}: the accumulator is NOT finite (non-finite "
                f"gradients); its {x['ms_per_frame']:.2f} ms/frame is that of a non-finite run")
    if not (counts["closest_hit"] > 0 and counts["tile_walk"] > 0 and counts["scatter_items"] == 0
            and counts["closest_hit"] + counts["tile_walk"] == counts["trace_calls"]):
        raise AssertionError(f"[bench] launches {counts}")
    require_spatial_kernel("[bench]", counts)
    log(f"[bench] {seconds:.1f} s; launches {counts} (tile walk: the city extra)")
    return counts


def run_train_phase(device):
    """[train]: the port's examples/train on the card, 10 steps at 48 px;
    the loss must fall and every trace go through the closest-hit kernel."""
    from hikari_tpu_torch.examples.train import train

    reset_counts()
    t0 = time.perf_counter()
    losses, est, true = train(10, 48, 0.5, device, log=lambda m: log(f"[train] {m}"))
    seconds = time.perf_counter() - t0
    counts = read_counts()
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[train] the loss did not fall: {losses}")
    if not (counts["trace_calls"] > 0 and counts["closest_hit"] == counts["trace_calls"]):
        raise AssertionError(f"[train] launches {counts}")
    log(f"[train] 10 steps at 48 px in {seconds:.1f} s: loss {losses[0]:.9g} -> {losses[-1]:.9g}; "
        f"estimate {est.round(4)}, true {true.round(4)}; launches {counts}")
    return counts


def output_settings(settings, width, height):
    """[output]'s settings: the bench frame's lighting (denoise, one
    bounce, indirect spatial reuse, f16 reservoirs, ``reproject="shift"``)
    with FSR1 at 1.5 instead of SMAA TU4x, TAA off (the JAX package's FSR1
    path fails under TAA Jasmine, hikari_tpu/render/taa.py:402) and HDR,
    bloom and FXAA on."""
    from hikari_tpu_torch.config import Taa, Upscale

    return settings.replace(
        width=width, height=height, upscale=Upscale.fsr1(1.5), taa=Taa.NONE, denoise=True,
        indirect_bounces=1, indirect_spatial_reuse=True, emissive_spatial_reuse=False,
        emissive_lit=True, reservoir_f16=True, reproject="shift", remat=False, hdr=True,
        bloom=True, fxaa=True, collect_stats=True, tracer="auto",
    )


def require_k1_only(label, counts):
    """Every trace of a phase went through the closest-hit kernel, and every
    spatial reuse pass through the spatial tap kernel."""
    if not (counts["trace_calls"] > 0 and counts["closest_hit"] == counts["trace_calls"]
            and counts["tile_walk"] == counts["scatter_items"] == 0):
        raise AssertionError(f"{label}: launches {counts}")
    require_spatial_kernel(label, counts)


def run_output_phase(cornell, cornell_cpu, cam, small, device):
    """[output]: ``cornell_output`` (1280x720 from 853x480, FSR1 at 1.5,
    HDR, bloom, FXAA) for ``FRAMES`` frames through ``render_frame``; the
    card against the CPU twins at 48x64 output at frames 2-3 (the camera
    moved by ``OUTPUT_SMALL_EYE_X``); one
    ``make_train_step`` frame at 48x64 on the card, every leaf finite and
    the ``gb_gather`` gradient firewall (the fractional-ratio G-buffer
    gather) among the counted clip sites. Returns the closest-hit
    launches of the 8 frames."""
    import os

    import torch

    from hikari_tpu_torch.diff import clip_engagement_report, reset_clip_engagement
    from hikari_tpu_torch.parallel import DIFF_LEAVES, make_train_step
    from hikari_tpu_torch.render.camera import Camera
    from hikari_tpu_torch.render.pipeline import initial_state, render_frame

    t0 = time.perf_counter()
    settings = output_settings(small, OUTPUT_HW[1], OUTPUT_HW[0])
    state, launches = run_main_path("cornell_output", cornell, cam, settings, device, tag="[output]")
    del state
    require_k1_only("[output] cornell_output", dict(launches, trace_calls=launches["closest_hit"]))
    small_out = output_settings(small, OUTPUT_SMALL_HW[1], OUTPUT_SMALL_HW[0])
    x = OUTPUT_SMALL_EYE_X
    cam_off = Camera.from_lookat(eye=(x, 1.0, 4.0), target=(x, 1.0, 0.0), device="cpu")
    check_small("cornell_output", cornell, cornell_cpu, cam_off, small_out, device, frames=(2, 3))

    st = initial_state(small_out, device)
    cam_gpu = cam_off.to(device)
    with torch.no_grad():
        for _ in range(2):
            _, st = render_frame(cornell, cam_gpu, st, small_out)
    reset_clip_engagement()
    os.environ["HIKARI_COUNT_CLIP"] = "1"
    reset_counts()
    try:
        target = torch.zeros(small_out.output_size + (3,), device=device)
        loss, grads, out, _ = make_train_step(small_out)(cornell, cam_gpu, st, target)
    finally:
        del os.environ["HIKARI_COUNT_CLIP"]
    counts = read_counts()
    require_k1_only("[output] train step", counts)
    report = clip_engagement_report()
    bad = [k for k in DIFF_LEAVES if not bool(torch.isfinite(grads[k]).all())]
    if bad or "gb_gather" not in report or not bool(torch.isfinite(out.image).all()):
        raise AssertionError(f"[output] train step: non-finite leaves {bad}, clip sites {report}")
    log(f"[output] train step {small_out.width}x{small_out.height} from "
        f"{small_out.render_size[1]}x{small_out.render_size[0]}, frame 2: loss {float(loss):.6g}, "
        f"every leaf finite; clip sites (engaged, seen, rate): "
        + ", ".join(f"{k} {v}" for k, v in report.items()) + f"; launches {counts}")
    log(f"[output] {time.perf_counter() - t0:.1f} s")
    return launches["closest_hit"]


def run_passes_phase(device):
    """[passes]: the port's ``tools/profile_prefix`` on the bench frame
    (cornell 1920x1080 from 960x540), forward, then fwd+grad: per stage
    the prefix's ms/frame and device ms/frame and their deltas. The deltas
    telescope to the untruncated prefix, whose device reading of each
    traced frame is held against the untruncated frame profiled again at
    the same frame, within 3% (the same work: a trace that lost device
    time fails here). The host sum is printed beside
    the frame timed again, with the larger of the two runs' ranges, and
    not checked: on a shared host two runs of the same frame have differed
    by more than either run's range. Every trace must go through the
    closest-hit kernel. Returns the closest-hit launches."""
    import contextlib
    import io

    import numpy as np

    from hikari_tpu_torch.tools import profile_prefix

    launches = 0
    for grad in (False, True):
        t0 = time.perf_counter()
        argv = ["--config", "cornell", "--frames", str(PASSES_FRAMES)] + (["--grad"] if grad else [])
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            res = profile_prefix.main(argv)
        counts = read_counts()
        require_k1_only(f"[passes] {'grad' if grad else 'fwd'}", counts)
        launches += counts["closest_hit"]
        for line in out.getvalue().splitlines():
            log(f"[passes] {line}")
        rows, again, dev_again = res["rows"], res["full_again"], res["device_again"]
        mode = "fwd+grad" if grad else "fwd"
        deltas = sum(r["delta_ms"] for r in rows)
        spread = max(max(x) - min(x) for x in (rows[-1]["samples"], again))
        dev_deltas = sum(r["delta_device_ms"] for r in rows)
        pairs = list(zip(rows[-1]["device_readings"], res["device_again_readings"]))
        if not all(abs(a - b) <= 0.03 * b for (a, _), (b, _) in pairs):
            raise AssertionError(f"[passes] {mode}: frame by frame, the untruncated prefix's "
                                 f"device (ms, events) {[p[0] for p in pairs]} against the frame "
                                 f"profiled again {[p[1] for p in pairs]}")
        log(f"[passes] {mode}: host stage deltas {deltas:.2f} ms/frame, the untruncated frame "
            f"timed again {np.median(again):.2f} (the larger run range {spread:.2f} ms; printed, "
            f"not checked); device "
            f"stage deltas {dev_deltas:.3f} ms/frame, profiled again {dev_again:.3f} (3%: "
            f"{0.03 * dev_again:.3f}); {time.perf_counter() - t0:.1f} s; launches {counts}")
    return launches


def run_spatial_phase(device):
    """[spatial]: the spatial reuse's tap kernel (``csrc/spatial_reuse.cu``)
    on the main path: ``SPATIAL_FRAMES`` frames of the benchmark cell's
    settings (``bench_config("cornell")``: 1920x1080 from 960x540, 518,400
    pixels, the indirect spatial reuse's 16 taps), every count set to 0
    just before; then as many with the emissive spatial reuse on too (8
    taps). Each run must launch the kernel once a spatial pass. The last
    frame's calls of both channels, recorded (``spatial.recording``) and
    replayed: each bit for bit against its twin (every field and the
    winner); the kernel's CUDA-event ms (``spatial.prepare``'s launch made
    again) beside the bound (``spatial.bound_bytes`` at 3.35 TB/s; below
    it fails), the call's CUDA-event ms and the host ms of the spiral's
    table, and the twin's device time (torch.profiler); the taps taken.
    Returns the indirect call's (max_abs_err, ms, plain_ms, bound_ms,
    bound_by) and the main-path run's kernel launches."""
    import torch

    from hikari_tpu_torch.bench import bench_config
    from hikari_tpu_torch.render import initial_state, render_frame, spatial
    from hikari_tpu_torch.scene import build_scene_buffers
    from hikari_tpu_torch.utils import map_tensors, same_bits
    from hikari_tpu_torch.utils.nvcc import ptxas_summary

    t0 = time.perf_counter()
    scene, cam, cell = bench_config("cornell", device)
    buffers = build_scene_buffers(scene, device)
    runs, calls = {}, {}
    for label, settings in (("the cell", cell),
                            ("emissive reuse on", cell.replace(emissive_spatial_reuse=True))):
        state = initial_state(settings, device)
        torch.cuda.synchronize()
        reset_counts()
        with spatial.recording() as recorded, torch.no_grad():
            for _ in range(SPATIAL_FRAMES):
                first = len(recorded)
                _, state = render_frame(buffers, cam, state, settings)
        torch.cuda.synchronize()
        counts = read_counts()
        want = SPATIAL_FRAMES * (1 + settings.emissive_spatial_reuse)
        if not counts["spatial_reuse"] == counts["spatial_passes"] == want:
            raise AssertionError(f"[spatial] {label}: {counts['spatial_reuse']} kernel launches "
                                 f"for {counts['spatial_passes']} spatial passes ({want} expected)")
        runs[label] = counts["spatial_reuse"]
        calls.update((call["shade"] is None, call) for call in recorded[first:])
    log(f"[spatial] {SPATIAL_FRAMES} frames, counts set to 0 just before: kernel launches = "
        f"spatial passes: the cell {runs['the cell']}, emissive reuse on "
        f"{runs['emissive reuse on']}")

    result = None
    for emissive in (False, True):
        call = calls[emissive]
        label = "emissive, 8 taps" if emissive else "indirect, 16 taps"
        got, want = spatial.spatial_taps(**call), spatial.spatial_taps_reference(**call)
        flat = []
        map_tensors(flat.append, (got, want))
        half = len(flat) // 2
        bad = [i for i, (a, b) in enumerate(zip(flat[:half], flat[half:])) if not same_bits(a, b)]
        if bad:
            raise AssertionError(f"[spatial] {label}: leaves {bad} differ from the twin")
        lh, lw = call["depth"].shape
        rh, rw = call["grid_depth"].shape
        nbytes = spatial.bound_bytes(lh, lw, rh, rw, emissive)
        bound, by = bound_ms(0, nbytes)
        # The kernel alone: one call's launch made again, between CUDA
        # events. A call's CUDA events also time its host side (the
        # spiral's table, the checks, the BRDF factors' ATen launches),
        # which paces back-to-back calls.
        ms = cuda_time_ms(spatial.prepare(**call), 50)
        if ms < bound:
            raise AssertionError(f"[spatial] {label}: {ms} ms is below the kernel's bound")
        call_ms = cuda_time_ms(lambda c=call: spatial.spatial_taps(**c), 50)
        pack_s = time.perf_counter()
        for _ in range(20):
            spatial.pack_spiral(call["spiral"], emissive)
        pack_ms = (time.perf_counter() - pack_s) / 20 * 1e3
        plain_ms = device_ms(lambda c=call: spatial.spatial_taps_reference(**c), 3)
        taken = int((got[1] >= 0).sum())
        log(f"[spatial] {label}: {lh}x{lw} pixels, kernel {ms:.4f} ms (CUDA events, 50 launches), bound "
            f"{bound:.4f} ms ({by}, {nbytes} B), {bound / ms * 100:.1f}% of it; the call "
            f"{call_ms:.4f} ms (CUDA events; the spiral's table {pack_ms:.3f} ms of host); twin "
            f"{plain_ms:.3f} ms device; bitwise equal, {taken} pixels took a neighbour")
        if not emissive:
            result = (0.0, ms, plain_ms, bound, by)
    log(f"[spatial] ptxas: {ptxas_summary(spatial.build_log)}; {time.perf_counter() - t0:.1f} s")
    return result, runs["the cell"]


def spatial_entry(res, launches):
    """The kernel table's line of the spatial tap kernel: ``res`` and
    ``launches`` (the main-path run's) from ``run_spatial_phase``."""
    err, ms, plain, bound, by = res
    return {"name": "spatial_reuse (the spatial reuse's tap loop)", "route": "cuda",
            "source": "hikari_tpu_torch/csrc/spatial_reuse.cu",
            "replaces": "none: the JAX package's spatial reuse is jnp (hikari_tpu/render/spatial.py:87)",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def run_textured_phase(device):
    """[textured]: ``scene_textured``, the port's examples/render ``scene``
    on a small textured glTF written into a temporary
    ``<assets>/models/FlightHelmet/FlightHelmet.gltf``
    (``io.gltf.write_textured_demo``: a checker base-color floor, a box
    with metallic-roughness and occlusion textures, a quad with an
    emissive texture, 528 triangles), at 512x512 for ``FRAMES`` frames with
    ``scene_config``'s settings (SMAA TU4x at 2, TAA Jasmine, denoise, both
    spatial reuses); the image must be finite and lit, and its mean
    luminance differ from the untextured stand-in's (the same entry point
    without the asset); then the card against the CPU twins on that scene
    at 48x62, frames 2-3. Returns the closest-hit launches."""
    import os
    import tempfile

    import numpy as np
    import torch

    from hikari_tpu_torch.examples import render
    from hikari_tpu_torch.io.gltf import write_textured_demo
    from hikari_tpu_torch.io.scenes import FLIGHT_HELMET, scene_config
    from hikari_tpu_torch.scene import compile_scene, to_device
    from hikari_tpu_torch.utils import luminance

    t0 = time.perf_counter()
    launches = 0
    size = TEXTURED_SIZE
    with tempfile.TemporaryDirectory() as tmp:
        write_textured_demo(os.path.join(tmp, FLIGHT_HELMET))
        means = {}
        for label, extra in (("scene_textured", ["--assets", tmp]), ("scene untextured", [])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            reset_counts()
            res = render.main(["scene", "--frames", str(FRAMES), "--size", str(size), "--out",
                               f"{tmp}/{label.replace(' ', '_')}.png"] + extra)
            torch.cuda.synchronize()
            counts = read_counts()
            require_k1_only(f"[textured] {label}", counts)
            launches += counts["closest_hit"]
            peak = torch.cuda.max_memory_allocated(device)
            img = res["outputs"].image
            nonfinite = int((~torch.isfinite(img)).sum())
            means[label] = float(luminance(img[..., :3]).mean())
            if nonfinite or not means[label] > 0.0:
                raise AssertionError(f"[textured] {label}: {nonfinite} non-finite pixels, mean "
                                     f"luminance {means[label]}")
            ms = float(np.median(res["frame_seconds"][1:])) * 1e3
            log(f"[textured] {label} {size}x{size}, {FRAMES} frames: ms/frame median(frames "
                f"2-{FRAMES}) {ms:.2f}, peak memory {peak / 2**30:.3f} GiB, non-finite pixels "
                f"{nonfinite}, mean luminance {means[label]:.4f}; launches {counts}")
        if means["scene_textured"] == means["scene untextured"]:
            raise AssertionError(f"[textured] the textured scene renders as the stand-in: {means}")
        scene, cam, settings = scene_config(TEXTURED_SMALL_HW[1], TEXTURED_SMALL_HW[0],
                                            device="cpu", assets=tmp)
    if not scene.textures:
        raise AssertionError("[textured] the glTF's textures did not load")
    arrays = compile_scene(scene)
    check_small("scene_textured", to_device(arrays, device), to_device(arrays, "cpu"), cam,
                settings, device, frames=(2, 3))
    log(f"[textured] {len(scene.textures)} textures, {len(arrays.tri_world)} triangles; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def dynamic_settings(settings, width, height):
    """``cornell_dynamic``'s settings: ``bench_config("cornell")``'s (SMAA
    TU4x at 2, TAA Jasmine, denoise, one bounce, f16 reservoirs,
    ``emissive_lit``) at the given output size with both spatial reuses on
    and ``reproject="adaptive"`` (the JAX package's ``"shift"`` promises
    zero velocity; the port always gathers)."""
    return settings.replace(
        width=width, height=height, indirect_spatial_reuse=True, emissive_spatial_reuse=True,
        reservoir_f16=True, emissive_lit=True, reproject="adaptive", collect_stats=True,
        tracer="auto",
    )


def orbit_camera(frame, device, x0=0.0):
    """Frame ``frame``'s camera on the orbit about (x0, 1, 0), its previous
    eye the frame before's (frame 0's is its own)."""
    import math

    from hikari_tpu_torch.render.camera import Camera

    def eye(f):
        a = math.radians(DYN_ORBIT_DEG * f)
        return (x0 + 4.0 * math.sin(a), 1.0, 4.0 * math.cos(a))

    target = (x0, 1.0, 0.0)
    return Camera.from_lookat(eye=eye(frame), target=target, prev_eye=eye(max(frame - 1, 0)),
                              prev_target=target, device=device)


def dynamic_moves(frame, models):
    """The (I, 4, 4) transforms after frame ``frame``'s moves."""
    import math

    import numpy as np

    m = np.array(models, dtype=np.float32)
    a = math.radians(DYN_BOX_TURN_DEG)
    turn = np.eye(4, dtype=np.float32)
    turn[[0, 0, 2, 2], [0, 2, 0, 2]] = (math.cos(a), math.sin(a), -math.sin(a), math.cos(a))
    m[DYN_BOX] = m[DYN_BOX] @ turn
    m[DYN_BOX, 0, 3] += DYN_BOX_STEP
    if frame == DYN_LIGHT_MOVE_FRAME:
        m[DYN_LIGHT, 0, 3] += DYN_LIGHT_MOVE
    if frame == DYN_LIGHT_SCALE_FRAME:
        m[DYN_LIGHT, :3, :3] *= DYN_LIGHT_SCALE
    return m


def static_snap(scene, moved):
    """Fail unless every instance outside ``moved`` keeps
    ``prev_model @ inv(model)`` within ``STATIC_SNAP`` of I (so its object
    motion snaps to exactly 0). Returns the largest deviation."""
    import torch

    pfc = scene.inst_prev_model @ scene.inst_inv_model
    dev = (pfc - torch.eye(4, device=pfc.device)).abs().amax((1, 2))
    keep = torch.ones_like(dev, dtype=torch.bool)
    keep[list(moved)] = False
    worst = float(dev[keep].max())
    if not worst < STATIC_SNAP:
        raise AssertionError(f"[dynamic] an unmoved instance leaves the static snap: "
                             f"|prev @ inv(model) - I| = {worst}")
    return worst


def hits_agree(label, got, want, map_prim=None, early=None, tag="[dynamic]"):
    """``got`` against ``want`` (two searches of one scene): prims equal
    apart from ties (prims differ, both t within ``TIE_REL``) and, where
    ``early`` (the rays' early distances) is given, any-hit answers (both
    hit nearer than it: each search may stop at any such hit); any other
    difference fails. Returns (ties, any-hit answers, max |t| error where
    prims agree)."""
    import torch

    pw = want.prim if map_prim is None else map_prim(want.prim)
    differ = got.prim != pw
    scale = torch.clamp(torch.maximum(got.t.abs(), want.t.abs()), min=1.0)
    close = (got.t - want.t).abs() <= TIE_REL * scale
    both_hit = (got.prim >= 0) & (pw >= 0)
    tie = differ & both_hit & close
    anyhit = torch.zeros_like(differ)
    if early is not None:
        anyhit = differ & both_hit & ~close & (got.t < early) & (want.t < early)
    other = int((differ & ~tie & ~anyhit).sum())
    same = ~differ
    err = float((got.t - want.t)[same & (got.prim >= 0)].abs().max()) if bool(same.any()) else 0.0
    if other:
        raise AssertionError(f"{tag} {label}: {other} rays differ in their hit beyond ties "
                             f"({int(tie.sum())} ties, {int(anyhit.sum())} any-hit answers)")
    return int(tie.sum()), int(anyhit.sum()), err


def run_cornell_dynamic(arrays, settings, device, profile=False):
    """[dynamic] (a): ``cornell_dynamic``, ``FRAMES`` frames through
    ``SceneUpdater`` and ``render_frame`` with the counts set to 0 just
    before (``profile``: two more frames, moves included, under
    ``profile_frames``). Returns (final buffers, closest-hit launches)."""
    import numpy as np
    import torch

    from hikari_tpu_torch.io.scenes import cornell_box_scene
    from hikari_tpu_torch.render.pipeline import image_size, initial_state, render_frame
    from hikari_tpu_torch.scene import SceneUpdater, to_device, update_transforms
    from hikari_tpu_torch.utils import luminance

    up = SceneUpdater(cornell_box_scene(), to_device(arrays, device))
    alias0 = (up.buffers.alias_prob.clone(), up.buffers.alias_index.clone())
    state = initial_state(settings, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    frame_ms, update_ms, survive, snap = [], [], [], 0.0
    with torch.no_grad():
        for f in range(FRAMES):
            cam = orbit_camera(f, device)
            t0 = time.perf_counter()
            if f:
                up.set_transforms(dynamic_moves(f, up.buffers.inst_model.cpu().numpy()))
                torch.cuda.synchronize()
                update_ms.append((time.perf_counter() - t0) * 1e3)
                moved = {DYN_BOX} | ({DYN_LIGHT} if f in (DYN_LIGHT_MOVE_FRAME,
                                                       DYN_LIGHT_SCALE_FRAME) else set())
            out, nxt = render_frame(up.buffers, cam, state, settings)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if f:
                survive.append(float((nxt.direct_temporal.count.float()
                                      >= state.direct_temporal.count.float()).float().mean()))
            state = nxt
            if f:
                snap = max(snap, static_snap(up.buffers, moved))
            kept = (torch.equal(up.buffers.alias_prob, alias0[0])
                    and torch.equal(up.buffers.alias_index, alias0[1]))
            if f == DYN_LIGHT_MOVE_FRAME and not kept:
                raise AssertionError("[dynamic] a translation of the light changed its alias rows")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    require_k1_only("[dynamic] cornell_dynamic", counts)
    lin = up._linear_cache[DYN_LIGHT]
    scaled = up.buffers.inst_model[DYN_LIGHT, :3, :3].cpu().numpy()
    if not np.array_equal(lin, scaled):
        raise AssertionError("[dynamic] the light's scale did not rebuild its alias rows")
    img = out.image
    if tuple(img.shape) != (*image_size(settings), 4):
        raise AssertionError(f"[dynamic] image shape {tuple(img.shape)}")
    nonfinite = int((~torch.isfinite(img)).sum())
    mean_lum = float(luminance(img[..., :3]).mean())
    gb = state.prev_gbuffer
    box = gb.instance == DYN_BOX
    vmax = float(gb.velocity_uv[..., :2][box].abs().max()) if bool(box.any()) else 0.0
    if nonfinite or not mean_lum > 0.0 or not vmax > 0.0 or not min(survive) > 0.5:
        raise AssertionError(f"[dynamic] cornell_dynamic: {nonfinite} non-finite pixels, mean "
                             f"luminance {mean_lum}, max |velocity| on the box {vmax}, temporal "
                             f"counts kept per frame {survive}")
    models = up.buffers.inst_model
    upd_dev_ms = cuda_time_ms(lambda: update_transforms(up.buffers, models), 20)
    log(f"[dynamic] cornell_dynamic {settings.width}x{settings.height} from "
        f"{settings.render_size[1]}x{settings.render_size[0]}, {FRAMES} frames (update + render): "
        f"ms/frame median(frames 2-{FRAMES}) {np.median(frame_ms[1:]):.2f} (all: "
        f"{', '.join(f'{m:.1f}' for m in frame_ms)}); set_transforms host ms per frame "
        f"{', '.join(f'{m:.2f}' for m in update_ms)}; update_transforms device "
        f"{upd_dev_ms:.4f} ms (CUDA events, 20 calls); peak memory {peak / 2**30:.3f} GiB")
    log(f"[dynamic] cornell_dynamic: non-finite pixels {nonfinite}, mean luminance "
        f"{mean_lum:.4f}; trace calls {counts['trace_calls']} = closest-hit launches "
        f"{counts['closest_hit']}; max |velocity| on the box's {int(box.sum())} pixels {vmax:.6g}; "
        f"share of pixels whose direct temporal count did not fall, frames 2-{FRAMES}: "
        f"{', '.join(f'{s:.4f}' for s in survive)}; unmoved instances' largest "
        f"|prev @ inv(model) - I| {snap:.3g} (< {STATIC_SNAP}); light alias rows kept on the "
        f"move (frame {DYN_LIGHT_MOVE_FRAME}, 0-based), rebuilt on the scale (frame "
        f"{DYN_LIGHT_SCALE_FRAME})")
    if profile:
        frame = [FRAMES]

        def advance(st):
            f = frame[0]
            frame[0] += 1
            with torch.no_grad():
                up.set_transforms(dynamic_moves(f, up.buffers.inst_model.cpu().numpy()))
                return render_frame(up.buffers, orbit_camera(f, device), st, settings)[1]

        profile_frames("cornell_dynamic", advance, state)
    return up.buffers, counts["closest_hit"]


def check_dynamic_small(arrays, bench, device):
    """[dynamic] (a): the card against the CPU twins on ``cornell_dynamic``'s
    scene, camera path and moves at 48x64 (camera ``OUTPUT_SMALL_EYE_X`` to
    the side), each side updating its own buffers, frames 0-3 each from
    the CPU's state."""
    import torch

    from hikari_tpu_torch.render.pipeline import initial_state, render_frame
    from hikari_tpu_torch.scene import to_device, update_transforms
    from hikari_tpu_torch.utils import map_tensors

    settings = dynamic_settings(bench, DYN_SMALL_HW[1], DYN_SMALL_HW[0])
    gpu, cpu = to_device(arrays, device), to_device(arrays, "cpu")
    st_cpu = initial_state(settings, "cpu")
    with torch.no_grad():
        for f in DYN_CHECK_FRAMES:
            if f:
                models = dynamic_moves(f, cpu.inst_model.numpy())
                gpu, cpu = update_transforms(gpu, models), update_transforms(cpu, models)
            cam = orbit_camera(f, "cpu", OUTPUT_SMALL_EYE_X)
            st_gpu = map_tensors(lambda x: x.to(device), st_cpu)
            o_gpu, _ = render_frame(gpu, cam.to(device), st_gpu, settings)
            o_cpu, st_cpu = render_frame(cpu, cam, st_cpu, settings)
            check_frame("cornell_dynamic", settings, f, o_gpu.image, o_cpu.image)


def run_city_stream(city, small_arrays, small_scene, city_cam, device):
    """[dynamic] (b): ``examples/render city --stream`` on the card with the
    counts set to 0 just before (every trace through the tile walk); the
    device time of ``update_activity`` on the full city; the half-inactive
    small city through the tile walk against its twin and against a scene
    compiled without those instances. Returns the tile-walk launches."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from hikari_tpu_torch.config import DISTANCE_MAX
    from hikari_tpu_torch.examples import render
    from hikari_tpu_torch.scene import compile_scene, to_device, update_activity
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import tile_walk as tw
    from hikari_tpu_torch.utils import luminance

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        res = render.main(["city", "--stream", "--frames", str(STREAM_FRAMES), "--size",
                           str(STREAM_SIZE), "--out", f"{tmp}/city_stream.png"])
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(device)
    if not (counts["trace_calls"] > 0 and counts["tile_walk"] == counts["trace_calls"]
            and counts["closest_hit"] == counts["scatter_items"] == 0):
        raise AssertionError(f"[dynamic] city_stream: launches {counts}")
    require_spatial_kernel("[dynamic] city_stream", counts)
    img = res["outputs"].image
    nonfinite = int((~torch.isfinite(img)).sum())
    mean_lum = float(luminance(img[..., :3]).mean())
    if nonfinite or not mean_lum > 0.0:
        raise AssertionError(f"[dynamic] city_stream: {nonfinite} non-finite pixels, mean "
                             f"luminance {mean_lum}")
    active = [int(m.sum()) for m in res["masks"]]
    half = np.ones(city.num_instances, dtype=bool)
    half[1::2] = False
    act_ms = cuda_time_ms(lambda: update_activity(city, half), 5)
    log(f"[dynamic] city_stream {STREAM_SIZE}x{STREAM_SIZE}, {STREAM_FRAMES} frames (update + "
        f"render): ms/frame median(frames 2-{STREAM_FRAMES}) "
        f"{np.median(res['frame_seconds'][1:]) * 1e3:.2f}; active instances per frame {active}; "
        f"peak memory {peak / 2**30:.3f} GiB; non-finite pixels {nonfinite}, mean luminance "
        f"{mean_lum:.4f}; trace calls {counts['trace_calls']} = tile-walk launches "
        f"{counts['tile_walk']}; update_activity on the {city.num_tris}-triangle, "
        f"{city.num_instances}-instance city {act_ms:.4f} ms (CUDA events, 5 calls)")

    # The small city with every other instance (the ground kept) inactive.
    small = to_device(small_arrays, device)
    keep = np.ones(small.num_instances, dtype=bool)
    keep[1::2] = False
    off = update_activity(small, keep)
    origin, direction = city_cam.pixel_rays(CITY_HW)
    o, d = origin.reshape(-1, 3).contiguous(), direction.reshape(-1, 3).contiguous()
    R = o.shape[0]
    walk, _ = walk_case(off, o, d, torch.full((R,), DISTANCE_MAX, device=device),
                        torch.zeros((R,), device=device),
                        torch.full((R,), -1, dtype=torch.int32, device=device),
                        torch.zeros((R,), dtype=torch.int32, device=device),
                        torch.full((R,), off.num_tris, dtype=torch.int32, device=device))
    compare("[dynamic] small city, every other instance inactive, K2",
            tw.tile_walk(*walk), tw.tile_walk_reference(*walk))
    kept = np.nonzero(keep)[0]
    sub_scene = copy.copy(small_scene)
    sub_scene.instances = [small_scene.instances[i] for i in kept]
    sub = to_device(compile_scene(sub_scene), device)
    # A prim of the compile without those instances, as a prim of the
    # full compile: same instance-local order, the full compile's offset.
    kept_t = torch.from_numpy(kept).to(device)

    def to_full(prim):
        p = prim.clamp(min=0).long()
        inst = sub.tri_inst[p].long()
        full = off.inst_prim_offset[kept_t[inst]] + (p - sub.inst_prim_offset[inst])
        return torch.where(prim >= 0, full.to(torch.int32), -1)

    kw = dict(max_distance=DISTANCE_MAX, method="pallas_tiled")
    h_off = api.trace_rays(off, o, d, **kw)
    h_sub = api.trace_rays(sub, o, d, **kw)
    ties, _, err = hits_agree("small city: inactive against compiled without", h_off, h_sub,
                              to_full)
    log(f"[dynamic] small city ({small.num_instances} instances, {len(kept)} active): K2 on the "
        f"half-inactive scene against K2 on a compile without those instances "
        f"({sub.num_tris} triangles): prims equal on {R - ties} of {R} rays, {ties} ties, max "
        f"|t| err {err:.3g}")
    return counts["tile_walk"]


def check_city_update(city, city_arrays, device):
    """[dynamic] (c): ``update_transforms`` on the card against the CPU on
    the city with 10% of its instances moved (seeded): every written field
    within ``DYN_UPDATE_REL`` of its largest magnitude, ``tri_valid``
    equal; the card's device time."""
    import math

    import numpy as np
    import torch

    from hikari_tpu_torch.scene import to_device, update_transforms

    rng = np.random.default_rng(23)
    I = city.num_instances
    models = np.array(city_arrays.inst_model, dtype=np.float32)
    for i in rng.choice(I, int(I * DYN_CITY_MOVED), replace=False):
        a = rng.uniform(-math.pi, math.pi)
        turn = np.eye(4, dtype=np.float32)
        turn[[0, 0, 2, 2], [0, 2, 0, 2]] = (math.cos(a), math.sin(a), -math.sin(a), math.cos(a))
        models[i] = models[i] @ turn
        models[i, :3, 3] += rng.uniform(-2.0, 2.0, 3).astype(np.float32)
    cpu = to_device(city_arrays, "cpu")
    t0 = time.perf_counter()
    want = update_transforms(cpu, models)
    cpu_s = time.perf_counter() - t0
    got = update_transforms(city, models)
    worst = 0.0
    for f in UPDATE_FIELDS:
        a, b = getattr(got, f).cpu(), getattr(want, f)
        if a.dtype == torch.bool:
            if not torch.equal(a, b):
                raise AssertionError(f"[dynamic] city update: {f} differs from the CPU's")
            continue
        scale = float(b.abs().max())
        rel = float((a - b).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        if not rel <= DYN_UPDATE_REL:
            raise AssertionError(f"[dynamic] city update: {f} differs from the CPU's by {rel:.3g} "
                                 f"of its largest magnitude {scale:.6g}")
    dev_ms = cuda_time_ms(lambda: update_transforms(city, models), 5)
    log(f"[dynamic] city update_transforms, {int(I * DYN_CITY_MOVED)} of {I} instances moved: "
        f"every written field within {worst:.3g} of its largest magnitude (<= {DYN_UPDATE_REL}), "
        f"tri_valid equal; card {dev_ms:.4f} ms (CUDA events, 5 calls), CPU {cpu_s:.2f} s (one "
        f"call, host clock)")
    return got


def check_bvh_walk(label, scene, o, d, method, device):
    """[dynamic] (d): ``trace_rays(method="bvh")`` against the kernel-backed
    ``method`` on the same rays: prims equal apart from counted ties;
    the bvh walk's time next to the kernel's."""
    import torch

    from hikari_tpu_torch.config import DISTANCE_MAX
    from hikari_tpu_torch.trace import api

    kw = dict(max_distance=DISTANCE_MAX)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walk = api.trace_rays(scene, o, d, method="bvh", **kw)
    torch.cuda.synchronize()
    walk_ms = (time.perf_counter() - t0) * 1e3
    kern = api.trace_rays(scene, o, d, method=method, **kw)
    kern_ms = cuda_time_ms(lambda: api.trace_rays(scene, o, d, method=method, **kw), 5)
    ties, _, err = hits_agree(label, walk, kern)
    R = o.shape[0]
    log(f"[dynamic] bvh walk on {label}, {R} rays: prims equal to {method} on {R - ties}, "
        f"{ties} ties, max |t| err {err:.3g}; bvh {walk_ms:.2f} ms (host clock, one call, a host "
        f"sync a step), {method} trace_rays {kern_ms:.4f} ms (CUDA events, 5 calls)")


def run_dynamic_phase(arrays, city, city_arrays, small_arrays, city_cam, device, profile=False):
    """[dynamic]: (a) ``cornell_dynamic`` and its check against the CPU,
    (b) ``city_stream`` and the small city's activity, (c) the city update
    against the CPU, (d) the bvh walk against K1 and K2. Returns the
    closest-hit launches of (a) and the tile-walk launches of (b)."""
    import numpy as np

    from hikari_tpu_torch.bench import bench_config
    from hikari_tpu_torch.io.scenes import city_scene
    from hikari_tpu_torch.scene import to_device, update_transforms

    t0 = time.perf_counter()
    _, _, bench = bench_config("cornell", device)
    settings = dynamic_settings(bench, CORNELL_HW[1], CORNELL_HW[0])
    moved_cornell, k1 = run_cornell_dynamic(arrays, settings, device, profile)
    check_dynamic_small(arrays, bench, device)
    k2 = run_city_stream(city, small_arrays, city_scene(blocks=3, detail=True), city_cam, device)
    check_city_update(city, city_arrays, device)
    origin, direction = orbit_camera(FRAMES - 1, device).pixel_rays(CORNELL_HW)
    check_bvh_walk(f"the moved cornell ({CORNELL_HW[1]}x{CORNELL_HW[0]} primary rays)",
                   moved_cornell, origin.reshape(-1, 3), direction.reshape(-1, 3), "pallas",
                   device)
    small = to_device(small_arrays, device)
    rng = np.random.default_rng(29)
    models = np.array(small_arrays.inst_model, dtype=np.float32)
    pick = rng.choice(small.num_instances - 1, small.num_instances // 10, replace=False) + 1
    models[pick, :3, 3] += rng.uniform(-1.5, 1.5, (len(pick), 3)).astype(np.float32)
    moved_small = update_transforms(small, models)
    origin, direction = city_cam.pixel_rays((256, 256))
    check_bvh_walk("the moved small city (256x256 primary rays)", moved_small,
                   origin.reshape(-1, 3), direction.reshape(-1, 3), "pallas_tiled", device)
    log(f"[dynamic] {time.perf_counter() - t0:.1f} s")
    return k1, k2



# ---------------------------------------------------------------------------
# [tiled], [bench_trace], [remat], [tools]
# ---------------------------------------------------------------------------


def check_tiled_call(label, scene, scene_cpu, rays, stride):
    """[tiled]: ``trace_rays(method="tiled")`` on the card over all ``rays``
    (o, d, maxd, early, excl, lo, hi) and host ms of the call; then the same
    walk as its two steps, ``tiled_inputs`` and ``trace_tiled``, on the card
    for the steps and clusters tested per tile (its hits must be the
    call's, bit for bit); the CPU's ``trace_tiled`` on every ``stride``-th
    tile of the same sorted, padded rays (tiles are independent) must give
    those tiles' rays the card's t, prim, u, v bit for bit. Returns the
    card's hit and the per-ray arguments."""
    import torch

    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import tiled as tt
    from hikari_tpu_torch.tools import ab_trace_kernels as ab
    from hikari_tpu_torch.utils import same_bits

    o, d, maxd, early, excl, lo, hi = rays
    kw = dict(max_distance=maxd, early_distance=early, exclude_instance=excl, range_lo=lo,
              range_hi=hi)
    before = read_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hit = api.trace_rays(scene, o, d, method="tiled", **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if read_counts() != before:
        raise AssertionError(f"[tiled] {label}: the tiled tracer launched a kernel or counted a "
                             f"trace call")
    R = o.shape[0]
    order, tiles = api.tiled_inputs(*rays)
    walk = tt.trace_tiled(scene, *tiles)
    steps, tested = walk[4], walk[5]
    for name, x in zip(("t", "prim", "u", "v"), walk[:4]):
        if not same_bits(getattr(hit, name)[order], x[:R]):
            raise AssertionError(f"[tiled] {label}: trace_tiled's {name} differs from the call's")
    t_max, t_p50, t_p90, _ = ab.tested_stats(tested)
    T = tiles[0].shape[0] // tt.TILE_R
    sel = (torch.arange(0, T, stride, device=o.device)[:, None] * tt.TILE_R
           + torch.arange(tt.TILE_R, device=o.device)).reshape(-1)
    t0 = time.perf_counter()
    cpu = tt.trace_tiled(scene_cpu, *(x[sel].cpu() for x in tiles))
    cpu_s = time.perf_counter() - t0
    real = sel < R
    idx = order[sel[real]]
    real = real.cpu()
    for name, want in zip(("t", "prim", "u", "v"), cpu[:4]):
        if not same_bits(getattr(hit, name)[idx].cpu(), want[real]):
            raise AssertionError(f"[tiled] {label}: the card's {name} differs from the CPU's")
    n_sel = -(-T // stride)
    log(f"[tiled] {label}: {R} rays, {T} tiles, {int((hit.prim >= 0).sum())} hits; "
        f"trace_rays(method='tiled') {ms:.2f} ms (host clock, one call), {steps} steps, clusters "
        f"of {tt.CLUSTER} tested per tile max {t_max}, p50 {t_p50:g}, p90 {t_p90:g} ({int(tested.sum())} "
        f"in all); card equals the CPU bit for bit (t, prim, u, v) on every {stride}th tile "
        f"({n_sel} of {T} tiles, {int(real.sum())} rays; CPU {cpu_s:.1f} s)")
    return hit, kw


def run_city_tiled(city, cam, settings, device):
    """[tiled] ``city_tiled``: ``TILED_FRAMES`` frames of ``city_path``'s
    settings with ``tracer="tiled"``, counts set to 0 just before: finite
    and lit, no trace kernel launch, every trace through the tiled tracer,
    whose phase 1 launches K2·p1's two kernels (table, tests) a call."""
    import numpy as np
    import torch

    from hikari_tpu_torch.render.pipeline import initial_state, render_frame
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import tiled as ttiled
    from hikari_tpu_torch.utils import luminance

    s = settings.replace(tracer="tiled")
    real, calls = api._trace_tiled, [0]

    def counted(*args):
        calls[0] += 1
        return real(*args)

    state = initial_state(s, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    frame_ms = []
    api._trace_tiled = counted
    try:
        with torch.no_grad():
            for _ in range(TILED_FRAMES):
                t0 = time.perf_counter()
                out, state = render_frame(city, cam, state, s)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        api._trace_tiled = real
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    img = out.image
    mean_lum = float(luminance(img[..., :3]).mean())
    nonfinite = int((~torch.isfinite(img)).sum())
    p1 = ttiled.launches
    if (any(counts.values()) or not calls[0] or p1 != 2 * calls[0] or nonfinite
            or not mean_lum > 0.0):
        raise AssertionError(f"[tiled] city_tiled: counts {counts}, tiled calls {calls[0]}, "
                             f"phase-1 launches {p1}, {nonfinite} non-finite pixels, mean "
                             f"luminance {mean_lum}")
    log(f"[tiled] city_tiled {s.width}x{s.height}, {TILED_FRAMES} frames: {calls[0]} tiled "
        f"calls, phase-1 kernel launches {p1} (two a call), trace kernel launches and trace_calls {counts}; "
        f"ms/frame "
        f"{', '.join(f'{m:.1f}' for m in frame_ms)} (median {np.median(frame_ms):.1f}); peak "
        f"memory {peak / 2**30:.3f} GiB; mean luminance {mean_lum:.4f}; non-finite pixels 0")


def run_tiled_phase(cornell, cornell_rays, city, city_arrays, city_cam, city_settings, small_gpu,
                    small_cpu, device):
    """[tiled]: the XLA tile-binned tracer (plain torch) on the card: against
    the CPU at (c) and (d), against K2 there and against K1 on the cornell
    1080p primary rays (ties counted), ``city_tiled`` and the small city's
    frames against the CPU."""
    import torch

    from hikari_tpu_torch.config import DISTANCE_MAX
    from hikari_tpu_torch.scene import to_device
    from hikari_tpu_torch.trace import api

    t0 = time.perf_counter()
    city_cpu = to_device(city_arrays, "cpu")
    co, cd = (x.reshape(-1, 3).contiguous() for x in city_cam.pixel_rays(CITY_HW))
    Rc = co.shape[0]
    c_rays = (co, cd, torch.full((Rc,), DISTANCE_MAX, device=device),
              torch.zeros((Rc,), device=device), torch.full((Rc,), -1, dtype=torch.int32, device=device),
              torch.zeros((Rc,), dtype=torch.int32, device=device),
              torch.full((Rc,), city.num_tris, dtype=torch.int32, device=device))
    d_rays = city_random_rays(city, device)
    for label, rays, stride in (("(c) city 512x512 primary", c_rays, TILED_CPU_STRIDE[0]),
                                ("(d) city random rays", d_rays, TILED_CPU_STRIDE[1])):
        hit, kw = check_tiled_call(label, city, city_cpu, rays, stride)
        k2 = api.trace_rays(city, rays[0], rays[1], method="pallas_tiled", **kw)
        k2_ms = cuda_time_ms(lambda: api.trace_rays(city, rays[0], rays[1], method="pallas_tiled",
                                                    **kw), 3)
        ties, anyhit, err = hits_agree(label + " vs K2", hit, k2, early=rays[3], tag="[tiled]")
        log(f"[tiled] {label} against K2 (tile walk): prims equal on "
            f"{rays[0].shape[0] - ties - anyhit}, {ties} ties, {anyhit} any-hit answers (both "
            f"nearer than the early distance), max |t| err {err:.3g}; K2 trace_rays {k2_ms:.4f} ms")
    del city_cpu
    o, d = cornell_rays
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hit = api.trace_rays(cornell, o, d, max_distance=DISTANCE_MAX, method="tiled")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    k1 = api.trace_rays(cornell, o, d, max_distance=DISTANCE_MAX, method="pallas")
    ties, _, err = hits_agree("cornell 1080p primary vs K1", hit, k1, tag="[tiled]")
    log(f"[tiled] cornell 1920x1080 primary, {o.shape[0]} rays: tiled {ms:.2f} ms (host clock, "
        f"one call) against K1: prims equal on "
        f"{o.shape[0] - ties}, {ties} ties, max |t| err {err:.3g}")
    run_city_tiled(city, city_cam, city_settings, device)
    check_small("small city (blocks=3), tiled", small_gpu, small_cpu, city_cam,
                path_settings(city_settings, SMALL_HW[1], SMALL_HW[0]).replace(tracer="tiled"),
                device)
    log(f"[tiled] {time.perf_counter() - t0:.1f} s")


def run_bench_trace_phase(device):
    """[bench_trace]: ``python -m hikari_tpu_torch.bench_trace --rays
    BENCH_TRACE_RAYS`` (cornell, city-8, city-24, city-551k, all six
    backends), then ``--stress --backends pallas,tiled,pallas_tiled,scatter``
    (terrain-1m), in this process, their lines echoed. Every backend must
    run; each measurement sets the counts to 0 just before its calls and
    reads them just after: a kernel backend's launches equal its
    trace_calls (> 0), "bvh" and "tiled" launch and count nothing. Then
    ``check_k1b_bench`` on the rows that launched K1b. Returns (K1b
    launches, K1b's kernel-line numbers)."""
    import contextlib
    import io

    from hikari_tpu_torch import bench_trace as bt

    t0 = time.perf_counter()
    rows = []
    for argv in (["--rays", str(BENCH_TRACE_RAYS)],
                 ["--stress", "--backends", "pallas,tiled,pallas_tiled,scatter"]):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            res = bt.main(argv)
        for line in out.getvalue().splitlines() + err.getvalue().splitlines():
            if line.strip():
                log(f"[bench_trace] {line}")
        if res["failed"]:
            raise AssertionError(f"[bench_trace] {' '.join(argv)}: failed {res['failed']}")
        rows += res["rows"]
    for r in rows:
        kernel = r["method"] in bt.KERNEL_BACKENDS
        if not (r["launches"] == r["trace_calls"] and (r["trace_calls"] > 0) == kernel):
            raise AssertionError(f"[bench_trace] {r['scene']}/{r['method']}: launches "
                                 f"{r['launches']}, trace_calls {r['trace_calls']}")
    k1b = sum(r["k1b_launches"] for r in rows)
    if not k1b:
        raise AssertionError("[bench_trace] no launch in K1b's regime")
    log(f"[bench_trace] every kernel backend's launches equal its trace_calls; K1b (tables above "
        f"2,048 triangles) launches {k1b}; {time.perf_counter() - t0:.1f} s")
    return k1b, check_k1b_bench(rows, device)


def check_k1b_bench(rows, device):
    """[bench_trace] K1b against its twin at the bench's shapes: for every
    scene whose "bruteforce"/"pallas" rows launched K1b, the kernel and
    ``closest_hit_reference`` on the card on the packed inputs that
    ``trace_rays`` gives them (the bench's rays, no max distance,
    exclusion or range), under the row's tie rule, bit for bit (t, prim,
    u, v). A row of at most half the bench's rays traced coherent grid
    rays alone, mostly misses: the last as many rays (random, hitting)
    join them. The twin takes every k-th of these, so that it tests at
    most ``K1B_TWIN_PAIRS`` pairs (city-8: all 1,048,576). At city-8's
    shape: the kernel's CUDA-event ms, the twin's and the bound. Returns
    (max error, ms, plain ms, bound ms, bound by) at that shape."""
    import torch

    from hikari_tpu_torch import bench_trace as bt
    from hikari_tpu_torch.config import F32_MAX
    from hikari_tpu_torch.scene import compile_scene, to_device
    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.utils import same_bits

    t0 = time.perf_counter()
    k1b_rows = [r for r in rows if r["k1b_launches"]]
    scenes = dict(bt.build_scenes(), **bt.build_scenes(stress=True))
    timed = None
    for name in dict.fromkeys(r["scene"] for r in k1b_rows):
        buffers = to_device(compile_scene(scenes[name]), device)
        packed = ch.pack_triangles(buffers)
        P = packed.shape[0]
        o_all, d_all = bt.make_rays(buffers, BENCH_TRACE_RAYS, device=device)
        for r in (r for r in k1b_rows if r["scene"] == name):
            n = r["rays"]
            o, d = o_all[:n], d_all[:n]
            if 2 * n <= BENCH_TRACE_RAYS:
                # The row's rays are coherent grid rays, mostly sky: the
                # last n (random, inside the scene) are added, so the
                # table's hits are compared too.
                o, d = torch.cat([o, o_all[-n:]]), torch.cat([d, d_all[-n:]])
            step = -(-o.shape[0] * P // K1B_TWIN_PAIRS)
            o, d = o[::step].contiguous(), d[::step].contiguous()
            R = o.shape[0]
            args = (o, d, torch.full((R,), F32_MAX, device=device),
                    torch.full((R,), -1, dtype=torch.int32, device=device),
                    torch.zeros((R,), dtype=torch.int32, device=device),
                    torch.full((R,), buffers.num_tris, dtype=torch.int32, device=device), packed)
            tie = "bruteforce" if r["method"] == "bruteforce" else "pallas"
            got, want = ch.closest_hit(*args, tie), ch.closest_hit_reference(*args, tie)
            label = (f"{name}/{r['method']} K1b, every {step} of the row's {n} rays"
                     + (f" and the last {n}" if 2 * n <= BENCH_TRACE_RAYS else "")
                     + f" ({R}) x {P} tris")
            err = compare(f"[bench_trace] {label}", got, want)
            if not all(same_bits(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"[bench_trace] {label}: K1b is not bitwise equal to its twin")
            if name == "city-8" and tie == "pallas":
                if step != 1:
                    raise AssertionError("city-8's K1b case must take every ray of its row")
                torch.cuda.synchronize()
                ms = cuda_time_ms(lambda: ch.closest_hit(*args), 10)
                plain = cuda_time_ms(lambda: ch.closest_hit_reference(*args), 1, warmup=0)
                bound, by = bound_ms(R * P * PAIR_FLOPS, R * 56 + P * 64)
                timed = (err, ms, plain, bound, by)
                log(f"[time] K1b at [bench_trace] city-8 ({R} rays x {P} tris): kernel {ms:.4f} "
                    f"ms, twin {plain:.4f} ms, bound {bound:.4f} ms ({by})")
        del buffers, packed, o_all, d_all
        torch.cuda.empty_cache()
    if timed is None:
        raise AssertionError("[bench_trace] city-8/pallas launched no K1b")
    log(f"[bench_trace] K1b bitwise to its twin on {len(k1b_rows)} bench rows; "
        f"{time.perf_counter() - t0:.1f} s")
    return timed


def grad_rel(a, b):
    """The relative L2 difference of ``a`` against ``b`` (absolute where
    ``b`` is 0)."""
    a, b = a.double().cpu(), b.double().cpu()
    n = float(b.norm())
    d = float((a - b).norm())
    return d / n if n else d


def bit_diff(a, b):
    """(largest |a - b|, entries that differ in their bits) of two tensors."""
    import torch

    a, b = a.cpu(), b.cpu()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    diff = (a.double() - b.double()).abs()
    diff = torch.where(same, 0.0, diff)
    return float(diff.max()) if diff.numel() else 0.0, int((~same).sum())


def run_remat_phase(cornell, cam, arrays, device):
    """[remat]: from one state (2 forward frames of ``cornell_bench``), one
    fwd+grad step with ``remat=True``, with ``remat=False`` twice, and with
    ``channel_remat=True``: loss and every leaf's gradient against the first
    no-remat step within ``REMAT_FACTOR`` times the larger of the two
    no-remat steps' own difference and ``REMAT_FLOOR`` (relative L2;
    ``sun_color`` absolute), peak memory, host ms and device ms of each
    step, and the closest-hit launches of each step's backward (0 with
    remat). Then the repeatability of ``cornell_dynamic``: frames 0-3 twice
    from the initial state, the largest bit difference."""
    import torch

    from hikari_tpu_torch.bench import bench_config
    from hikari_tpu_torch.parallel import DIFF_LEAVES, make_train_step, sharding
    from hikari_tpu_torch.render.pipeline import initial_state, render_frame
    from hikari_tpu_torch.trace import closest_hit as ch

    t_phase = time.perf_counter()
    _, _, bench = bench_config("cornell", device)
    state = initial_state(bench, device)
    with torch.no_grad():
        for _ in range(2):
            _, state = render_frame(cornell, cam, state, bench)
    target = torch.zeros(bench.output_size + (3,), device=device)
    real_loss = sharding.render_loss
    fwd_end = []

    def marked_loss(*args):
        res = real_loss(*args)
        fwd_end.append(ch.launches)
        return res

    def one(label, flags):
        step = make_train_step(bench.replace(**flags))
        step(cornell, cam, state, target)  # warm the allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        sharding.render_loss = marked_loss
        try:
            t0 = time.perf_counter()
            loss, grads, _, _ = step(cornell, cam, state, target)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            sharding.render_loss = real_loss
        k1_fwd, k1_bwd = fwd_end[-1], ch.launches - fwd_end[-1]
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(device)
        dev_ms = device_ms(lambda: step(cornell, cam, state, target), 1, warmup=0)
        if not (k1_fwd == counts["trace_calls"] > 0) or k1_bwd:
            raise AssertionError(f"[remat] {label}: {counts}, closest-hit launches forward "
                                 f"{k1_fwd}, backward {k1_bwd}")
        require_spatial_kernel(f"[remat] {label}", counts)
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            raise AssertionError(f"[remat] {label}: non-finite gradients")
        log(f"[remat] {label}: fwd+grad {ms:.2f} ms (host, one step), device {dev_ms:.2f} ms "
            f"(one profiled step); peak memory {peak / 2**30:.3f} GiB; loss {float(loss):.9g}; "
            f"closest-hit launches forward {k1_fwd} (= trace calls), backward {k1_bwd}")
        return loss, grads, peak

    runs = {
        "remat": one("remat=True", dict(remat=True)),
        "none": one("remat=False", dict(remat=False)),
        "none2": one("remat=False, again", dict(remat=False)),
        "channel": one("channel_remat=True", dict(remat=False, channel_remat=True)),
    }

    def errs(run):
        loss, grads, _ = run
        base_loss, base_grads, _ = runs["none"]
        out = {"loss": abs(float(loss) - float(base_loss)) / abs(float(base_loss))}
        for k in DIFF_LEAVES:
            out[k] = (float((grads[k].double() - base_grads[k].double()).norm())
                      if k == "sun_color" else grad_rel(grads[k], base_grads[k]))
        return out

    noise = errs(runs["none2"])
    limit = REMAT_FACTOR * max(max(noise.values()), REMAT_FLOOR)
    bits = {k: bit_diff(runs["none2"][1][k], runs["none"][1][k]) for k in DIFF_LEAVES}
    bits["loss"] = bit_diff(runs["none2"][0], runs["none"][0])
    log(f"[remat] repeatability: two remat=False steps from one state differ by (relative L2; "
        f"sun_color absolute) " + ", ".join(f"{k} {e:.3g}" for k, e in noise.items()))
    log("[remat] repeatability: largest |difference| and entries whose bits differ: " + ", ".join(
        f"{k} {m:.3g} ({n})" for k, (m, n) in bits.items()))
    for label in ("remat", "channel"):
        e = errs(runs[label])
        bad = {k: v for k, v in e.items() if not v <= limit}
        if bad:
            raise AssertionError(f"[remat] {label} against remat=False past the limit {limit:.3g}: "
                                 f"{bad}")
        log(f"[remat] {label} against remat=False (limit {limit:.3g} = {REMAT_FACTOR} x max(noise, "
            f"{REMAT_FLOOR})): " + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
    peak_r, peak_n = runs["remat"][2], runs["none"][2]
    if not peak_r < peak_n:
        raise AssertionError(f"[remat] the remat step's peak {peak_r} is not below remat=False's "
                             f"{peak_n}")
    log(f"[remat] peak memory remat {peak_r / 2**30:.3f} GiB < remat=False {peak_n / 2**30:.3f} "
        f"GiB; channel_remat {runs['channel'][2] / 2**30:.3f} GiB")
    del runs
    torch.cuda.empty_cache()
    repeat_dynamic(arrays, bench, device)
    log(f"[remat] {time.perf_counter() - t_phase:.1f} s")


def repeat_dynamic(arrays, bench, device):
    """[remat] repeatability of ``cornell_dynamic``: frames 0-3 (moves and
    orbit included) twice from the initial state on fresh buffers; the
    largest bit difference of the image and of the state's tensors."""
    import torch

    from hikari_tpu_torch.io.scenes import cornell_box_scene
    from hikari_tpu_torch.render.pipeline import initial_state, render_frame
    from hikari_tpu_torch.scene import SceneUpdater, to_device
    from hikari_tpu_torch.utils import map_tensors

    settings = dynamic_settings(bench, CORNELL_HW[1], CORNELL_HW[0])
    runs = []
    for _ in range(2):
        up = SceneUpdater(cornell_box_scene(), to_device(arrays, device))
        state = initial_state(settings, device)
        with torch.no_grad():
            for f in range(4):
                if f:
                    up.set_transforms(dynamic_moves(f, up.buffers.inst_model.cpu().numpy()))
                out, state = render_frame(up.buffers, orbit_camera(f, device), state, settings)
        flat = []
        map_tensors(flat.append, state)
        runs.append((out.image, flat, up.buffers.em_surface_area))
    img = bit_diff(runs[0][0], runs[1][0])
    st = [bit_diff(a, b) for a, b in zip(runs[0][1], runs[1][1]) if a.is_floating_point()]
    area = bit_diff(runs[0][2], runs[1][2])
    log(f"[remat] repeatability: cornell_dynamic frames 0-3 twice from the initial state: image "
        f"largest |difference| {img[0]:.3g} ({img[1]} entries differ); state "
        f"{max(m for m, _ in st):.3g} ({sum(n for _, n in st)} entries differ); emissive areas "
        f"{area[0]:.3g} ({area[1]} differ)")


def run_tools_phase(device):
    """[tools]: ``tools/clip_engagement --size 256`` (cornell and scene) and
    ``tools/measure_spatial_grads --size 64 -k 2`` on the card, lines echoed;
    both must finish with finite output."""
    import contextlib
    import io
    import math

    import numpy as np

    from hikari_tpu_torch.tools import clip_engagement, measure_spatial_grads

    t0 = time.perf_counter()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        clip = clip_engagement.main(["--size", "256"])
        rows = measure_spatial_grads.main(["--size", "64", "-k", "2"])
    for line in out.getvalue().splitlines() + err.getvalue().splitlines():
        if line.strip():
            log(f"[tools] {line}")
    bad = [k for k, (loss, rep) in clip.items()
           if not (math.isfinite(loss) and rep and all(t > 0 for _, t, _ in rep.values()))]
    bad += [f"spatial_radiance_grads={k}" for k, r in rows.items()
            if not (np.isfinite(r[0]) and np.isfinite(r[4]).all() and r[3])]
    if bad:
        raise AssertionError(f"[tools] non-finite or empty output: {bad}")
    log(f"[tools] {time.perf_counter() - t0:.1f} s")


def run_sharded_phase(city_arrays, city_cam, smi):
    """[sharded] (s1)-(s4) (``tools/sharded_smoke.phase``) on ranks that
    share cuda:0 over gloo (NCCL takes one rank a GPU), then
    ``bench_scaling --procs 2``. Any failed check raises."""
    from hikari_tpu_torch.tools import sharded_smoke

    t0 = time.perf_counter()
    log(f"[sharded] ranks share cuda:0, backend gloo (NCCL takes one rank a GPU); one card "
        f"measures no scaling; nvidia-smi: {smi}")
    launches = sharded_smoke.phase("cuda:0", city_arrays, city_cam, log)
    log(f"[sharded] closest-hit and tile-walk launches over the ranks: {launches}")
    t1 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "hikari_tpu_torch.bench_scaling", "--procs", "2"],
                         capture_output=True, text=True, timeout=600)
    if run.returncode:
        raise AssertionError(f"bench_scaling failed:\n{run.stdout[-2000:]}{run.stderr[-4000:]}")
    log(f"[sharded] bench_scaling --procs 2 ({time.perf_counter() - t1:.1f} s): "
        f"{run.stdout.strip().splitlines()[-1]}")
    log(f"[sharded] {time.perf_counter() - t0:.1f} s")


def entries_bound(R, L):
    """K2·p1's bound: one slab test a (ray, cluster) pair; each ray's o,
    inv, maxd, lo, hi read and its max entry written (40 B), the bounds
    read (25 B a cluster), the (T, L) entries written."""
    return bound_ms(R * L * SLAB_FLOPS, R * 40 + L * 25 + (R // 512) * L * 4)


def plan_bound(R, L, cap):
    """K3·pAB's bound: one slab test a (ray, cluster) pair; each ray's o,
    d, maxd, lo, hi read (36 B), the bounds read, meta (8 B a block) and
    the items (8 B a slot) written (the ballot masks are the kernel's own
    intermediate, not counted)."""
    return bound_ms(R * L * SLAB_FLOPS, R * 36 + L * 25 + cap // 128 * 8 + cap * 8)


def slab_hazards(cmin, cmax, cvalid, o, d, maxd, lo, hi):
    """The phase kernels' hazards on a case of the card: a copy of the
    cluster bounds where cluster 3 has a NaN min x, 10 a min x of -inf, 11
    a max y of +inf, 12 a min z of +inf (above its max) and 20 is invalid,
    and of the rays where every 97th has an infinite direction component
    (inv 0), every 101st a NaN origin component and every 103rd a NaN
    direction: warps that mix clean and unclean rays beside clean warps.
    Returns (cmin, cmax, cvalid, o, d, maxd, lo, hi)."""
    cmin, cmax, cvalid, o, d = (x.clone() for x in (cmin, cmax, cvalid, o, d))
    cmin[3, 0] = float("nan")
    cmin[10, 0] = float("-inf")
    cmax[11, 1] = float("inf")
    cmin[12, 2] = float("inf")
    cvalid[20] = False
    d[::97, 0] = float("inf")
    o[::101, 1] = float("nan")
    d[::103, 2] = float("nan")
    return cmin, cmax, cvalid, o, d, maxd, lo, hi


def slab_sass(source, kernel, tests):
    """(SASS instructions a slab test on the common path of the kernel's
    test loop (``ab_trace_kernels.slab_loop``), the issue floor ms of
    ``tests`` tests)."""
    from hikari_tpu_torch.tools import ab_trace_kernels as ab

    _, common, n = ab.slab_loop(ab.kernel_sass(source), kernel)
    ipt = common / max(n, 1)
    return ipt, ab.issue_floor_ms(tests, ipt)


def check_entries(label, cmin, cmax, cvalid, o, d, maxd, lo, hi, cluster):
    """[kernel] K2·p1 against its twin on the card, with the rays' prim
    ranges and without: entries, ray_maxent and the stable sort of the
    entries bit for bit. Returns the largest |kernel - twin| (0)."""
    import torch

    from hikari_tpu_torch.config import F32_MAX
    from hikari_tpu_torch.trace import tiled as ttiled
    from hikari_tpu_torch.utils import same_bits

    inv = ttiled.safe_inv_dir(d)
    err = 0.0
    for rng in ((lo, hi), (None, None)):
        got = ttiled.tile_cluster_entries(cmin, cmax, cvalid, o, inv, maxd, *rng, cluster=cluster)
        want = ttiled.tile_cluster_entries_reference(cmin, cmax, cvalid, o, inv, maxd, *rng,
                                                     cluster=cluster)
        torch.cuda.synchronize()
        ranges = "with" if rng[0] is not None else "without"
        err = max([err] + [float((g - w).abs().max()) for g, w in zip(got, want)])
        if not (same_bits(got[0], want[0]) and same_bits(got[1], want[1])):
            raise AssertionError(f"K2·p1 {label} {ranges} prim ranges: not bitwise equal to the "
                                 f"twin")
        if not torch.equal(torch.sort(got[0], dim=1, stable=True)[1],
                           torch.sort(want[0], dim=1, stable=True)[1]):
            raise AssertionError(f"K2·p1 {label}: the sorted order differs from the twin's")
        T, L = want[0].shape
        log(f"[kernel] K2·p1 {label} {ranges} prim ranges, {T} tiles x {L} clusters of "
            f"{cluster}: entries, ray_maxent and the sorted order bitwise equal to the twin; "
            f"{int((want[0] < F32_MAX).sum())} entered (tile, cluster) entries "
            f"({int((want[0] == 0).sum())} at 0), {int((want[1] >= 0).sum())} rays enter a cluster")
    return err


def check_plan(label, cmin, cmax, cvalid, o, d, maxd, lo, hi, items_per_ray=32):
    """[kernel] K3·pAB against its twin on the card: meta, items and the
    dropped count bit for bit. Returns the kernel's plan and the largest
    |kernel - twin| of meta, items and the dropped count (0)."""
    import torch

    from hikari_tpu_torch.trace import scatter as sc

    got = sc.scatter_plan(cmin, cmax, cvalid, o, d, maxd, lo, hi, items_per_ray)
    want = sc.scatter_plan_reference(cmin, cmax, cvalid, o, d, maxd, lo, hi, items_per_ray)
    torch.cuda.synchronize()
    err = max([abs(got[2] - want[2])] + [float((g - w).abs().max()) if g.numel() else 0.0
                                         for g, w in zip(got[:2], want[:2])])
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == want[2]):
        raise AssertionError(f"K3·pAB {label}: not bitwise equal to the twin (dropped {got[2]} "
                             f"vs {want[2]})")
    meta = want[0]
    log(f"[kernel] K3·pAB {label}, {o.shape[0]} rays x {cmin.shape[0]} clusters, items_per_ray "
        f"{items_per_ray}: meta, items and dropped bitwise equal to the twin; "
        f"{int(meta[:, 1].sum()) + want[2]} entered pairs, {int((meta[:, 1] > 0).sum())} used "
        f"blocks, dropped {want[2]}")
    return got, err


def time_phases_city8(device):
    """[time] K2·p1, the sort and K3·pAB at ``[bench_trace]``'s city-8
    shape (its 1,048,576 rays, sorted into tiles as ``trace_rays`` sorts
    them for the tile walk), each beside its twin and its bound."""
    import torch

    from hikari_tpu_torch import bench_trace as bt
    from hikari_tpu_torch.config import F32_MAX
    from hikari_tpu_torch.scene import compile_scene, to_device
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import scatter as sc
    from hikari_tpu_torch.trace import tile_walk as tw
    from hikari_tpu_torch.trace import tiled as ttiled

    buffers = to_device(compile_scene(bt.build_scenes()["city-8"]), device)
    o, d = bt.make_rays(buffers, BENCH_TRACE_RAYS, device=device)
    R = o.shape[0]
    order = api.ray_sort_order(buffers, o, d)
    o, d = o[order].contiguous(), d[order].contiguous()
    maxd = torch.full((R,), F32_MAX, device=device)
    lo = torch.zeros((R,), dtype=torch.int32, device=device)
    hi = torch.full((R,), buffers.num_tris, dtype=torch.int32, device=device)
    cluster, _ = api.tile_cluster_rule(buffers.tri_n.shape[0])
    _, cmin, cmax, cvalid = tw.pack_clusters(buffers, cluster)
    check_entries(f"[bench_trace] city-8 ({R} rays)", cmin, cmax, cvalid, o, d, maxd, lo, hi,
                  cluster)
    p1 = (cmin, cmax, cvalid, o, ttiled.safe_inv_dir(d), maxd, lo, hi)
    torch.cuda.synchronize()
    p1_ms = cuda_time_ms(lambda: ttiled.tile_cluster_entries(*p1, cluster=cluster), 20)
    p1_plain = cuda_time_ms(lambda: ttiled.tile_cluster_entries_reference(*p1, cluster=cluster), 2,
                            warmup=1)
    entries = ttiled.tile_cluster_entries(*p1, cluster=cluster)[0]
    sort_ms = cuda_time_ms(lambda: torch.sort(entries, dim=1, stable=True), 20)
    L = cmin.shape[0]
    p1_bound, p1_by = entries_bound(R, L)
    _, cmin_s, cmax_s, cvalid_s = tw.pack_clusters(buffers, sc.CLUSTER)
    plan_args = (cmin_s, cmax_s, cvalid_s, o, d, maxd, lo, hi)
    check_plan(f"[bench_trace] city-8 ({R} rays)", *plan_args)  # its error is 0 or it raises
    pab_ms = device_ms(lambda: sc.scatter_plan(*plan_args), 10, names=PLAN_KERNELS)
    pab_call = cuda_time_ms(lambda: sc.scatter_plan(*plan_args), 10)
    pab_plain = cuda_time_ms(lambda: sc.scatter_plan_reference(*plan_args), 2, warmup=1)
    Ls = cmin_s.shape[0]
    pab_bound, pab_by = plan_bound(R, Ls, sc.capacity(R, Ls, 32))
    log(f"[time] K2·p1 at [bench_trace] city-8 ({R} rays x {L} clusters of {cluster}): kernel "
        f"{p1_ms:.4f} ms, twin {p1_plain:.4f} ms, bound {p1_bound:.4f} ms ({p1_by})")
    log(f"[time] sort at city-8: torch.sort(stable) of the ({R // 512}, {L}) entries "
        f"{sort_ms:.4f} ms")
    log(f"[time] K3·pAB at [bench_trace] city-8 ({R} rays x {Ls} clusters of 128): its kernels "
        f"{pab_ms:.4f} ms device, the whole scatter_plan call {pab_call:.4f} ms, twin "
        f"{pab_plain:.4f} ms, bound {pab_bound:.4f} ms ({pab_by})")
    del buffers, o, d, entries
    torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU",
              file=sys.stderr)
        return 1

    from concurrent.futures import ThreadPoolExecutor

    from hikari_tpu_torch.config import DISTANCE_MAX
    from hikari_tpu_torch.io.scenes import city_config, city_scene, cornell_box_scene, cornell_config
    from hikari_tpu_torch.render import spatial
    from hikari_tpu_torch.scene import compile_scene, native, to_device
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.trace import scatter as sc
    from hikari_tpu_torch.trace import tile_walk as tw
    from hikari_tpu_torch.trace import tiled as ttiled
    from hikari_tpu_torch.tools import ab_trace_kernels as ab
    from hikari_tpu_torch.tools import prims
    from hikari_tpu_torch.utils.nvcc import ptxas_summary

    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # ---- 2. build: the seven nvcc builds and the g++ builder at once ----
    def g_build():
        native.get_builder()
        return native.build_seconds

    builds = (ch.build, tw.build, sc.build, lambda: prims.build("window_pack"),
              lambda: prims.build("take_along"), g_build, ttiled.build, sc.build_plan,
              spatial.build)
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = [pool.submit(f) for f in builds]
        ch_s, tw_s, sc_s, wp_s, ta_s, gxx_s, te_s, sp_s, sr_s = (f.result() for f in futures)
    log(f"[build] closest_hit.cu {ch_s:.2f} s; ptxas: {ptxas_summary(ch.build_log)}")
    log(f"[build] tile_walk.cu {tw_s:.2f} s; ptxas: {ptxas_summary(tw.build_log)}")
    log(f"[build] scatter_items.cu {sc_s:.2f} s; ptxas: {ptxas_summary(sc.build_log)}")
    log(f"[build] window_pack.cu {wp_s:.2f} s; ptxas: "
        f"{ptxas_summary(prims.build_logs['window_pack'])}")
    log(f"[build] take_along.cu {ta_s:.2f} s; ptxas: {ptxas_summary(prims.build_logs['take_along'])}")
    log(f"[build] bvh_builder.cpp (g++) {gxx_s:.2f} s")
    log(f"[build] tile_entries.cu {te_s:.2f} s; ptxas: {ptxas_summary(ttiled.build_log)}")
    log(f"[build] scatter_plan.cu {sp_s:.2f} s; ptxas: {ptxas_summary(sc.plan_build_log)}")
    log(f"[build] spatial_reuse.cu {sr_s:.2f} s; ptxas: {ptxas_summary(spatial.build_log)}")

    # ---- 3a. closest-hit kernel vs twin on the cornell shapes ----
    arrays = compile_scene(cornell_box_scene())
    cornell = to_device(arrays, dev)
    cornell_cpu = to_device(arrays, "cpu")
    _, cam, cornell_settings = cornell_config(device=dev)
    cornell_settings = path_settings(cornell_settings, CORNELL_HW[1], CORNELL_HW[0])
    origin, direction = cam.pixel_rays(CORNELL_HW)
    R = origin.shape[0] * origin.shape[1]
    prim_args = (
        origin.reshape(-1, 3).contiguous(),
        direction.reshape(-1, 3).contiguous(),
        torch.full((R,), DISTANCE_MAX, device=dev),
        torch.full((R,), -1, dtype=torch.int32, device=dev),
        torch.zeros((R,), dtype=torch.int32, device=dev),
        torch.full((R,), cornell.num_tris, dtype=torch.int32, device=dev),
        ch.pack_triangles(cornell),
    )
    err_a = compare("(a) cornell 1080p primary", ch.closest_hit(*prim_args),
                    ch.closest_hit_reference(*prim_args))
    soup = soup_case(dev)
    err_b = compare("(b) 5120-tri soup", ch.closest_hit(*soup), ch.closest_hit_reference(*soup))
    err_bf = compare("(a) cornell 1080p primary, tie='bruteforce'",
                     ch.closest_hit(*prim_args, "bruteforce"),
                     ch.closest_hit_reference(*prim_args, "bruteforce"))
    tie_cases(dev)
    k1_edge_cases(cornell, dev)
    torch.cuda.synchronize()
    ch_ms = cuda_time_ms(lambda: ch.closest_hit(*prim_args), 50)
    ch_bf_ms = cuda_time_ms(lambda: ch.closest_hit(*prim_args, "bruteforce"), 50)
    ch_plain_ms = cuda_time_ms(lambda: ch.closest_hit_reference(*prim_args), 5)
    soup_ms = cuda_time_ms(lambda: ch.closest_hit(*soup), 20)
    soup_plain_ms = cuda_time_ms(lambda: ch.closest_hit_reference(*soup), 3)
    P = cornell.num_tris
    # Bytes: each ray's o, d, maxd, excl, lo, hi read and t, prim, u, v
    # written (56 B), the table read once.
    ch_bound, ch_by = bound_ms(R * P * PAIR_FLOPS, R * 56 + P * 64)
    Rs, Ps = soup[0].shape[0], soup[6].shape[0]
    soup_bound, soup_by = bound_ms(Rs * Ps * PAIR_FLOPS, Rs * 56 + Ps * 64)
    ch_ipp = ab.per_pair(ab.kernel_sass(ch.SOURCE), "closest_hit_kernel")
    ch_regs = "/".join(map(str, ab.registers(ch.SOURCE, "closest_hit_kernel").values()))
    log(f"[time] (a) {R} rays x {P} tris: kernel {ch_ms:.4f} ms (tie='bruteforce' "
        f"{ch_bf_ms:.4f} ms), twin {ch_plain_ms:.4f} ms, bound {ch_bound:.4f} ms ({ch_by}); "
        f"(b) {Rs} rays x {Ps} tris: kernel {soup_ms:.4f} ms, twin {soup_plain_ms:.4f} ms, "
        f"bound {soup_bound:.4f} ms ({soup_by})")
    log(f"[time] K1 SASS {ch_ipp:.2f} instructions a pair on the loop's common path (no ray of "
        f"the warp takes the pair), issue floor (a) "
        f"{ab.issue_floor_ms(R * P, ch_ipp):.4f} ms, (b) {ab.issue_floor_ms(Rs * Ps, ch_ipp):.4f} "
        f"ms; {ch_regs} registers; resident warps per SM (a) {ch.warps_per_sm(P)}, (b) "
        f"{ch.warps_per_sm(Ps)}")

    # ---- 3b. cornell_path ----
    cornell_state, cornell_launches = run_main_path("cornell_path", cornell, cam, cornell_settings, dev)
    if cornell_launches["tile_walk"] or cornell_launches["tile_entries"]:
        raise AssertionError("cornell_path launched the tile walk: it has only 36 triangles")
    if profile:
        profile_frames("cornell_path", render_advance(cornell, cam, cornell_settings), cornell_state)
    cornell_bench = bench_settings(cornell_settings, CORNELL_HW[1], CORNELL_HW[0], "auto")
    bench_state, bench_launches = run_main_path("cornell_bench", cornell, cam, cornell_bench, dev)
    if any(bench_launches[k] for k in ("tile_walk", "scatter_items", "tile_entries",
                                        "scatter_plan")):
        raise AssertionError(f"cornell_bench launched another search than K1: {bench_launches}")
    if cornell_launches["scatter_plan"]:
        raise AssertionError(f"cornell_path launched the scatter plan: {cornell_launches}")
    if profile:
        profile_frames("cornell_bench", render_advance(cornell, cam, cornell_bench), bench_state)
    del bench_state, cornell_state
    _, cam_s, small = cornell_config(device="cpu")
    check_small("cornell", cornell, cornell_cpu, cam_s,
                path_settings(small, SMALL_HW[1], SMALL_HW[0]), dev)

    # ---- 3c. the output options: FSR1 at 1.5, HDR, bloom, FXAA ----
    output_launches = run_output_phase(cornell, cornell_cpu, cam, small, dev)

    # ---- 4a. tile-walk kernel vs twin on the city shapes ----
    t0 = time.perf_counter()
    city_scene_, city_cam, city_settings = city_config(device=dev)
    city_arrays = compile_scene(city_scene_)
    compile_s = time.perf_counter() - t0
    city = to_device(city_arrays, dev)
    city_settings = path_settings(city_settings, CITY_HW[1], CITY_HW[0])
    log(f"[city] host compile {compile_s:.2f} s (C++ builder): {city.num_tris} triangles, "
        f"{city.num_instances} instances, {city.num_emissives} emissive instances; cluster rule "
        f"{api.tile_cluster_rule(city.tri_n.shape[0])}")
    c_origin, c_direction = city_cam.pixel_rays(CITY_HW)
    Rc = c_origin.shape[0] * c_origin.shape[1]
    co, cd = c_origin.reshape(-1, 3).contiguous(), c_direction.reshape(-1, 3).contiguous()
    walk_c, phase1_c = walk_case(
        city, co, cd, torch.full((Rc,), DISTANCE_MAX, device=dev), torch.zeros((Rc,), device=dev),
        torch.full((Rc,), -1, dtype=torch.int32, device=dev),
        torch.zeros((Rc,), dtype=torch.int32, device=dev),
        torch.full((Rc,), city.num_tris, dtype=torch.int32, device=dev),
    )
    got_c = tw.tile_walk(*walk_c)
    err_c = compare("(c) city 512x512 primary", got_c, tw.tile_walk_reference(*walk_c))
    walk_d, phase1_d = walk_case(city, *city_random_rays(city, dev))
    err_d = compare("(d) city random rays", tw.tile_walk(*walk_d), tw.tile_walk_reference(*walk_d))
    err_p1 = max(check_entries("(c) city 512x512 primary", *phase1_c),
                 check_entries("(d) city random rays", *phase1_d),
                 check_entries("(c) mixed NaN/clean warps, non-finite bounds",
                               *slab_hazards(*phase1_c[:8]), phase1_c[8]))
    tested = got_c[4]
    torch.cuda.synchronize()
    tw_ms = cuda_time_ms(lambda: tw.tile_walk(*walk_c), 20)
    entries_ms = cuda_time_ms(lambda: tw.tile_entries(*phase1_c), 5)
    # K2·p1 alone, its twin and the sort, at (c).
    p1_c = (*phase1_c[:4], ttiled.safe_inv_dir(phase1_c[4]), *phase1_c[5:8])
    p1_ms = cuda_time_ms(lambda: ttiled.tile_cluster_entries(*p1_c, cluster=phase1_c[8]), 20)
    p1_plain_ms = cuda_time_ms(
        lambda: ttiled.tile_cluster_entries_reference(*p1_c, cluster=phase1_c[8]), 3, warmup=1)
    entries_c = ttiled.tile_cluster_entries(*p1_c, cluster=phase1_c[8])[0]
    sort_ms = cuda_time_ms(lambda: torch.sort(entries_c, dim=1, stable=True), 20)
    p1_bound, p1_by = entries_bound(Rc, entries_c.shape[1])
    trace_ms = cuda_time_ms(
        lambda: api.trace_rays(city, c_origin, c_direction, max_distance=DISTANCE_MAX), 5)
    tw_plain_ms = cuda_time_ms(lambda: tw.tile_walk_reference(*walk_c), 1, warmup=1)
    cluster = walk_c[13]
    T, L = walk_c[10].shape
    pairs = int(tested.sum()) * 512 * cluster
    # Bytes: each ray's o, d, maxd, early, excl, lo, hi, maxent read and
    # t, prim, u, v written (64 B), each tile's cluster ids and entries
    # read (8 B each), the tested count written, the packed table and the
    # cluster bounds read once.
    walk_bytes = Rc * 64 + T * L * 8 + T * 4 + walk_c[0].numel() * 4 + L * 24
    tw_bound, tw_by = bound_ms(pairs * PAIR_FLOPS, walk_bytes)
    tw_ipp = ab.per_pair(ab.kernel_sass(tw.SOURCE), "tile_walk")
    t_max, t_p50, t_p90, _ = ab.tested_stats(tested)
    longest = t_max * 512 * cluster
    log(f"[time] (c) {Rc} rays, {T} tiles x {L} clusters of {cluster}: {int(tested.sum())} "
        f"clusters tested ({pairs} pairs); K2 kernel {tw_ms:.4f} ms, bound {tw_bound:.4f} ms "
        f"({tw_by}); phase 1 + sort {entries_ms:.4f} ms; whole trace_rays {trace_ms:.4f} ms; "
        f"twin {tw_plain_ms:.4f} ms")
    log(f"[time] (c) clusters tested per tile: max {t_max}, p50 {t_p50:g}, p90 {t_p90:g}; the "
        f"longest tile alone on one SM at 1/{ab.NUM_SMS} of the FP32 rate: "
        f"{longest * PAIR_FLOPS / (PEAK_FP32 / ab.NUM_SMS) * 1e3:.4f} ms; K2 SASS "
        f"{tw_ipp:.2f} instructions a pair (common path), issue floor "
        f"{ab.issue_floor_ms(pairs, tw_ipp):.4f} ms")
    p1_ipt, p1_floor = slab_sass(ttiled.SOURCE, "tile_entries", Rc * L)
    log(f"[time] (c) K2·p1 ({Rc} rays x {L} clusters of {cluster} = {L // 128} stages of 128 + "
        f"{L % 128}, {Rc * L} slab tests): kernel {p1_ms:.4f} ms (earlier designs: PERF.md §6, "
        f"K2·p1's row), twin {p1_plain_ms:.4f} ms, bound {p1_bound:.4f} ms ({p1_by}); SASS {p1_ipt:.2f} "
        f"instructions a test on the test loop's common path, issue floor {p1_floor:.4f} ms")
    log(f"[time] (c) sort: torch.sort(stable) of the ({T}, {L}) entries {sort_ms:.4f} ms")
    del entries_c

    # ---- 4b. scatter kernel vs twin on the city shapes ----
    del walk_c, walk_d, got_c, phase1_c, phase1_d, p1_c  # keep the cases out of later peaks
    packed_s, cmin_s, cmax_s, cvalid_s = tw.pack_clusters(city, sc.CLUSTER)

    err_pab = []

    def scatter_case(name, o, d, maxd, excl, lo, hi):
        """Plan (against its twin), fields, kernel and twin on every item;
        returns (plan, fields, kernel output, max error)."""
        plan, plan_err = check_plan(name, cmin_s, cmax_s, cvalid_s, o, d, maxd, lo, hi)
        err_pab.append(plan_err)
        meta, items, n_drop = plan
        fields = sc.item_fields(items, o, d, maxd, excl, lo, hi)
        got = sc.scatter_items(meta, fields, packed_s)
        want = sc.scatter_items_reference(meta, fields, packed_s)
        err = compare(name, got, want)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: K3 is not bitwise equal to its twin")
        check_cluster_errors(name)
        used = int((meta[:, 1] > 0).sum())
        log(f"[kernel] {name}: {int(meta[:, 1].sum()) + n_drop} entered pairs, CAP "
            f"{items.shape[0]}, {used} used blocks of {meta.shape[0]}, dropped items {n_drop}")
        return plan, fields, got, err

    e_args = (co, cd, torch.full((Rc,), DISTANCE_MAX, device=dev),
              torch.full((Rc,), -1, dtype=torch.int32, device=dev),
              torch.zeros((Rc,), dtype=torch.int32, device=dev),
              torch.full((Rc,), city.num_tris, dtype=torch.int32, device=dev))
    plan_e, fields_e, got_e, err_e = scatter_case("(e) city 512x512 primary, K3", *e_args)
    hit_e = api.trace_rays(city, co, cd, max_distance=DISTANCE_MAX, method="scatter")
    hit_c = api.trace_rays(city, co, cd, max_distance=DISTANCE_MAX, method="pallas_tiled")
    share = float((hit_e.prim == hit_c.prim).to(torch.float32).mean())
    if share < K2_K3_SHARE:
        raise AssertionError(f"(e): K3 and K2 agree on only {share:.5f} of the primary rays")
    log(f"[kernel] (e) K3 against K2 on the primary rays: prim equal on {share:.6f} "
        f"(>= {K2_K3_SHARE} required), {int((hit_e.prim >= 0).sum())} hits")
    f_rays = city_random_rays(city, dev)
    _, _, _, err_f = scatter_case("(f) city random rays, K3", *f_rays[:3], *f_rays[4:])
    plan_e_args = (cmin_s, cmax_s, cvalid_s, *e_args[:3], *e_args[4:])
    err_pab.append(check_plan("(e) items_per_ray=2 (drops)", *plan_e_args, items_per_ray=2)[1])
    # (e) with every ray restricted to one instance's prims.
    rng_inst = torch.randint(0, city.num_instances, (Rc,), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(5))
    lo_r = city.inst_prim_offset[rng_inst].to(torch.int32).contiguous()
    hi_r = (lo_r + city.inst_prim_count[rng_inst]).to(torch.int32).contiguous()
    err_pab.append(check_plan("(e) one instance's prim range a ray", *plan_e_args[:6], lo_r,
                              hi_r)[1])
    err_pab.append(check_plan("(e) mixed NaN/clean warps, non-finite bounds",
                              *slab_hazards(*plan_e_args))[1])
    del rng_inst, lo_r, hi_r
    meta_e, items_e, _ = plan_e
    torch.cuda.synchronize()
    pab_ms = device_ms(lambda: sc.scatter_plan(*plan_e_args), 10, names=PLAN_KERNELS)
    pab_call_ms = cuda_time_ms(lambda: sc.scatter_plan(*plan_e_args), 10)
    pab_plain_ms = cuda_time_ms(lambda: sc.scatter_plan_reference(*plan_e_args), 2, warmup=1)
    pab_bound, pab_by = plan_bound(Rc, cmin_s.shape[0], items_e.shape[0])
    sc_ms = cuda_time_ms(lambda: sc.scatter_items(meta_e, fields_e, packed_s), 20)
    plan_ms = cuda_time_ms(lambda: sc.item_fields(
        sc.scatter_plan(cmin_s, cmax_s, cvalid_s, *e_args[:3], *e_args[4:])[1], *e_args), 3)
    segmin_ms = cuda_time_ms(lambda: sc.segment_min(items_e, *got_e, e_args[2]), 10)
    sc_trace_ms = cuda_time_ms(lambda: api.trace_rays(
        city, c_origin, c_direction, max_distance=DISTANCE_MAX, method="scatter"), 3)
    sc_plain_ms = cuda_time_ms(lambda: sc.scatter_items_reference(meta_e, fields_e, packed_s), 1,
                               warmup=1)
    used_e = int((meta_e[:, 1] > 0).sum())
    cap_e = items_e.shape[0]
    sc_pairs = used_e * sc.BLOCK_R * sc.CLUSTER
    # Bytes: each item slot's 11 fields read and 4 results written, the
    # 128 rows of 64 B of each used block's cluster read.
    sc_bound, sc_by = bound_ms(sc_pairs * PAIR_FLOPS, 15 * 4 * cap_e + 64 * sc.CLUSTER * used_e)
    sc_ipp = ab.per_pair(ab.kernel_sass(sc.SOURCE), "scatter_items")
    log(f"[time] (e) {Rc} rays, CAP {cap_e}, {used_e} used blocks ({sc_pairs} pairs): K3 kernel "
        f"{sc_ms:.4f} ms, bound {sc_bound:.4f} ms ({sc_by}); phases A+B with the item fields "
        f"{plan_ms:.4f} ms; segment-min {segmin_ms:.4f} ms; whole trace_rays(method='scatter') "
        f"{sc_trace_ms:.4f} ms; twin {sc_plain_ms:.4f} ms; K3 SASS {sc_ipp:.2f} instructions a "
        f"pair (common path), issue floor {ab.issue_floor_ms(sc_pairs, sc_ipp):.4f} ms")
    Ls = cmin_s.shape[0]
    pab_ipt, pab_floor = slab_sass(sc.PLAN_SOURCE, "scatter_plan", Rc * Ls)
    log(f"[time] (e) K3·pAB ({Rc} rays x {Ls} clusters of 128 = {Ls // 128} stages + {Ls % 128}, "
        f"{Rc * Ls} slab tests, one a pair): its kernels (table, count, place) {pab_ms:.4f} ms "
        f"device (earlier designs: PERF.md §6, K3·pAB's row), the whole "
        f"scatter_plan call "
        f"{pab_call_ms:.4f} ms, twin {pab_plain_ms:.4f} ms, bound {pab_bound:.4f} ms ({pab_by}); "
        f"SASS {pab_ipt:.2f} instructions a test on the count loop's common path, issue floor "
        f"{pab_floor:.4f} ms; ballot masks {sc.mask_bytes(Rc, Ls)} bytes "
        f"({sc.mask_bytes(Rc, Ls) / 2**30:.4f} GiB)")
    check_cluster_errors("(e) timing")
    del plan_e, fields_e, got_e, hit_e, hit_c, meta_e, items_e, f_rays

    # ---- 4c. city_path and city_bench_scatter ----
    live = {"city_path": torch.cuda.memory_allocated(dev) / 2**30}
    city_state, city_launches = run_main_path("city_path", city, city_cam, city_settings, dev)
    peaks = {"city_path": torch.cuda.max_memory_allocated(dev) / 2**30}
    if city_launches["closest_hit"] or city_launches["scatter_items"]:
        raise AssertionError(f"city_path sent a trace to another search than K2: {city_launches}")
    if not city_launches["tile_entries"]:
        raise AssertionError(f"city_path launched no K2·p1: {city_launches}")
    if profile:
        profile_frames("city_path", render_advance(city, city_cam, city_settings), city_state)
    del city_state
    city_bench = bench_settings(city_settings, CITY_HW[1], CITY_HW[0], "scatter")
    live["city_bench_scatter"] = torch.cuda.memory_allocated(dev) / 2**30
    cb_state, cb_launches = run_main_path("city_bench_scatter", city, city_cam, city_bench, dev)
    peaks["city_bench_scatter"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log("[main] peaks: " + "; ".join(
        f"{k} {v:.3f} GiB, of it {live[k]:.3f} live before the path" for k, v in peaks.items())
        + f"; the (e) plan's ballot masks {sc.mask_bytes(Rc, cmin_s.shape[0]) / 2**30:.4f} GiB")
    if cb_launches["closest_hit"] or cb_launches["tile_walk"]:
        raise AssertionError(f"city_bench_scatter sent a trace past the scatter kernel: {cb_launches}")
    if not cb_launches["scatter_plan"]:
        raise AssertionError(f"city_bench_scatter launched no K3·pAB: {cb_launches}")
    if profile:
        profile_frames("city_bench_scatter", render_advance(city, city_cam, city_bench), cb_state)
    del cb_state
    small_arrays = compile_scene(city_scene(blocks=3, detail=True))
    if len(small_arrays.tri_world) <= city_settings.bruteforce_max_tris:
        raise AssertionError("the small city must be large enough for the tile walk")
    small_gpu, small_cpu = to_device(small_arrays, dev), to_device(small_arrays, "cpu")
    check_small("small city (blocks=3)", small_gpu, small_cpu, city_cam,
                path_settings(city_settings, SMALL_HW[1], SMALL_HW[0]), dev)
    check_small("small city (blocks=3), bench settings, scatter", small_gpu, small_cpu, city_cam,
                bench_settings(city_settings, SMALL_BENCH_HW[1], SMALL_BENCH_HW[0], "scatter"), dev)

    # ---- 4c'. the XLA tiled tracer, then the per-scene trace bench ----
    run_tiled_phase(cornell, prim_args[:2], city, city_arrays, city_cam, city_settings, small_gpu,
                    small_cpu, dev)
    bench_trace_k1b, k1b_bench = run_bench_trace_phase(dev)
    time_phases_city8(dev)

    # ---- 4d. dynamic scenes: cornell_dynamic, city_stream, the update, the bvh walk ----
    dyn_k1, dyn_k2 = run_dynamic_phase(arrays, city, city_arrays, small_arrays, city_cam, dev,
                                       profile)

    # The closest-hit launches with a table larger than one TPU tile (K1b's
    # regime): none of the render paths has one; [bench_trace]'s city and
    # terrain scenes do.
    k1b_launches = bench_trace_k1b + sum(x["closest_hit_k1b"] for x in (
        cornell_launches, bench_launches, city_launches, cb_launches))

    # ---- 5. the primitives: kernels vs twins, then the tool ----
    prim_res = prim_cases(dev)
    t1_launches, t2_launches, t3_launches = run_prims(dev)

    # ---- 6. the entry points ----
    render_launches = run_render(dev)
    log(f"[render] closest-hit launches over the entry points: {render_launches}")
    textured_launches = run_textured_phase(dev)

    # ---- 7. fwd+grad: the train step, the port bench, the train example ----
    from hikari_tpu_torch.bench import bench_config

    del city, small_gpu, small_cpu
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, _, grad_settings = bench_config("cornell", dev)
    grad_state, grad_k1 = run_grad_path("cornell_bench", cornell, cam, grad_settings, dev)
    if profile:
        profile_frames("cornell_bench fwd+grad", grad_advance(cornell, cam, grad_settings, dev),
                       grad_state)
    del grad_state
    torch.cuda.empty_cache()
    log(f"[grad] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for label, s in GRAD_CHECKS:
        check_grad_small(label, cornell, cornell_cpu, cam_s, s(small), dev, GRAD_LOSS_RTOL,
                         GRAD_LEAF_REL)
    log(f"[grad check] {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    passes_launches = run_passes_phase(dev)
    log(f"[passes] closest-hit launches: {passes_launches}")
    torch.cuda.empty_cache()
    spatial_res, spatial_launches = run_spatial_phase(dev)
    log(f"[launches] closest-hit launches of this slice's paths: [output] {output_launches}, "
        f"[passes] {passes_launches}, [textured] {textured_launches}")
    bench_counts = run_bench_phase(dev)
    run_train_phase(dev)

    # ---- 12. pass-level remat, repeatability, the fwd+grad tools ----
    torch.cuda.empty_cache()
    run_remat_phase(cornell, cam, arrays, dev)
    run_tools_phase(dev)

    # ---- 13. the parallel layer: ranks sharing the card ----
    torch.cuda.empty_cache()
    run_sharded_phase(city_arrays, city_cam, smi)

    if "jax" in sys.modules or "hikari_tpu" in sys.modules:
        raise AssertionError("the port imported jax or hikari_tpu")

    def prim_entry(name, source, replaces, launches, key):
        err, ms, plain, bound, by, lib = prim_res[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by, "library_ms": lib}

    print(json.dumps({"kernels": [
        {
            "name": "closest_hit",
            "route": "cuda",
            "source": "hikari_tpu_torch/csrc/closest_hit.cu",
            "replaces": "hikari_tpu/trace/pallas_kernel.py:142",
            "launches": cornell_launches["closest_hit"] + dyn_k1,
            "max_abs_err": max(err_a, err_bf),
            "ms": ch_ms,
            "plain_ms": ch_plain_ms,
            "bound_ms": ch_bound,
            "bound_by": ch_by,
            "library_ms": None,
        },
        {
            "name": "closest_hit (K1b regime: tables above 2,048 triangles)",
            "route": "cuda",
            "source": "hikari_tpu_torch/csrc/closest_hit.cu",
            "replaces": "hikari_tpu/trace/pallas_kernel.py:168",
            "launches": k1b_launches,
            "max_abs_err": max(err_b, k1b_bench[0]),
            "ms": k1b_bench[1],
            "plain_ms": k1b_bench[2],
            "bound_ms": k1b_bench[3],
            "bound_by": k1b_bench[4],
            "library_ms": None,
        },
        {
            "name": "tile_walk",
            "route": "cuda",
            "source": "hikari_tpu_torch/csrc/tile_walk.cu",
            "replaces": "hikari_tpu/trace/pallas_tiled.py:96",
            "launches": city_launches["tile_walk"] + dyn_k2,
            "max_abs_err": max(err_c, err_d),
            "ms": tw_ms,
            "plain_ms": tw_plain_ms,
            "bound_ms": tw_bound,
            "bound_by": tw_by,
            "library_ms": None,
        },
        {
            "name": "scatter_items",
            "route": "cuda",
            "source": "hikari_tpu_torch/csrc/scatter_items.cu",
            "replaces": "hikari_tpu/trace/scatter.py:82",
            "launches": cb_launches["scatter_items"],
            "max_abs_err": max(err_e, err_f),
            "ms": sc_ms,
            "plain_ms": sc_plain_ms,
            "bound_ms": sc_bound,
            "bound_by": sc_by,
            "library_ms": None,
        },
        {
            "name": "tile_entries (K2 phase 1)",
            "route": "cuda",
            "source": "hikari_tpu_torch/csrc/tile_entries.cu",
            "replaces": "hikari_tpu/trace/tiled.py:89",
            "launches": city_launches["tile_entries"] + cb_launches["tile_entries"],
            "max_abs_err": err_p1,
            "ms": p1_ms,
            "plain_ms": p1_plain_ms,
            "bound_ms": p1_bound,
            "bound_by": p1_by,
            "library_ms": None,
        },
        {
            "name": "scatter_plan (K3 phases A and B)",
            "route": "cuda",
            "source": "hikari_tpu_torch/csrc/scatter_plan.cu",
            "replaces": "hikari_tpu/trace/scatter.py:242",
            "launches": city_launches["scatter_plan"] + cb_launches["scatter_plan"],
            "max_abs_err": max(err_pab),
            "ms": pab_ms,
            "plain_ms": pab_plain_ms,
            "bound_ms": pab_bound,
            "bound_by": pab_by,
            "library_ms": None,
        },
        prim_entry("window_pack", "hikari_tpu_torch/csrc/window_pack.cu",
                   "tools/bench_pallas_prims.py:153", t1_launches, "window_pack"),
        prim_entry("take_along (T2, single gather)", "hikari_tpu_torch/csrc/take_along.cu",
                   "tools/bench_pallas_prims.py:193", t2_launches, "take_along_T2"),
        prim_entry("take_along (T3, repeated gather)", "hikari_tpu_torch/csrc/take_along.cu",
                   "tools/bench_pallas_prims.py:227", t3_launches, "take_along_T3"),
        spatial_entry(spatial_res, spatial_launches),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
