"""Time the closest-hit kernel (K1/K1b), the tile walk (K2), the scatter
kernel (K3) and the gathers (T2/T3) of several checkouts of this
repository in turn on one card, so that two versions compare inside one
run (run them as parent, change, change, parent).

    python -m hikari_tpu_torch.tools.ab_trace_kernels ROOT [ROOT ...]

Each ROOT is the root of a checkout (a directory holding
``hikari_tpu_torch`` and ``chip_smoke.py``). For each, a fresh process
builds that checkout's kernels and prints:

- ``[ab]``: the registers ptxas gave each kernel and the CUDA-event time
  of K1 on the 1080p cornell primary rays (case (a) of ``chip_smoke.py``)
  and on the 65,536 rays x 5,120 triangles soup (case (b), K1b's regime),
  of K2 on the 512x512 city primary rays (case (c)) and of K3 on the same
  rays through the scatter plan (case (e));
- ``[rays]``: K1 on the first N of (a)'s rays, N from 16,384 to all, and
- ``[entry]``: K1 over the real calls of frame 2 of ``examples/render``
  for cornell at 128 and 256 px and minimal at 256 px, recorded as the
  frames run and replayed: device time under torch.profiler, since below
  ~10^6 rays a call is shorter than its launch from the host;
- ``[frames]``: K1 over the real calls of two ``cornell_path`` frames
  (frames 2-3 at 1920x1080: primary, shadow, emissive-target and bounce
  rays), recorded as the frames run and replayed under CUDA events;
- ``[tiles]``: at (c), the clusters tested per tile (max, p50, p90, sum)
  and the longest tile's lower bound: its pairs on one SM at 1/132 of the
  card's FP32 rate, and at 1/132 of its issue rate with the SASS count;
- ``[sass]``: for K1, K2 and K3, the SASS instructions of the innermost
  loop that holds the pair tests (``cuobjdump -sass`` of the built
  library), all of them and those of its common path (what forward
  branches skip when no ray of the warp takes the pair left out: the
  update of the best and the division's slow path), the pair tests it
  holds (one ``MUFU.RCP`` each: the division), the instructions per pair,
  and the issue floor the common path gives: pairs x its instructions per
  pair over the card's 33.5 T lane-instructions a second (132 SMs x 4
  schedulers x 32 lanes x 1.98 GHz); for K1 also the resident warps per SM at (a) and (b)
  (the card's occupancy query).
  With ``AB_SASS_DIR`` set, the listings are written there;
- ``[prims]``: the device time per call under torch.profiler of T2 at
  (512, 512) and T3 at the TPU tool's four shapes, of ``torch.gather`` at
  T2's shape and T3's x1 shape, and, where the checkout has it, of an
  empty kernel of the gathers' launch shape (their launch floor).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

# Lane-instructions a second of one H100 SXM at its 1.98 GHz boost: one
# warp instruction a clock from each of the 4 schedulers of the 132 SMs
# (half the FP32 peak, which counts a multiply-add as two flops).
INSTRUCTION_RATE = 132 * 4 * 32 * 1.98e9
NUM_SMS = 132
# [rays]: K1 on the first N cornell primary rays of (a), from the entry
# points' 128x128 and 256x256 frames to the 1080p frame.
RAY_COUNTS = (16384, 65536, 131072, 262144, 524288, 1048576, 2073600)
# [entry]: the render entry points' cornell and minimal frames.
ENTRY_CASES = (("cornell", 128), ("cornell", 256), ("minimal", 256))


def sass_loop(sass: str, kernel: str):
    """(instructions, common-path instructions, pair tests) of the innermost
    loop of ``kernel``'s pair tests in a ``cuobjdump -sass`` listing: the
    shortest backward-branch range, within one function whose name holds
    ``kernel``, that holds at least 8 ``MUFU.RCP`` (one per pair test: the
    division; the pair loops test a group of 8 rows per turn). Where a
    kernel has two versions of the loop (with and without the prim-range
    compares), this is the shorter, which runs when every ray of a warp
    takes the whole cluster. The common path leaves out what a forward
    branch inside the loop skips when that holds no pair test: the
    division's slow path (a ``CALL`` taken only for operands outside the
    fast path's range) and the update of the best, which a warp runs only
    when one of its rays takes the pair. It is what a pair costs when no
    ray of the warp takes it, the usual case."""
    bodies, body = [], None
    for line in sass.splitlines():
        if "Function :" in line:
            body = [] if kernel in line else None
            if body is not None:
                bodies.append(body)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if body is not None and m:
            body.append((int(m.group(1), 16), m.group(2)))
    best = None
    for body in bodies:  # each function (template instance) on its own addresses
        for addr, ins in body:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
            if not m or int(m.group(1), 16) >= addr:
                continue
            span = [(a, i) for a, i in body if int(m.group(1), 16) <= a <= addr]
            if sum("MUFU.RCP" in i for _, i in span) >= 8 and (best is None or len(span) < len(best)):
                best = span
    if best is None:
        return 0, 0, 0
    skipped = set()
    for addr, ins in best:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if not m or not addr < int(m.group(1), 16) <= best[-1][0]:
            continue
        inside = [(a, i) for a, i in best if addr < a < int(m.group(1), 16)]
        if not any("MUFU.RCP" in i for _, i in inside):
            skipped.update(a for a, _ in inside)
    return len(best), len(best) - len(skipped), sum("MUFU.RCP" in i for _, i in best)


def cuobjdump(source, flag: str) -> str:
    """``cuobjdump FLAG`` of the built library of a ``csrc`` source."""
    from torch.utils.cpp_extension import CUDA_HOME

    from hikari_tpu_torch.utils.nvcc import library_path

    return subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), flag,
                           str(library_path(source))], capture_output=True, text=True,
                          check=True).stdout


def kernel_sass(source) -> str:
    """``cuobjdump -sass`` of the built library of a ``csrc`` source."""
    return cuobjdump(source, "-sass")


def registers(source, kernel: str) -> dict:
    """{function: registers} of the built library of a ``csrc`` source
    (``cuobjdump -res-usage``), for the functions whose (mangled) name
    holds ``kernel``."""
    out, name = {}, None
    for line in cuobjdump(source, "-res-usage").splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and name and kernel in name:
            out[name] = int(m.group(1))
    return out


def per_pair(sass: str, kernel: str) -> float:
    """Common-path SASS instructions per pair test of ``kernel``'s
    innermost pair loop."""
    _, n_common, n_pairs = sass_loop(sass, kernel)
    return n_common / max(n_pairs, 1)


def issue_floor_ms(pairs: int, instructions_per_pair: float) -> float:
    return pairs * instructions_per_pair / INSTRUCTION_RATE * 1e3


def tested_stats(tested):
    """(max, p50, p90, sum) of the clusters tested per tile."""
    import torch

    x = tested.to(torch.float64)
    q = torch.quantile(x, torch.tensor([0.5, 0.9], dtype=torch.float64, device=x.device))
    return int(x.max()), float(q[0]), float(q[1]), int(x.sum())


def cornell_frame_calls(cs, ch, cornell, cam, settings, dev):
    """The closest-hit calls of ``cornell_path`` frames 2-3 (1920x1080),
    recorded as the frames run: a list of argument tuples."""
    import torch

    from hikari_tpu_torch.render.pipeline import initial_state, render_frame
    from hikari_tpu_torch.trace import api

    calls = []

    def recording(*args):
        calls.append(args)
        return ch.closest_hit(*args)

    settings = cs.path_settings(settings, cs.CORNELL_HW[1], cs.CORNELL_HW[0])
    state = initial_state(settings, dev)
    api.closest_hit = recording
    try:
        with torch.no_grad():
            for frame in range(3):
                if frame == 1:
                    calls.clear()
                _, state = render_frame(cornell, cam, state, settings)
    finally:
        api.closest_hit = ch.closest_hit
    return calls


def entry_calls(ch, name, size, dev):
    """The closest-hit calls of frame 2 of ``examples/render NAME --size
    SIZE``, recorded as the frames run: a list of argument tuples."""
    import torch

    from hikari_tpu_torch.examples.render import make_config
    from hikari_tpu_torch.render import initial_state, render_frame
    from hikari_tpu_torch.scene import build_scene_buffers
    from hikari_tpu_torch.trace import api

    scene, cam, settings = make_config(name, size, dev)
    buffers = build_scene_buffers(scene, dev)
    state = initial_state(settings, dev)
    calls = []

    def recording(*args):
        calls.append(args)
        return ch.closest_hit(*args)

    api.closest_hit = recording
    try:
        with torch.no_grad():
            for frame in range(2):
                calls.clear()
                _, state = render_frame(buffers, cam, state, settings)
    finally:
        api.closest_hit = ch.closest_hit
    return calls


def prims_line(cs, label, dev) -> None:
    """[prims]: T2/T3 (each first checked equal to its twin), ``torch.gather``
    and the launch floor, device time per call under torch.profiler."""
    import torch

    from hikari_tpu_torch.tools import prims

    g = torch.Generator().manual_seed(5)

    def case(m, n, axis, reps=1):
        x = (torch.arange(m * n, dtype=torch.float32) * 1e-4).reshape(m, n).to(dev)
        idx = torch.randint(0, (m, n)[axis], (m, n), generator=g, dtype=torch.int32).to(dev)
        if not torch.equal(prims.take_along_sum(x, idx, axis, reps),
                           prims.take_along_sum_reference(x, idx, axis, reps)):
            raise AssertionError(f"{label}: take_along ({m}, {n}) axis {axis} x{reps} differs "
                                 "from its twin")
        return x, idx

    x, idx = case(512, 512, 0)
    idx_64 = idx.long()
    t2_us = cs.device_ms(lambda: prims.take_along_sum(x, idx, 0), 200) * 1e3
    gather_us = cs.device_ms(lambda: torch.gather(x, 0, idx_64), 200) * 1e3
    parts = [f"T2 (512, 512) axis 0 {t2_us:.2f} us", f"torch.gather there {gather_us:.2f} us"]
    for (m, n), axis, reps in cs.GATHER_CASES:
        x3, idx3 = case(m, n, axis, reps)
        us = cs.device_ms(lambda: prims.take_along_sum(x3, idx3, axis, reps), 200) * 1e3
        parts.append(f"T3 ({m}, {n}) axis {axis} x{reps} {us:.2f} us")
        if reps == 1:
            idx3_64 = idx3.long()
            us = cs.device_ms(lambda: torch.gather(x3, axis, idx3_64), 200) * 1e3
            parts.append(f"torch.gather there {us:.2f} us")
    if hasattr(prims, "take_along_empty"):
        us = cs.device_ms(lambda: prims.take_along_empty((512, 512), dev), 200) * 1e3
        parts.append(f"empty kernel of T2's launch shape {us:.2f} us")
    print(f"[prims] {label}: device time per call: " + "; ".join(parts), flush=True)


def time_one(root: str) -> None:
    """Build and time the kernels of the checkout at ``root`` (this
    process imports that checkout's package)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from hikari_tpu_torch.config import DISTANCE_MAX
    from hikari_tpu_torch.io.scenes import city_config, cornell_box_scene, cornell_config
    from hikari_tpu_torch.scene import compile_scene, to_device
    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.trace import scatter as sc
    from hikari_tpu_torch.trace import tile_walk as tw

    dev = torch.device("cuda", 0)
    label = os.path.basename(os.path.abspath(root))
    ch.build()
    tw.build()
    sc.build()
    cornell = to_device(compile_scene(cornell_box_scene()), dev)
    _, cam, cornell_settings = cornell_config(device=dev)
    o, d = cam.pixel_rays(cs.CORNELL_HW)
    R = o.shape[0] * o.shape[1]
    k1_args = (o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(),
               torch.full((R,), DISTANCE_MAX, device=dev),
               torch.full((R,), -1, dtype=torch.int32, device=dev),
               torch.zeros((R,), dtype=torch.int32, device=dev),
               torch.full((R,), cornell.num_tris, dtype=torch.int32, device=dev),
               ch.pack_triangles(cornell))
    soup = cs.soup_case(dev)
    scene, city_cam, _ = city_config(device=dev)
    city = to_device(compile_scene(scene), dev)
    co, cd = city_cam.pixel_rays(cs.CITY_HW)
    Rc = co.shape[0] * co.shape[1]
    co, cd = co.reshape(-1, 3).contiguous(), cd.reshape(-1, 3).contiguous()
    maxd = torch.full((Rc,), DISTANCE_MAX, device=dev)
    excl = torch.full((Rc,), -1, dtype=torch.int32, device=dev)
    lo = torch.zeros((Rc,), dtype=torch.int32, device=dev)
    hi = torch.full((Rc,), city.num_tris, dtype=torch.int32, device=dev)
    walk, _ = cs.walk_case(city, co, cd, maxd, torch.zeros((Rc,), device=dev), excl, lo, hi)
    packed_s, cmin_s, cmax_s, cvalid_s = tw.pack_clusters(city, sc.CLUSTER)
    meta, items, _ = sc.scatter_plan(cmin_s, cmax_s, cvalid_s, co, cd, maxd, lo, hi)
    fields = sc.item_fields(items, co, cd, maxd, excl, lo, hi)
    k1_ms = cs.cuda_time_ms(lambda: ch.closest_hit(*k1_args), 50)
    k1b_ms = cs.cuda_time_ms(lambda: ch.closest_hit(*soup), 20)
    k2_ms = cs.cuda_time_ms(lambda: tw.tile_walk(*walk), 20)
    k3_ms = cs.cuda_time_ms(lambda: sc.scatter_items(meta, fields, packed_s), 20)
    regs = {name: "/".join(map(str, registers(mod.SOURCE, kernel).values())) + " registers"
            for name, mod, kernel in (("K1", ch, "closest_hit_kernel"), ("K2", tw, "tile_walk"),
                                      ("K3", sc, "scatter_items"))}
    print(f"[ab] {root}: K1 (a) {k1_ms:.4f} ms, K1b (b) {k1b_ms:.4f} ms ({regs['K1']}); K2 (c) "
          f"{k2_ms:.4f} ms ({regs['K2']}); K3 (e) {k3_ms:.4f} ms ({regs['K3']})", flush=True)

    sweep = []
    for n in RAY_COUNTS:
        args = tuple(a[:n] for a in k1_args[:6]) + k1_args[6:]
        sweep.append(f"{n} {cs.device_ms(lambda: ch.closest_hit(*args), 50):.4f}")
    print(f"[rays] {label}: K1 on the first N rays of (a) x {cornell.num_tris} tris, device "
          "time per call under torch.profiler, N ms: " + ", ".join(sweep), flush=True)
    for name, size in ENTRY_CASES:
        calls = entry_calls(ch, name, size, dev)
        ms = cs.device_ms(lambda: [ch.closest_hit(*a) for a in calls], 20)
        print(f"[entry] {label}: K1 over the {len(calls)} closest-hit calls of frame 2 of "
              f"examples/render {name} --size {size} ({sum(a[0].shape[0] for a in calls)} rays, "
              f"{calls[0][6].shape[0]} tris): {ms:.4f} ms device time under torch.profiler",
              flush=True)
        del calls

    calls = cornell_frame_calls(cs, ch, cornell, cam, cornell_settings, dev)
    rays = sum(a[0].shape[0] for a in calls)
    full = sum(int(((a[4] <= 0) & (a[5] >= a[6].shape[0])).sum()) for a in calls)
    empty = sum(int((a[4] >= a[5]).sum()) for a in calls)
    frame_ms = cs.cuda_time_ms(lambda: [ch.closest_hit(*a) for a in calls], 10)
    print(f"[frames] {label}: K1 over the {len(calls)} closest-hit calls of cornell_path frames "
          f"2-3 ({rays} rays: {full} with the whole table, {empty} with an empty prim range, "
          f"{rays - full - empty} with a part): {frame_ms:.4f} ms (CUDA events, the calls "
          f"replayed in order)", flush=True)
    del calls

    tested = tw.tile_walk(*walk)[4]
    cluster = walk[13]
    P, Rs, Ps = cornell.num_tris, soup[0].shape[0], soup[6].shape[0]
    pairs_k1, pairs_k1b = R * P, Rs * Ps
    pairs_k2 = int(tested.sum()) * 512 * cluster
    pairs_k3 = int((meta[:, 1] > 0).sum()) * sc.BLOCK_R * sc.CLUSTER
    out = os.environ.get("AB_SASS_DIR")
    if out:
        os.makedirs(out, exist_ok=True)
    ipp = {}
    for name, mod, kernel, pairs in (("K1", ch, "closest_hit_kernel", pairs_k1),
                                     ("K2", tw, "tile_walk", pairs_k2),
                                     ("K3", sc, "scatter_items", pairs_k3)):
        sass = kernel_sass(mod.SOURCE)
        if out:
            with open(os.path.join(out, f"{label}_{name}.sass"), "w") as f:
                f.write(sass)
        n_ins, n_common, n_pairs = sass_loop(sass, kernel)
        ipp[name] = n_common / max(n_pairs, 1)
        print(f"[sass] {label} {name}: innermost pair loop {n_ins} instructions, {n_common} on "
              f"its common path, for {n_pairs} pair tests = {n_ins / max(n_pairs, 1):.2f} / "
              f"{ipp[name]:.2f} a pair; issue floor (common path) {pairs} pairs x "
              f"{ipp[name]:.2f} / {INSTRUCTION_RATE / 1e12:.1f} T/s = "
              f"{issue_floor_ms(pairs, ipp[name]):.4f} ms", flush=True)
    # Resident warps from the card's occupancy query, where the checkout
    # has it.
    warps = ((ch.warps_per_sm(P), ch.warps_per_sm(Ps)) if hasattr(ch, "warps_per_sm")
             else ("not reported",) * 2)
    print(f"[sass] {label} K1b (b): issue floor {pairs_k1b} pairs x {ipp['K1']:.2f} = "
          f"{issue_floor_ms(pairs_k1b, ipp['K1']):.4f} ms; K1 resident warps per SM: (a) "
          f"{warps[0]}, (b) {warps[1]}", flush=True)
    mx, p50, p90, total = tested_stats(tested)
    longest = mx * 512 * cluster
    print(f"[tiles] {label} (c): clusters tested per tile over {tested.numel()} tiles: max {mx}, "
          f"p50 {p50:g}, p90 {p90:g}, sum {total}; longest tile {longest} pairs on one SM: "
          f"{longest * cs.PAIR_FLOPS / (cs.PEAK_FP32 / NUM_SMS) * 1e3:.4f} ms at 1/{NUM_SMS} of "
          f"the FP32 rate, {issue_floor_ms(longest, ipp['K2']) * NUM_SMS:.4f} ms at 1/{NUM_SMS} "
          f"of the issue rate", flush=True)
    prims_line(cs, label, dev)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        time_one(argv[1])
        return 0
    env = dict(os.environ)
    if env.get("AB_SASS_DIR"):
        env["AB_SASS_DIR"] = os.path.abspath(env["AB_SASS_DIR"])
    for root in argv:
        root = os.path.abspath(root)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True,
                       cwd=root, env=env)
    return 0


if __name__ == "__main__":
    sys.exit(main())
