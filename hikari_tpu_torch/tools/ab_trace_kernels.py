"""Time the closest-hit kernel (K1/K1b), the tile walk (K2), the scatter
kernel (K3) and the gathers (T2/T3) of several checkouts of this
repository in turn on one card, so that two versions compare inside one
run (run them as parent, change, change, parent).

    python -m hikari_tpu_torch.tools.ab_trace_kernels [--slab] ROOT [ROOT ...]

Each ROOT is the root of a checkout (a directory holding
``hikari_tpu_torch`` and ``chip_smoke.py``). For each, a fresh process
builds that checkout's kernels and prints (with ``--slab`` only the
``[slab]``, ``[sass]`` and ``[bench_trace]`` lines):

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
- ``[slab]``: the slab-test phases: K2·p1 (``tile_cluster_entries``) at
  (c) and (d) and K3·pAB (``scatter_plan``) at (e) and (f), CUDA-event ms
  of the call and, for K3·pAB, the device time of its kernels under
  torch.profiler (the whole call also runs torch's scan and block map
  between its launches);
  then for each the SASS of its innermost test loop: instructions on the
  loop's common path per slab test (the loop whose common path has the
  fewest a test; a test is six ``FMUL``, the slab's products: nothing else
  in those kernels multiplies), the tests of one call and the issue floor
  they give;
- ``[bench_trace]`` (``--slab`` only): the pallas_tiled and scatter rows
  of the trace bench on city-551k and terrain-1m, with rates and peaks;
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
    best = None
    for body in _functions(sass, kernel):  # each function (template instance) on its own addresses
        for span in _loops(body):
            if sum("MUFU.RCP" in i for _, i in span) >= 8 and (best is None or len(span) < len(best)):
                best = span
    if best is None:
        return 0, 0, 0
    skipped = _skipped(best, "MUFU.RCP")
    return len(best), len(best) - len(skipped), sum("MUFU.RCP" in i for _, i in best)


def slab_loop(sass: str, kernel: str):
    """(instructions, common-path instructions, slab tests) of the test
    loop of ``kernel`` (a function whose name holds it) in a ``cuobjdump
    -sass`` listing: among the backward-branch ranges that hold at least
    one test (six ``FMUL``: the slab's products), the one whose common
    path has the fewest instructions a test, i.e. the innermost unrolled
    loop of the warps that take the test without NaN and range compares.
    The common path leaves out what a forward branch inside the loop skips
    when it holds no ``FMUL`` (the parent's shuffle tree of a warp where
    a ray enters)."""
    best, best_rate = (0, 0, 0), None
    for body in _functions(sass, kernel):
        for span in _loops(body):
            tests = sum("FMUL" in i for _, i in span) // 6
            if tests == 0:
                continue
            common = len(span) - len(_skipped(span, "FMUL"))
            if best_rate is None or common / tests < best_rate:
                best, best_rate = (len(span), common, tests), common / tests
    return best


def _functions(sass: str, kernel: str):
    """Each function of the listing whose name holds ``kernel``: a list of
    (address, instruction)."""
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
    return bodies


def _loops(body):
    """The backward-branch ranges of a function, each a list of
    (address, instruction)."""
    for addr, ins in body:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            yield [(a, i) for a, i in body if int(m.group(1), 16) <= a <= addr]


def _skipped(span, marker: str) -> set:
    """Addresses of ``span`` that a forward branch inside it skips, where
    the skipped part holds no ``marker``."""
    skipped = set()
    for addr, ins in span:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if not m or not addr < int(m.group(1), 16) <= span[-1][0]:
            continue
        inside = [(a, i) for a, i in span if addr < a < int(m.group(1), 16)]
        if not any(marker in i for _, i in inside):
            skipped.update(a for a, _ in inside)
    return skipped


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


def kernel_ms(fn, iters, names) -> dict:
    """Device ms per call of ``fn``'s kernels whose names hold one of
    ``names``, kernel by kernel (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    short = re.compile(r"^.*?(\w+(?:<[^(]*>)?)\(.*$")
    return {short.sub(r"\1", e.key): e.self_device_time_total / iters / 1e3
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and any(n in e.key for n in names)}


def slab_lines(cs, label, city, co, cd, dev) -> None:
    """[slab]: K2·p1 at (c) and K3·pAB at (e), CUDA-event ms of the call
    (and device time of K3·pAB's kernels), their SASS a test and issue
    floors."""
    import torch

    from hikari_tpu_torch.config import DISTANCE_MAX
    from hikari_tpu_torch.trace import api
    from hikari_tpu_torch.trace import scatter as sc
    from hikari_tpu_torch.trace import tile_walk as tw
    from hikari_tpu_torch.trace import tiled as ttiled

    R = co.shape[0]
    maxd = torch.full((R,), DISTANCE_MAX, device=dev)
    lo = torch.zeros((R,), dtype=torch.int32, device=dev)
    hi = torch.full((R,), city.num_tris, dtype=torch.int32, device=dev)
    # (c): the rays sorted into tiles as trace_rays sorts them.
    cluster, _ = api.tile_cluster_rule(city.tri_n.shape[0])
    order = api.ray_sort_order(city, co, cd)
    oc, dc = co[order].contiguous(), cd[order].contiguous()
    _, cmin, cmax, cvalid, prange, cond = tw.tile_clusters(city, cluster)
    p1 = (cmin, cmax, cvalid, oc, ttiled.safe_inv_dir(dc), maxd, lo, hi, prange, city.num_tris,
          tw.ray_margin(oc, cond))
    p1_ms = cs.cuda_time_ms(lambda: ttiled.tile_cluster_entries(*p1), 20)
    _, cmin_s, cmax_s, cvalid_s = tw.pack_clusters(city, sc.CLUSTER)
    pab = (cmin_s, cmax_s, cvalid_s, co, cd, maxd, lo, hi)
    pab_call = cs.cuda_time_ms(lambda: sc.scatter_plan(*pab), 10)
    names = ("scatter_plan", "slab_table")
    pab_dev = cs.device_ms(lambda: sc.scatter_plan(*pab), 10, names=names)
    each = kernel_ms(lambda: sc.scatter_plan(*pab), 10, names)
    tests_c, tests_e = R * cmin.shape[0], R * cmin_s.shape[0]
    print(f"[slab] {label}: K2·p1 (c) {R} rays x {cmin.shape[0]} clusters: {p1_ms:.4f} ms; "
          f"K3·pAB (e) {R} rays x {cmin_s.shape[0]} clusters: the call {pab_call:.4f} ms, its "
          f"kernels {pab_dev:.4f} ms device (" + ", ".join(f"{k} {v:.4f}" for k, v in each.items())
          + ")", flush=True)
    # (d)/(f): the random rays of chip_smoke's cases, whose warps take the
    # mixed-octant and ranged forms of the test.
    _, phase1_d = cs.walk_case(city, *cs.city_random_rays(city, dev))
    p1_d = cs.cuda_time_ms(lambda: ttiled.tile_cluster_entries(
        *phase1_d[:4], ttiled.safe_inv_dir(phase1_d[4]), *phase1_d[5:]), 20)
    o, d, maxd_f, _, _, lo_f, hi_f = cs.city_random_rays(city, dev)
    pab_f = (cmin_s, cmax_s, cvalid_s, o, d, maxd_f, lo_f, hi_f)
    f_call = cs.cuda_time_ms(lambda: sc.scatter_plan(*pab_f), 10)
    f_dev = cs.device_ms(lambda: sc.scatter_plan(*pab_f), 10, names=names)
    print(f"[slab] {label}: K2·p1 (d) {o.shape[0]} random rays x {cmin.shape[0]} clusters: "
          f"{p1_d:.4f} ms; K3·pAB (f) the same rays x {cmin_s.shape[0]} clusters: the call "
          f"{f_call:.4f} ms, its kernels {f_dev:.4f} ms device", flush=True)
    out = os.environ.get("AB_SASS_DIR")
    for name, mod, kernel, tests in (("K2·p1", ttiled, "tile_entries", tests_c),
                                     ("K3·pAB", sc, "scatter_plan", tests_e)):
        source = mod.SOURCE if mod is ttiled else mod.PLAN_SOURCE
        sass = kernel_sass(source)
        if out:
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, f"{label}_{name.replace('·', '_')}.sass"), "w") as f:
                f.write(sass)
        n_ins, n_common, n_tests = slab_loop(sass, kernel)
        ipt = n_common / max(n_tests, 1)
        regs = "/".join(map(str, registers(source, kernel).values()))
        print(f"[sass] {label} {name}: test loop {n_ins} instructions, {n_common} on its common "
              f"path, for {n_tests} slab tests = {ipt:.2f} a test ({regs} registers); issue floor "
              f"{tests} tests (one a pair) x {ipt:.2f} / {INSTRUCTION_RATE / 1e12:.1f} T/s = "
              f"{issue_floor_ms(tests, ipt):.4f} ms", flush=True)


def bench_lines(label, dev) -> None:
    """[bench_trace]: the checkout's ``bench_trace.measure`` of the
    pallas_tiled and scatter rows of city-551k and terrain-1m (the bench's
    rays and budgets), each with its rate, the memory live before it and
    its peak; for scatter also the bytes of the plan's ballot masks at the
    row's shape (what this design adds over the parent's)."""
    import torch

    from hikari_tpu_torch import bench_trace as bt
    from hikari_tpu_torch.scene import compile_scene, to_device
    from hikari_tpu_torch.trace import scatter as sc

    for name, stress in (("city-551k", False), ("terrain-1m", True)):
        buffers = to_device(compile_scene(bt.build_scenes(stress=stress)[name]), dev)
        o, d = bt.make_rays(buffers, 1 << 20, device=dev)
        for method in ("pallas_tiled", "scatter"):
            n = bt.ray_budget(method, buffers.num_tris, o.shape[0])
            torch.cuda.synchronize()
            live = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            m = bt.measure(buffers, o[:n], d[:n], method)
            peak = torch.cuda.max_memory_allocated(dev)
            clusters = -(-buffers.num_tris // sc.CLUSTER)
            masks = (f"; ballot masks of {n} rays x ~{clusters} clusters "
                     f"{-(-n // 32) * clusters * 4 / 2**30:.4f} GiB" if method == "scatter" else "")
            print(f"[bench_trace] {label} {name}/{method}: {n} rays, {m['rays_per_s']:.6g} rays/s "
                  f"({m['seconds'] * 1e3:.4f} ms a call, {m['trace_calls']} calls); memory live "
                  f"before {live / 2**30:.4f} GiB, peak {peak / 2**30:.4f} GiB{masks}", flush=True)
        del buffers, o, d
        torch.cuda.empty_cache()


def time_one(root: str, slab_only: bool = False) -> None:
    """Build and time the kernels of the checkout at ``root`` (this
    process imports that checkout's package); with ``slab_only`` only the
    slab-test phases."""
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
    if slab_only:
        scene, city_cam, _ = city_config(device=dev)
        city = to_device(compile_scene(scene), dev)
        co, cd = city_cam.pixel_rays(cs.CITY_HW)
        slab_lines(cs, label, city, co.reshape(-1, 3).contiguous(),
                   cd.reshape(-1, 3).contiguous(), dev)
        del city, co, cd
        torch.cuda.empty_cache()
        bench_lines(label, dev)
        return
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
    slab_lines(cs, label, city, co, cd, dev)
    prims_line(cs, label, dev)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    slab = argv[:1] == ["--slab"]
    argv = argv[1:] if slab else argv
    if argv[:1] == ["--one"]:
        time_one(argv[1], slab)
        return 0
    env = dict(os.environ)
    if env.get("AB_SASS_DIR"):
        env["AB_SASS_DIR"] = os.path.abspath(env["AB_SASS_DIR"])
    for root in argv:
        root = os.path.abspath(root)
        subprocess.run([sys.executable, os.path.abspath(__file__)] + ["--slab"] * slab
                       + ["--one", root], check=True, cwd=root, env=env)
    return 0


if __name__ == "__main__":
    sys.exit(main())
