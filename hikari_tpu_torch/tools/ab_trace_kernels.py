"""Time the closest-hit kernel (K1), the tile walk (K2) and the scatter
kernel (K3) of several checkouts of this repository in turn on one card,
so that two versions compare inside one run (run them as parent, change,
change, parent).

    python -m hikari_tpu_torch.tools.ab_trace_kernels ROOT [ROOT ...]

Each ROOT is the root of a checkout (a directory holding
``hikari_tpu_torch`` and ``chip_smoke.py``). For each, a fresh process
builds that checkout's kernels and prints:

- ``[ab]``: the registers ptxas gave each kernel and the CUDA-event time
  of K1 on the 1080p cornell primary rays (case (a) of ``chip_smoke.py``),
  of K2 on the 512x512 city primary rays (case (c)) and of K3 on the same
  rays through the scatter plan (case (e));
- ``[tiles]``: at (c), the clusters tested per tile (max, p50, p90, sum)
  and the longest tile's lower bound: its pairs on one SM at 1/132 of the
  card's FP32 rate, and at 1/132 of its issue rate with the SASS count;
- ``[sass]``: for K2 and K3, the SASS instructions of the innermost loop
  that holds the pair tests (``cuobjdump -sass`` of the built library; the
  division's slow-path call left out), the pair tests it holds (one
  ``MUFU.RCP`` each: the division), the instructions per pair, and the
  issue floor they give: pairs x instructions per pair over the card's
  33.5 T lane-instructions a second (132 SMs x 4 schedulers x 32 lanes x
  1.98 GHz). With ``AB_SASS_DIR`` set, the listings are written there.
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


def sass_loop(sass: str, kernel: str):
    """(instructions, pair tests) of the innermost loop of ``kernel``'s pair
    tests in a ``cuobjdump -sass`` listing: the shortest backward-branch
    range that holds at least 8 ``MUFU.RCP`` (one per pair test: the
    division; the pair loops test a group of 8 rows per turn). Where a
    kernel has two versions of the loop (with and without the prim-range
    compares), this is the shorter, which runs when every ray of a warp
    takes the whole cluster. The division's slow path (a ``CALL`` with the
    ``MOV`` before and after it, taken only for operands outside the fast
    path's range) is left out of the count; every other instruction of the
    loop counts, so the count is what a pair costs when every branch in the
    loop falls through."""
    body, on = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            on = kernel in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if on and m:
            body.append((int(m.group(1), 16), m.group(2)))
    best = None
    for addr, ins in body:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) >= addr:
            continue
        span = [i for a, i in body if int(m.group(1), 16) <= a <= addr]
        if sum("MUFU.RCP" in i for i in span) >= 8 and (best is None or len(span) < len(best)):
            best = span
    if best is None:
        return 0, 0
    slow = 3 * sum("CALL" in i for i in best)
    return len(best) - slow, sum("MUFU.RCP" in i for i in best)


def kernel_sass(source) -> str:
    """``cuobjdump -sass`` of the built library of a ``csrc`` source."""
    from torch.utils.cpp_extension import CUDA_HOME

    from hikari_tpu_torch.utils.nvcc import library_path

    return subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                           str(library_path(source))], capture_output=True, text=True,
                          check=True).stdout


def per_pair(sass: str, kernel: str) -> float:
    """SASS instructions per pair test of ``kernel``'s innermost pair loop."""
    n_ins, n_pairs = sass_loop(sass, kernel)
    return n_ins / max(n_pairs, 1)


def issue_floor_ms(pairs: int, instructions_per_pair: float) -> float:
    return pairs * instructions_per_pair / INSTRUCTION_RATE * 1e3


def tested_stats(tested):
    """(max, p50, p90, sum) of the clusters tested per tile."""
    import torch

    x = tested.to(torch.float64)
    q = torch.quantile(x, torch.tensor([0.5, 0.9], dtype=torch.float64, device=x.device))
    return int(x.max()), float(q[0]), float(q[1]), int(x.sum())


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
    from hikari_tpu_torch.utils.nvcc import ptxas_summary

    dev = torch.device("cuda", 0)
    label = os.path.basename(os.path.abspath(root))
    ch.build()
    tw.build()
    sc.build()
    cornell = to_device(compile_scene(cornell_box_scene()), dev)
    _, cam, _ = cornell_config(device=dev)
    o, d = cam.pixel_rays(cs.CORNELL_HW)
    R = o.shape[0] * o.shape[1]
    k1_args = (o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(),
               torch.full((R,), DISTANCE_MAX, device=dev),
               torch.full((R,), -1, dtype=torch.int32, device=dev),
               torch.zeros((R,), dtype=torch.int32, device=dev),
               torch.full((R,), cornell.num_tris, dtype=torch.int32, device=dev),
               ch.pack_triangles(cornell))
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
    k2_ms = cs.cuda_time_ms(lambda: tw.tile_walk(*walk), 20)
    k3_ms = cs.cuda_time_ms(lambda: sc.scatter_items(meta, fields, packed_s), 20)
    regs = {name: ptxas_summary(log).split("Used ")[-1].split(",")[0]
            for name, log in (("K1", ch.build_log), ("K2", tw.build_log), ("K3", sc.build_log))}
    print(f"[ab] {root}: K1 (a) {k1_ms:.4f} ms ({regs['K1']}); K2 (c) {k2_ms:.4f} ms "
          f"({regs['K2']}); K3 (e) {k3_ms:.4f} ms ({regs['K3']})", flush=True)

    tested = tw.tile_walk(*walk)[4]
    cluster = walk[13]
    pairs_k2 = int(tested.sum()) * 512 * cluster
    pairs_k3 = int((meta[:, 1] > 0).sum()) * sc.BLOCK_R * sc.CLUSTER
    out = os.environ.get("AB_SASS_DIR")
    if out:
        os.makedirs(out, exist_ok=True)
    ipp = {}
    for name, mod, kernel, pairs in (("K2", tw, "tile_walk", pairs_k2),
                                     ("K3", sc, "scatter_items", pairs_k3)):
        sass = kernel_sass(mod.SOURCE)
        if out:
            with open(os.path.join(out, f"{label}_{name}.sass"), "w") as f:
                f.write(sass)
        n_ins, n_pairs = sass_loop(sass, kernel)
        ipp[name] = n_ins / max(n_pairs, 1)
        print(f"[sass] {label} {name}: innermost pair loop {n_ins} instructions for {n_pairs} "
              f"pair tests = {ipp[name]:.2f} a pair; issue floor {pairs} pairs x "
              f"{ipp[name]:.2f} / {INSTRUCTION_RATE / 1e12:.1f} T/s = "
              f"{issue_floor_ms(pairs, ipp[name]):.4f} ms", flush=True)
    mx, p50, p90, total = tested_stats(tested)
    longest = mx * 512 * cluster
    print(f"[tiles] {label} (c): clusters tested per tile over {tested.numel()} tiles: max {mx}, "
          f"p50 {p50:g}, p90 {p90:g}, sum {total}; longest tile {longest} pairs on one SM: "
          f"{longest * cs.PAIR_FLOPS / (cs.PEAK_FP32 / NUM_SMS) * 1e3:.4f} ms at 1/{NUM_SMS} of "
          f"the FP32 rate, {issue_floor_ms(longest, ipp['K2']) * NUM_SMS:.4f} ms at 1/{NUM_SMS} "
          f"of the issue rate", flush=True)


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
