"""Time the closest-hit kernel (K1) and the tile walk (K2) of several
checkouts of this repository in turn on one card, so that two versions
compare inside one run (run them as parent, change, change, parent).

    python -m hikari_tpu_torch.tools.ab_trace_kernels ROOT [ROOT ...]

Each ROOT is the root of a checkout (a directory holding
``hikari_tpu_torch`` and ``chip_smoke.py``). For each, a fresh process
builds that checkout's kernels and prints one line: the registers ptxas
gave each kernel and the CUDA-event time of K1 on the 1080p cornell primary
rays (case (a) of ``chip_smoke.py``) and of K2 on the 512x512 city primary
rays (case (c)).
"""

from __future__ import annotations

import os
import subprocess
import sys


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
    from hikari_tpu_torch.trace import tile_walk as tw
    from hikari_tpu_torch.utils.nvcc import ptxas_summary

    dev = torch.device("cuda", 0)
    ch.build()
    tw.build()
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
    walk, _ = cs.walk_case(
        city, co.reshape(-1, 3).contiguous(), cd.reshape(-1, 3).contiguous(),
        torch.full((Rc,), DISTANCE_MAX, device=dev), torch.zeros((Rc,), device=dev),
        torch.full((Rc,), -1, dtype=torch.int32, device=dev),
        torch.zeros((Rc,), dtype=torch.int32, device=dev),
        torch.full((Rc,), city.num_tris, dtype=torch.int32, device=dev))
    k1_ms = cs.cuda_time_ms(lambda: ch.closest_hit(*k1_args), 50)
    k2_ms = cs.cuda_time_ms(lambda: tw.tile_walk(*walk), 20)
    regs = {name: ptxas_summary(log).split("Used ")[-1].split(",")[0]
            for name, log in (("K1", ch.build_log), ("K2", tw.build_log))}
    print(f"[ab] {root}: K1 (a) {k1_ms:.4f} ms ({regs['K1']}); K2 (c) {k2_ms:.4f} ms "
          f"({regs['K2']})", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        time_one(argv[1])
        return 0
    for root in argv:
        root = os.path.abspath(root)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True,
                       cwd=root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
