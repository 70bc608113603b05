"""Time the main paths of several checkouts of this repository in turn on
one card, so that two versions compare inside one run (run them as parent,
change, change, parent).

    python -m hikari_tpu_torch.tools.ab_paths ROOT [ROOT ...]

Each ROOT is the root of a checkout (a directory holding
``hikari_tpu_torch`` and ``chip_smoke.py``). For each, a fresh process
builds that checkout's trace kernels and, per path, prints
``chip_smoke.run_main_path``'s ``[main]`` lines (8 frames: ms/frame, peak
memory, launches) and ``chip_smoke.profile_frames``' ``[profile]`` lines
(two more frames under torch.profiler: device busy share, launches, the
forward's and the backward's device time, the kernels and backward nodes
with the most device time), for the forward paths ``cornell_path`` and
``cornell_bench`` (1920x1080, the closest-hit kernel), ``city_path``
(512x512, the tile walk) and ``city_bench_scatter`` (512x512 from 256x256,
the scatter kernel); then ``chip_smoke.run_grad_path``'s ``[grad]`` lines
for 8 fwd+grad frames of the bench frame (``bench_config("cornell")``)
through ``parallel.make_train_step`` (ms/frame, peak memory, closest-hit
launches in the forward and the backward, each leaf's gradient) and its
``[profile]``.
"""

from __future__ import annotations

import os
import subprocess
import sys


def time_one(root: str) -> None:
    """Build and run the checkout at ``root`` (this process imports that
    checkout's package)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from hikari_tpu_torch.bench import bench_config
    from hikari_tpu_torch.io.scenes import city_config, cornell_box_scene, cornell_config
    from hikari_tpu_torch.scene import compile_scene, native, to_device
    from hikari_tpu_torch.trace import closest_hit as ch
    from hikari_tpu_torch.trace import scatter as sc
    from hikari_tpu_torch.trace import tile_walk as tw

    dev = torch.device("cuda", 0)
    label = os.path.basename(os.path.abspath(root))
    for build in (ch.build, tw.build, sc.build, native.get_builder):
        build()
    print(f"[ab] {label}", flush=True)
    cornell = to_device(compile_scene(cornell_box_scene()), dev)
    _, cam, settings = cornell_config(device=dev)
    city_scene, city_cam, city_settings = city_config(device=dev)
    city = to_device(compile_scene(city_scene), dev)
    h, w = cs.CORNELL_HW
    ch_, cw = cs.CITY_HW
    path = cs.path_settings(settings, w, h)
    city_path = cs.path_settings(city_settings, cw, ch_)
    cases = (
        ("cornell_path", cornell, cam, path),
        ("cornell_bench", cornell, cam, cs.bench_settings(path, w, h, "auto")),
        ("city_path", city, city_cam, city_path),
        ("city_bench_scatter", city, city_cam, cs.bench_settings(city_path, cw, ch_, "scatter")),
    )
    for name, scene, camera, s in cases:
        state, _ = cs.run_main_path(f"{name} ({label})", scene, camera, s, dev)
        cs.profile_frames(f"{name} ({label})", cs.render_advance(scene, camera, s), state)
        del state
        torch.cuda.empty_cache()
    _, _, grad = bench_config("cornell", dev)
    state, _ = cs.run_grad_path(f"cornell_bench ({label})", cornell, cam, grad, dev)
    cs.profile_frames(f"cornell_bench fwd+grad ({label})", cs.grad_advance(cornell, cam, grad, dev),
                      state)


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
