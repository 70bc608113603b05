"""Time the fwd+grad train step of several checkouts of this repository in
turn on one card, so that two versions compare inside one run (run them
as parent, change, change, parent).

    python -m hikari_tpu_torch.tools.ab_grad ROOT [ROOT ...]

Each ROOT is the root of a checkout (a directory holding
``hikari_tpu_torch`` and ``chip_smoke.py``). For each, a fresh process
builds that checkout's closest-hit kernel and prints:

- ``[grad]``: ``chip_smoke.run_grad_path``: 8 fwd+grad frames of
  ``cornell_bench`` (1920x1080 from 960x540) through
  ``parallel.make_train_step``, ms/frame, peak memory, closest-hit
  launches in the forward and the backward, each leaf's gradient;
- ``[profile]``: two more such frames under torch.profiler
  (``chip_smoke.profile_frames``): device busy share, launches, the
  forward's and the backward's device time, the kernels and the backward
  nodes with the most device time.
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
    from hikari_tpu_torch.io.scenes import cornell_box_scene, cornell_config
    from hikari_tpu_torch.scene import compile_scene, native, to_device
    from hikari_tpu_torch.trace import closest_hit as ch

    dev = torch.device("cuda", 0)
    label = os.path.basename(os.path.abspath(root))
    ch.build()
    native.get_builder()
    print(f"[ab] {label}", flush=True)
    cornell = to_device(compile_scene(cornell_box_scene()), dev)
    _, cam, _ = cornell_config(device=dev)
    _, _, settings = bench_config("cornell", dev)
    state, _ = cs.run_grad_path(f"cornell_bench ({label})", cornell, cam, settings, dev)
    cs.profile_frames(f"cornell_bench fwd+grad ({label})",
                      cs.grad_advance(cornell, cam, settings, dev), state)


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
