"""Time the main paths of several checkouts of this repository in turn on
one card, so that two versions compare inside one run (run them in
alternating pairs: parent, change, change, parent, parent, change).

    python -m hikari_tpu_torch.tools.ab_paths ROOT [ROOT ...]

Each ROOT is the root of a checkout (a directory holding
``hikari_tpu_torch`` and ``chip_smoke.py``); a root may be given more
than once. For each, a fresh process builds that checkout's trace
kernels and, per path, prints ``chip_smoke.run_main_path``'s ``[main]`` lines (8 frames: ms/frame, peak
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
``[profile]``. At the end, per path, every run's device ms of the two
profiled frames with the peak memory of its 8 frames, read from those
lines (``[readings]``).
"""

from __future__ import annotations

import os
import re
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


def readings(stdout: str, run: int) -> list:
    """(path, run, device ms of the two profiled frames, peak GiB of the 8
    frames) of one run's output, from its ``[profile]`` and
    ``[main]``/``[grad]`` lines."""
    peaks, out = {}, []
    for line in stdout.splitlines():
        m = re.match(r"\[(?:main|grad)\] (.+?) \(.*peak memory ([0-9.]+) GiB", line)
        if m:
            peaks[m.group(1)] = float(m.group(2))
        m = re.match(r"\[profile\] (.+?) \([^)]*\), \d+ frames: .*device busy ([0-9.]+) ms", line)
        if m:
            path = m.group(1)
            peak = peaks.get("cornell_bench" if path == "cornell_bench fwd+grad" else path)
            out.append((path, run, float(m.group(2)), peak))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        time_one(argv[1])
        return 0
    got = []
    for i, root in enumerate(argv):
        root = os.path.abspath(root)
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             cwd=root, capture_output=True, text=True)
        sys.stdout.write(run.stdout)
        sys.stdout.flush()
        if run.returncode:
            sys.stderr.write(run.stderr[-8000:])
            raise RuntimeError(f"{root}: exit code {run.returncode}")
        got += [(path, f"run {i + 1} ({os.path.basename(root)})", ms, peak)
                for path, _, ms, peak in readings(run.stdout, i + 1)]
    for path in dict.fromkeys(r[0] for r in got):
        print(f"[readings] {path}: device ms in 2 frames (peak GiB of 8 frames): " + ", ".join(
            f"{run} {ms:.2f} ({peak:.3f})" for p, run, ms, peak in got if p == path), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
