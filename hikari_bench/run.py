"""One run of one cell of ``BENCHMARK.json`` on the CUDA card:

    python -m hikari_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the port's kernels built or loaded, the scene compiled, the
cell's own shapes warmed up), the measured window of ``--seconds``, then
the check against the reference. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones, read
from ``torch.profiler`` over a few steady frames inside the window),
``device`` and, traced, ``breakdown``; then ``check``, each compared number
with its limit, which also close standard error. Without a CUDA card, or
with fewer cards than the cell asks for, it exits 1 and prints no result."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

# Top-level module names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "hikari_tpu")


class RunError(RuntimeError):
    """The run cannot give a result."""


@dataclass
class Context:
    """What a per-layer reader gets: the profiled frames' trace, the cell,
    and the measured window (its frames' latencies)."""

    trace: object
    cell: object
    window: object


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN``."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def end_to_end(name: str, win, program, setup_s: float) -> float:
    from hikari_bench import arith

    if name == "setup_s":
        return setup_s
    if name == "train_rays_per_s":
        return arith.rate(program.rays_per_frame() * win.frames, win.seconds)
    if name == "gpu_frame_ms":
        return None if win.busy_s is None else 1e3 * win.busy_s / win.frames
    if name == "peak_mem_gib":
        return win.peak_bytes / 2**30
    raise RunError(f"no definition of the end-to-end metric {name!r}")


def card(device) -> str:
    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return f"{torch.cuda.get_device_name(device)}; nvidia-smi: {smi[0] if smi else 'n/a'}"


def run(workload: str, seed: int, seconds: float, trace: bool, device=None,
        program_factory=None, shrink=None, root=None):
    """One run; returns (result dict, compared numbers). ``device`` None
    means the CUDA card, which must be there; tests pass "cpu", a
    ``shrink(config) -> config`` to a size the CPU holds, a
    ``program_factory`` to break the timed path and a ``root`` holding
    another ``BENCHMARK.json``."""
    import torch

    from hikari_bench import check, harness, profiling, spec

    cell = spec.find_cell(workload, root or spec.ROOT)
    config = shrink(cell.config) if shrink else cell.config
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise RunError(f"{workload} needs {cell.chips} CUDA card(s); this machine has {n}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    os.environ.pop("HIKARI_REFERENCE_ASSETS", None)  # the procedural scenes, always
    program = (program_factory or harness.Program)(config, device)
    kind = cell.traffic["kind"]
    if kind == "view":
        win, cap = harness.view(program, cell.traffic, seed, seconds, trace)
    elif kind == "train":
        win, cap = harness.train(program, cell.traffic, seed, seconds, trace)
    else:
        raise RunError(f"unknown traffic kind {kind!r}")
    setup_s = win.start - T0
    cuda = torch.device(device).type == "cuda"
    metrics = {}
    if trace:
        ctx = Context(trace=win.trace, cell=cell, window=win)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = end_to_end(m["name"], win, program, setup_s)
            if value is None and cuda:
                raise RunError(f"the window measured no {m['name']}")
            if value is not None:  # a device metric reads nothing on the CPU
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": win.peak_bytes}
    result = {"correct": False, "attempted": win.frames, "failed": 0, "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = win.trace.busy_s()
        dev["window_s"] = win.trace.window_s()
        result["breakdown"] = profiling.breakdown(win.trace)
    busy = "" if win.busy_s is None else f", device busy {win.busy_s:.4f} s"
    print(f"# {workload}: set-up {setup_s:.3f} s, {win.frames} frames in {win.seconds:.3f} s"
          f"{busy}", file=sys.stderr)
    if trace:
        print(f"# trace: {profiling.summary(win.trace)}", file=sys.stderr)
    first = harness.start_frame(seed, cell.traffic)
    del program, win
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = check.Reference(config, device)
    limits = check.load_limits(workload, root)
    if kind == "view":
        numbers = check.judge_view(ref, cap, limits, first)
    else:
        numbers = check.judge_train(ref, cap, limits, first, seed, cell.traffic)
    print(f"# reference check {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    result["correct"] = all(n.ok for n in numbers)
    result["failed"] = 0 if result["correct"] else 1
    result["check"] = {n.name: {"value": n.value, "limit": n.limit} for n in numbers}
    return result, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from hikari_bench.spec import SpecError

    try:
        result, numbers = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except (RunError, SpecError) as e:
        print(f"hikari_bench: {e}", file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print(f"hikari_bench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 1
    import torch

    print(f"# {card(torch.cuda.current_device())}", file=sys.stderr)
    for n in numbers:
        print(f"check {n.name} {n.value!r} limit {n.limit!r} {'ok' if n.ok else 'OFF'}",
              file=sys.stderr)
    check_block = result.pop("check")
    result["check"] = check_block  # the compared numbers come last
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
