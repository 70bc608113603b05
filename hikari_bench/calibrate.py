"""The readings that the limits of ``limits/<workload>.json`` are set
from: for each seed, the port's run of the cell (a short window at the
cell's own size and load) judged against the reference, and the control
judged the same way, and with ``--fault-seeds`` each planted fault of
``faults.py``. The control is the reference in bfloat16: the
checked frame (or the first steps) rendered again with every pass's float
outputs rounded to it, and the sampled rays' nearest hits computed in it.

    python -m hikari_bench.calibrate --workload <cell> --seeds 1 2 3 ... [--seconds 2]

One process reads every seed (the scene is built once) and prints one
JSON line a seed; it needs the card, as a run does."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from hikari_bench import check, faults, harness, spec
from hikari_bench.reference.render.pipeline import lowered


def _fault_numbers(cls, config, cell, seed, seconds, device, ref, limits, first):
    program = cls(config, device)
    if cell.traffic["kind"] == "view":
        _, cap = harness.view(program, cell.traffic, seed, seconds, False)
        numbers = check.judge_view(ref, cap, limits, first)
    else:
        _, cap = harness.train(program, cell.traffic, seed, seconds, False)
        numbers = check.judge_train(ref, cap, limits, first, seed, cell.traffic)
    return {n.name: n.value for n in numbers}


def readings(workload: str, seeds, seconds: float, device, shrink=None, control_seeds=None,
             fault_seeds=0):
    """Yield {seed, sound, control, faults} with each number's reading; the
    control only on the first ``control_seeds`` seeds (all by default),
    the faults of ``faults.FAULTS`` on the first ``fault_seeds``."""
    cell = spec.find_cell(workload)
    config = shrink(cell.config) if shrink else cell.config
    limits = check.load_limits(workload)
    program = harness.Program(config, device)
    ref = check.Reference(config, device)
    kind = cell.traffic["kind"]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        with_control = control_seeds is None or i < control_seeds
        first = harness.start_frame(seed, cell.traffic)
        if kind == "view":
            win, cap = harness.view(program, cell.traffic, seed, seconds, False)
            state_in = check.to_reference(cap.state_in, device)
            out, st = ref.render(state_in)
            sound = check.view_numbers(ref, cap, out, st, limits, first)
            control = []
            if with_control:
                with lowered():
                    c_out, c_st = ref.render(state_in)
                ctl = check.ViewCapture(start_state=cap.start_state, state_in=cap.state_in,
                                        image=c_out.image, state_out=c_st, samples=cap.samples)
                control = check.view_numbers(ref, ctl, out, st, limits, first,
                                             hits_dtype=torch.bfloat16)
        else:
            colors = program.buffers.mat_base_color
            win, cap = harness.train(program, cell.traffic, seed, seconds, False)
            program.set_base_color(colors)  # the next seed starts from the scene's colours
            steps = check.reference_steps(ref, len(cap.losses), first, seed, cell.traffic)
            sound = check.train_numbers(ref, cap, steps, limits, first)
            control = []
            if with_control:
                with lowered():
                    c = check.reference_steps(ref, len(cap.losses), first, seed, cell.traffic)
                ctl = check.TrainCapture(start_state=cap.start_state, losses=c.losses,
                                         norms=c.norms, image=c.image, state_out=c.state_out,
                                         samples=cap.samples, target=c.target,
                                         start_colors=c.start_colors, colors=c.colors)
                control = check.train_numbers(ref, ctl, steps, limits, first,
                                              hits_dtype=torch.bfloat16)
        planted = {}
        if i < fault_seeds:
            for cls in faults.FAULTS[kind]:
                planted[cls.__name__] = _fault_numbers(cls, config, cell, seed, seconds, device,
                                                       ref, limits, first)
        yield {"seed": seed, "frames": win.frames, "seconds": time.perf_counter() - t0,
               "sound": {n.name: n.value for n in sound},
               "control": {n.name: n.value for n in control}, "faults": planted}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first N seeds only (default: all)")
    ap.add_argument("--fault-seeds", type=int, default=0,
                    help="read each planted fault on the first N seeds (default: none)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hikari_bench.calibrate: needs a CUDA card", file=sys.stderr)
        return 1
    os.environ.pop("HIKARI_REFERENCE_ASSETS", None)
    for r in readings(args.workload, args.seeds, args.seconds, torch.device("cuda", 0),
                      control_seeds=args.control_seeds, fault_seeds=args.fault_seeds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
