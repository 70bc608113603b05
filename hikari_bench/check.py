"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``hikari_bench.reference``), which imports
nothing of the port and works out again whatever the port derived.

* The trace layer: a sample of the rays of each trace call of the checked
  frame or step, drawn from the seed, with the port's answers, against
  every triangle in float64 (``reference/brute.py``). An answer is off
  where its t is not the nearest hit's, unless the call allowed an early
  stop (``early_distance``) and the port's t is a hit of its own
  triangle nearer than that.
* The render passes: the reference renders the checked frame from the
  port's state before it (the reference cannot follow the window's many
  frames in its time) and compares the image and the next state; the
  start is checked apart, the reference's initial state against the
  port's.
* The train step: the reference renders its own target, starts from its
  own base colours moved by the same seed-drawn offsets, follows the
  first three steps and updates from its own initial state, and compares
  the target, each step's loss and each leaf's gradient norm, the
  parameters' change after the three updates, and the third step's image
  and state.

Each number has its limit in ``limits/<workload>.json``. The control (the
reference in bfloat16: every pass's float outputs rounded to it, the
brute force computed in it) is run by ``calibrate.py`` and the tests,
never by a benchmark run."""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from hikari_bench import scenes, spec, trainer
from hikari_bench.reference import brute

REFERENCE = scenes.REFERENCE
# Relative agreement of a ray's t with the float64 nearest hit.
T_RTOL = 1e-4
# An image or state element is off where it differs by more than this
# (absolute, plus the same relative to the reference's magnitude).
ELEM_TOL = 1e-3


@dataclass
class Number:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def load_limits(workload: str, root: Path | None = None) -> dict:
    """The limits of ``workload``: ``limits/<workload>.json`` of the
    benchmark at ``root``, else of this package."""
    return spec.load_json(spec.locate(root, "limits", f"{workload}.json"))["limits"]


def leaves(obj, prefix=""):
    """{path: leaf} of the tensors and ints of a (nested) dataclass."""
    out = {}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            out.update(leaves(getattr(obj, f.name), f"{prefix}{f.name}."))
    elif isinstance(obj, (torch.Tensor, int, float)):
        out[prefix.rstrip(".")] = obj
    return out


def to_reference(obj, device):
    """The port's dataclass tree as the reference's classes of the same
    names (module by module), its tensors on ``device``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = type(obj).__module__
        if not mod.startswith(REFERENCE + "."):
            mod = f"{REFERENCE}.{mod.split('.', 1)[1]}"
        cls = getattr(importlib.import_module(mod), type(obj).__name__)
        return cls(**{f.name: to_reference(getattr(obj, f.name), device)
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return obj


def host_copy(obj, pin: bool):
    """``obj`` (a dataclass tree, tuple or tensor) with every tensor copied
    to new host memory; with ``pin``, pinned and without a wait, so read
    it only once the device has passed this point."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: host_copy(getattr(obj, f.name), pin)
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(host_copy(x, pin) for x in obj)
    if isinstance(obj, torch.Tensor):
        out = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=pin)
        return out.copy_(obj.detach(), non_blocking=pin)
    return obj


def to_host(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: to_host(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    return obj


def _off(got, want):
    """Elementwise: differs beyond ``ELEM_TOL`` (absolute and relative);
    NaN matches NaN only, and an infinity only itself."""
    g, w = got.double(), want.double()
    same = (g - w).abs() <= ELEM_TOL * (1 + w.abs())
    same |= (g == w) | (torch.isnan(g) & torch.isnan(w))
    return ~same


def off_share(got, want) -> float:
    """Share of elements of ``got`` that differ from ``want`` (on
    ``want``'s device): exactly for integers, by ``_off`` for floats; a
    shape mismatch is wholly off."""
    if isinstance(want, (int, float)) or isinstance(got, (int, float)):
        return float(got != want)
    if got.shape != want.shape:
        return 1.0
    got = got.to(want.device)
    if not want.is_floating_point():
        return (got != want).double().mean().item() if want.numel() else 0.0
    return _off(got, want).double().mean().item() if want.numel() else 0.0


def image_off(got, want) -> float:
    """Share of pixels with any channel off."""
    if got.shape != want.shape:
        return 1.0
    got = got.to(want.device)
    return _off(got, want).any(dim=-1).double().mean().item()


def state_shares(got, want) -> dict:
    """{leaf path: share of its elements off}; a leaf on one side only is
    wholly off."""
    g, w = leaves(got), leaves(want)
    out = {k: 1.0 for k in set(g) ^ set(w)}
    out.update({k: off_share(g[k], w[k]) for k in set(g) & set(w)})
    return out


def state_off(got, want) -> float:
    """The worst share of off elements over the state's leaves."""
    shares = state_shares(got, want)
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:3]
    if worst and worst[0][1] > 0:
        print("# state leaves off: " + ", ".join(f"{k} {v!r}" for k, v in worst),
              file=sys.stderr)
    return max(shares.values())


def hits_off(samples, buffers, dtype=torch.float64) -> float:
    """Share of the sampled rays whose answer is off, against the
    reference's own compiled triangles. A ray that grazes an edge or a
    vertex may hit or miss on rounding, so a hit counts where the ray meets
    its triangle with ``brute.EDGE`` of slack, and a triangle counts as
    nearer, or a miss as wrong, only where the ray meets it with that much
    to spare; a hit at the nearest triangle's t is right whichever of the
    triangles that share the edge it names. ``dtype`` below float64 gives the control's reading: its
    answers are its own nearest hits in that precision."""
    tri, inst = buffers.tri_world.detach(), buffers.tri_inst
    dev = tri.device
    bad = total = 0
    for s in samples:
        o, d = s["o"].to(dev), s["d"].to(dev)
        maxd, early = s["maxd"].to(dev), s["early"].to(dev)
        args = (s["excl"].to(dev), s["lo"].to(dev), s["hi"].to(dev))
        clear = brute.closest(o, d, maxd, *args, tri, inst, edge=-brute.EDGE)
        if dtype == torch.float64:
            t, prim = s["t"].to(dev).double(), s["prim"].to(dev)
            own = brute.along(o, d, prim, tri, edge=brute.EDGE)
        else:
            t = brute.closest(o, d, maxd, *args, tri, inst, dtype=dtype).double()
            prim = torch.where(torch.isfinite(t), 0, -1)
            own = t
            t = torch.where(torch.isfinite(t), t, maxd.double())
        hit = prim >= 0
        nearest = torch.isfinite(clear) & ((t - clear).abs() <= T_RTOL * clear.abs().clamp(min=1.0))
        real = torch.isfinite(own) & ((t - own).abs() <= T_RTOL * own.abs().clamp(min=1.0))
        not_farther = t <= clear + T_RTOL * clear.abs().clamp(min=1.0)
        early_ok = (early > 0) & (t < early.double())
        ok = torch.where(hit, nearest | (real & (not_farther | early_ok)), ~torch.isfinite(clear))
        bad += int((~ok).sum())
        total += ok.numel()
    return bad / max(total, 1)


def worst(values) -> float:
    """The largest value; NaN if any is NaN, so that a non-finite reading
    is never passed over."""
    values = list(values)
    return float("nan") if any(math.isnan(v) for v in values) else max(values)


def grad_gap(prog_norms, ref_norms) -> float:
    """The worst leaf's gap of gradient norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    floor = statistics.median(ref_norms.values())
    return worst(abs(prog_norms[k] - ref_norms[k]) / max(ref_norms[k], floor, 1e-30)
                 for k in ref_norms)


def change_gap(prog_start, prog_end, ref_start, ref_end) -> float:
    """The gap of the norms of the parameters' change (the base colours'
    rgb, the one leaf the trainer moves) over the reference's norm."""
    def norm(a, b):
        return float(torch.linalg.vector_norm((b[..., :3] - a[..., :3]).double()))

    ref = norm(ref_start, ref_end)
    return abs(norm(prog_start, prog_end) - ref) / max(ref, 1e-30)


def grad_norms(grads) -> dict:
    return {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}


class Reference:
    """The reference's side of a cell: its own scene, compile and state."""

    def __init__(self, config: dict, device):
        from hikari_bench.reference.render import initial_state, render_frame
        from hikari_bench.reference.scene import build_scene_buffers

        t0 = time.perf_counter()
        self.device = device
        self.scene, self.camera, self.settings = scenes.build(config, REFERENCE, device)
        self.buffers = build_scene_buffers(self.scene, device)
        print(f"# reference scene {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        self._initial_state, self._render = initial_state, render_frame

    def initial_state(self, start_frame: int):
        return self._initial_state(self.settings, self.device).replace(frame_number=start_frame)

    def render(self, state):
        with torch.no_grad():
            return self._render(self.buffers, self.camera, state, self.settings)

    def train_step(self, state, target):
        from hikari_bench.reference.train import train_step

        return train_step(self.buffers, self.camera, state, target, self.settings)

    def set_base_color(self, colors):
        self.buffers = dataclasses.replace(self.buffers, mat_base_color=colors)

    def update(self, grads, lr: float):
        self.set_base_color(trainer.descend(self.buffers.mat_base_color,
                                            grads["mat_base_color"], lr))


@dataclass
class ViewCapture:
    """What the port produced for the checked frame, on the host: the
    state before it, its image, the state after it, the trace samples of
    its calls, and the port's initial state of the run."""

    start_state: object
    state_in: object
    image: torch.Tensor
    state_out: object
    samples: list


@dataclass
class TrainCapture:
    """The port's first three steps: losses, leaf gradient norms, the
    third step's image and state, the first step's trace samples, the
    target, and the base colours before the first update and after the
    third."""

    start_state: object
    losses: list
    norms: list
    image: torch.Tensor
    state_out: object
    samples: list
    target: torch.Tensor
    start_colors: torch.Tensor
    colors: torch.Tensor


@dataclass
class ReferenceSteps:
    """The reference's side of ``TrainCapture``."""

    losses: list
    norms: list
    image: torch.Tensor
    state_out: object
    target: torch.Tensor
    start_colors: torch.Tensor
    colors: torch.Tensor


def view_numbers(ref: Reference, cap: ViewCapture, out, state, limits: dict, start_frame: int,
                 hits_dtype=torch.float64):
    """The view cell's numbers: ``cap`` against the reference's render of
    the same frame (``out``, ``state``)."""
    numbers = {
        "hits_off": hits_off(cap.samples, ref.buffers, hits_dtype),
        "image_off": image_off(cap.image, out.image),
        "state_off": max(state_off(cap.state_out, state),
                         state_off(cap.start_state, ref.initial_state(start_frame))),
    }
    return [Number(k, v, limits[k]) for k, v in numbers.items()]


def judge_view(ref: Reference, cap: ViewCapture, limits: dict, start_frame: int):
    t0 = time.perf_counter()
    out, state = ref.render(to_reference(cap.state_in, ref.device))
    print(f"# reference frame {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return view_numbers(ref, cap, out, state, limits, start_frame)


def reference_steps(ref: Reference, steps: int, start_frame: int, seed: int,
                    traffic: dict) -> ReferenceSteps:
    """The reference's target (its first frame with the scene's own
    colours) and its first ``steps`` train steps and updates, from its own
    initial state and its own base colours moved by the seed's offsets."""
    out, _ = ref.render(ref.initial_state(start_frame))
    target = out.image[..., :3].contiguous()
    colors = ref.buffers.mat_base_color
    start = trainer.perturbed(colors, seed, float(traffic["perturb"]))
    ref.set_base_color(start)
    state = ref.initial_state(start_frame)
    losses, norms = [], []
    try:
        for _ in range(steps):
            loss, grads, out, state = ref.train_step(state, target)
            ref.update(grads, float(traffic["lr"]))
            losses.append(float(loss))
            norms.append(grad_norms(grads))
            del grads
        end = ref.buffers.mat_base_color
    finally:
        ref.set_base_color(colors)
    return ReferenceSteps(losses=losses, norms=norms, image=out.image, state_out=state,
                          target=target, start_colors=start, colors=end)


def train_numbers(ref: Reference, cap: TrainCapture, steps: ReferenceSteps, limits: dict,
                  start_frame: int, hits_dtype=torch.float64):
    """The train cell's numbers: ``cap`` against ``reference_steps``."""
    dev = steps.colors.device
    numbers = {
        "hits_off": hits_off(cap.samples, ref.buffers, hits_dtype),
        "loss_gap": worst(abs(a - b) / max(abs(b), 1e-30)
                          for a, b in zip(cap.losses, steps.losses)),
        "grad_gap": worst(grad_gap(a, b) for a, b in zip(cap.norms, steps.norms)),
        "param_gap": change_gap(cap.start_colors.to(dev), cap.colors.to(dev),
                                steps.start_colors, steps.colors),
        "image_off": max(image_off(cap.target, steps.target), image_off(cap.image, steps.image)),
        "state_off": max(state_off(cap.state_out, steps.state_out),
                         state_off(cap.start_state, ref.initial_state(start_frame))),
    }
    return [Number(k, v, limits[k]) for k, v in numbers.items()]


def judge_train(ref: Reference, cap: TrainCapture, limits: dict, start_frame: int, seed: int,
                traffic: dict):
    t0 = time.perf_counter()
    steps = reference_steps(ref, len(cap.losses), start_frame, seed, traffic)
    print(f"# reference steps {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return train_numbers(ref, cap, steps, limits, start_frame)
