"""The run: set-up, warm-up, the measured window and the capture of what
the check compares. It drives the port (``hikari_tpu_torch``) through its
own entry points: ``render.render_frame`` for a viewer and
``parallel.make_train_step`` for a trainer."""

from __future__ import annotations

import inspect
import sys
import time
from collections import deque
from dataclasses import dataclass, field

import torch

from hikari_bench import arith, check, profiling, scenes, trainer

PROGRAM = "hikari_tpu_torch"


class Program:
    """The port's side of a cell. Tests replace its methods to break the
    timed path underneath a run."""

    package = PROGRAM

    def __init__(self, config: dict, device):
        from hikari_tpu_torch.diff import replace_scene_field
        from hikari_tpu_torch.parallel import make_train_step
        from hikari_tpu_torch.render import initial_state, render_frame
        from hikari_tpu_torch.scene import build_scene_buffers
        from hikari_tpu_torch.trace import api as trace_api

        self.device = device
        self.trace_api = trace_api
        self.scene, self.camera, self.settings = scenes.build(config, PROGRAM, device)
        self.buffers = build_scene_buffers(self.scene, device)
        self._initial_state = initial_state
        self._render_frame = render_frame
        self._make_train_step = make_train_step
        self._replace = replace_scene_field
        self._step = None

    def initial_state(self, start_frame: int):
        return self._initial_state(self.settings, self.device).replace(frame_number=start_frame)

    def render(self, state):
        with torch.no_grad():
            return self._render_frame(self.buffers, self.camera, state, self.settings)

    def train_step(self, state, target):
        if self._step is None:
            self._step = self._make_train_step(self.settings)
        return self._step(self.buffers, self.camera, state, target)

    def set_base_color(self, colors):
        self.buffers = self._replace(self.buffers, mat_base_color=colors)

    def update(self, grads, lr: float):
        """The trainer's step on the parameters: gradient descent on the
        base colours (``trainer.descend``)."""
        colors = self.buffers.mat_base_color
        self.set_base_color(trainer.descend(colors, grads["mat_base_color"], lr))

    def counters(self) -> dict:
        return {"rays_traced": self.trace_api.rays_traced,
                "trace_calls": self.trace_api.trace_calls}

    def rays_per_frame(self) -> float:
        s = self.settings
        return arith.rays_per_frame(s.output_size, s.render_size, s.direct_validate_interval,
                                    s.emissive_validate_interval, s.emissive_lit,
                                    self.buffers.num_emissives, s.indirect_bounces)


class TraceSampler:
    """While active, every ``trace_rays`` the port's modules call records a
    sample of its rays (drawn from the seed) with the answers it returned.
    The port's function is swapped back on exit."""

    def __init__(self, program: Program, seed: int, per_call: int):
        self.program, self.per_call = program, per_call
        self.gen = torch.Generator(device=program.device).manual_seed(seed)
        self.samples: list = []
        self._swapped: list = []

    def __enter__(self):
        orig = self.program.trace_api.trace_rays
        sig = inspect.signature(orig)

        def sampled(*args, **kwargs):
            hit = orig(*args, **kwargs)
            self._record(sig.bind(*args, **kwargs), hit)
            return hit

        for mod in list(sys.modules.values()):
            name = getattr(mod, "__name__", "")
            pkg = self.program.package
            if (name == pkg or name.startswith(pkg + ".")) and getattr(
                    mod, "trace_rays", None) is orig:
                self._swapped.append((mod, orig))
                mod.trace_rays = sampled
        return self

    def __exit__(self, *exc):
        for mod, orig in self._swapped:
            mod.trace_rays = orig
        self._swapped.clear()

    def _record(self, bound, hit):
        a = bound.arguments
        origin = a["origin"]
        shape = origin.shape[:-1]
        R = origin.reshape(-1, 3).shape[0]
        if R == 0:
            return
        dev = origin.device
        idx = torch.randint(0, R, (min(self.per_call, R),), generator=self.gen, device=dev)
        ntri = self.program.buffers.num_tris

        def per_ray(key, default, dtype):
            x = a.get(key)
            if x is None:
                return torch.full((idx.numel(),), default, dtype=dtype, device=dev)
            x = torch.as_tensor(x, device=dev).detach().to(dtype)
            return torch.broadcast_to(x, shape).reshape(-1)[idx]

        self.samples.append({
            "o": origin.detach().reshape(-1, 3)[idx].float(),
            "d": a["direction"].detach().reshape(-1, 3)[idx].float(),
            "maxd": per_ray("max_distance", float(torch.finfo(torch.float32).max),
                            torch.float32),
            "early": per_ray("early_distance", 0.0, torch.float32),
            "excl": per_ray("exclude_instance", -1, torch.int32),
            "lo": per_ray("range_lo", 0, torch.int32),
            "hi": per_ray("range_hi", ntri, torch.int32),
            "t": hit.t.reshape(-1)[idx],
            "prim": hit.prim.reshape(-1)[idx],
        })

    def on_host(self) -> list:
        return [{k: v.cpu() for k, v in s.items()} for s in self.samples]


@dataclass
class Window:
    """What the measured window saw."""

    start: float = 0.0  # host time (perf_counter) of the window's start
    seconds: float = 0.0
    frames: int = 0
    latencies: list = field(default_factory=list)
    peak_bytes: int = 0
    trace: profiling.Trace | None = None
    busy_s: float | None = None  # the device's busy seconds over every frame (DeviceBusy)


class _Clock:
    """Maps a CUDA event's completion onto the host clock: a reference
    event is recorded on an idle stream, so its device time is the host
    time of its record."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            torch.cuda.synchronize(device)
            self.ref = torch.cuda.Event(enable_timing=True)
            self.ref.record()
            self.ref.synchronize()
        self.host = time.perf_counter()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> float:
        """Wait for ``mark``; the host time at which the device reached it."""
        if not self.cuda:
            return mark
        mark.synchronize()
        return self.host + self.ref.elapsed_time(mark) * 1e-3


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class DeviceBusy:
    """The device's busy time (the union of its operations' intervals)
    over frames run between ``start`` and ``stop``: ``torch.profiler`` with
    the CUDA activity alone, so that the host records no operator. Frames
    are metered in chunks, each its own profiling session, to keep the
    profiler's buffers small; ``stop`` drains the device first, so the
    chunks' busy times add up."""

    def __init__(self, device):
        self.device = device
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> float:
        _sync(self.device)
        self.prof.stop()
        busy = arith.union_length(profiling.device_intervals(self.prof))
        self.prof = None
        return busy


def run_window(device, seconds: float, in_flight: int, one, min_frames: int = 1,
               profile_at: int | None = None, profile_frames: int = 0, counters=None,
               num_tris: int = 0, busy_chunk: int = 0) -> Window:
    """Call ``one(n)`` for frame or step n = 0, 1, ... until ``seconds``
    have passed and at least ``min_frames`` ran, with at most ``in_flight``
    on the device; then wait for all. Each frame's latency runs from the
    host's start of its enqueue to the device's completion of its last
    operation. With ``profile_at``, frames ``profile_at`` ...
    ``profile_at + profile_frames - 1`` run under ``torch.profiler`` (the
    device drained before them and after them). Else, with ``busy_chunk``
    on a CUDA card, every frame runs under a ``DeviceBusy`` meter, in
    chunks of that many frames, and ``busy_s`` sums their busy times."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    clock = _Clock(device)
    win, pending = Window(), deque()
    prof, before, traced = None, None, None
    chunk = busy_chunk if cuda and profile_at is None else 0
    meter = DeviceBusy(device) if chunk else None
    if meter:
        win.busy_s = 0.0
    start = win.start = time.perf_counter()
    n = 0
    while n < min_frames or time.perf_counter() - start < seconds:
        if meter and n % chunk == 0:
            meter.start()
        if profile_at is not None and n == profile_at:
            for t0, mark in pending:
                win.latencies.append(clock.wait(mark) - t0)
            pending.clear()
            prof, before = _start_profiler(device), dict(counters() if counters else {})
        t0 = time.perf_counter()
        if prof is not None:
            with torch.profiler.record_function(profiling.FRAME_RANGE):
                one(n)
        else:
            one(n)
        pending.append((t0, clock.mark()))
        while len(pending) >= in_flight:
            t, mark = pending.popleft()
            win.latencies.append(clock.wait(mark) - t)
        n += 1
        if meter and n % chunk == 0:
            win.busy_s += meter.stop()
        if prof is not None and n == profile_at + profile_frames:
            _sync(device)
            prof.stop()
            after = counters() if counters else {}
            traced = prof, {k: after[k] - before[k] for k in after}
            prof = None
    for t0, mark in pending:
        win.latencies.append(clock.wait(mark) - t0)
    if meter and meter.prof is not None:
        win.busy_s += meter.stop()
    _sync(device)
    win.seconds = time.perf_counter() - start
    win.frames = n
    if cuda:
        win.peak_bytes = torch.cuda.max_memory_allocated(device)
    if traced is not None:  # reduced once the window has closed
        win.trace = profiling.reduce_events(profiling.kineto_records(traced[0]), traced[1],
                                            num_tris)
    return win


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def start_frame(seed: int, traffic: dict) -> int:
    """The renderer's first frame index, from the seed: it sets the random
    streams and the jitter, and keeps the same work (the frame number
    stays small, where the golden-ratio offsets keep their precision)."""
    return seed % int(traffic["start_frames"])


def seed_draw(seed: int, lo: int, hi: int) -> int:
    """An index in [lo, hi) drawn from the seed."""
    g = torch.Generator().manual_seed(seed ^ 0x5EED)
    return int(torch.randint(lo, hi, (1,), generator=g))


def view(program: Program, traffic: dict, seed: int, seconds: float, trace: bool):
    """Set-up's warm-up, the viewer's window and the checked frame.
    Returns (window, capture)."""
    first = start_frame(seed, traffic)
    state = program.initial_state(first)
    start_state = check.to_host(state)
    cuda = torch.device(program.device).type == "cuda"
    busy_chunk = 0 if trace or not cuda else int(traffic.get("busy_chunk", 0))
    for k in range(int(traffic["warmup"])):
        meter = DeviceBusy(program.device) if busy_chunk and k == 0 else None
        if meter:  # the meter's first session, which starts the profiler, is set-up
            meter.start()
        out, state = program.render(state)
        if meter:
            meter.stop()
    j = seed_draw(seed, *traffic["checked_frame"])
    pin = cuda
    # The checked frame's copies go to pinned host memory without a wait;
    # copies of the same sizes made here fill the pinned cache first.
    check.host_copy((state, out.image, state), pin)
    del out
    _sync(program.device)
    box = {"state": state}
    del state  # the window holds the state only through ``box``
    kept = {}

    def one(n):
        st = box["state"]
        if n == j:
            kept["state_in"] = check.host_copy(st, pin)
            with TraceSampler(program, seed, int(traffic["sample_rays"])) as sampler:
                out, box["state"] = program.render(st)
            kept.update(image=check.host_copy(out.image, pin),
                        state_out=check.host_copy(box["state"], pin), sampler=sampler)
        else:
            _, box["state"] = program.render(st)

    profile_at = int(traffic["profile_at"]) if trace else None
    win = run_window(program.device, seconds, int(traffic["in_flight"]), one,
                     min_frames=max(j + 1, (profile_at or 0) + int(traffic["profile_frames"])),
                     profile_at=profile_at, profile_frames=int(traffic["profile_frames"]),
                     counters=program.counters, num_tris=program.buffers.num_tris,
                     busy_chunk=busy_chunk)
    cap = check.ViewCapture(start_state=start_state, state_in=kept["state_in"],
                            image=kept["image"], state_out=kept["state_out"],
                            samples=kept["sampler"].on_host())
    return win, cap


def train(program: Program, traffic: dict, seed: int, seconds: float, trace: bool):
    """Set-up's target (the first frame rendered with the scene's own
    colours) and checked steps (the first ``checked_steps`` steps and
    updates, through the window's own calls, which also warm them up),
    then the trainer's window. Returns (window, capture)."""
    first = start_frame(seed, traffic)
    lr = float(traffic["lr"])
    out, _ = program.render(program.initial_state(first))
    target = out.image[..., :3].contiguous()
    colors = program.buffers.mat_base_color
    start_colors = trainer.perturbed(colors, seed, float(traffic["perturb"]))
    program.set_base_color(start_colors)
    state = program.initial_state(first)
    start_state = check.to_host(state)
    losses, norms, samples = [], [], []
    for k in range(int(traffic["checked_steps"])):
        if k == 0:
            with TraceSampler(program, seed, int(traffic["sample_rays"])) as sampler:
                loss, grads, out, state = program.train_step(state, target)
            samples = sampler.on_host()
        else:
            loss, grads, out, state = program.train_step(state, target)
        program.update(grads, lr)
        losses.append(float(loss))
        norms.append(check.grad_norms(grads))
    cap = check.TrainCapture(start_state=start_state, losses=losses, norms=norms,
                             image=out.image.detach().cpu(), state_out=check.to_host(state),
                             samples=samples, target=target.cpu(),
                             start_colors=start_colors.cpu(),
                             colors=program.buffers.mat_base_color.cpu())
    box = {"state": state}
    del grads, out, state  # the window holds the state only through ``box``

    def one(n):
        _, grads, _, box["state"] = program.train_step(box["state"], target)
        program.update(grads, lr)

    profile_at = int(traffic["profile_at"]) if trace else None
    win = run_window(program.device, seconds, int(traffic["in_flight"]), one,
                     min_frames=(profile_at or 0) + int(traffic["profile_frames"]),
                     profile_at=profile_at, profile_frames=int(traffic["profile_frames"]),
                     counters=program.counters, num_tris=program.buffers.num_tris)
    return win, cap
