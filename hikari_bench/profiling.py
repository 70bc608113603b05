"""The traced run's reduction: ``torch.profiler`` over a few steady frames
or steps inside the window, kept in memory, reduced to device intervals
with what launched them. Nothing is written to disk.

Each device operation (kernel, copy, fill) becomes a ``DeviceOp`` with its
interval, the host thread that launched it and the program's profiler
ranges that were open on that thread at the launch. A launch is matched to
its device operation by the profiler's correlation id; the range and the
thread come from the launch's runtime call on the host."""

from __future__ import annotations

from dataclasses import dataclass, field

from hikari_bench import arith

# Names of the harness's own range around each profiled frame or step.
FRAME_RANGE = "hikari_bench.frame"
# Host events of the profiler's own work, which name no gap.
PROFILER_OWN = ("Activity Buffer",)
# Longest name a breakdown entry keeps.
NAME_CHARS = 160


@dataclass
class DeviceOp:
    name: str
    kind: str  # "kernel", "memcpy" or "memset"
    start: float  # seconds, the profiler's clock
    end: float
    thread: int | None  # the launching host thread, None when unmatched
    ranges: tuple = ()  # the program's ranges open at the launch


@dataclass
class HostSpan:
    name: str
    start: float
    end: float
    thread: int


@dataclass
class Trace:
    """What the profiled frames left: device operations, the host's spans
    (ranges and operators), the harness's frame ranges and the main
    thread, and the program's counters over the same frames."""

    ops: list
    host: list
    frames: list  # (start, end) of each profiled frame, host time
    main_thread: int | None
    span: tuple  # (start, end): the first frame's start to the last op's end
    counters: dict = field(default_factory=dict)
    num_tris: int = 0

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    @property
    def kernels(self):
        return [o for o in self.ops if o.kind == "kernel"]

    def busy_s(self) -> float:
        lo, hi = self.span
        return arith.union_length(arith.clip([(o.start, o.end) for o in self.ops], lo, hi))

    def window_s(self) -> float:
        return self.span[1] - self.span[0]


def _kind(activity: str, name: str) -> str | None:
    a = activity.lower()
    if "memcpy" in a or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in a or name.startswith("Memset"):
        return "memset"
    if "kernel" in a:
        return "kernel"
    return None


def reduce_events(events, counters=None, num_tris: int = 0) -> Trace:
    """A ``Trace`` from event records. Each record is a dict with ``name``,
    ``device`` ("cpu" or "cuda"), ``activity`` (the profiler's activity
    type), ``start``/``end`` in seconds, ``thread``, ``correlation`` (the
    profiler's correlation id, which a launch shares with its device
    operation) and ``annotation`` (a user range)."""
    host, runtime, frames = [], {}, []
    ranges = []
    for e in events:
        if e["device"] != "cpu":
            continue
        span = HostSpan(e["name"], e["start"], e["end"], e["thread"])
        if e["name"] == FRAME_RANGE:
            frames.append(span)
        elif e["annotation"]:
            ranges.append(span)
        if e["activity"].lower().startswith("cuda_runtime") or e["activity"].lower().startswith(
                "cuda_driver"):
            runtime[e["correlation"]] = span
        else:
            host.append(span)
    main = frames[0].thread if frames else None
    by_thread: dict = {}
    for r in ranges:
        by_thread.setdefault(r.thread, []).append(r)
    ops = []
    for e in events:
        if e["device"] == "cpu":
            continue
        kind = _kind(e["activity"], e["name"])
        if kind is None:
            continue
        launch = runtime.get(e["correlation"])
        thread, open_ranges = None, ()
        if launch is not None:
            thread = launch.thread
            open_ranges = tuple(r.name for r in by_thread.get(thread, ())
                                if r.start <= launch.start <= r.end)
        ops.append(DeviceOp(e["name"], kind, e["start"], e["end"], thread, open_ranges))
    frames.sort(key=lambda s: s.start)
    lo = frames[0].start if frames else min((o.start for o in ops), default=0.0)
    hi = max([f.end for f in frames] + [o.end for o in ops], default=lo)
    return Trace(ops=ops, host=host, frames=[(f.start, f.end) for f in frames],
                 main_thread=main, span=(lo, hi), counters=dict(counters or {}),
                 num_tris=num_tris)


def _activity(e, device: str) -> str:
    """The event's activity type; older and newer profilers name it
    differently, so it is read from the event where the profiler gives it
    and else worked out from the device, the annotation flag and the
    name."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name = e.name()
    if device != "cpu":
        if e.is_user_annotation():
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    if name.startswith(("cuda", "cuLaunch", "cuMem")):
        return "cuda_runtime"
    return "cpu_op"


def device_intervals(prof) -> list:
    """(start, end), in seconds, of every device operation (kernel, copy,
    fill) that a stopped profiler saw; its host events are passed over."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).split(".")[-1].lower() == "cpu":
            continue
        if _kind(_activity(e, "cuda"), e.name()) is None:
            continue
        start = e.start_ns()
        out.append((start * 1e-9, (start + e.duration_ns()) * 1e-9))
    return out


def kineto_records(prof):
    """The profiler's events as ``reduce_events`` records."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "cpu" if str(e.device_type()).split(".")[-1].lower() == "cpu" else "cuda"
        out.append({
            "name": e.name(),
            "device": dev,
            "activity": _activity(e, dev),
            "start": e.start_ns() * 1e-9,
            "end": (e.start_ns() + e.duration_ns()) * 1e-9,
            "thread": e.start_thread_id(),
            "correlation": e.correlation_id(),
            "annotation": bool(e.is_user_annotation()),
        })
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps of the device, each named by the innermost host
    operation of the main thread that was running when the gap began."""
    by_name: dict = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start)
    device_ops = [(k[:NAME_CHARS], v) for k, v in sorted(by_name.items(),
                                                          key=lambda kv: -kv[1])[:top]]
    lo, hi = trace.span
    gaps = arith.idle_gaps([(o.start, o.end) for o in trace.ops], lo, hi)
    main = [h for h in trace.host
            if h.thread == trace.main_thread and not h.name.startswith(PROFILER_OWN)]
    main.sort(key=lambda h: h.start)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        inner = None
        for h in main:
            if h.start > s:
                break
            if h.end >= s and (inner is None or h.start >= inner.start):
                inner = h
        named.append([inner.name[:NAME_CHARS] if inner else "(no host operation)", e - s])
    return {"device_ops": [[k, v] for k, v in device_ops], "idle_gaps": named}


def summary(trace: Trace) -> str:
    """One line on how the events matched: ops, ops with a launching
    thread, threads, ops under a range, frames."""
    threads = {o.thread for o in trace.ops if o.thread is not None}
    matched = sum(o.thread is not None for o in trace.ops)
    ranged = sum(bool(o.ranges) for o in trace.ops)
    return (f"{len(trace.ops)} device ops ({len(trace.kernels)} kernels), {matched} matched to a "
            f"launch, threads {sorted(threads)}, main {trace.main_thread}, {ranged} under a range, "
            f"{trace.n_frames} frames, span {trace.window_s():.4f} s, busy {trace.busy_s():.4f} s, "
            f"counters {trace.counters}")
