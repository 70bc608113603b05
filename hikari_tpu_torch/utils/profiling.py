"""Tracing and profiling helpers — the port of
``hikari_tpu.utils.profiling``:

* ``pass_scope(name)`` labels a render pass: a ``torch.profiler``
  ``record_function`` range, visible in a profiler trace on the CPU and,
  for the kernels it launches, on the card. ``render_frame`` opens
  ``render_frame`` and one ``pass:<name>`` range a pass inside it;
* ``host_read(site, fn)`` runs a blocking device-to-host read (or a
  blocking copy to the card) under the range ``host_sync:<site>`` and
  counts it in ``host_syncs``;
* ``trace_to(dir)`` records a ``torch.profiler`` trace of the code under
  it (CPU, plus CUDA where a card is present) and writes it to ``dir`` as
  a Chrome trace (``trace.json``);
* ``FrameTimer`` times a step on the host clock; given a result to block
  on, it first waits for the card (PyTorch returns before the card has
  finished).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


# Blocking reads that went through ``host_read`` in this process, on any
# device: each waits for the card to finish the work queued before it.
host_syncs = 0


def pass_scope(name: str):
    """Label a render pass in the profile (use as context manager)."""
    return record_function(name)


def host_read(site: str, fn):
    """``fn()``, a read that waits for the card (``bool(t)``, ``.item()``,
    ``nonzero``, ``.cpu()``, a blocking copy of host data to the card),
    under the range ``host_sync:<site>``; adds one to ``host_syncs``.
    Under ``torch.cuda.set_sync_debug_mode`` the mode is lifted for this
    read alone, so a frame run in mode "error" raises at any other sync."""
    global host_syncs
    host_syncs += 1
    with record_function(f"host_sync:{site}"):
        mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_initialized() else 0
        if not mode:
            return fn()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the code under it and write ``log_dir/trace.json`` (Chrome
    trace format); yields the ``torch.profiler.profile`` object."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class FrameTimer:
    """Blocking wall-clock timer for frame steps. ``time(result)`` waits
    for the card before it stops the clock; the JAX package's waits for
    ``result``."""

    def __init__(self):
        self.samples: list[float] = []

    @contextlib.contextmanager
    def time(self, result_to_block_on=None):
        t0 = time.perf_counter()
        yield
        if result_to_block_on is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.samples.append(time.perf_counter() - t0)

    @property
    def mean(self) -> float:
        return sum(self.samples) / max(len(self.samples), 1)

    @property
    def last(self) -> float:
        return self.samples[-1] if self.samples else 0.0
