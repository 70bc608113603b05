"""Faults planted in the timed path, and the control put in the port's
place: what the check has to find. The tests drive whole runs with them on
the CPU; ``calibrate.py --fault-seeds`` reads them on the card at the
cell's size. The cells run on one card, so none can leave out an
exchange between chips; a viewer's frame takes no batch mean, so half the
batch is the trainer's fault."""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch

from hikari_bench import check, harness
from hikari_bench.reference.render.pipeline import lowered


class Control(harness.Program):
    """The reference, in bfloat16, in the port's place."""

    package = check.REFERENCE

    def __init__(self, config, device):
        from hikari_bench.reference.trace import api

        self.ref = check.Reference(config, device)
        self.device, self.trace_api = device, api
        self.scene, self.camera, self.settings = self.ref.scene, self.ref.camera, self.ref.settings
        self.buffers = self.ref.buffers

    def initial_state(self, start_frame):
        return self.ref.initial_state(start_frame)

    def render(self, state):
        with lowered():
            return self.ref.render(state)

    def train_step(self, state, target):
        with lowered():
            return self.ref.train_step(state, target)

    def set_base_color(self, colors):
        self.ref.set_base_color(colors)
        self.buffers = self.ref.buffers


class StateUnchanged(harness.Program):
    """A step that returns its frame state unchanged."""

    def render(self, state):
        out, _ = super().render(state)
        return out, state

    def train_step(self, state, target):
        loss, grads, out, _ = super().train_step(state, target)
        return loss, grads, out, state


class UpdateSkipped(harness.Program):
    """A trainer's step that leaves its parameters unchanged."""

    def update(self, grads, lr):
        pass


class HalfBatch(harness.Program):
    """The train step's loss over half of the image's rows, the mean taken
    over them."""

    def train_step(self, state, target):
        from hikari_tpu_torch.parallel import DIFF_LEAVES
        from hikari_tpu_torch.utils import map_tensors

        params = {k: getattr(self.buffers, k).detach().clone().requires_grad_(True)
                  for k in DIFF_LEAVES}
        with torch.enable_grad():
            out, new = self._render_frame(dataclasses.replace(self.buffers, **params),
                                          self.camera, state, self.settings)
            h = target.shape[0] // 2
            diff = out.image[:h, :, :3] - target[:h]
            loss = torch.mean(diff * diff)
            grads = torch.autograd.grad(loss, [params[k] for k in DIFF_LEAVES],
                                        materialize_grads=True)
        out, new = map_tensors(torch.Tensor.detach, (out, new))
        return loss.detach(), dict(zip(DIFF_LEAVES, grads)), out, new


class HitAltered(harness.Program):
    """The search's answers altered where they are produced, whichever
    search the scene and the tracer take (``trace_api._search``): every
    16th ray's t 10% farther."""

    @contextmanager
    def _altered(self):
        api = self.trace_api
        saved = api._search

        def alter(*a, **k):
            hit = saved(*a, **k)
            t = hit.t.clone()
            t.reshape(-1)[::16] *= 1.1
            return dataclasses.replace(hit, t=t)

        api._search = alter
        try:
            yield
        finally:
            api._search = saved

    def render(self, state):
        with self._altered():
            return super().render(state)

    def train_step(self, state, target):
        with self._altered():
            return super().train_step(state, target)


# The faults each kind of cell can have.
FAULTS = {
    "view": (StateUnchanged, HitAltered),
    "train": (StateUnchanged, UpdateSkipped, HalfBatch, HitAltered),
}
