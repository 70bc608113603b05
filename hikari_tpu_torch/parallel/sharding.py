"""The fwd+grad train step — the unsharded part of
``hikari_tpu.parallel.sharding`` (``render_loss``, ``DIFF_LEAVES``,
``make_train_step``), on torch autograd.

One step renders a frame with the eight scene leaves as fresh leaves that
require grad, takes the pixel L2 loss against a target and its gradient
with respect to each leaf, and frees the graph: the outputs and the next
frame state come back detached, as the JAX step carries the state in the
aux of ``value_and_grad``. The ray searches run on detached rays
(``trace.api.trace_rays``), so the backward launches no trace kernel;
gradients reach the vertices through ``refine_hit``/``hit_info`` at the
forward's hits."""

from __future__ import annotations

import dataclasses

import torch

from hikari_tpu_torch.config import RenderSettings
from hikari_tpu_torch.render.pipeline import render_frame
from hikari_tpu_torch.utils import map_tensors

DIFF_LEAVES = (
    "mat_base_color",
    "mat_emissive",
    "mat_perceptual_roughness",
    "mat_metallic",
    "mat_reflectance",
    "sun_color",
    "ambient_color",
    "tri_world",
)


def render_loss(scene, camera, state, target, settings: RenderSettings):
    """Pixel L2 loss of the frame's image against ``target`` (h, w, 3).
    Returns (loss, (RenderOutputs, FrameState))."""
    out, new_state = render_frame(scene, camera, state, settings)
    diff = out.image[..., :3] - target
    return torch.mean(diff * diff), (out, new_state)


def make_train_step(settings: RenderSettings, sharded: bool = False, mesh=None):
    """``train_step(scene, camera, state, target) -> (loss, grads, out,
    new_state)``: ``grads`` maps each name of ``DIFF_LEAVES`` to the
    gradient of the loss with respect to that scene field (zeros for a
    field no path reads, as ``jax.grad`` gives). ``loss``, ``out`` and
    ``new_state`` carry no graph."""
    if sharded or mesh is not None:
        raise NotImplementedError(
            "the sharded train step is not ported yet (ROADMAP.md queue 1 item 1, 'parallel/')"
        )

    def train_step(scene, camera, state, target):
        params = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in DIFF_LEAVES}
        leaves = [params[k] for k in DIFF_LEAVES]
        with torch.enable_grad():
            loss, (out, new_state) = render_loss(
                dataclasses.replace(scene, **params), camera, state, target, settings
            )
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        out, new_state = map_tensors(torch.Tensor.detach, (out, new_state))
        return loss.detach(), dict(zip(DIFF_LEAVES, grads)), out, new_state

    return train_step
