"""The reference's train step: the pixel L2 loss of the frame's image
against a target and its gradient with respect to each differentiable
scene field (the port's ``render_loss`` and unsharded step)."""

from __future__ import annotations

import dataclasses

import torch

from hikari_bench.reference.render.pipeline import render_frame
from hikari_bench.reference.utils import map_tensors

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


def train_step(scene, camera, state, target, settings):
    """(loss, {leaf: gradient}, outputs, next state), all detached."""
    params = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in DIFF_LEAVES}
    with torch.enable_grad():
        out, new_state = render_frame(dataclasses.replace(scene, **params), camera, state,
                                      settings)
        diff = out.image[..., :3] - target
        loss = torch.mean(diff * diff)
        grads = torch.autograd.grad(loss, [params[k] for k in DIFF_LEAVES],
                                    materialize_grads=True)
    out, new_state = map_tensors(torch.Tensor.detach, (out, new_state))
    return loss.detach(), dict(zip(DIFF_LEAVES, grads)), out, new_state
