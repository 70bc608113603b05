"""The trainer's side of the train traffic, as examples/train.py trains:
where its parameters start and how a step moves them. The port and the
reference each apply it to their own base-colour table."""

from __future__ import annotations

import torch


def descend(colors, grad, lr: float):
    """examples/train.py's update of a base-colour table: rgb - lr *
    gradient, clamped to [0, 1]; alpha kept."""
    out = colors.clone()
    out[..., :3] = torch.clamp(colors[..., :3] - lr * grad[..., :3], 0.0, 1.0)
    return out


def perturbed(colors, seed: int, amount: float):
    """The trainer's start: each base colour's rgb moved by an offset in
    [-amount, amount] drawn from the seed on the table's device, clamped
    to [0, 1]."""
    g = torch.Generator(device=colors.device).manual_seed(seed ^ 0xC0105)
    off = torch.rand(colors[..., :3].shape, generator=g, device=colors.device) * 2.0 - 1.0
    out = colors.clone()
    out[..., :3] = torch.clamp(colors[..., :3] + amount * off, 0.0, 1.0)
    return out
