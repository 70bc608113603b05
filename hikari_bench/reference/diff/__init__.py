"""The frame's gradient firewalls as ``torch.autograd.Function``s:
``clip_gradient`` (identity forward) and ``stable_div`` (plain division
forward)."""

from __future__ import annotations

import torch


class _ClipGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, limit):
        ctx.limit = limit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), 0.0, g)
        return torch.clamp(g, -ctx.limit, ctx.limit), None


def clip_gradient(x, limit: float = 1e6, name: str = ""):
    """Identity forward; NaN-scrubs and clips the cotangent to
    [-limit, limit] in backward (the coarse safety net at pass boundaries
    and estimator weights). ``name`` labels the site in the caller."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ClipGradient.apply(x, limit)


class _StableDiv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        out = a / b
        ctx.save_for_backward(b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        b, out = ctx.saved_tensors
        gb = g / b

        def scrub(x):
            return torch.where(torch.isfinite(x), x, 0.0)

        return scrub(gb), scrub(-gb * out)


def stable_div(a, b):
    """``a / b`` with the overflow-reassociated backward
    ``db = -(g / b) * (a / b)``; non-finite cotangents scrub to 0."""
    a, b = torch.broadcast_tensors(a, b)
    if not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        return a / b
    return _StableDiv.apply(a, b)
