"""Differentiable-rendering utilities — the counterpart of
``hikari_tpu.diff``: the gradient firewalls ``clip_gradient`` and
``stable_div`` as ``torch.autograd.Function``s (plain identity and plain
division in the forward pass), the image loss, central finite differences
and the functional update of ``SceneBuffers`` leaves."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

# site name -> int64 tensor [cotangents engaged (NaN or |g| > limit),
# cotangents seen], on the device of the site's cotangents; filled in the
# backward when HIKARI_COUNT_CLIP=1, read by clip_engagement_report.
CLIP_ENGAGEMENT: dict[str, torch.Tensor] = {}


def _record_clip_engagement(name, g, limit):
    """Add one backward's counts to the site's tensor, on the device:
    no host sync in the backward."""
    engaged = (torch.isnan(g) | (g.abs() > limit)).sum(dtype=torch.int64)
    seen = torch.full_like(engaged, g.numel())
    key = name or "<anon>"
    ent = CLIP_ENGAGEMENT.get(key)
    counts = torch.stack([engaged, seen])
    CLIP_ENGAGEMENT[key] = counts if ent is None else ent + counts.to(ent.device)


def reset_clip_engagement():
    CLIP_ENGAGEMENT.clear()


def clip_engagement_report() -> dict[str, tuple[int, int, float]]:
    """{site: (engaged, total, rate)} accumulated since the last reset; one
    host read of the counts."""
    out = {}
    for k, ent in sorted(CLIP_ENGAGEMENT.items()):
        e, t = (int(x) for x in ent.tolist())
        out[k] = (e, t, e / t if t else 0.0)
    return out


class _ClipGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, limit, name):
        ctx.limit = limit
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if os.environ.get("HIKARI_COUNT_CLIP"):
            _record_clip_engagement(ctx.name, g, ctx.limit)
        g = torch.where(torch.isnan(g), 0.0, g)
        return torch.clamp(g, -ctx.limit, ctx.limit), None, None


def clip_gradient(x, limit: float = 1e6, name: str = ""):
    """Identity forward; NaN-scrubs and clips the cotangent to
    [-limit, limit] in backward (the coarse safety net at pass boundaries
    and estimator weights).

    Set HIKARI_NO_GRAD_CLIP=1 to run without the firewall (it is read at
    call time, as in the JAX package). Set HIKARI_COUNT_CLIP=1 to count
    per ``name`` site how many cotangents the clamp engages
    (``clip_engagement_report``)."""
    if os.environ.get("HIKARI_NO_GRAD_CLIP"):
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ClipGradient.apply(x, limit, name)


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


def l2_image_loss(image, target):
    d = image[..., :3] - target[..., :3]
    return torch.mean(d * d)


def finite_difference_grad(f, x, eps: float = 1e-3, indices=None):
    """Central finite differences of scalar ``f`` at numpy array ``x``, at
    the given flat ``indices`` (all when None); ``f`` takes a float32 numpy
    array. The test-harness half of the gradient gate."""
    x = np.asarray(x, dtype=np.float64)
    flat = x.reshape(-1).copy()
    if indices is None:
        indices = range(flat.size)
    g = np.zeros(flat.size)
    for i in indices:
        xp = flat.copy()
        xp[i] += eps
        xm = flat.copy()
        xm[i] -= eps
        g[i] = (
            float(f(xp.reshape(x.shape).astype(np.float32)))
            - float(f(xm.reshape(x.shape).astype(np.float32)))
        ) / (2 * eps)
    return g.reshape(x.shape)


def replace_scene_field(scene, **updates):
    """Functional update of ``SceneBuffers`` leaves (a frozen dataclass)."""
    return dataclasses.replace(scene, **updates)
