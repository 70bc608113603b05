"""``RenderSettings.stop_after``: the profiling truncations of the frame —
the port of the JAX package's ``_truncate``/``_trunc`` helpers
(``render/pipeline.py``, ``render/gbuffer.py``, ``render/light.py``,
``render/smaa.py``).

A frame cut after a stage reduces everything computed so far to one
scalar, so that nothing before the cut is skipped and consecutive-prefix
time deltas price each stage (``hikari_tpu_torch.tools.profile_prefix``).
The stop points are the JAX package's: the coarse passes, and
``<pass>:<stage>`` points inside the G-buffer, the light channels and
SMAA. The JAX package renders the whole frame for a string it does not
know; the port raises, so a prefix time is never read off a whole frame.
"""

from __future__ import annotations

import torch

from hikari_tpu_torch.utils import map_tensors

COARSE = ("gbuffer", "albedo", "direct", "emissive", "indirect", "denoise", "tonemap", "smaa",
          "taa")
_CHANNEL = ("fetch", "reproject", "candidate", "trace", "restir")
FINE = {
    "gbuffer": ("trace", "hitinfo"),
    "direct": _CHANNEL,
    "emissive": _CHANNEL,
    "indirect": ("fetch", "bounce", "nee", "restir"),
    "smaa": ("velq", "gather", "clip", "remix", "extrap"),
}
STOP_POINTS = COARSE + tuple(f"{p}:{s}" for p, stages in FINE.items() for s in stages)


def check_stop(stop_after) -> None:
    """Raise ValueError for a ``stop_after`` that is not a stop point."""
    if stop_after is not None and stop_after not in STOP_POINTS:
        raise ValueError(
            f"stop_after={stop_after!r} is not a stop point of the JAX package; "
            f"one of {', '.join(STOP_POINTS)}"
        )


def tensor_leaves(*trees) -> list:
    """The tensors inside ``trees`` in field order (the JAX package's
    ``tree_leaves`` order for the same records)."""
    out = []
    map_tensors(lambda t: out.append(t) or t, trees)
    return out


def prefix_sum(*trees):
    """The pipeline's reduction (JAX ``_truncate``): the sum of every
    float leaf, as it is."""
    return sum(v.to(torch.float32).sum() for v in tensor_leaves(*trees) if v.is_floating_point())


def channel_sum(*trees):
    """The light channels' reduction (JAX ``light.py`` ``_trunc``): the
    float leaves with non-finite values zeroed and clipped to +-1e6."""
    total = 0
    for v in tensor_leaves(*trees):
        if v.is_floating_point():
            vf = v.to(torch.float32)
            vf = torch.where(torch.isfinite(vf), vf, 0.0)
            total = total + torch.clamp(vf, -1e6, 1e6).sum()
    return total


def pass_sum(*trees):
    """The G-buffer's and SMAA's reduction (JAX ``gbuffer.py``/``smaa.py``
    ``_trunc``): every leaf, integer and boolean ones too, through
    ``nan_to_num`` and clipped to +-1e6."""
    return sum(
        torch.clamp(torch.nan_to_num(v.to(torch.float32)), -1e6, 1e6).sum()
        for v in tensor_leaves(*trees)
    )
