"""Frame-persistent state records — the port of
``hikari_tpu.render.types``: the G-buffer, the cross-frame ``FrameState``
and the per-frame ``RenderOutputs``, as frozen dataclasses of tensors.
``FrameState.frame_number`` is a host int: it selects the validation
frames and the noise texture on the host, with no device sync."""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from hikari_bench.reference.render.restir import Reservoir


@dataclass(frozen=True)
class GBuffer:
    """The prepass MRTs (reference src/prepass.rs:43-47,
    src/shaders/prepass.wgsl:84-100), at full output resolution."""

    position: torch.Tensor  # (h, w, 4) world xyz + reversed-Z depth
    normal: torch.Tensor  # (h, w, 3)
    depth_gradient: torch.Tensor  # (h, w, 2)
    instance: torch.Tensor  # (h, w) i32 (-1 background)
    material: torch.Tensor  # (h, w) i32
    velocity_uv: torch.Tensor  # (h, w, 4) screen velocity xy + surface uv

    @staticmethod
    def zeros(shape_hw, device) -> "GBuffer":
        h, w = shape_hw

        def z(c):
            return torch.zeros((h, w, c), device=device)

        return GBuffer(
            position=z(4),
            normal=z(3),
            depth_gradient=z(2),
            instance=torch.full((h, w), -1, dtype=torch.int32, device=device),
            material=torch.full((h, w), -1, dtype=torch.int32, device=device),
            velocity_uv=z(4),
        )

    @property
    def depth(self) -> torch.Tensor:
        return self.position[..., 3]


@dataclass(frozen=True)
class FrameState:
    """Everything carried frame to frame (reference buffer pairing
    [(0,4),(2,4),(6,8)], src/light.rs:376, :518-546)."""

    frame_number: int
    prev_gbuffer: GBuffer
    direct_temporal: Reservoir
    emissive_temporal: Reservoir
    indirect_temporal: Reservoir
    de_spatial: Reservoir  # shared direct/emissive spatial
    indirect_spatial: Reservoir
    prev_tonemapped: torch.Tensor  # (rh, rw, 4)
    prev_taa: torch.Tensor  # (rh, rw, 4)
    prev_upscaled: torch.Tensor  # (2rh, 2rw, 4)

    def replace(self, **kw) -> "FrameState":
        return replace(self, **kw)


@dataclass(frozen=True)
class RenderOutputs:
    """Per-frame pass outputs for inspection and tests."""

    image: torch.Tensor  # (h, w, 4) final output
    albedo: torch.Tensor  # (h, w, 3)
    direct: torch.Tensor  # (rh, rw, 3)
    emissive: torch.Tensor
    indirect: torch.Tensor
    tonemapped: torch.Tensor  # (rh, rw, 4)
    stats: dict = None  # frame health counters (0-dim tensors) or None
