"""Camera model: view/projection matrices and primary-ray generation —
the port of ``hikari_tpu.render.camera``. Bevy 0.9 cameras use an infinite
reversed-Z right-handed perspective (near plane depth = 1, infinity = 0),
the G-buffer depth convention of the reference (src/shaders/prepass.wgsl:87).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hikari_tpu_torch.utils import basis_apply, dot3_ordered, resolve_device
from hikari_tpu_torch.utils.block import current
from hikari_tpu_torch.utils.profiling import host_read


def look_at_transform(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera world transform looking from ``eye`` at ``target``
    (Bevy ``Transform::looking_at``): -Z forward, +Y up, +X right."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = r
    m[:3, 1] = u
    m[:3, 2] = -f
    m[:3, 3] = eye
    return m.astype(np.float32)


def perspective_infinite_reverse(fov_y: float, aspect: float, near: float) -> np.ndarray:
    """Bevy 0.9's ``Mat4::perspective_infinite_reverse_rh``: ndc depth =
    near / -z_view (reference src/prepass.rs:251-266)."""
    f = 1.0 / np.tan(0.5 * fov_y)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 3] = near
    m[3, 2] = -1.0
    return m


def _inv(m):
    """The f32 inverse, computed in f64 and rounded, so that the card and
    the CPU give the same matrix: under a moving camera its last bits move
    the depth and motion vectors, on which SMAA TU4x and TAA take exact
    ties on planar surfaces. inv_ex: no singularity check, so no
    device-to-host sync per frame."""
    return torch.linalg.inv_ex(m.double()).inverse.float()


@dataclass(frozen=True)
class Camera:
    """Camera state: world transforms (current and previous frame, for
    motion vectors and reprojection) and static intrinsics."""

    world_from_view: torch.Tensor  # (4,4)
    prev_world_from_view: torch.Tensor  # (4,4)
    fov_y: float = float(np.pi / 4)
    near: float = 0.1

    @staticmethod
    def from_lookat(eye, target, up=(0.0, 1.0, 0.0), prev_eye=None, prev_target=None,
                    fov_y: float = float(np.pi / 4), near: float = 0.1,
                    device=None) -> "Camera":
        """The camera's matrices live on ``device``: the CUDA card unless
        the caller names another (raises without a card)."""
        device = resolve_device(device)
        cur = look_at_transform(eye, target, up)
        prev = look_at_transform(prev_eye, prev_target, up) if prev_eye is not None else cur
        return Camera(
            world_from_view=torch.from_numpy(cur).to(device),
            prev_world_from_view=torch.from_numpy(np.array(prev)).to(device),
            fov_y=float(fov_y),
            near=float(near),
        )

    def to(self, device) -> "Camera":
        return Camera(self.world_from_view.to(device), self.prev_world_from_view.to(device),
                      self.fov_y, self.near)

    @property
    def device(self) -> torch.device:
        return self.world_from_view.device

    def projection(self, size_hw) -> torch.Tensor:
        h, w = size_hw
        m = perspective_infinite_reverse(self.fov_y, w / h, self.near)
        return host_read("camera_projection", lambda: torch.from_numpy(m).to(self.device))

    def view_proj(self, size_hw, previous: bool = False) -> torch.Tensor:
        """Clip-from-world matrix (Bevy ``view.view_proj``)."""
        world = self.prev_world_from_view if previous else self.world_from_view
        return self.projection(size_hw) @ _inv(world)

    @property
    def position(self) -> torch.Tensor:
        return self.world_from_view[:3, 3]

    def pixel_rays(self, size_hw, jitter=None):
        """Primary rays through (jittered) pixel centers of an image of
        ``size_hw``, at the pixels of the frame's block (``utils.block``:
        the whole image outside a sharded frame). ``jitter``: (2,) host
        offset in pixel units. Returns (origins, directions), each
        (block h, block w, 3), in world space."""
        h, w = size_hw
        dev = self.device
        ys, xs = current().coords(size_hw, dev, torch.float32)
        px = xs + 0.5
        py = ys + 0.5
        if jitter is not None:
            px = px + float(jitter[0])
            py = py + float(jitter[1])
        # The card's rays are the CPU twin's bit for bit: the divisors are
        # tensors (CUDA divides by a Python scalar as a product with its
        # reciprocal, the CPU divides), the norm is summed in order and its
        # root taken in f64 and rounded (neither device's f32 sqrt is
        # correctly rounded, and they differ).
        f = float(np.float32(1.0) / np.tan(np.float32(0.5 * self.fov_y)))
        w_t, h_t, f_t = (torch.full((), float(x), device=dev) for x in (w, h, f))
        ndc_x = 2.0 * px / w_t - 1.0
        ndc_y = 1.0 - 2.0 * py / h_t
        aspect = w / h
        dir_view = torch.stack(
            [ndc_x * aspect / f_t, ndc_y / f_t, -torch.ones_like(ndc_x)], dim=-1
        )
        dir_world = basis_apply(self.world_from_view[:3, :3], dir_view)
        n2 = dot3_ordered(dir_world, dir_world)[..., None]
        dir_world = dir_world / torch.sqrt(n2.double()).float()
        origin = self.position.expand(dir_world.shape)
        return origin, dir_world

    def depth_of(self, world_position) -> torch.Tensor:
        """Reversed-Z ndc depth of world points: near / view distance —
        the G-buffer ``position.w`` of the reference."""
        inv = _inv(self.world_from_view)
        z_view = dot3_ordered(world_position, inv[2, :3]) + inv[2, 3]
        return self.near / torch.clamp(-z_view, min=1e-8)
