"""ReSTIR reservoirs: weighted reservoir sampling with temporal reuse —
the port of ``hikari_tpu.render.restir`` (reference
src/shaders/light.wgsl:33-224, :911-1004). Reservoirs are frozen
dataclasses of image-shaped tensors; every GPU "ptr<function>" mutation is
a masked functional update over the whole grid."""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from hikari_tpu_torch.utils import dot3, fract, map_tensors, safe_normalize


def _where(mask, a, b):
    """where(mask, a, b) with ``mask`` (...,) broadcast over trailing
    channel dims of a/b."""
    m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
    return torch.where(m, a, b)


@dataclass(frozen=True)
class Sample:
    """Reference ``Sample`` (light.wgsl:49-57)."""

    radiance: torch.Tensor  # (..., 4)
    random: torch.Tensor  # (..., 4)
    visible_position: torch.Tensor  # (..., 4) xyz + depth
    visible_normal: torch.Tensor  # (..., 3)
    visible_instance: torch.Tensor  # (...,) i32
    sample_position: torch.Tensor  # (..., 4) xyz + hit flag
    sample_normal: torch.Tensor  # (..., 3)

    @staticmethod
    def zeros(shape, device) -> "Sample":
        def z(c):
            return torch.zeros(tuple(shape) + (c,), device=device)

        return Sample(
            radiance=z(4),
            random=z(4),
            visible_position=z(4),
            visible_normal=z(3),
            visible_instance=torch.full(tuple(shape), -1, dtype=torch.int32, device=device),
            sample_position=z(4),
            sample_normal=z(3),
        )

    def select(self, mask, other: "Sample") -> "Sample":
        """where(mask, self, other) fieldwise; mask (...,)."""
        return Sample(
            radiance=_where(mask, self.radiance, other.radiance),
            random=_where(mask, self.random, other.random),
            visible_position=_where(mask, self.visible_position, other.visible_position),
            visible_normal=_where(mask, self.visible_normal, other.visible_normal),
            visible_instance=_where(mask, self.visible_instance, other.visible_instance),
            sample_position=_where(mask, self.sample_position, other.sample_position),
            sample_normal=_where(mask, self.sample_normal, other.sample_normal),
        )


@dataclass(frozen=True)
class Reservoir:
    """Reference ``Reservoir`` (light.wgsl:59-66)."""

    s: Sample
    count: torch.Tensor  # (...,)
    lifetime: torch.Tensor
    w: torch.Tensor
    w_sum: torch.Tensor
    w2_sum: torch.Tensor

    @staticmethod
    def zeros(shape, device) -> "Reservoir":
        z = torch.zeros(tuple(shape), device=device)
        return Reservoir(s=Sample.zeros(shape, device), count=z, lifetime=z, w=z, w_sum=z, w2_sum=z)

    def select(self, mask, other: "Reservoir") -> "Reservoir":
        return Reservoir(
            s=self.s.select(mask, other.s),
            count=torch.where(mask, self.count, other.count),
            lifetime=torch.where(mask, self.lifetime, other.lifetime),
            w=torch.where(mask, self.w, other.w),
            w_sum=torch.where(mask, self.w_sum, other.w_sum),
            w2_sum=torch.where(mask, self.w2_sum, other.w2_sum),
        )


def set_reservoir(s: Sample, w_new) -> Reservoir:
    """Reference ``set_reservoir`` (light.wgsl:138-144)."""
    return Reservoir(
        s=s,
        count=torch.ones_like(w_new),
        lifetime=torch.zeros_like(w_new),
        w=torch.zeros_like(w_new),
        w_sum=w_new,
        w2_sum=w_new * w_new,
    )


def _update(r: Reservoir, s: Sample, w_new):
    """``update_reservoir`` without its mask, and where it took ``s``."""
    w_sum = r.w_sum + w_new
    w2_sum = r.w2_sum + w_new * w_new
    count = r.count + 1.0
    rand = fract(s.random.sum(-1))
    replace_mask = rand < w_new / torch.where(w_sum == 0.0, 1.0, w_sum)
    out = Reservoir(
        s=s.select(replace_mask, r.s),
        count=count,
        lifetime=r.lifetime,
        w=r.w,
        w_sum=w_sum,
        w2_sum=w2_sum,
    )
    return out, replace_mask


def update_reservoir(r: Reservoir, s: Sample, w_new, mask=None) -> Reservoir:
    """Weighted random replacement (reference ``update_reservoir``,
    light.wgsl:146-173); ``mask`` gates the whole update."""
    out, _ = _update(r, s, w_new)
    if mask is not None:
        out = out.select(mask, r)
    return out


def merge_reservoir(r: Reservoir, other: Reservoir, p, mask=None) -> Reservoir:
    """Reference ``merge_reservoir`` (light.wgsl:175-179)."""
    return merge_reservoir_taken(r, other, p, mask)[0]


def merge_reservoir_taken(r: Reservoir, other: Reservoir, p, mask=None):
    """``merge_reservoir`` and where it took ``other``'s sample (under
    ``mask``)."""
    merged, taken = _update(r, other.s, p * other.w * other.count)
    merged = replace(merged, count=r.count + other.count)
    if mask is not None:
        merged = merged.select(mask, r)
        taken = taken & mask
    return merged, taken


def clamp_reservoir(r: Reservoir, max_count) -> Reservoir:
    """Count clamp rescaling w_sum/w2_sum (reference light.wgsl:945-951)."""
    m = float(max_count)
    over = r.count > m
    scale = torch.where(over, m / torch.clamp(r.count, min=1e-8), 1.0)
    return replace(
        r,
        count=torch.where(over, m, r.count),
        w_sum=r.w_sum * scale,
        w2_sum=r.w2_sum * scale,
    )


def temporal_restir(r: Reservoir, s: Sample, w_new, max_count, mask=None) -> Reservoir:
    """Reference ``temporal_restir`` (light.wgsl:937-952)."""
    out = clamp_reservoir(update_reservoir(r, s, w_new), max_count)
    if mask is not None:
        out = out.select(mask, r)
    return out


def check_previous_reservoir(r: Reservoir, s: Sample):
    """Geometric validation of a reprojected reservoir (reference
    ``check_previous_reservoir``, light.wgsl:917-935). Returns (validated
    reservoir, ok mask)."""
    depth_prev = r.s.visible_position[..., 3]
    depth_cur = s.visible_position[..., 3]
    ratio = depth_prev / torch.where(depth_cur == 0.0, 1e-8, depth_cur)
    ratio = torch.where(ratio < 1.0, 1.0 / torch.where(ratio == 0.0, 1e-8, ratio), ratio)
    depth_miss = ratio > 1.05 * (1.0 + 0.5 * s.random[..., 0])
    instance_miss = r.s.visible_instance != s.visible_instance
    normal_miss = dot3(s.visible_normal, r.s.visible_normal) < 0.9
    ok = ~(depth_miss | normal_miss | instance_miss)
    return r.select(ok, Reservoir.zeros(ok.shape, ok.device)), ok


def reservoir_variance(r: Reservoir, max_variance: float):
    """Per-pixel variance estimate (reference light.wgsl:1224-1227)."""
    count = torch.clamp(r.count, min=1e-8)
    var = r.w2_sum / count - torch.square(r.w_sum / count)
    var = torch.where(r.count < 1.0, var, var / count)
    return torch.clamp(var, max=max_variance)


def compress_reservoir(r: Reservoir) -> Reservoir:
    """Storage packing of the cross-frame reservoir state, mirroring the
    reference's 64-byte ``PackedReservoir`` (light.wgsl:35-43): everything
    f16 (round to nearest-even, as XLA's conversion) except positions (f32)
    and the instance id (i32). Passes compute in f32."""
    s = r.s
    half = {
        f: getattr(s, f).to(torch.float16)
        for f in ("radiance", "random", "visible_normal", "sample_normal")
    }
    return Reservoir(
        s=Sample(
            visible_position=s.visible_position.to(torch.float32),
            visible_instance=s.visible_instance.to(torch.int32),
            sample_position=s.sample_position.to(torch.float32),
            **half,
        ),
        count=r.count.to(torch.float16),
        lifetime=r.lifetime.to(torch.float16),
        w=r.w.to(torch.float16),
        w_sum=r.w_sum.to(torch.float16),
        w2_sum=r.w2_sum.to(torch.float16),
    )


def decompress_reservoir(r: Reservoir) -> Reservoir:
    """Upcast a packed reservoir back to f32 compute precision."""
    return map_tensors(lambda x: x.to(torch.float32) if x.dtype == torch.float16 else x, r)


def finalize_w(r: Reservoir, target_luminance) -> Reservoir:
    """Unbiased contribution weight W = w_sum / (count * p_target)
    (reference light.wgsl:1216-1217), with the ``stable_div`` backward."""
    from hikari_tpu_torch.diff import stable_div

    total = r.count * target_luminance
    w = torch.where(
        total > 0.0, stable_div(r.w_sum, torch.where(total == 0.0, 1.0, total)), 0.0
    )
    return replace(r, w=w)


def compute_jacobian(q: Sample, r: Sample):
    """GRIS reconnection Jacobian, clamped to [1, 50] (reference
    ``compute_jacobian``, light.wgsl:985-1004)."""
    normal = q.sample_normal
    d_r = r.visible_position[..., :3] - q.sample_position[..., :3]
    d_q = q.visible_position[..., :3] - q.sample_position[..., :3]
    cos_phi_1 = dot3(safe_normalize(d_r), normal).abs()
    cos_phi_2 = dot3(safe_normalize(d_q), normal).abs()
    term_1 = cos_phi_1 / torch.clamp(cos_phi_2, min=0.0001)
    term_2 = (d_q * d_q).sum(-1) / torch.clamp((d_r * d_r).sum(-1), min=0.0001)
    return torch.clamp(term_1 * term_2, 1.0, 50.0)


def compute_inv_jacobian(current: Sample, neighbor: Sample):
    """Inverse-form Jacobian with visibility-cone rejections, in [0.06, 1]
    or 0 (reference ``compute_inv_jacobian``, light.wgsl:954-983)."""
    offset_b = neighbor.sample_position[..., :3] - neighbor.visible_position[..., :3]
    offset_a = neighbor.sample_position[..., :3] - current.visible_position[..., :3]
    front = dot3(current.visible_normal, offset_a) > 0.0
    rb2 = (offset_b * offset_b).sum(-1)
    ra2 = (offset_a * offset_a).sum(-1)
    ob = safe_normalize(offset_b)
    oa = safe_normalize(offset_a)
    cos_a = dot3(current.visible_normal, oa)
    cos_b = dot3(neighbor.visible_normal, ob)
    cos_phi_a = -dot3(oa, neighbor.sample_normal)
    cos_phi_b = -dot3(ob, neighbor.sample_normal)
    valid = (
        front
        & (cos_b > 0.0)
        & (cos_phi_b > 0.0)
        & (cos_a > 0.0)
        & (cos_phi_a > 0.0)
        & (ra2 > 0.0)
        & (rb2 > 0.0)
    )
    denominator = rb2 * cos_phi_a
    numerator = ra2 * cos_phi_b
    jac = torch.clamp(
        numerator / torch.where(denominator <= 0.0, 1.0, denominator), 0.06, 1.0
    )
    return torch.where(valid & (denominator > 0.0), jac, 0.0)
