"""Ray-tracing API: closest-hit queries over the compiled scene, in plain
PyTorch: every ray against every triangle (``trace/closest_hit``), the
search of the small scenes, and above them, or for any tracer name but
the small-scene ones, the clustered search (``trace/accel``), which
returns the same answers bit for bit.

The search is not differentiable (it returns integer hit ids plus
detached (t, u, v)); ``refine_hit`` / ``hit_info`` recompute (t, u, v) at
the fixed hit triangle from ``scene.tri_world``, so gradients reach the
vertices through them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from hikari_bench.reference.config import DISTANCE_MAX, F32_MAX
from hikari_bench.reference.diff import clip_gradient
from hikari_bench.reference.scene.buffers import SceneBuffers
from hikari_bench.reference.trace import accel
from hikari_bench.reference.trace.closest_hit import closest_hit, pack_triangles
from hikari_bench.reference.trace.intersect import intersects_triangle
from hikari_bench.reference.utils import safe_normalize, take_rows

# trace_rays calls with rays on a CUDA device, and rays searched.
trace_calls = 0
rays_traced = 0

# The port's tracer names; the answer is the exact closest hit for each.
METHODS = ("auto", "auto_xla", "pallas", "pallas_tiled", "scatter", "tiled", "bvh", "bruteforce")
# The names that test every triangle up to ``bruteforce_max_tris``.
EVERY_TRIANGLE = ("auto", "auto_xla", "pallas", "bruteforce")


@dataclass(frozen=True)
class Hit:
    """SoA hit record (reference ``Hit``, light.wgsl:275-279). Miss is
    ``prim == -1`` / ``inst == -1`` with ``t = min(max_distance, F32_MAX)``."""

    t: torch.Tensor  # (...,) f32
    prim: torch.Tensor  # (...,) i32, -1 = miss
    inst: torch.Tensor  # (...,) i32, -1 = miss
    u: torch.Tensor  # (...,) f32 barycentric
    v: torch.Tensor  # (...,) f32

def trace_rays(
    scene: SceneBuffers,
    origin,
    direction,
    max_distance=None,
    early_distance=None,
    exclude_instance=None,
    range_lo=None,
    range_hi=None,
    method: str = "auto",
    bruteforce_max_tris: int = 2048,
    max_steps: int = 0,
) -> Hit:
    """Closest-hit query. origin/direction: (...,3). Optional per-ray
    scalars (broadcast to the ray shape): max_distance, exclude_instance
    (i32, -1 = none), and a primitive id range [range_lo, range_hi).
    ``early_distance`` and ``max_steps`` are accepted and ignored: the
    answer is always the exact closest hit.

    ``method`` is any of the port's names (``METHODS``). "auto",
    "auto_xla", "pallas" and "bruteforce" test every triangle up to
    ``bruteforce_max_tris`` triangles; above that, and for the other
    names, the clustered search (``trace/accel``) gives the same answer.
    Among hits at exactly equal t all but "bruteforce" keep a best per
    (prim mod 8) sublane and halve the eight towards the lower sublane
    unless the upper one is strictly nearer, so the sublanes win in the
    order 0, 4, 2, 6, 1, 5, 3, 7 (K1's rule). "bruteforce" keeps the
    lowest prim among equal t."""
    global trace_calls, rays_traced
    if method not in METHODS:
        raise ValueError(f"the reference has no trace method {method!r}")
    shape = origin.shape[:-1]
    o = origin.detach().reshape(-1, 3).to(torch.float32).contiguous()
    d = direction.detach().reshape(-1, 3).to(torch.float32).contiguous()
    R, dev = o.shape[0], o.device

    def per_ray(x, default, dtype):
        if x is None:
            return torch.full((R,), default, dtype=dtype, device=dev)
        x = torch.as_tensor(x, device=dev).detach().to(dtype)
        return torch.broadcast_to(x, shape).reshape(-1).contiguous()

    maxd = per_ray(max_distance, F32_MAX, torch.float32)
    excl = per_ray(exclude_instance, -1, torch.int32)
    lo = per_ray(range_lo, 0, torch.int32)
    hi = per_ray(range_hi, scene.num_tris, torch.int32)
    tie = "bruteforce" if method == "bruteforce" else "pallas"
    if method in EVERY_TRIANGLE and scene.num_tris <= bruteforce_max_tris:
        t, prim, u, v = closest_hit(o, d, maxd, excl, lo, hi, pack_triangles(scene), tie)
    else:
        t, prim, u, v = accel.closest_hit_clustered(o, d, maxd, excl, lo, hi,
                                                    accel.clusters(scene), tie)
    rays_traced += R
    if dev.type == "cuda" and R:
        trace_calls += 1
    inst = torch.where(prim >= 0, scene.tri_inst[prim.clamp(min=0)], -1).to(torch.int32)
    return Hit(
        t=t.reshape(shape),
        prim=prim.reshape(shape),
        inst=inst.reshape(shape),
        u=u.reshape(shape),
        v=v.reshape(shape),
    )


# ---------------------------------------------------------------------------
# Differentiable hit attribute reconstruction
# ---------------------------------------------------------------------------


def gather_triangle_vertices(tri_world, prim):
    """Hit-triangle vertices (v0, v1, v2), each (..., 3); differentiable
    with respect to ``tri_world``."""
    v = take_rows(tri_world.reshape(tri_world.shape[0], 9), prim)
    return v[..., 0:3], v[..., 3:6], v[..., 6:9]


def refine_hit(scene: SceneBuffers, origin, direction, hit: Hit):
    """Recompute (t, u, v) differentiably at the fixed hit triangle — the
    fixed-topology gradient path. Misses keep their sentinel values."""
    v0, v1, v2 = gather_triangle_vertices(scene.tri_world, hit.prim.clamp(min=0))
    return _refine_from_vertices(origin, direction, hit, v0, v1, v2)


def _refine_from_vertices(origin, direction, hit: Hit, v0, v1, v2):
    # Firewalls on both sides of the refine math (see hikari_tpu.trace.api).
    v0 = clip_gradient(v0, 1e6, "refine_verts")
    v1 = clip_gradient(v1, 1e6, "refine_verts")
    v2 = clip_gradient(v2, 1e6, "refine_verts")
    t, u, v = intersects_triangle(origin, direction, v0, v1, v2)
    t = clip_gradient(t, 1e4, "refine_tuv")
    u = clip_gradient(u, 1e4, "refine_tuv")
    v = clip_gradient(v, 1e4, "refine_tuv")
    miss = hit.prim < 0
    return (
        torch.where(miss, hit.t, t),
        torch.where(miss, hit.u, u),
        torch.where(miss, hit.v, v),
    )


@dataclass(frozen=True)
class HitInfo:
    """Interpolated surface info (reference ``HitInfo``/``hit_info``,
    light.wgsl:290-296, :496-523). ``position`` carries the hit flag in w
    (1 = hit, 0 = miss at origin + DISTANCE_MAX * dir)."""

    position: torch.Tensor  # (..., 4)
    normal: torch.Tensor  # (..., 3)
    uv: torch.Tensor  # (..., 2)
    instance: torch.Tensor  # (...,) i32, -1 = miss
    material: torch.Tensor  # (...,) i32, -1 = miss


def _hit_rows(scene: SceneBuffers):
    """Per-triangle rows (P, 24): [v0 v1 v2 (9) | n0 n1 n2 (9) |
    uv0 uv1 uv2 (6)], so one row gather by prim serves the refine
    vertices and the vertex attributes."""
    P = scene.tri_world.shape[0]
    attr = torch.cat([scene.vert_normal, scene.vert_uv], dim=-1)[scene.tri_vidx]  # (P,3,5)
    return torch.cat(
        [
            scene.tri_world.reshape(P, 9),
            attr[..., :3].reshape(P, 9),
            attr[..., 3:].reshape(P, 6),
        ],
        dim=-1,
    )


def hit_info(scene: SceneBuffers, origin, direction, hit: Hit) -> HitInfo:
    """Reference ``hit_info`` (light.wgsl:496-523): barycentric-interpolated
    uv + world normal from vertex attributes, world position from the
    (differentiably refined) distance."""
    safe_prim = hit.prim.clamp(min=0)
    rows = take_rows(_hit_rows(scene), safe_prim)  # (..., 24)
    v0, v1, v2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    t, u, v = _refine_from_vertices(origin, direction, hit, v0, v1, v2)
    n0, n1, n2 = rows[..., 9:12], rows[..., 12:15], rows[..., 15:18]
    uv0, uv1, uv2 = rows[..., 18:20], rows[..., 20:22], rows[..., 22:24]
    tri_material = scene.inst_material[scene.tri_inst.clamp(min=0)][safe_prim]
    uu = u[..., None]
    vv = v[..., None]
    normal = safe_normalize(n0 + uu * (n1 - n0) + vv * (n2 - n0))
    uv = uv0 + uu * (uv1 - uv0) + vv * (uv2 - uv0)

    miss = hit.prim < 0
    # Straight-through clamp of the refined distance to the trace bound
    # (value clamped, gradient untouched), as in the JAX package.
    t = t + (torch.clamp(t, max=DISTANCE_MAX) - t).detach()
    pos_hit = origin + direction * t[..., None]
    pos_miss = origin + direction * DISTANCE_MAX
    position = torch.where(miss[..., None], pos_miss, pos_hit)
    w = torch.where(miss, 0.0, 1.0)
    position = torch.cat([position, w[..., None]], dim=-1)

    return HitInfo(
        position=position,
        normal=torch.where(miss[..., None], 0.0, normal),
        uv=torch.where(miss[..., None], 0.0, uv),
        instance=hit.inst,
        material=torch.where(miss, -1, tri_material).to(torch.int32),
    )


def occlude_hit_info(origin, direction, hit: Hit, info: HitInfo) -> HitInfo:
    """Reference ``occlude_hit_info`` (light.wgsl:526-533): after a shadow
    ray, replace the light-sample info with the occluder on hit (position
    flag stays 1, normal zeroed)."""
    occluded = hit.prim >= 0
    pos = origin + direction * hit.t[..., None]
    position = torch.where(
        occluded[..., None], torch.cat([pos, torch.ones_like(pos[..., :1])], dim=-1), info.position
    )
    return HitInfo(
        position=position,
        normal=torch.where(occluded[..., None], 0.0, info.normal),
        uv=info.uv,
        instance=torch.where(occluded, hit.inst, info.instance).to(torch.int32),
        material=torch.where(occluded, -1, info.material).to(torch.int32),
    )
