"""Core intersection math on tensors: Möller-Trumbore, the AABB slab test
and the point-in-box test (reference src/shaders/light.wgsl:340-398) and
the plane/dual-basis
triangle precomputation the closest-hit search consumes — the port of
``hikari_tpu.trace.intersect``. Everything broadcasts over leading dims."""

from __future__ import annotations

import torch

from hikari_bench.reference.config import F32_EPSILON, F32_MAX
from hikari_bench.reference.utils import cross, dot3_ordered

# |det| guard of the refine recompute: bounds 1/det (and its backward) for
# grazing hits; forward values change only for |det| < 1e-6.
DET_GUARD = 1e-6


def inside_aabb(p, aabb_min, aabb_max):
    """Point-in-box (reference light.wgsl:340-342, strict inequalities)."""
    return ((p > aabb_min) & (p < aabb_max)).all(-1)


def intersects_triangle(origin, direction, v0, v1, v2):
    """Möller-Trumbore without backface culling (reference
    light.wgsl:364-398). Returns (t, u, v) with t = F32_MAX on miss."""
    ab = v1 - v0
    ac = v2 - v0
    u_vec = cross(direction, ac)
    det = dot3_ordered(ab, u_vec)
    safe_det = torch.where(
        det.abs() < DET_GUARD,
        torch.where(det < 0.0, -DET_GUARD, DET_GUARD),
        det,
    )
    inv_det = 1.0 / safe_det
    ao = origin - v0
    u = dot3_ordered(ao, u_vec) * inv_det
    v_vec = cross(ao, ab)
    v = dot3_ordered(direction, v_vec) * inv_det
    t = dot3_ordered(ac, v_vec) * inv_det
    valid = (
        (det.abs() >= F32_EPSILON)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > F32_EPSILON)
    )
    return torch.where(valid, t, F32_MAX), u, v


def precompute_triangles(tri_world):
    """Plane + barycentric dual basis of each triangle (v0, v1, v2):
    e1=v1-v0, e2=v2-v0, n=cross(e1,e2), eu=cross(e2,n)/|n|^2,
    ev=cross(n,e1)/|n|^2, so that a plane point p has u=(p-v0)·eu,
    v=(p-v0)·ev, and a ray hits the plane at t=(v0·n - o·n)/(d·n).
    Returns a dict of (P,3) n/eu/ev, (P,) cn/cu/cv and the valid mask."""
    v0 = tri_world[:, 0]
    e1 = tri_world[:, 1] - v0
    e2 = tri_world[:, 2] - v0
    n = cross(e1, e2)
    n2 = dot3_ordered(n, n)[..., None]
    valid = n2[..., 0] > 1e-24
    inv_n2 = 1.0 / torch.clamp(n2, min=1e-24)
    eu = cross(e2, n) * inv_n2
    ev = cross(n, e1) * inv_n2
    return dict(
        n=n,
        eu=eu,
        ev=ev,
        cn=dot3_ordered(v0, n),
        cu=dot3_ordered(v0, eu),
        cv=dot3_ordered(v0, ev),
        valid=valid,
    )
