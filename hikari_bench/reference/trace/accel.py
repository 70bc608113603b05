"""An exact closest-hit search for a scene of any size, in plain PyTorch:
the reference's answer above ``bruteforce_max_tris`` triangles and for
every tracer name but the small-scene ones (``trace/api.trace_rays``).

Each ray/triangle pair it tests is computed with the arithmetic of the
K1 twin (``trace/closest_hit.closest_hit_reference``), operation for
operation, on the same packed rows, and among the pairs that hit it keeps
the least key (t, rank, prim): ``rank`` is the 3-bit reversal of the
sublane ``prim mod 8`` under ``tie="pallas"`` (so among equal t the
sublanes win in the order 0, 4, 2, 6, 1, 5, 3, 7, then the lowest prim,
as K1's halving does) and 0 under ``tie="bruteforce"`` (the lowest prim).
So its (t, prim, u, v) equal the twin's test of every triangle, bit for
bit, on any scene; only which pairs it tests differs.

Which pairs: the triangles, sorted by the Morton code of their centres,
form clusters of ``CLUSTER`` and the clusters groups of ``GROUP``. A block
of rays tests every group's box, then the boxes of the clusters in the
groups it enters; each ray then takes its entered clusters near to far in
rounds (2, 4, 8, ... at a time), and a cluster whose entry lies beyond the
ray's best t so far is dropped untested.

A box may drop no pair that the twin's arithmetic would accept. The box of
a triangle is that of the triangle its packed rows describe (the corners
at (u, v) = (0, 0), (1, 0), (0, 1) on its plane, solved in float64), grown
by a margin that bounds how far from it a point the twin accepts can lie:
the float32 rounding of the twin's t, u and v moves an accepted point by a
few units of float32 rounding times the lengths involved (the origin's,
the corner's, the ray's), scaled by how skewed the triangle's dual basis
is (``cond``). The margin takes ``MARGIN_K`` such units, several times the
bound, and box tests run in float64. A triangle too skewed for a
meaningful box (``cond`` over ``MAX_COND``, or corners that do not solve)
is tested against every ray. A ray that is not finite, or whose distance
or prim range admits no hit, hits nothing, as in the twin.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import torch

from hikari_bench.reference.config import F32_EPSILON, F32_MAX
from hikari_bench.reference.trace.closest_hit import SUBLANES, TIE_RULES, pack_triangles

CLUSTER = 32  # triangles a cluster
GROUP = 32  # clusters a group
# Box tests and ray/triangle pair tests a chunk: bounds the temporaries.
BOX_CHUNK = 1 << 23
PAIR_CHUNK = 1 << 22
FIRST_ROUND = 2  # clusters a ray tests in its first round; doubling after
# A ray whose prim range holds at most this many prims tests each of them.
NARROW = 512
UNIT = 2.0**-24  # float32's unit roundoff
MARGIN_K = 128.0
MAX_COND = 1e4
MORTON_BITS = 10
NO_KEY = torch.iinfo(torch.int64).max
# Stands in for a zero direction component in the slab test: the slab then
# admits the ray where its origin lies on or inside it, and never beyond.
TINY = 1e-300
# The sublane's rank under K1's halving: the 3-bit reversal of prim mod 8.
SUBLANE_RANK = (0, 4, 2, 6, 1, 5, 3, 7)


@dataclass(frozen=True)
class Clusters:
    """A scene's triangles as the search walks them. Boxes are float64;
    ``cond`` and ``span`` give each box's margin for a ray (``margin``)."""

    packed: torch.Tensor  # (P, 16) f32, ``pack_triangles``
    order: torch.Tensor  # (C * CLUSTER,) i64 prims in cluster order, -1 padding
    lo: torch.Tensor  # (C, 3) f64
    hi: torch.Tensor  # (C, 3) f64
    cond: torch.Tensor  # (C,) f64
    span: torch.Tensor  # (C,) f64
    pmin: torch.Tensor  # (C,) i64 least prim
    pmax: torch.Tensor  # (C,) i64 greatest prim
    glo: torch.Tensor  # (G, 3) f64: the groups
    ghi: torch.Tensor
    gcond: torch.Tensor
    gspan: torch.Tensor
    gpmin: torch.Tensor
    gpmax: torch.Tensor
    loose: torch.Tensor  # (Q,) i64 prims tested against every ray
    cmax: float  # the largest corner's length

    @property
    def num_clusters(self) -> int:
        return self.lo.shape[0]


def _morton(c, lo, hi):
    """30-bit Morton codes of points (N, 3) in the box [lo, hi]."""
    cells = (1 << MORTON_BITS) - 1
    q = ((c - lo) / torch.clamp(hi - lo, min=1e-30) * cells).clamp(0, cells).long()
    code = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    for b in range(MORTON_BITS):
        for k in range(3):
            code |= ((q[:, k] >> b) & 1) << (3 * b + k)
    return code


def _reduce(x, n, size, fill, op):
    """``op`` ("amin"/"amax") over consecutive runs of ``size`` rows of x
    (N, ...), padded with ``fill`` to ``n * size`` rows."""
    pad = n * size - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])
    x = x.reshape((n, size) + x.shape[1:])
    return x.amin(1) if op == "amin" else x.amax(1)


def build(scene) -> Clusters:
    """The search's clusters of ``scene`` (a ``SceneBuffers``)."""
    packed = pack_triangles(scene)
    f = packed.double()
    n, eu, ev = f[:, 0:3], f[:, 3:6], f[:, 6:9]
    inv, _ = torch.linalg.inv_ex(torch.stack([eu, ev, n], dim=1))
    e1, e2, nn = inv[..., 0], inv[..., 1], inv[..., 2]
    c0 = (inv @ torch.stack([f[:, 10], f[:, 11], f[:, 9]], dim=1)[..., None])[..., 0]
    corners = torch.stack([c0, c0 + e1, c0 + e2], dim=1)
    span = e1.norm(dim=1) + e2.norm(dim=1)
    cond = (eu.norm(dim=1) + ev.norm(dim=1)) * span + n.norm(dim=1) * nn.norm(dim=1)
    valid = packed[:, 12] > 0.5
    finite = torch.isfinite(corners).flatten(1).all(1) & torch.isfinite(cond)
    bounded = valid & finite & (cond <= MAX_COND)
    loose = torch.nonzero(valid & ~bounded)[:, 0]
    prims = torch.nonzero(bounded)[:, 0]
    lo, hi = corners[prims].amin(1), corners[prims].amax(1)
    if prims.numel():
        centre = 0.5 * (lo + hi)
        key = _morton(centre, lo.amin(0), hi.amax(0))
        sort = torch.sort(key, stable=True).indices
        prims, lo, hi = prims[sort], lo[sort], hi[sort]
        cond, span = cond[prims], span[prims]
        cmax = float(corners[prims].norm(dim=-1).max())
    else:
        cond = span = lo.new_zeros(0)
        cmax = 0.0
    C = -(-prims.numel() // CLUSTER)
    G = -(-C // GROUP)
    order = torch.cat([prims, prims.new_full((C * CLUSTER - prims.numel(),), -1)])
    inf = float("inf")
    clo = _reduce(lo, C, CLUSTER, inf, "amin")
    chi = _reduce(hi, C, CLUSTER, -inf, "amax")
    ccond = _reduce(cond, C, CLUSTER, 0.0, "amax")
    cspan = _reduce(span, C, CLUSTER, 0.0, "amax")
    big = torch.iinfo(torch.int64).max
    cpmin = _reduce(prims, C, CLUSTER, big, "amin")
    cpmax = _reduce(prims, C, CLUSTER, -1, "amax")
    return Clusters(
        packed=packed, order=order, lo=clo, hi=chi, cond=ccond, span=cspan,
        pmin=cpmin, pmax=cpmax,
        glo=_reduce(clo, G, GROUP, inf, "amin"), ghi=_reduce(chi, G, GROUP, -inf, "amax"),
        gcond=_reduce(ccond, G, GROUP, 0.0, "amax"), gspan=_reduce(cspan, G, GROUP, 0.0, "amax"),
        gpmin=_reduce(cpmin, G, GROUP, big, "amin"), gpmax=_reduce(cpmax, G, GROUP, -1, "amax"),
        loose=loose, cmax=cmax)


# The clusters of the scene last searched, keyed by its triangle rows:
# a frame searches one scene many times.
_last: list = []


def clusters(scene) -> Clusters:
    """``build(scene)``, kept while ``scene``'s triangle rows live."""
    for ref, num, cl in _last:
        if ref() is scene.tri_n and num == scene.num_tris:
            return cl
    cl = build(scene)
    _last[:] = [e for e in _last if e[0]() is not None][-1:] + [
        (weakref.ref(scene.tri_n), scene.num_tris, cl)]
    return cl


def margin(reach, cond, span):
    """How far a box grows for a ray: ``MARGIN_K`` units of rounding of
    the lengths ``reach`` (twice the ray's origin's and the farthest
    corner's), scaled by the skew."""
    return MARGIN_K * UNIT * (reach * cond + span)


def _enter(o, inv, lo, hi, tmax):
    """Float64 slab test of rays (o, 1/d) against boxes [lo, hi], each
    (..., 3): the entry t (at least 0) where the ray enters the box at or
    before ``tmax``, else +inf."""
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    near = torch.minimum(t1, t2).amax(-1).clamp(min=0.0)
    far = torch.maximum(t1, t2).amin(-1)
    return torch.where(near <= torch.minimum(far, tmax), near, float("inf"))


def pair_test(o, d, maxd, init, excl, lo, hi, packed, ray, prim):
    """The twin's arithmetic for the pairs (ray, prim): (hit, t, u, v),
    each (N,), ``hit`` where the twin's test accepts the pair below the
    ray's starting t ``init``. Per-ray arrays are indexed by ``ray``."""
    r = packed[prim]
    nx, ny, nz, eux, euy, euz, evx, evy, evz, cn, cu, cv = r[:, :12].unbind(1)
    valid = r[:, 12] > 0.5
    inst = r[:, 13].contiguous().view(torch.int32)
    ox, oy, oz = o[ray].unbind(1)
    dx, dy, dz = d[ray].unbind(1)
    dn = dx * nx + dy * ny + dz * nz
    on = ox * nx + oy * ny + oz * nz
    safe_dn = torch.where(dn.abs() < F32_EPSILON, 1.0, dn)
    t = (cn - on) / safe_dn
    deu = dx * eux + dy * euy + dz * euz
    oeu = ox * eux + oy * euy + oz * euz
    dev_ = dx * evx + dy * evy + dz * evz
    oev = ox * evx + oy * evy + oz * evz
    u = (oeu - cu) + t * deu
    v = (oev - cv) + t * dev_
    hit = (
        valid
        & (dn.abs() >= F32_EPSILON)
        & (t > F32_EPSILON)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t < maxd[ray])
        & (inst != excl[ray])
        & (prim >= lo[ray])
        & (prim < hi[ray])
        & (t < init[ray])
    )
    return hit, t, u, v


class _Best:
    """Each ray's best hit so far, by the least key (t, rank, prim)."""

    def __init__(self, init, tie):
        self.t = init.clone()
        self.key = torch.full(init.shape, NO_KEY, dtype=torch.int64, device=init.device)
        self.u = torch.zeros_like(init)
        self.v = torch.zeros_like(init)
        rank = SUBLANE_RANK if tie == "pallas" else (0,) * SUBLANES
        self.rank = torch.tensor(rank, dtype=torch.int64, device=init.device)

    def merge(self, ray, prim, t, u, v):
        """Take the hits (ray, prim, t, u, v); a (ray, prim) pair comes at
        most once a call."""
        key = (self.rank[prim % SUBLANES] << 32) | prim
        new_t = self.t.scatter_reduce(0, ray, t, "amin", include_self=True)
        at = t == new_t[ray]
        key_in = torch.where(self.t == new_t, self.key, NO_KEY)
        new_key = key_in.scatter_reduce(0, ray[at], key[at], "amin", include_self=True)
        won = at & (key == new_key[ray])
        self.u[ray[won]] = u[won]
        self.v[ray[won]] = v[won]
        self.t, self.key = new_t, new_key


def closest_hit_clustered(o, d, maxd, excl, lo, hi, cl: Clusters, tie: str = "pallas"):
    """Closest hit of every ray, as ``closest_hit_reference`` with the
    same arguments and ``packed = cl.packed`` returns it: (t, prim i32,
    u, v), each (R,). A ray whose prim range holds at most ``NARROW``
    prims tests each of them; the others walk the clusters."""
    if tie not in TIE_RULES:
        raise ValueError(f"unknown tie rule {tie!r}: one of {TIE_RULES}")
    init = torch.clamp(maxd, max=F32_MAX)
    best = _Best(init, tie)
    P = cl.packed.shape[0]
    lo64, hi64 = lo.long().clamp(min=0), hi.long().clamp(max=P)
    width = (hi64 - lo64).clamp(min=0)
    live = (torch.isfinite(o).all(1) & torch.isfinite(d).all(1) & (width > 0)
            & (init > F32_EPSILON))
    args = (o, d, maxd, init, excl, lo64, hi64, cl.packed)

    def test(ray, prim):
        for s in range(0, ray.numel(), PAIR_CHUNK):
            r, p = ray[s:s + PAIR_CHUNK], prim[s:s + PAIR_CHUNK]
            hit, t, u, v = pair_test(*args, r, p)
            if hit.any():
                best.merge(r[hit], p[hit], t[hit], u[hit], v[hit])

    narrow = torch.nonzero(live & (width <= NARROW))[:, 0]
    for s in range(0, narrow.numel(), PAIR_CHUNK // NARROW):
        block = narrow[s:s + PAIR_CHUNK // NARROW]
        n = width[block]
        ray = block.repeat_interleave(n)
        first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
        test(ray, lo64[ray] + torch.arange(ray.numel(), device=ray.device) - first)
    rays = torch.nonzero(live & (width > NARROW))[:, 0]
    if rays.numel() and cl.loose.numel():
        per = max(1, PAIR_CHUNK // cl.loose.numel())
        for s in range(0, rays.numel(), per):
            block = rays[s:s + per]
            test(block.repeat_interleave(cl.loose.numel()), cl.loose.repeat(block.numel()))
    if rays.numel() and cl.num_clusters:
        o64 = o.double()
        inv = 1.0 / torch.where(d == 0, TINY, d.double())
        reach = 2.0 * o64.norm(dim=1) + 2.0 * cl.cmax
        per = max(1, BOX_CHUNK // cl.glo.shape[0])
        for s in range(0, rays.numel(), per):
            _walk(rays[s:s + per], o64, inv, reach, lo64, hi64, cl, best, test)
    prim = torch.where(best.key == NO_KEY, -1, best.key & 0xFFFFFFFF).to(torch.int32)
    return best.t, prim, best.u, best.v


def _walk(block, o64, inv, reach, lo, hi, cl, best, test):
    """One block of rays: the groups, the clusters, then the triangles of
    the entered clusters near to far."""
    dev = block.device
    m = margin(reach[block, None], cl.gcond[None], cl.gspan[None])[..., None]
    t = _enter(o64[block, None], inv[block, None], cl.glo[None] - m, cl.ghi[None] + m,
               best.t[block, None].double())
    t = torch.where((cl.gpmax[None] >= lo[block, None]) & (cl.gpmin[None] < hi[block, None]), t,
                    float("inf"))
    bi, gi = torch.nonzero(torch.isfinite(t), as_tuple=True)
    ray = block[bi]
    rays, cids, near = [], [], []
    per = max(1, BOX_CHUNK // GROUP)
    j = torch.arange(GROUP, device=dev)
    for s in range(0, ray.numel(), per):
        r = ray[s:s + per, None].expand(-1, GROUP)
        c = gi[s:s + per, None] * GROUP + j
        inside = c < cl.num_clusters
        r, c = r[inside], c[inside]
        m = margin(reach[r], cl.cond[c], cl.span[c])[:, None]
        t = _enter(o64[r], inv[r], cl.lo[c] - m, cl.hi[c] + m, best.t[r].double())
        keep = torch.isfinite(t) & (cl.pmax[c] >= lo[r]) & (cl.pmin[c] < hi[r])
        rays.append(r[keep])
        cids.append(c[keep])
        near.append(t[keep])
    if not rays:
        return
    ray, cid, near = torch.cat(rays), torch.cat(cids), torch.cat(near)
    # Each ray's clusters near to far, then the rank of each in its ray.
    order = torch.sort(near, stable=True).indices
    order = order[torch.sort(ray[order], stable=True).indices]
    ray, cid, near = ray[order], cid[order], near[order]
    _, counts = torch.unique_consecutive(ray, return_counts=True)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    rank = torch.arange(ray.numel(), device=dev) - first
    k = torch.arange(CLUSTER, device=dev)
    start, width = 0, FIRST_ROUND
    while ray.numel():
        now = rank < start + width
        r, c = ray[now], cid[now]
        prim = cl.order[c[:, None] * CLUSTER + k]
        real = prim >= 0
        test(r[:, None].expand(-1, CLUSTER)[real], prim[real])
        # The rest, less the clusters that lie beyond each ray's best t.
        rest = ~now
        ray, cid, near, rank = ray[rest], cid[rest], near[rest], rank[rest]
        keep = near <= best.t[ray].double()
        ray, cid, near, rank = ray[keep], cid[keep], near[keep], rank[keep]
        start, width = start + width, 2 * width
