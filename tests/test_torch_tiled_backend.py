"""Parity of the port's XLA-style tiled tracer (``trace/tiled.trace_tiled``,
``trace_rays(method="tiled")``, plain torch on either device) with the JAX
package's ``method="tiled"`` (``hikari_tpu.trace.tiled.trace_tiled``) on the
same inputs: the small city with the whole trace contract, the cornell
box, the tie rule within and across clusters, a ragged last tile, and a
ray that stopped early in a tile that stays active.

Tolerances: prim and inst ids equal, t within 1e-5 relative + 1e-6
absolute (those of ``test_torch_tiled.py``), u/v within 1e-5 absolute plus
two f32 ulps of the larger term that cancels in them (u = (o.eu - cu) +
t d.eu: on the city o.eu reaches ~70, where an ulp is 7.6e-6, and one ray
of the 1,500 reads 1.13e-5 apart, each package 5.4e-6 and 5.8e-6 from the
f64 value). XLA's CPU compiler contracts the JAX side's multiply-adds into
FMAs, while the port rounds every operation; the port's u/v are those of
its own brute force. The hand-built scenes of the tie and early-stop
cases feed both packages the same precomputed triangle planes, and their
hits are asserted exactly."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.scene.buffers import to_device as jax_to_device
from hikari_tpu.scene.compile import compile_scene as jax_compile
from hikari_tpu.trace import api as japi
from hikari_tpu.trace import tiled as jtiled
from hikari_tpu_torch.scene.buffers import to_device as torch_to_device
from hikari_tpu_torch.trace import api as tapi
from hikari_tpu_torch.trace import intersect as tint
from hikari_tpu_torch.trace import tiled as ttiled
from test_torch_tiled import _jax_city, _ranges, _walk_rays

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def city():
    """procedural_city(blocks=3, detail=True): 18,422 triangles, 36 clusters
    of 512."""
    arrays = jax_compile(_jax_city(3, True))
    return arrays, jax_to_device(arrays), torch_to_device(arrays, "cpu")


@pytest.fixture(scope="module")
def cornell():
    from hikari_tpu.io.scenes import cornell_box_scene

    arrays = jax_compile(cornell_box_scene())
    return arrays, jax_to_device(arrays), torch_to_device(arrays, "cpu")


def _assert_hits_match(tb, o, d, th, jh):
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    np.testing.assert_array_equal(th.inst.numpy(), np.asarray(jh.inst))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-5, atol=1e-6)
    p = th.prim.numpy().reshape(-1)
    hit = p >= 0
    o64 = np.asarray(o, np.float64).reshape(-1, 3)
    for f, e, c in (("u", tb.tri_eu, tb.tri_cu), ("v", tb.tri_ev, tb.tri_cv)):
        got, want = getattr(th, f).numpy().reshape(-1), np.asarray(getattr(jh, f)).reshape(-1)
        np.testing.assert_array_equal(got[~hit], want[~hit])
        ph = p[hit]
        scale = np.maximum(np.abs((o64[hit] * e[ph].double().numpy()).sum(-1)),
                           np.abs(c[ph].double().numpy()))
        err = np.abs(got[hit].astype(np.float64) - want[hit])
        bad = err > 1e-5 + 2.0 ** -22 * scale
        assert not bad.any(), (f, err[bad], scale[bad])


def _trace_both(jb, tb, o, d, **kw):
    jh = japi.trace_rays(jb, jnp.asarray(o), jnp.asarray(d), method="tiled",
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    th = tapi.trace_rays(tb, torch.from_numpy(o), torch.from_numpy(d), method="tiled",
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    return th, jh


@pytest.mark.parametrize("with_range", [False, True])
def test_trace_rays_tiled_matches_jax_city(city, with_range):
    """1,500 rays (a ragged third tile) with random max distance, exclusion,
    early distance on a third of them and, with a range, one instance's
    prims on half of them."""
    arrays, jb, tb = city
    r = _walk_rays(1500, 41)
    kw = dict(max_distance=r["maxd"], early_distance=r["early"], exclude_instance=r["excl"])
    if with_range:
        kw["range_lo"], kw["range_hi"] = _ranges(arrays, 1500, 42)
    th, jh = _trace_both(jb, tb, r["o"], r["d"], **kw)
    _assert_hits_match(tb, r["o"], r["d"], th, jh)
    hit = th.prim.numpy() >= 0
    assert hit.sum() > 300 and (~hit).sum() > 100
    assert ((r["early"] > 0) & hit & (th.t.numpy() < r["early"])).sum() > 10  # stopped early
    lo, hi = kw.get("range_lo"), kw.get("range_hi")
    if lo is None:
        lo, hi = np.zeros(1500, np.int32), np.full(1500, tb.num_tris, np.int32)
    steps, _ = _walk_stats(tb, r["o"], r["d"], r["maxd"], r["early"], r["excl"], lo, hi)
    assert steps >= 2


def test_trace_rays_tiled_matches_jax_cornell(cornell):
    """Random rays in and around the cornell box (one cluster of 512)."""
    _, jb, tb = cornell
    rng = np.random.default_rng(8)
    o = (rng.uniform(-0.9, 0.9, (2000, 3)) + [0.0, 1.0, 0.0]).astype(np.float32)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxd = rng.uniform(0.5, 4.0, 2000).astype(np.float32)
    th, jh = _trace_both(jb, tb, o, d, max_distance=maxd)
    _assert_hits_match(tb, o, d, th, jh)
    assert (th.prim.numpy() >= 0).sum() > 1000


def test_trace_tiled_matches_jax_directly(city):
    """``trace_tiled`` on rays already sorted and padded, against the JAX
    function itself; the port also returns its steps and the clusters each
    tile tested."""
    from test_torch_tiled import _padded

    arrays, jb, tb = city
    args = _padded(arrays, 1100, 51)
    jt, jp, ju, jv = jtiled.trace_tiled(jb, *(jnp.asarray(a) for a in args))
    t, prim, u, v, steps, tested = ttiled.trace_tiled(tb, *(torch.from_numpy(a) for a in args))
    inst = torch.where(prim >= 0, tb.tri_inst[prim.clamp(min=0)], -1)
    th = types.SimpleNamespace(t=t, prim=prim, u=u, v=v, inst=inst)
    jh = types.SimpleNamespace(t=jt, prim=jp, u=ju, v=jv, inst=inst.numpy())
    _assert_hits_match(tb, args[0], args[1], th, jh)
    L = -(-tb.tri_n.shape[0] // ttiled.CLUSTER)
    assert tested.shape == (3,) and 0 < int(tested.max()) == steps <= L


def _soup(tris, valid):
    """A hand-built scene of ``tris`` (P, 3, 3), P a multiple of 512, for
    both packages: the port's triangle planes, shared, instance 0."""
    tw = torch.from_numpy(tris)
    pre = tint.precompute_triangles(tw)
    fields = dict(tri_world=tw, tri_n=pre["n"], tri_eu=pre["eu"], tri_ev=pre["ev"],
                  tri_cn=pre["cn"], tri_cu=pre["cu"], tri_cv=pre["cv"],
                  tri_valid=torch.from_numpy(valid),
                  tri_inst=torch.zeros(len(tris), dtype=torch.int32))
    tb = types.SimpleNamespace(**fields)
    jb = types.SimpleNamespace(**{k: jnp.asarray(v.numpy()) for k, v in fields.items()})
    return jb, tb


def _tri(z, x0=0.0):
    return np.array([[x0 - 1.0, -1.0, z], [x0 + 1.0, -1.0, z], [x0, 1.0, z]], np.float32)


def _walk_stats(tb, *rays):
    """(steps, clusters tested per tile) of the tiled walk over flat numpy
    rays (o, d, maxd, early, excl, lo, hi), as ``_trace_tiled`` runs it."""
    _, tiles = tapi.tiled_inputs(*(torch.from_numpy(np.ascontiguousarray(a)) for a in rays))
    *_, steps, tested = ttiled.trace_tiled(tb, *tiles)
    return steps, tested


def _run_soup(jb, tb, o, d, early=None):
    """prims of the tiled tracer in both packages (asserted equal, with t, u
    and v), and the port's clusters tested per tile."""
    n = len(o)
    early = np.zeros(n, np.float32) if early is None else early
    args = [o, d, np.full(n, 3.0e38, np.float32), early, np.full(n, -1, np.int32),
            np.zeros(n, np.int32), np.full(n, len(tb.tri_n), np.int32)]
    jh = japi._trace_tiled(jb, *(jnp.asarray(a) for a in args))
    t, prim, u, v = tapi._trace_tiled(tb, *(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(prim.numpy(), np.asarray(jh.prim))
    for a, b in ((t, jh.t), (u, jh.u), (v, jh.v)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return prim.numpy(), _walk_stats(tb, *args)[1]


def _tie_rays():
    """512 rays along +z from z = -5 and 512 along -z from z = 4 (so one
    tile each), x, y in [-0.3, 0.3]; every 64th ray of each tile at
    (-0.9, 0.9) instead, inside the clusters' boxes but beside the
    triangles, so it stays open and keeps its tile walking."""
    rng = np.random.default_rng(5)
    xy = rng.uniform(-0.3, 0.3, (1024, 2)).astype(np.float32)
    xy[::64] = (-0.9, 0.9)
    front = np.arange(1024) < 512
    o = np.concatenate([xy, np.where(front, -5.0, 4.0)[:, None]], 1).astype(np.float32)
    d = np.zeros((1024, 3), np.float32)
    d[:, 2] = np.where(front, 1.0, -1.0)
    return o, d, front


def test_tie_rule_matches_jax():
    """One triangle at z = 0 duplicated at prims 3 (cluster 0), 600 and 603
    (cluster 1). A valid triangle of cluster 1 at x = 5, z = -2 stretches
    its box towards z = -5, so the +z tile enters cluster 1 first (entry 3
    against 5): the first column of that cluster wins, prim 600, and cluster
    0's equal t does not replace it. The -z tile enters both boxes at t = 4
    and the stable sort visits cluster 0 first: prim 3. The open rays
    beside the triangles keep both tiles walking into their second
    cluster, where every ray of the tile is tested again."""
    P = 1024
    tris = np.zeros((P, 3, 3), np.float32)
    valid = np.zeros(P, bool)
    for p in (3, 600, 603):
        tris[p], valid[p] = _tri(0.0), True
    tris[700], valid[700] = _tri(-2.0, x0=5.0), True
    jb, tb = _soup(tris, valid)
    o, d, front = _tie_rays()
    prim, tested = _run_soup(jb, tb, o, d)
    on_tri = np.ones(1024, bool)
    on_tri[::64] = False
    assert (prim[front & on_tri] == 600).all() and (prim[~front & on_tri] == 3).all()
    assert (prim[~on_tri] == -1).all()
    assert tested.tolist() == [2, 2]


def test_ragged_last_tile_matches_jax(city):
    """513 rays: the second tile holds one ray and 511 inert pads, which
    enter no cluster; the ray's hit equals its hit traced alone."""
    arrays, jb, tb = city
    r = _walk_rays(513, 61)
    kw = dict(max_distance=r["maxd"], exclude_instance=r["excl"])
    th, jh = _trace_both(jb, tb, r["o"], r["d"], **kw)
    _assert_hits_match(tb, r["o"], r["d"], th, jh)
    order = tapi.octant_order(torch.from_numpy(r["d"]))
    last = int(order[-1])
    alone = tapi.trace_rays(tb, torch.from_numpy(r["o"][last:last + 1]),
                            torch.from_numpy(r["d"][last:last + 1]), method="tiled",
                            max_distance=torch.from_numpy(r["maxd"][last:last + 1]),
                            exclude_instance=torch.from_numpy(r["excl"][last:last + 1]))
    assert int(alone.prim[0]) == int(th.prim[last]) and float(alone.t[0]) == float(th.t[last])


def test_early_stopped_ray_still_updated():
    """Cluster 0 holds a far triangle (z = 2, t = 7) and a triangle at x = 5,
    z = -4 that stretches its box (entry t = 1); cluster 1 a nearer triangle
    (z = 1, t = 6, entry t = 6). A ray with early distance 100 stops after
    cluster 0's hit, but the open rays beside the triangles keep the tile
    active, so cluster 1 tests every ray of it: the stopped ray takes the
    nearer hit, prim 512, as in the JAX package (updating only the open
    rays would leave it at prim 0)."""
    P = 1024
    tris = np.zeros((P, 3, 3), np.float32)
    valid = np.zeros(P, bool)
    tris[0], tris[1], tris[512] = _tri(2.0), _tri(-4.0, x0=5.0), _tri(1.0)
    valid[[0, 1, 512]] = True
    jb, tb = _soup(tris, valid)
    o, d, front = _tie_rays()
    o, d = o[front], d[front]
    early = np.zeros(512, np.float32)
    early[1] = 100.0
    prim, tested = _run_soup(jb, tb, o, d, early)
    assert prim[1] == 512 and (prim[::64] == -1).all()
    assert tested.tolist() == [2]


@pytest.mark.cuda
def test_tiled_card_equals_cpu(city):
    """On the card the tiled tracer equals the CPU bit for bit (ordered dot
    products, no kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    arrays, _, tb = city
    dev = torch.device("cuda", 0)
    tg = torch_to_device(arrays, dev)
    r = _walk_rays(4000, 71)
    lo, hi = _ranges(arrays, 4000, 72)
    kw = dict(max_distance=r["maxd"], early_distance=r["early"], exclude_instance=r["excl"],
              range_lo=lo, range_hi=hi)
    want = tapi.trace_rays(tb, torch.from_numpy(r["o"]), torch.from_numpy(r["d"]),
                           method="tiled", **{k: torch.from_numpy(v) for k, v in kw.items()})
    got = tapi.trace_rays(tg, torch.from_numpy(r["o"]).to(dev), torch.from_numpy(r["d"]).to(dev),
                          method="tiled", **{k: torch.from_numpy(v).to(dev) for k, v in kw.items()})
    for f in ("prim", "t", "u", "v"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def test_tile_subset_traces_alike(city):
    """Tiles are independent: tracing every third whole tile of the sorted,
    padded rays (``tiled_inputs``) gives those tiles' rays the hits of the
    full run, bit for bit (how ``chip_smoke.py`` holds the card's full
    call to the CPU on a share of its tiles)."""
    arrays, _, tb = city
    r = _walk_rays(2600, 81)
    lo, hi = _ranges(arrays, 2600, 82)
    args = [torch.from_numpy(x) for x in (r["o"], r["d"], r["maxd"], r["early"], r["excl"], lo, hi)]
    full = tapi.trace_rays(tb, args[0], args[1], max_distance=args[2], early_distance=args[3],
                           exclude_instance=args[4], range_lo=args[5], range_hi=args[6],
                           method="tiled")
    order, rays = tapi.tiled_inputs(*args)
    T = rays[0].shape[0] // ttiled.TILE_R
    sel = (torch.arange(0, T, 3)[:, None] * ttiled.TILE_R + torch.arange(ttiled.TILE_R)).reshape(-1)
    t, prim, u, v, _, _ = ttiled.trace_tiled(tb, *(x[sel] for x in rays))
    real = sel < 2600
    idx = order[sel[real]]
    for got, want in ((prim, full.prim), (t, full.t), (u, full.u), (v, full.v)):
        assert torch.equal(got[real], want[idx])
    assert int((prim[real] >= 0).sum()) > 100
