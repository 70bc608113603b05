"""Parity of the port's scatter tracer (``trace/scatter.py``: phases A and
B, the kernel twin ``scatter_items_reference``, the segment-min) with the
JAX package's ``trace_scatter``, whose kernel K3 runs in interpret mode on
the CPU, as ``tests/test_trace.py`` runs it. One scene compile (the JAX
package's, ``procedural_city(blocks=4)``) feeds both packages; the rays are
seeded numpy arrays.

Tolerances: a ray agrees when its prim is equal, t is within 1e-5
(relative above 1) and u, v are within 1e-5; >= 99.5% of the rays agree,
and u, v of every ray with an equal prim are within 1e-4. XLA's CPU
compiler contracts the JAX side's multiply-adds into FMAs, while the twin
rounds every operation (ROADMAP.md section 3): a ray that grazes an edge
may hit in one package and miss in the other, and the barycentrics of a
far hit on a large triangle differ by a few ulps of the terms they cancel.
The kernel on the card matches the twin bit for bit (the cuda-marked
test). The tie test is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hikari_tpu.io.scenes import _sun_from_euler, procedural_city
from hikari_tpu.scene.buffers import to_device as jax_to_device
from hikari_tpu.scene.compile import Scene as JScene
from hikari_tpu.scene.compile import compile_scene as jax_compile
from hikari_tpu.trace import api as japi
from hikari_tpu.trace import pallas_tiled as jpt
from hikari_tpu.trace import scatter as jsc
from hikari_tpu_torch.scene.buffers import to_device as torch_to_device
from hikari_tpu_torch.trace import api as tapi
from hikari_tpu_torch.trace import scatter as tsc
from hikari_tpu_torch.trace import tile_walk as tw
from hikari_tpu_torch.trace.intersect import precompute_triangles

torch.set_num_threads(2)

N_RAYS = 700


@pytest.fixture(scope="module")
def city():
    """procedural_city(blocks=4): several 128-triangle clusters."""
    scene = procedural_city(JScene(materials=[], directional_light=_sun_from_euler(-1, 0.6, 0)),
                            blocks=4)
    arrays = jax_compile(scene)
    assert len(arrays.tri_world) > 4 * 128
    return arrays, jax_to_device(arrays), torch_to_device(arrays, "cpu")


def _rays(arrays, case, n=N_RAYS, seed=47):
    """Seeded rays into the small city; ``case`` adds max distance with
    instance exclusion, or one instance's prim range on every ray."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) / 3 + 1.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kw = {}
    if case == "maxd_excl":
        kw = dict(max_distance=rng.uniform(2.0, 30.0, n).astype(np.float32),
                  exclude_instance=rng.integers(-1, 8, n).astype(np.int32))
    elif case == "range":
        # Half the rays keep one random instance's prims, half all prims.
        inst = rng.integers(0, len(arrays.inst_material), n)
        part = rng.uniform(size=n) < 0.5
        lo = np.where(part, arrays.inst_prim_offset[inst], 0).astype(np.int32)
        hi = np.where(part, lo + arrays.inst_prim_count[inst], len(arrays.tri_world))
        kw = dict(range_lo=lo, range_hi=hi.astype(np.int32))
    return o, d, kw


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_hits_match(got, want, share=0.995):
    t, prim, u, v = (_np(x) for x in got)
    jt, jprim, ju, jv = (_np(x) for x in want)
    same = prim == jprim
    agree = (
        same
        & (np.abs(t - jt) <= 1e-5 * np.maximum(1.0, np.abs(jt)))
        & (np.abs(u - ju) <= 1e-5)
        & (np.abs(v - jv) <= 1e-5)
    )
    assert agree.mean() >= share, (~agree).sum()
    np.testing.assert_allclose(u[same], ju[same], atol=1e-4)
    np.testing.assert_allclose(v[same], jv[same], atol=1e-4)


@pytest.mark.parametrize("case", ["plain", "maxd_excl", "range"])
def test_trace_rays_scatter_matches_jax(city, case):
    """``trace_rays(method="scatter")`` in both packages: the port's twin
    path on CPU tensors against the JAX kernel in interpret mode."""
    arrays, jb, tb = city
    o, d, kw = _rays(arrays, case)
    jh = japi.trace_rays(jb, jnp.asarray(o), jnp.asarray(d), method="scatter",
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    th = tapi.trace_rays(tb, torch.from_numpy(o), torch.from_numpy(d), method="scatter",
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    _assert_hits_match((th.t, th.prim, th.u, th.v), (jh.t, jh.prim, jh.u, jh.v))
    np.testing.assert_array_equal(th.inst.numpy()[th.prim.numpy() == np.asarray(jh.prim)],
                                  np.asarray(jh.inst)[th.prim.numpy() == np.asarray(jh.prim)])
    prim = th.prim.numpy()
    assert (prim >= 0).sum() >= 100 and (prim < 0).sum() >= 20
    if case == "range":
        hit = prim >= 0
        assert ((prim[hit] >= kw["range_lo"][hit]) & (prim[hit] < kw["range_hi"][hit])).all()
    if case == "maxd_excl":
        inst = th.inst.numpy()
        assert (inst[prim >= 0] != kw["exclude_instance"][prim >= 0]).all()


def test_scatter_matches_closest_hit(city):
    """Both are exact closest-hit searches: the scatter twin equals the
    brute-force twin (K1's) on every ray with a distinct nearest triangle."""
    arrays, _, tb = city
    o, d, kw = _rays(arrays, "maxd_excl", seed=5)
    args = (tb, torch.from_numpy(o), torch.from_numpy(d))
    kw = {k: torch.from_numpy(v) for k, v in kw.items()}
    a = tapi.trace_rays(*args, method="scatter", **kw)
    b = tapi.trace_rays(*args, method="bruteforce", **kw)
    assert torch.equal(a.prim >= 0, b.prim >= 0)
    assert float((a.prim == b.prim).to(torch.float32).mean()) >= 0.995
    assert torch.equal(a.t, b.t)


def test_early_distance_is_ignored(city):
    """``early_distance`` changes nothing: the scatter search always
    returns the exact closest hit, as in the JAX package."""
    arrays, jb, tb = city
    o, d, _ = _rays(arrays, "plain", seed=9)
    early = np.random.default_rng(3).uniform(0.0, 40.0, len(o)).astype(np.float32)
    base = tapi.trace_rays(tb, torch.from_numpy(o), torch.from_numpy(d), method="scatter")
    with_early = tapi.trace_rays(tb, torch.from_numpy(o), torch.from_numpy(d),
                                 early_distance=torch.from_numpy(early), method="scatter")
    for f in ("t", "prim", "inst", "u", "v"):
        assert torch.equal(getattr(base, f), getattr(with_early, f)), f
    jh = japi.trace_rays(jb, jnp.asarray(o), jnp.asarray(d), early_distance=jnp.asarray(early),
                         method="scatter")
    _assert_hits_match((with_early.t, with_early.prim, with_early.u, with_early.v),
                       (jh.t, jh.prim, jh.u, jh.v))


def _packed(jb, tb):
    """The JAX package's packed rows for the JAX call and the port's own
    for the port's (equal but for the instance id's encoding and FMAs)."""
    jpacked = jpt.pack_clusters(jb, jsc.CLUSTER)
    return jpacked, tw.pack_clusters(tb, tsc.CLUSTER)


def test_dropped_items_match_jax(city):
    """``items_per_ray=2`` leaves too few slots: both packages drop the
    same (ray, cluster) items — the slots past the capacity — and so return
    the same hits, which differ from the exact closest hit on some rays."""
    arrays, jb, tb = city
    o, d, _ = _rays(arrays, "plain", n=1500, seed=13)
    n = len(o)
    maxd = np.full(n, 3.0e38, np.float32)
    excl = np.full(n, -1, np.int32)
    lo, hi = np.zeros(n, np.int32), np.full(n, len(arrays.tri_world), np.int32)
    jpacked, tpacked = _packed(jb, tb)
    want = jsc.trace_scatter(*jpacked, *(jnp.asarray(x) for x in (o, d, maxd, excl, lo, hi)),
                             interpret=True, items_per_ray=2)
    targs = [torch.from_numpy(x) for x in (o, d, maxd, excl, lo, hi)]
    before = tsc.dropped
    got = tsc.trace_scatter(*tpacked, *targs, items_per_ray=2)
    n_drop = tsc.dropped - before
    meta, items, plan_drop = tsc.scatter_plan(*tpacked[1:], targs[0], targs[1], targs[2],
                                              targs[4], targs[5], items_per_ray=2)
    assert n_drop == plan_drop > 0
    assert int(meta[:, 1].sum()) == int((items >= 0).sum())
    # The slots themselves: the JAX package's entered mask and its running
    # per-cluster cursors, replayed ray by ray in numpy.
    mask = np.asarray(jsc._chunk_mask(
        jpacked[1], jpacked[2], jpacked[3], jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxd),
        jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32)))
    counts = mask.sum(0)
    padded = -(-counts // 128) * 128
    cursor = np.cumsum(padded) - padded
    want_items = np.full(items.shape[0], -1)
    for r, c in zip(*np.nonzero(mask)):  # ray-major, so rays ascend per cluster
        if cursor[c] < items.shape[0]:
            want_items[cursor[c]] = r
        cursor[c] += 1
    np.testing.assert_array_equal(items.numpy(), want_items)
    _assert_hits_match(got, want, share=1.0)
    exact = tsc.trace_scatter(*tpacked, *targs)
    assert (exact[1] != got[1]).any()
    assert (exact[0] <= got[0]).all()  # dropping items can only lose hits


def test_tie_rule_matches_jax_kernel():
    """One triangle duplicated at prims 1, 4 and 8 of a cluster (the other
    125 triangles invalid): the JAX kernel's per-sublane bests and halving
    keep prim 8 (sublane 0), and so do the port's twin and trace."""
    from hikari_tpu.trace.intersect import precompute_triangles as jax_precompute

    tri = np.array([[[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]]], np.float32)
    tris = np.repeat(tri + np.array([0.0, 0.0, 50.0], np.float32), 128, axis=0)
    tris[[1, 4, 8]] = tri
    valid = np.zeros(128, np.float32)
    valid[[1, 4, 8]] = 1.0
    jpre = jax_precompute(jnp.asarray(tris))
    cols = [np.asarray(jpre[k]).reshape(128, -1) for k in ("n", "eu", "ev", "cn", "cu", "cv")]
    rows16 = np.concatenate(cols + [valid[:, None], np.zeros((128, 3), np.float32)], axis=1)
    jrows = np.concatenate([rows16, np.zeros((128, 112), np.float32)], axis=1)
    cmin, cmax = tri[0].min(0)[None], tri[0].max(0)[None]
    o = np.array([[0.1, -0.2, -5.0], [-0.3, 0.1, 4.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float32)
    maxd = np.full(2, 3.0e38, np.float32)
    excl = np.full(2, -1, np.int32)
    lo, hi = np.zeros(2, np.int32), np.full(2, 128, np.int32)
    jt, jp, _, _ = jsc.trace_scatter(
        jnp.asarray(jrows), jnp.asarray(cmin), jnp.asarray(cmax), jnp.ones(1, bool),
        *(jnp.asarray(x) for x in (o, d, maxd, excl, lo, hi)), interpret=True)
    assert np.asarray(jp).tolist() == [8, 8]

    pre = precompute_triangles(torch.from_numpy(tris))
    packed = torch.cat([pre["n"], pre["eu"], pre["ev"], pre["cn"][:, None], pre["cu"][:, None],
                        pre["cv"][:, None], torch.from_numpy(valid)[:, None],
                        torch.zeros((128, 3))], dim=1).contiguous()
    t, p, _, _ = tsc.trace_scatter(
        packed, torch.from_numpy(cmin), torch.from_numpy(cmax), torch.ones(1, dtype=torch.bool),
        *(torch.from_numpy(x) for x in (o, d, maxd, excl, lo, hi)))
    assert p.tolist() == [8, 8]
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6)


def _jax_kernel(meta, fields, rows):
    """The JAX package's K3 call (scatter.py:314-336), in interpret mode."""
    nb = meta.shape[0]
    return pl.pallas_call(
        jsc._make_kernel(jsc.CLUSTER),
        grid=(nb,),
        in_specs=[
            pl.BlockSpec((1, 1, 2), lambda i: (i, 0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((11, jsc.BLOCK_R), lambda i: (0, i), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.HBM),
        ],
        out_specs=pl.BlockSpec((4, jsc.BLOCK_R), lambda i: (0, i), memory_space=pltpu.VMEM),
        out_shape=jax_shape((4, nb * jsc.BLOCK_R)),
        scratch_shapes=[pltpu.VMEM((jsc.CLUSTER, 128), jnp.float32), pltpu.SMEM((1,), jnp.int32),
                        pltpu.SemaphoreType.DMA(())],
        interpret=True,
    )(jnp.asarray(meta).reshape(nb, 1, 2), jnp.asarray(fields), jnp.asarray(rows))


def jax_shape(shape):
    import jax

    return jax.ShapeDtypeStruct(shape, jnp.float32)


def test_twin_matches_jax_kernel(city):
    """The twin and the JAX kernel on the same meta, fields and rows (the
    port's plan of rays with the whole contract, converted to the JAX
    layout: ids as float values instead of int32 bits)."""
    arrays, jb, tb = city
    o, d, kw = _rays(arrays, "maxd_excl", n=400, seed=21)
    targs = dict(o=torch.from_numpy(o), d=torch.from_numpy(d),
                 maxd=torch.from_numpy(kw["max_distance"]),
                 excl=torch.from_numpy(kw["exclude_instance"]),
                 lo=torch.zeros(400, dtype=torch.int32),
                 hi=torch.full((400,), len(arrays.tri_world), dtype=torch.int32))
    targs["lo"][::3] = 128
    packed, cmin, cmax, cvalid = tw.pack_clusters(tb, tsc.CLUSTER)
    meta, items, _ = tsc.scatter_plan(cmin, cmax, cvalid, targs["o"], targs["d"], targs["maxd"],
                                      targs["lo"], targs["hi"])
    fields = tsc.item_fields(items, *targs.values())
    got = tsc.scatter_items_reference(meta, fields, packed)

    jfields = fields.numpy().copy()
    jfields[7:10] = jfields[7:10].view(np.int32).astype(np.float32)
    jrows = np.asarray(jpt.pack_clusters(jb, jsc.CLUSTER)[0])
    out = np.asarray(_jax_kernel(meta.numpy(), jfields, jrows))
    want = (out[0], out[1].astype(np.int32), out[2], out[3])
    assert int((got[1] >= 0).sum()) >= 200
    _assert_hits_match(got, want)


@pytest.mark.parametrize("layout", ["prefix", "scattered"])
@pytest.mark.parametrize("grid", [1, 7, 64, 300])
def test_run_ranges_cover_and_balance(layout, grid):
    """The persistent blocks' ranges: every item block exactly once, the
    used blocks split evenly (shares differ by at most one), and with the
    used blocks first (``scatter_plan``'s layout) the first ranges hold
    exactly the used blocks and the second exactly the empty tail."""
    rng = np.random.default_rng(grid)
    nb, n_used = 300, 173
    count = np.zeros(nb, np.int32)
    if layout == "prefix":
        count[:n_used] = rng.integers(1, 129, n_used)
    else:
        count[rng.choice(nb, n_used, replace=False)] = rng.integers(1, 129, n_used)
    meta = torch.from_numpy(np.stack([rng.integers(0, 9, nb), count], 1).astype(np.int32))
    r = tsc.run_ranges(meta, grid)
    assert r.dtype == torch.int32 and tuple(r.shape) == (grid, 4)
    w0, w1, t0, t1 = r.numpy().T
    blocks = np.concatenate([np.arange(a, b) for a, b in zip(w0, w1)]
                            + [np.arange(a, b) for a, b in zip(t0, t1)])
    np.testing.assert_array_equal(np.sort(blocks), np.arange(nb))
    assert (w1 - w0).max() - (w1 - w0).min() <= 1
    assert (t1 - t0).max() - (t1 - t0).min() <= 1
    assert w0[0] == 0 and w1[-1] == n_used == t0[0] and t1[-1] == nb
    if layout == "prefix":
        for a, b, c, e in r.numpy():
            assert (count[a:b] > 0).all() and (count[c:e] == 0).all()


def test_scatter_items_never_falls_back():
    """Off the CPU the wrapper launches its kernel or raises: tensors on a
    device with no kernel raise, and run no twin."""
    nb, L = 3, 2
    meta = torch.zeros((nb, 2), dtype=torch.int32, device="meta")
    fields = torch.zeros((tsc.FIELDS, nb * tsc.BLOCK_R), device="meta")
    packed = torch.zeros((L * tsc.CLUSTER, 16), device="meta")
    before = tsc.launches
    with pytest.raises(NotImplementedError, match="no kernel for device meta"):
        tsc.scatter_items(meta, fields, packed)
    assert tsc.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the scatter kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(city, cuda_device):
    """On the card the kernel equals its twin bit for bit on t, prim, u, v
    for every item, and ``trace_rays(method="scatter")`` launches it once
    per call."""
    arrays, _, tb_cpu = city
    from hikari_tpu_torch.utils import map_tensors

    tb = map_tensors(lambda x: x.to(cuda_device), tb_cpu)
    o, d, kw = _rays(arrays, "maxd_excl", n=65536, seed=41)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    maxd = torch.from_numpy(kw["max_distance"]).to(cuda_device)
    excl = torch.from_numpy(kw["exclude_instance"]).to(cuda_device)
    lo = torch.zeros(65536, dtype=torch.int32, device=cuda_device)
    hi = torch.full((65536,), len(arrays.tri_world), dtype=torch.int32, device=cuda_device)
    packed, cmin, cmax, cvalid = tw.pack_clusters(tb, tsc.CLUSTER)
    meta, items, _ = tsc.scatter_plan(cmin, cmax, cvalid, o, d, maxd, lo, hi)
    fields = tsc.item_fields(items, o, d, maxd, excl, lo, hi)
    before = tsc.launches
    got = tsc.scatter_items(meta, fields, packed)
    assert tsc.launches == before + 1
    want = tsc.scatter_items_reference(meta, fields, packed)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    before = tsc.launches
    tapi.trace_rays(tb, o, d, max_distance=maxd, method="scatter")
    assert tsc.launches == before + 1


@pytest.mark.cuda
def test_kernel_runs_and_bad_clusters_on_card(city, cuda_device):
    """The redesigned kernel's own cases, bit for bit against the twin, on a
    block map built from a real plan's blocks: one cluster's run much
    longer than a persistent block's share, cluster changes inside the
    blocks' ranges, ragged counts, empty blocks among the used ones and an
    all-empty tail. Then blocks with items and a cluster id outside
    [0, L) get misses and raise ``cluster_errors()`` by their number (an
    empty block's id is not read), and every other block still equals the
    twin."""
    arrays, _, tb_cpu = city
    from hikari_tpu_torch.utils import map_tensors

    dev = cuda_device
    tb = map_tensors(lambda x: x.to(dev), tb_cpu)
    o, d, kw = _rays(arrays, "maxd_excl", n=65536, seed=43)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    maxd = torch.from_numpy(kw["max_distance"]).to(dev)
    excl = torch.from_numpy(kw["exclude_instance"]).to(dev)
    lo = torch.zeros(65536, dtype=torch.int32, device=dev)
    hi = torch.full((65536,), len(arrays.tri_world), dtype=torch.int32, device=dev)
    packed, cmin, cmax, cvalid = tw.pack_clusters(tb, tsc.CLUSTER)
    L = cmin.shape[0]
    meta0, items0, _ = tsc.scatter_plan(cmin, cmax, cvalid, o, d, maxd, lo, hi)
    fields0 = tsc.item_fields(items0, o, d, maxd, excl, lo, hi).reshape(tsc.FIELDS, -1, 128)
    used = torch.nonzero(meta0[:, 1] > 0)[:, 0]
    empty = torch.nonzero(meta0[:, 1] == 0)[:, 0]
    busiest = used[int(torch.argmax(meta0[used, 1]))]
    sel = torch.cat([used[:40], busiest.repeat(600), empty[:3], used[40:], empty[3:900]])
    meta = meta0[sel].contiguous()
    fields = fields0[:, sel].reshape(tsc.FIELDS, -1).contiguous()
    nb = meta.shape[0]

    tsc.build()
    grid = min(tsc._lib.hikari_scatter_items_grid(), nb)
    n_used = int((meta[:, 1] > 0).sum())
    assert 600 > 4 * n_used / grid  # the long run spans several blocks' shares
    ranges = tsc.run_ranges(meta, grid).cpu().numpy()
    cid = meta[:, 0].cpu().numpy()
    assert any(len(set(cid[a:b])) > 1 for a, b, _, _ in ranges)  # cluster changes in a range
    assert set((meta[:, 1] % 64).tolist()) - {0}  # counts that do not fill the threads' rows

    tsc.reset_cluster_errors()
    got = tsc.scatter_items(meta, fields, packed)
    want = tsc.scatter_items_reference(meta, fields, packed)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tsc.cluster_errors() == 0

    bad = meta.clone()
    bad[5, 0], bad[45, 0], bad[n_used - 1, 0] = L, -1, L + 7
    bad[n_used + 10, 0] = L + 1  # an empty block in the tail: not an error
    assert (bad[[5, 45, n_used - 1], 1] > 0).all() and bad[n_used + 10, 1] == 0
    got = tsc.scatter_items(bad, fields, packed)
    assert tsc.cluster_errors() == 3
    good = meta.clone()
    good[[5, 45, n_used - 1], 1] = 0  # the twin's misses for those blocks
    want = tsc.scatter_items_reference(good, fields, packed)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tsc.reset_cluster_errors()
