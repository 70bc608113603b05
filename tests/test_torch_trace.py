"""Parity of the PyTorch port's closest-hit search (the plain twin of the
CUDA kernel, which is what runs for CPU tensors) and hit reconstruction
with ``hikari_tpu.trace``: against the JAX brute-force path and the Pallas
kernel in interpret mode, with exclusion and prim ranges, the miss value,
the tie rule, a soup of thousands of triangles, and ``refine_hit`` /
``hit_info`` / ``occlude_hit_info``. One scene compile feeds both packages.

Tolerances: prim/inst ids equal; t within 1e-5 relative + 1e-6 absolute
(t = (cn - o.n)/(d.n) cancels for close hits) and u/v within 1e-5
absolute — XLA's CPU compiler contracts the JAX side's multiply-adds
into FMAs, while the twin rounds every operation (the CUDA kernel matches
the twin bit for bit; see the cuda-marked test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.scene.buffers import to_device as jax_to_device
from hikari_tpu.trace import api as japi
from hikari_tpu_torch.config import F32_MAX
from hikari_tpu_torch.scene.buffers import to_device as torch_to_device
from hikari_tpu_torch.trace import api as tapi
from hikari_tpu_torch.trace import closest_hit as ch
from hikari_tpu_torch.utils import map_tensors, same_bits

torch.set_num_threads(2)


def _both(arrays):
    return jax_to_device(arrays), torch_to_device(arrays, "cpu")


@pytest.fixture(scope="module")
def cornell():
    from hikari_tpu.io.scenes import cornell_box_scene
    from hikari_tpu.scene.compile import compile_scene

    return _both(compile_scene(cornell_box_scene()))


def _rays(n, seed, lo=-2.0, hi=2.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _assert_hits_match(jh, th):
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    np.testing.assert_array_equal(th.inst.numpy(), np.asarray(jh.inst))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.u.numpy(), np.asarray(jh.u), atol=1e-5)
    np.testing.assert_allclose(th.v.numpy(), np.asarray(jh.v), atol=1e-5)


@pytest.mark.parametrize("method", ["bruteforce", "pallas"])
def test_twin_matches_jax(cornell, method):
    """"pallas" runs K1 in interpret mode, as tests/test_pallas_kernel.py."""
    jb, tb = cornell
    o, d = _rays(300, 1)
    jh = japi.trace_rays(jb, jnp.asarray(o), jnp.asarray(d), method=method)
    th = tapi.trace_rays(tb, torch.from_numpy(o), torch.from_numpy(d), method=method)
    assert (th.prim.numpy() >= 0).sum() > 50
    _assert_hits_match(jh, th)


def test_exclusion_and_range_match_jax(cornell):
    jb, tb = cornell
    o, d = _rays(256, 2, -0.5, 0.5)
    o[:, 1] += 1.0
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    h0 = tapi.trace_rays(tb, to, td)
    excl = h0.inst.numpy()
    jh = japi.trace_rays(jb, jnp.asarray(o), jnp.asarray(d), exclude_instance=jnp.asarray(excl),
                         method="bruteforce")
    th = tapi.trace_rays(tb, to, td, exclude_instance=torch.from_numpy(excl))
    _assert_hits_match(jh, th)
    both = (excl >= 0) & (th.inst.numpy() >= 0)
    assert both.any() and (th.inst.numpy()[both] != excl[both]).all()

    lo = int(tb.inst_prim_offset[1])
    hi = lo + int(tb.inst_prim_count[1])
    jh = japi.trace_rays(jb, jnp.asarray(o), jnp.asarray(d), range_lo=lo, range_hi=hi,
                         method="bruteforce")
    th = tapi.trace_rays(tb, to, td, range_lo=lo, range_hi=hi)
    _assert_hits_match(jh, th)
    p = th.prim.numpy()
    assert (p >= 0).any() and ((p[p >= 0] >= lo) & (p[p >= 0] < hi)).all()


def test_miss_value(cornell):
    """A miss returns t = min(max_distance, F32_MAX), prim = inst = -1 and
    u = v = 0 (exact)."""
    _, tb = cornell
    o = np.tile(np.array([[0.0, 1.0, 10.0]], np.float32), (4, 1))
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (4, 1))  # away from the box
    maxd = np.array([5.0, np.inf, 3.0e38, 7.5], np.float32)
    h = tapi.trace_rays(tb, torch.from_numpy(o), torch.from_numpy(d),
                        max_distance=torch.from_numpy(maxd))
    np.testing.assert_array_equal(h.t.numpy(), np.minimum(maxd, np.float32(F32_MAX)))
    for x in (h.prim, h.inst):
        np.testing.assert_array_equal(x.numpy(), -1)
    for x in (h.u, h.v):
        np.testing.assert_array_equal(x.numpy(), 0.0)
    h = tapi.trace_rays(tb, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(h.t.numpy(), np.float32(F32_MAX))
    # A hit beyond max_distance is a miss too.
    d[:, 2] = -1.0
    h = tapi.trace_rays(tb, torch.from_numpy(o), torch.from_numpy(d), max_distance=1.0)
    np.testing.assert_array_equal(h.prim.numpy(), -1)
    np.testing.assert_array_equal(h.t.numpy(), 1.0)


def _duplicate_table(rows: int = 16, dup=(1, 4, 8)):
    """One triangle duplicated at the prims ``dup`` of a ``rows``-triangle
    table (the others invalid), packed for both packages: the JAX
    kernel's f32 rows and the port's rows (instance id as int32 bits)."""
    from hikari_tpu.trace.intersect import precompute_triangles as jax_precompute

    dup = list(dup)
    tri = np.array([[[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]]], np.float32)
    tris = np.repeat(tri + np.array([0.0, 0.0, 50.0], np.float32), rows, axis=0)
    tris[dup] = tri
    valid = np.zeros(rows, np.float32)
    valid[dup] = 1.0
    pre = jax_precompute(jnp.asarray(tris))
    cols = [np.asarray(pre[k]).reshape(rows, -1) for k in ("n", "eu", "ev", "cn", "cu", "cv")]
    jrows = np.concatenate(cols + [valid[:, None], np.zeros((rows, 3), np.float32)], axis=1)
    trows = jrows.copy()
    trows[:, 13] = np.zeros(rows, np.int32).view(np.float32)
    return jrows, trows


def _tie_rays(R):
    """R rays straight through the duplicated triangle, half from each side."""
    o = np.tile(np.array([[0.1, -0.2, -5.0], [-0.3, 0.1, 4.0]], np.float32), (R // 2, 1))
    d = np.tile(np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float32), (R // 2, 1))
    return o, d


@pytest.mark.parametrize("method", ["bruteforce", "pallas"])
def test_tie_rule_lowest_prim(method):
    """Exact ties in t. Coplanar duplicate quads (one quad in three
    instances) tie under both rules on prim 0 or 1 (a quad's triangles sit
    in sublanes 2k, 2k+1, which both rules resolve to the lower prim), as
    the JAX package's same method gives; excluding instance 0 hands the
    hit to the next duplicate. One triangle duplicated at prims 1, 4 and 8
    tells the rules apart: "bruteforce" keeps the lowest prim (1), the JAX
    ``_trace_bruteforce`` rule; "pallas" keeps prim 8 (sublane 0 beats 1
    and 4 in the halving), as K1 does in interpret mode."""
    from hikari_tpu.trace.pallas_kernel import trace_pallas
    from hikari_tpu_torch.scene.compile import Instance, Material, Scene, compile_scene
    from hikari_tpu_torch.scene.mesh import quad_mesh

    scene = Scene(materials=[])
    mat = scene.add_material(Material())
    quad = scene.add_mesh(quad_mesh(2.0))
    for _ in range(3):
        scene.add_instance(Instance(quad, mat))
    arrays = compile_scene(scene)
    jb, tb = _both(arrays)
    o, d = _rays(200, 3, -0.8, 0.8)
    o[:, 2] = 1.0
    d[:, :2] *= 0.1
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    th = tapi.trace_rays(tb, to, td, method=method)
    prim, inst = th.prim.numpy(), th.inst.numpy()
    assert (prim >= 0).all() and (prim < 2).all() and (inst == 0).all()
    jh = japi.trace_rays(jb, jnp.asarray(o), jnp.asarray(d), method=method)
    np.testing.assert_array_equal(prim, np.asarray(jh.prim))
    # Without instance 0, prims 2k+2 and 2k+4 tie: "pallas" halves sublane 4
    # into slot 0 before slot 2 can win, so it keeps the third duplicate.
    excl = tapi.trace_rays(tb, to, td, exclude_instance=0, method=method)
    j_excl = japi.trace_rays(jb, jnp.asarray(o), jnp.asarray(d), exclude_instance=0, method=method)
    np.testing.assert_array_equal(excl.prim.numpy(), np.asarray(j_excl.prim))
    dup = 1 if method == "bruteforce" else 2
    np.testing.assert_array_equal(excl.prim.numpy(), prim + 2 * dup)
    np.testing.assert_array_equal(excl.inst.numpy(), dup)
    np.testing.assert_array_equal(excl.t.numpy(), th.t.numpy())

    jrows, trows = _duplicate_table()
    R = 1024  # the resident JAX kernel takes whole 8 x 128-ray grid steps
    o, d = _tie_rays(R)
    maxd = np.full(R, 3.0e38, np.float32)
    excl = np.full(R, -1, np.int32)
    lo, hi = np.zeros(R, np.int32), np.full(R, 16, np.int32)
    want = 1 if method == "bruteforce" else 8
    t, p, _, _ = ch.closest_hit(*(torch.from_numpy(x) for x in (o, d, maxd, excl, lo, hi)),
                                torch.from_numpy(trows), tie=method)
    assert (p.numpy() == want).all()
    np.testing.assert_allclose(t.numpy(), np.tile([5.0, 4.0], R // 2), rtol=1e-6)
    if method == "pallas":
        jt, jp, _, _ = trace_pallas(jnp.asarray(jrows), *(jnp.asarray(x) for x in (o, d, maxd, excl,
                                                                                   lo, hi)),
                                    interpret=True)
        np.testing.assert_array_equal(np.asarray(jp), p.numpy())
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6)


def test_tie_across_tiles_matches_streamed_jax_kernel():
    """One triangle duplicated at prims 1, 4 and 2,056 of a 2,064-row table:
    above the JAX kernel's 2,048-row tile, so it runs its streamed K1b path
    (the table padded to two tiles, the eight sublane bests carried across
    them) and across the CUDA kernel's 256-row tiles. The twin equals the
    JAX kernel in interpret mode: prim 2,056 (sublane 0 wins the halving)
    under "pallas", and keeps the lowest prim, 1, under "bruteforce"."""
    from hikari_tpu.trace.pallas_kernel import TRI_TILE, trace_pallas

    rows, far = 2064, 2056
    jrows, trows = _duplicate_table(rows, (1, 4, far))
    jrows = np.concatenate([jrows, np.zeros((2 * TRI_TILE - rows, 16), np.float32)])
    R = 256  # two 128-ray blocks of the streamed grid
    o, d = _tie_rays(R)
    maxd = np.full(R, 3.0e38, np.float32)
    excl = np.full(R, -1, np.int32)
    lo, hi = np.zeros(R, np.int32), np.full(R, rows, np.int32)
    args = [torch.from_numpy(x) for x in (o, d, maxd, excl, lo, hi)] + [torch.from_numpy(trows)]
    jt, jp, ju, jv = trace_pallas(jnp.asarray(jrows), *(jnp.asarray(x) for x in (o, d, maxd, excl,
                                                                                lo, hi)),
                                  interpret=True)
    t, p, u, v = ch.closest_hit_reference(*args, tie="pallas")
    np.testing.assert_array_equal(np.asarray(jp), far)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)
    _, p_bf, _, _ = ch.closest_hit_reference(*args, tie="bruteforce")
    np.testing.assert_array_equal(p_bf.numpy(), 1)


@pytest.fixture(scope="module")
def soup():
    """3000 random triangles in 5 instances: more than the 2048-triangle
    resident limit of K1 and more than one of the kernel's 256-triangle
    tiles, and several chunks of the twin's ray loop."""
    from hikari_tpu.scene.compile import Instance, Material, Scene, compile_scene
    from hikari_tpu.scene.mesh import Mesh

    rng = np.random.default_rng(4)
    scene = Scene(materials=[])
    mat = scene.add_material(Material())
    for _ in range(5):
        c = rng.uniform(-1, 1, (600, 1, 3))
        pos = (c + rng.normal(scale=0.12, size=(600, 3, 3))).reshape(-1, 3)
        mesh = Mesh(pos, np.tile([[0.0, 1.0, 0.0]], (len(pos), 1)), np.zeros((len(pos), 2)),
                    np.arange(len(pos)).reshape(-1, 3))
        scene.add_instance(Instance(scene.add_mesh(mesh), mat))
    return _both(compile_scene(scene))


def test_soup_matches_jax(soup):
    jb, tb = soup
    assert tb.num_tris == 3000
    o, d = _rays(4096, 5, -1.5, 1.5)
    rng = np.random.default_rng(6)
    excl = rng.integers(-1, 5, 4096).astype(np.int32)
    lo = rng.integers(0, 3000, 4096).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 3000, 4096), 3000).astype(np.int32)
    kw_j = dict(exclude_instance=jnp.asarray(excl), range_lo=jnp.asarray(lo), range_hi=jnp.asarray(hi))
    kw_t = dict(exclude_instance=torch.from_numpy(excl), range_lo=torch.from_numpy(lo),
                range_hi=torch.from_numpy(hi))
    jh = japi.trace_rays(jb, jnp.asarray(o), jnp.asarray(d), method="bruteforce", **kw_j)
    # A forced "pallas" above 2048 triangles is the K1b contract; on CPU
    # tensors it runs the twin, as "auto" does.
    th = tapi.trace_rays(tb, torch.from_numpy(o), torch.from_numpy(d), method="pallas", **kw_t)
    assert (th.prim.numpy() >= 0).sum() > 500
    assert 4096 > ch.RAY_CHUNK_PAIRS // 3000  # the twin's chunk loop runs more than once
    _assert_hits_match(jh, th)
    auto = tapi.trace_rays(tb, torch.from_numpy(o), torch.from_numpy(d), **kw_t)
    np.testing.assert_array_equal(auto.prim.numpy(), th.prim.numpy())


@pytest.mark.parametrize("method", ["tiled", "bvh", "scatter"])
def test_unported_backends_raise(cornell, method):
    """Every backend of the JAX package is ported: "tiled", "bvh" and
    "scatter" return the exact closest hits, those of the brute-force
    search; an unknown method raises."""
    _, tb = cornell
    o, d = _rays(8, 7)
    args = (tb, torch.from_numpy(o), torch.from_numpy(d))
    got = tapi.trace_rays(*args, method=method)
    want = tapi.trace_rays(*args, method="bruteforce")
    assert bool((want.prim >= 0).any())
    assert torch.equal(got.prim, want.prim) and torch.equal(got.t, want.t)
    with pytest.raises(ValueError, match="unknown trace method"):
        tapi.trace_rays(*args, method=method + "_x")


def test_refine_and_hit_info_match_jax(cornell):
    """Tolerances: ids equal; normal/uv/refined t,u,v within 1e-5; positions
    within 1e-6 relative + 1e-5 absolute (misses sit at 65535 units). Both
    sides take the brute-force tie rule: rays that start inside a box hit
    its bottom face and the coplanar floor at exactly equal t."""
    jb, tb = cornell
    o, d = _rays(400, 8, -0.9, 0.9)
    o[:, 1] += 1.0
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    jh = japi.trace_rays(jb, jo, jd, method="bruteforce")
    th = tapi.trace_rays(tb, to, td, method="bruteforce")
    _assert_hits_match(jh, th)
    for a, b in zip(japi.refine_hit(jb, jo, jd, jh), tapi.refine_hit(tb, to, td, th)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
    ji, ti = japi.hit_info(jb, jo, jd, jh), tapi.hit_info(tb, to, td, th)
    np.testing.assert_allclose(ti.position.numpy(), np.asarray(ji.position), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ti.normal.numpy(), np.asarray(ji.normal), atol=1e-5)
    np.testing.assert_allclose(ti.uv.numpy(), np.asarray(ji.uv), atol=1e-5)
    np.testing.assert_array_equal(ti.instance.numpy(), np.asarray(ji.instance))
    np.testing.assert_array_equal(ti.material.numpy(), np.asarray(ji.material))

    # Shadow-ray occlusion of that info by a second trace.
    o2 = o + d * 0.05
    jh2 = japi.trace_rays(jb, jnp.asarray(o2), jd, method="bruteforce")
    th2 = tapi.trace_rays(tb, torch.from_numpy(o2), td, method="bruteforce")
    jo2 = japi.occlude_hit_info(jnp.asarray(o2), jd, jh2, ji)
    to2 = tapi.occlude_hit_info(torch.from_numpy(o2), td, th2, ti)
    np.testing.assert_allclose(to2.position.numpy(), np.asarray(jo2.position), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(to2.normal.numpy(), np.asarray(jo2.normal), atol=1e-5)
    np.testing.assert_array_equal(to2.instance.numpy(), np.asarray(jo2.instance))
    np.testing.assert_array_equal(to2.material.numpy(), np.asarray(jo2.material))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the closest-hit kernel has no CPU mode")
    return torch.device("cuda", 0)


def _assert_kernel_is_twin(args, tie="pallas"):
    before = ch.launches
    got = ch.closest_hit(*args, tie=tie)
    assert ch.launches == before + 1
    want = ch.closest_hit_reference(*args, tie=tie)
    for a, b in zip(got, want):
        assert same_bits(a, b)
    return got


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(cornell, soup, cuda_device):
    """On the card the kernel equals its twin bit for bit on prim, t, u, v
    (no FMA contraction, same operation order), under both tie modes: for
    the resident-size cornell table and for the multi-tile soup; for rays
    whose lanes mix prim ranges (the whole table, the emissive instance's
    prims, empty, a random part: per lane and per warp of 32), with max
    distances of NaN, +inf and 0, the instance of their own hit excluded,
    on the table and with every fifth row invalid, at 300,000 rays (a
    ragged last block) and 65,536; and for the duplicated
    triangle at prims 1, 4 and 2,056, across the kernel's 256-row tiles."""
    dev = cuda_device
    for _, tb_cpu in (cornell, soup):
        arrays_dev = map_tensors(lambda x: x.to(cuda_device), tb_cpu)
        o, d = _rays(65536, 9)
        to = torch.from_numpy(o).to(cuda_device)
        td = torch.from_numpy(d).to(cuda_device)
        R = to.shape[0]
        args = (
            to, td, torch.full((R,), F32_MAX, device=cuda_device),
            torch.full((R,), -1, dtype=torch.int32, device=cuda_device),
            torch.zeros((R,), dtype=torch.int32, device=cuda_device),
            torch.full((R,), arrays_dev.num_tris, dtype=torch.int32, device=cuda_device),
            ch.pack_triangles(arrays_dev),
        )
        for tie in ch.TIE_RULES:
            _assert_kernel_is_twin(args, tie)

    tb = map_tensors(lambda x: x.to(dev), cornell[1])
    packed = ch.pack_triangles(tb)
    P, R = tb.num_tris, 300000
    em = int(tb.em_instance[0])
    em_lo = int(tb.inst_prim_offset[em])
    em_hi = em_lo + int(tb.inst_prim_count[em])
    rng = np.random.default_rng(12)
    o, d = _rays(R, 13, -0.9, 0.9)
    o[:, 1] += 1.0
    kind = rng.integers(0, 4, R)
    kind[R // 2:] = np.repeat(rng.integers(0, 4, -(-R // 64)), 32)[: R - R // 2]
    part_lo = rng.integers(0, P, R)
    part_hi = np.minimum(part_lo + rng.integers(0, P, R), P)
    lo = np.select([kind == 0, kind == 1, kind == 2], [0, em_lo, 5], part_lo)
    hi = np.select([kind == 0, kind == 1, kind == 2], [P, em_hi, 5], part_hi)
    pick = rng.integers(0, 5, R)
    maxd = np.select([pick == 0, pick == 1, pick == 2, pick == 3], [np.nan, np.inf, 0.0, 3.0e38],
                     rng.uniform(0.1, 3.0, R))
    args = [torch.from_numpy(x.astype(dt)).to(dev) for x, dt in (
        (o, np.float32), (d, np.float32), (maxd, np.float32), (np.full(R, -1), np.int32),
        (lo, np.int32), (hi, np.int32))]
    first = ch.closest_hit_reference(*args, packed)[1]
    own = torch.where(first >= 0, tb.tri_inst[first.clamp(min=0)].to(torch.int32), -1)
    third = torch.from_numpy(rng.uniform(size=R) < 1 / 3).to(dev)
    args[3] = torch.where(third, own, args[3]).to(torch.int32).contiguous()
    invalid = packed.clone()
    invalid[2::5, 12] = 0.0
    for table in (packed, invalid):
        for n in (R, 65536):
            for tie in ch.TIE_RULES:
                got = _assert_kernel_is_twin([x[:n] for x in args] + [table], tie)
    assert bool(torch.isnan(got[0]).any()) and bool((got[1] >= 0).any())

    rows, far = 2064, 2056
    _, trows = _duplicate_table(rows, (1, 4, far))
    for n in (1024, 300032):
        o, d = _tie_rays(n)
        args = [torch.from_numpy(x).to(dev) for x in (
            o, d, np.full(n, 3.0e38, np.float32), np.full(n, -1, np.int32),
            np.zeros(n, np.int32), np.full(n, rows, np.int32), trows)]
        for tie, want in (("pallas", far), ("bruteforce", 1)):
            got = _assert_kernel_is_twin(args, tie)
            assert bool((got[1] == want).all())
