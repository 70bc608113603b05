"""The reference's clustered search (``reference/trace/accel.py``) against
its twin of K1, which tests every triangle: equal bit for bit in t, prim,
u and v, under both tie rules, on the Cornell box, on seeded triangle
soups with duplicated triangles (equal t, so the tie rule decides), with
coplanar duplicates spread over clusters (which only the boxes' margin
keeps), with slivers too skewed for a box, and on rays with a max
distance, an excluded instance and a prim range set."""

from types import SimpleNamespace

import pytest
import torch

from hikari_bench.reference.io.scenes import cornell_config
from hikari_bench.reference.scene import build_scene_buffers
from hikari_bench.reference.trace import accel, api
from hikari_bench.reference.trace.closest_hit import closest_hit_reference, pack_triangles
from hikari_bench.reference.trace.intersect import precompute_triangles

F32_MAX = 3.402823466e38


def scene_of(tri, inst_every: int = 7):
    """The triangle fields the searches read, of triangles (P, 3, 3)."""
    pre = precompute_triangles(tri)
    P = tri.shape[0]
    return SimpleNamespace(num_tris=P, tri_n=pre["n"], tri_eu=pre["eu"], tri_ev=pre["ev"],
                           tri_cn=pre["cn"], tri_cu=pre["cu"], tri_cv=pre["cv"],
                           tri_valid=pre["valid"],
                           tri_inst=(torch.arange(P) // inst_every).to(torch.int32))


def soup(seed: int, P: int = 3000, dup: int = 300, floor: int = 0, slivers: int = 0):
    """Seeded triangles around the origin; ``dup`` of them copies of
    others, ``floor`` copies of a 20 x 20 floor quad at y = 0 spread
    through the prims, ``slivers`` nearly flat ones."""
    g = torch.Generator().manual_seed(seed)
    tri = torch.rand(P, 1, 3, generator=g) * 10 - 5 + torch.randn(P, 3, 3, generator=g) * 0.5
    if dup:
        src = torch.randint(0, P, (dup,), generator=g)
        tri[torch.randint(0, P, (dup,), generator=g)] = tri[src]
    if slivers:
        a, b = tri[:slivers, 0], tri[:slivers, 1]
        tri[:slivers, 2] = a + 0.5 * (b - a) + 1e-4 * torch.randn(slivers, 3, generator=g)
    if floor:
        quad = torch.tensor([[[-10.0, 0, -10], [10, 0, -10], [10, 0, 10]],
                             [[-10.0, 0, -10], [10, 0, 10], [-10, 0, 10]]])
        tri = torch.cat([tri, quad.repeat(floor // 2, 1, 1)])
        tri = tri[torch.randperm(tri.shape[0], generator=g)]
    return scene_of(tri)


def rays(seed: int, R: int, P: int, limits: bool, down: bool = False):
    """Seeded rays through the soup's box; with ``limits`` a third of them
    each get a max distance, an excluded instance, a prim range."""
    g = torch.Generator().manual_seed(seed)
    o = torch.rand(R, 3, generator=g) * 16 - 8
    d = torch.nn.functional.normalize(torch.randn(R, 3, generator=g), dim=1)
    if down:  # towards the floor from above, some grazing
        o[:, 1] = 9.0
        d = torch.nn.functional.normalize(d * torch.tensor([1.0, 0.2, 1.0])
                                          - torch.tensor([0.0, 1.0, 0.0]), dim=1)
    d[: R // 8, 1:] = 0.0  # along x: the slab test's zero components
    d[: R // 8, 0] = 1.0
    maxd = torch.full((R,), F32_MAX)
    excl = torch.full((R,), -1, dtype=torch.int32)
    lo = torch.zeros(R, dtype=torch.int32)
    hi = torch.full((R,), P, dtype=torch.int32)
    if limits:
        pick = lambda: torch.rand(R, generator=g) < 1 / 3  # noqa: E731
        maxd = torch.where(pick(), torch.rand(R, generator=g) * 10, maxd)
        excl = torch.where(pick(), torch.randint(0, P // 7, (R,), generator=g), excl).int()
        lo = torch.where(pick(), torch.randint(0, P, (R,), generator=g), lo).int()
        hi = torch.where(pick(), torch.randint(0, P, (R,), generator=g), hi).int()
    return o, d, maxd, excl, lo, hi


def assert_bitwise(want, got):
    for name, a, b in zip(("t", "prim", "u", "v"), want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        diff = int((a != b).sum())
        assert diff == 0, f"{name}: {diff} of {a.numel()} rays differ"


def same_answers(scene, args, tie):
    want = closest_hit_reference(*args, pack_triangles(scene), tie)
    got = accel.closest_hit_clustered(*args, accel.build(scene), tie)
    assert_bitwise(want, got)
    return want


@pytest.mark.parametrize("tie", ["pallas", "bruteforce"])
@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("limits", [False, True], ids=["open", "limited"])
def test_soup_matches_the_twin(seed, tie, limits):
    scene = soup(seed)
    want = same_answers(scene, rays(seed + 100, 4000, scene.num_tris, limits), tie)
    assert (want[1] >= 0).sum() > 500


def test_duplicates_make_ties_that_the_rule_decides():
    """Equal t at copies of one triangle: the two tie rules disagree on
    many rays, and the search follows each."""
    scene = soup(7, dup=600)
    args = rays(5, 6000, scene.num_tris, False)
    a = same_answers(scene, args, "pallas")
    b = same_answers(scene, args, "bruteforce")
    assert int((a[1] != b[1]).sum()) > 50


@pytest.mark.parametrize("tie", ["pallas", "bruteforce"])
def test_coplanar_copies_over_many_clusters(tie):
    """Sixty copies of a floor quad lie in several clusters at one t: a
    cluster entered exactly at the best t so far must still be tested."""
    scene = soup(1, P=2000, dup=0, floor=120)
    assert accel.build(scene).num_clusters > 60
    same_answers(scene, rays(5, 8000, scene.num_tris, False, down=True), tie)


def test_slivers_are_tested_against_every_ray():
    scene = soup(3, P=2500, dup=0, slivers=200)
    assert accel.build(scene).loose.numel() > 100
    same_answers(scene, rays(9, 6000, scene.num_tris, True), "pallas")


def test_cornell_box():
    scene, _, _ = cornell_config(device="cpu")
    buffers = build_scene_buffers(scene, "cpu")
    g = torch.Generator().manual_seed(4)
    R = 5000
    o = torch.tensor([0.0, 1.0, 4.0]).expand(R, 3).clone()  # the camera's eye
    o[R // 2:] = torch.rand(R - R // 2, 3, generator=g) * 2 - torch.tensor([1.0, 0.0, 1.0])
    d = torch.nn.functional.normalize(torch.randn(R, 3, generator=g), dim=1)
    P = buffers.num_tris
    args = (o, d, torch.full((R,), F32_MAX), torch.full((R,), -1, dtype=torch.int32),
            torch.zeros(R, dtype=torch.int32), torch.full((R,), P, dtype=torch.int32))
    want = same_answers(buffers, args, "pallas")
    assert (want[1] >= 0).sum() > R // 3


@pytest.mark.parametrize("method", api.METHODS)
def test_every_tracer_name_gives_the_exact_closest_hit(method):
    """``trace_rays`` over 2,048 triangles takes the clustered search for
    every name, each equal to the twin under its tie rule."""
    scene = soup(21)
    o, d, maxd, excl, lo, hi = rays(22, 3000, scene.num_tris, True)
    hit = api.trace_rays(scene, o, d, max_distance=maxd, exclude_instance=excl, range_lo=lo,
                         range_hi=hi, method=method, early_distance=maxd * 0.5, max_steps=3)
    tie = "bruteforce" if method == "bruteforce" else "pallas"
    want = closest_hit_reference(o, d, maxd, excl, lo, hi, pack_triangles(scene), tie)
    assert_bitwise(want, (hit.t, hit.prim, hit.u, hit.v))


def test_unknown_tracer_name_raises():
    scene = soup(1, P=64, dup=0)
    o, d, *_ = rays(1, 8, 64, False)
    with pytest.raises(ValueError):
        api.trace_rays(scene, o, d, method="no_such_search")


def on(device, scene, args):
    fields = {k: v.to(device) if torch.is_tensor(v) else v for k, v in vars(scene).items()}
    return SimpleNamespace(**fields), tuple(a.to(device) for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("tie", ["pallas", "bruteforce"])
@pytest.mark.parametrize("floor", [0, 120], ids=["soup", "floor"])
def test_the_card_matches_the_twin(tie, floor):
    """The same equality on the card: a seeded soup with duplicates (and
    coplanar floor copies over many clusters), rays with limits set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    scene = soup(31, P=4000, dup=400, floor=floor)
    scene, args = on("cuda", scene, rays(32, 20000, scene.num_tris, True, down=bool(floor)))
    want = same_answers(scene, args, tie)
    assert want[0].is_cuda and (want[1] >= 0).sum() > 2000
