"""The benchmark's cell ``many_cubes_view`` driven whole on the CPU, cut
to 64x48 and to the ``many_cubes`` grid of 20 (1,297 cubes, 15,564
triangles: the port walks tiles, the reference takes its clustered
search): its configuration, its reference twin
(``hikari_bench/reference/io/many_cubes_twin.py``) and its limits as the
benchmark has them. A sound run reads 0 in its image and state. Its
hits read 0.0024, not 0 and above the cell's limit (0.0008, set from the
full scene on the card): at this grid the cubes stand ten times as far
apart and the rays' offset from a surface does not grow with them, so
more shadow rays graze their own cube's face at large coordinates, where
float32's rounding of the pair test moves t by more than the check's
1e-4. The test holds the port to that explanation: on every sampled ray
that the check counts off, and on every sampled ray without an early
distance, the port's answer (K2, the tile walk) is K1's (every triangle
tested, ``method="pallas"``) bit for bit, so the reading is float32's and
not the walk's; and the reading stays under 0.003. The control (the
reference in bfloat16 in the port's place) and ``faults.HitAltered`` come
out not correct."""

import json

import pytest
import torch

from hikari_bench import check, faults, harness, run
from hikari_bench.reference import brute

SEED = 2**31 + 1201
# The grid-20 cell's sound hits reading (0.0024) with a little room.
SOUND_HITS = 0.003

torch.set_num_threads(2)


def shrink(config):
    c = json.loads(json.dumps(config))
    c["settings"]["width"], c["settings"]["height"] = 64, 48
    c["geometry"] = {"fn": "many_cubes_scene", "kwargs": {"grid": 20}}
    return c


def _flagged(sample, buffers):
    """(R,) bool: the rays of one sample that ``check.hits_off`` counts
    off, by its float64 rule."""
    tri, inst = buffers.tri_world.detach(), buffers.tri_inst
    o, d, maxd, early = sample["o"], sample["d"], sample["maxd"], sample["early"]
    args = (sample["excl"], sample["lo"], sample["hi"])
    clear = brute.closest(o, d, maxd, *args, tri, inst, edge=-brute.EDGE)
    t, prim = sample["t"].double(), sample["prim"]
    own = brute.along(o, d, prim, tri, edge=brute.EDGE)
    tol = check.T_RTOL
    nearest = torch.isfinite(clear) & ((t - clear).abs() <= tol * clear.abs().clamp(min=1.0))
    real = torch.isfinite(own) & ((t - own).abs() <= tol * own.abs().clamp(min=1.0))
    not_farther = t <= clear + tol * clear.abs().clamp(min=1.0)
    early_ok = (early > 0) & (t < early.double())
    ok = torch.where(prim >= 0, nearest | (real & (not_farther | early_ok)),
                     ~torch.isfinite(clear))
    return ~ok


def _assert_off_rays_are_k1(seen, reading):
    """The rays the check counts off, and every ray without an early
    distance, carry K1's answer on the port's own scene bit for bit."""
    from hikari_tpu_torch.trace import api

    program, samples, ref_buffers = seen["program"], seen["samples"], seen["buffers"]
    off = total = n_checked = 0
    for s in samples:
        flagged = _flagged(s, ref_buffers)
        off += int(flagged.sum())
        total += flagged.numel()
        k1 = api.trace_rays(program.buffers, s["o"], s["d"], max_distance=s["maxd"],
                            exclude_instance=s["excl"], range_lo=s["lo"], range_hi=s["hi"],
                            method="pallas")
        pick = flagged | (s["early"] <= 0)
        n_checked += int(pick.sum())
        assert torch.equal(s["prim"][pick], k1.prim[pick])
        assert torch.equal(s["t"][pick].view(torch.int32), k1.t[pick].view(torch.int32))
    assert off / total == reading  # the rule above is the check's
    assert off > 0 and n_checked > total // 2


@pytest.mark.parametrize("fault", [None, faults.Control, faults.HitAltered],
                         ids=["sound", "control", "hit_altered"])
def test_many_cubes_cell(fault, monkeypatch):
    seen = {}
    factory = fault
    if fault is None:
        judge = check.hits_off

        def kept_hits_off(samples, buffers, dtype=torch.float64):
            seen.update(samples=samples, buffers=buffers)
            return judge(samples, buffers, dtype)

        class Kept(harness.Program):
            def __init__(self, config, device):
                super().__init__(config, device)
                seen["program"] = self

        monkeypatch.setattr(check, "hits_off", kept_hits_off)
        factory = Kept
    result, numbers = run.run("many_cubes_view", SEED, 0.0, False, device="cpu",
                              program_factory=factory, shrink=shrink)
    values = {n.name: n.value for n in numbers}
    if fault is None:
        assert values["image_off"] == values["state_off"] == 0, values
        assert values["hits_off"] < SOUND_HITS, values
        _assert_off_rays_are_k1(seen, values["hits_off"])
    else:
        assert not result["correct"], values
