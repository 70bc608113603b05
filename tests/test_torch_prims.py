"""Parity of the port's primitives (``hikari_tpu_torch.tools.prims``, the
T1-T3 kernels of ``tools/bench_pallas_prims.py``) with the JAX package's
Pallas kernels, rebuilt here from that tool (its kernels are closures in
its ``main()``) and run in interpret mode: the window-table pack (T1)
against ``pack_kernel_v2`` and against the JAX ``pack_rows``; the gathers
(T2/T3) against ``make_g``/``make_vreg_g`` and ``jnp.take_along_axis`` in
each index mode; the wrappers' argument checks; on the card (``-m cuda``)
each kernel against its twin.

Tolerances: none. The pack is a copy, the gathers add the same f32 values
in the same order, so every comparison is bitwise (NaN where both sides
read the fill value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hikari_tpu.render.filters import pack_rows as jax_pack_rows
from hikari_tpu_torch.render.filters import pack_rows
from hikari_tpu_torch.tools import prims
from hikari_tpu_torch.utils import same_bits

torch.set_num_threads(2)

DXS = list(range(16))


def _jax_pack_v2(planes, H, W, TB=16, MD=2, PADW=128):
    """``pack_kernel_v2`` / ``pallas_pack_v2`` of tools/bench_pallas_prims.py
    (:109-165) at the given size, in interpret mode; planes (C, H, W)."""
    C, K, Wp = planes.shape[0], planes.shape[0] * len(DXS), W + PADW

    def pack_kernel_v2(*refs):
        ins, out = refs[:C], refs[C]
        slabs, sem = refs[C + 1 : C + 1 + C], refs[-1]
        t, s = pl.program_id(0), pl.program_id(1)

        def dma(ci):
            return pltpu.make_async_copy(ins[ci].at[pl.ds(t * TB, TB + 2 * MD), :], slabs[ci],
                                         sem.at[ci])

        @pl.when(s == 0)
        def _():
            for ci in range(C):
                dma(ci).start()
            for ci in range(C):
                dma(ci).wait()

        rows = [slabs[ci][pl.ds(s + MD, 1), dx : dx + W] for ci in range(C) for dx in DXS]
        out[:] = jnp.concatenate(rows, axis=0).T

    padded = [jnp.pad(jnp.asarray(p), ((MD, MD), (0, PADW)), mode="edge") for p in planes]
    return pl.pallas_call(
        pack_kernel_v2,
        out_shape=jax.ShapeDtypeStruct((H * W, K), jnp.float32),
        grid=(H // TB, TB),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * C,
        out_specs=pl.BlockSpec((W, K), lambda t, s: (t * TB + s, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((TB + 2 * MD, Wp), jnp.float32)] * C
        + [pltpu.SemaphoreType.DMA((C,))],
        interpret=True,
    )(*padded)


def test_window_pack_twin_matches_jax_kernel():
    """H = 32, W = 40, C = 2, TB = 16: the twin equals the JAX kernel and
    the tool's XLA pack (``pack_rows`` of edge-padded slices) bitwise."""
    H, W, C = 32, 40, 2
    planes = np.random.default_rng(0).normal(size=(C, H, W)).astype(np.float32)
    want = np.asarray(_jax_pack_v2(planes, H, W))
    got = prims.window_pack(torch.from_numpy(planes), DXS)
    assert got.shape == (H * W, C * len(DXS))
    np.testing.assert_array_equal(got.numpy(), want)
    xla = jax_pack_rows([jnp.pad(jnp.asarray(p), ((0, 0), (0, 128)), mode="edge")[:, dx : dx + W]
                         for p in planes for dx in DXS])
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    # The contract, written out: out[y*W + x, c*D + j] = planes[c, y, min(x + dx_j, W - 1)].
    y, x, c, j = 5, W - 3, 1, 9
    assert got[y * W + x, c * len(DXS) + j] == planes[c, y, min(x + DXS[j], W - 1)]


def test_pack_rows_matches_jax():
    parts = [np.random.default_rng(k).normal(size=(7, 9)).astype(np.float32) for k in range(5)]
    want = np.asarray(jax_pack_rows([jnp.asarray(p) for p in parts]))
    got = pack_rows([torch.from_numpy(p) for p in parts])
    assert got.shape == (63, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_gather(x, idx, axis, reps=None, mode=None):
    """The tool's gather kernels in interpret mode: ``make_g`` (one
    ``take_along_axis``, reps None) or ``make_vreg_g`` (reps of them, of
    x + r, summed), :186-250."""
    Mv, Nv = idx.shape

    def g_kernel(x_ref, i_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=axis, mode=mode)

    def vreg_kernel(x_ref, i_ref, o_ref):
        acc = jnp.zeros((Mv, Nv), jnp.float32)
        for r in range(reps):
            acc = acc + jnp.take_along_axis(x_ref[:] + r, i_ref[:], axis=axis)
        o_ref[:] = acc

    return np.asarray(pl.pallas_call(
        g_kernel if reps is None else vreg_kernel,
        out_shape=jax.ShapeDtypeStruct((Mv, Nv), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(idx)))


def _gather_case(shape, axis, seed, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    x = (np.arange(shape[0] * shape[1], dtype=np.float32).reshape(shape) * 1e-4
         + rng.normal(size=shape).astype(np.float32))
    n = shape[axis]
    idx = rng.integers(lo, n if hi is None else hi, shape).astype(np.int32)
    return x, idx


@pytest.mark.parametrize("reps", [1, 4])
@pytest.mark.parametrize("shape,axis", [((64, 128), 1), ((8, 256), 0)],
                         ids=["64x128-ax1", "8x256-ax0"])
def test_take_along_twin_matches_jax_kernel(shape, axis, reps):
    """The twin against ``make_vreg_g`` at ``reps``; at reps 1 also
    against ``make_g`` (the single gather, T2)."""
    x, idx = _gather_case(shape, axis, seed=reps)
    got = prims.take_along_sum(torch.from_numpy(x), torch.from_numpy(idx), axis, reps).numpy()
    np.testing.assert_array_equal(got, _jax_gather(x, idx, axis, reps))
    if reps == 1:
        np.testing.assert_array_equal(got, _jax_gather(x, idx, axis))


@pytest.mark.parametrize("mode", [None, "clip", "fill"])
def test_take_along_modes_match_jax(mode):
    """Indices from -2n to 2n along each axis: negative ones gain the axis
    length once, then "clip" clamps and None/"fill" read NaN, exactly as
    ``jnp.take_along_axis`` (and ``make_g`` with that mode) does."""
    for shape, axis in (((16, 32), 1), ((8, 24), 0)):
        n = shape[axis]
        x, idx = _gather_case(shape, axis, seed=7, lo=-2 * n, hi=2 * n)
        want = np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx), axis=axis,
                                              mode=mode))
        assert np.isnan(want).any() == (mode != "clip")
        got = prims.take_along_sum(torch.from_numpy(x), torch.from_numpy(idx), axis, 1, mode)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), _jax_gather(x, idx, axis, mode=mode))


def test_wrappers_check_their_arguments():
    """Each wrapper raises for a dtype or device mismatch, an unknown mode
    and a device it has no kernel for; it never falls back."""
    x = torch.zeros((4, 8))
    idx = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        prims.take_along_sum(x.double(), idx, 1)
    with pytest.raises(TypeError, match="int32"):
        prims.take_along_sum(x, idx.long(), 1)
    with pytest.raises(ValueError, match="is on meta"):
        prims.take_along_sum(x, idx.to("meta"), 1)
    with pytest.raises(NotImplementedError, match="no kernel"):
        prims.take_along_sum(x.to("meta"), idx.to("meta"), 1)
    with pytest.raises(ValueError, match="mode"):
        prims.take_along_sum(x, idx, 1, mode="wrap")
    planes = torch.zeros((2, 4, 8))
    with pytest.raises(TypeError, match="float32"):
        prims.window_pack(planes.double(), DXS)
    with pytest.raises(NotImplementedError, match="no kernel"):
        prims.window_pack(planes.to("meta"), DXS)
    with pytest.raises(ValueError, match="dx >= 0"):
        prims.window_pack(planes, [0, -1])


def test_bench_runs_on_cpu(capsys):
    """The tool's entry point on the CPU at a small pack size: every case
    meets its check; the twins run, so no kernel is launched."""
    from hikari_tpu_torch.tools import bench_pallas_prims

    before = (prims.window_pack_launches, prims.take_along_launches)
    results = bench_pallas_prims.main(["--cpu", "--pack-size", "16x24"])
    assert len(results) == 8 and all(r["ok"] for r in results.values())
    assert (prims.window_pack_launches, prims.take_along_launches) == before
    assert "cuda pack (window_pack.cu) + gather" in capsys.readouterr().out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the T1-T3 kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernels_match_twins_on_card(cuda_device):
    """On the card each kernel equals its twin bitwise: the pack at 8
    planes of 96 x 300 (a ragged last column run), the gathers at the
    tool's shapes and in each mode, and at ON % 4 != 0, with an idx 4
    bytes past a 16-byte boundary, at (2048, 2048) and (2048, 1030), at
    reps 0, 1 and 3, on indices in [-2n, 2n) in each mode (NaN where the
    twin fills)."""
    planes = torch.randn((8, 96, 300), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    before = prims.window_pack_launches
    got = prims.window_pack(planes, DXS)
    assert prims.window_pack_launches == before + 1
    assert torch.equal(got, prims.window_pack_reference(planes, DXS))
    cases = (((512, 512), 0, 1, None, 0), ((512, 512), 1, 1, "clip", -600),
             ((512, 128), 1, 32, "fill", -200), ((8, 1024), 0, 32, None, -9))
    for shape, axis, reps, mode, lo in cases:
        x, idx = _gather_case(shape, axis, seed=3, lo=lo, hi=2 * shape[axis])
        x, idx = torch.from_numpy(x).to(cuda_device), torch.from_numpy(idx).to(cuda_device)
        got = prims.take_along_sum(x, idx, axis, reps, mode)
        want = prims.take_along_sum_reference(x, idx, axis, reps, mode)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    for xshape, ishape, axis, shift in (
            ((512, 128), (512, 130), 1, False), ((64, 130), (50, 130), 0, False),
            ((8, 1024), (8, 1024), 0, True), ((2048, 2048), (2048, 2048), 1, False),
            ((2048, 2048), (2048, 2048), 1, True), ((2048, 1030), (2048, 1030), 0, False)):
        n = xshape[axis]
        x = torch.from_numpy(_gather_case(xshape, axis, seed=4)[0]).to(cuda_device)
        rng = np.random.default_rng(8)
        idx = torch.from_numpy(rng.integers(-2 * n, 2 * n, ishape).astype(np.int32)).to(cuda_device)
        if shift:
            flat = torch.empty(idx.numel() + 1, dtype=torch.int32, device=cuda_device)
            idx = flat[1:].view(ishape).copy_(idx)
            assert idx.data_ptr() % 16 == 4
        for reps in (0, 1, 3):
            for mode in prims.TAKE_MODES:
                before = prims.take_along_launches
                got = prims.take_along_sum(x, idx, axis, reps, mode)
                assert prims.take_along_launches == before + 1
                want = prims.take_along_sum_reference(x, idx, axis, reps, mode)
                assert same_bits(got, want)
                assert bool(torch.isnan(want).any()) == (mode != "clip" and reps > 0)
