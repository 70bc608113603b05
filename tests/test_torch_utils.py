"""Parity of the PyTorch port's shared math with ``hikari_tpu``: the
integer hash and its float conversion (bitwise), the Halton jitter table,
the f16 reservoir packing (bitwise), the frame math helpers and the
gradient firewalls. Inputs come from numpy with a fixed seed; JAX runs on
the CPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu.utils as ju
import hikari_tpu_torch.utils as tu

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _u32_inputs():
    rng = np.random.default_rng(11)
    edge = np.array(
        [0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFF7F, 0xFFFFFF80, 0xFFFFFFFF],
        dtype=np.uint32,
    )
    # Half of the random values carry the high bit.
    return np.concatenate([edge, rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])


def test_pcg_hash_bitwise():
    """Tolerance: bitwise. The port hashes in int64 masked to 32 bits."""
    x = _u32_inputs()
    want = np.asarray(ju.pcg_hash(jnp.asarray(x)))
    got = tu.pcg_hash(torch.from_numpy(x.astype(np.int64))).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    # Signed inputs with the same low 32 bits hash the same.
    signed = tu.pcg_hash(torch.from_numpy(x.view(np.int32).astype(np.int64))).numpy()
    np.testing.assert_array_equal(signed, got)


def test_random_float_bitwise():
    """Tolerance: bitwise — the u32 -> f32 conversion rounds to nearest
    even in both packages."""
    x = _u32_inputs()
    want = np.asarray(ju.random_float(jnp.asarray(x)))
    got = tu.random_float(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_halton_table_equal():
    """Tolerance: exact (same host arithmetic)."""
    np.testing.assert_array_equal(tu.HALTON_JITTER, ju.HALTON_JITTER)
    for base in (2, 3, 5):
        for index in (0, 1, 7, 100, 12345):
            assert tu.halton(base, index) == ju.halton(base, index)


def _random_reservoir_fields(shape, rng):
    def f(*c):
        # Wide dynamic range: f16 rounding, overflow to inf and subnormals.
        mag = 10.0 ** rng.uniform(-9, 6, shape + c)
        return (np.sign(rng.normal(size=shape + c)) * mag).astype(np.float32)

    s = dict(
        radiance=f(4), random=rng.uniform(size=shape + (4,)).astype(np.float32),
        visible_position=f(4), visible_normal=f(3),
        visible_instance=rng.integers(-1, 9, shape).astype(np.int32),
        sample_position=f(4), sample_normal=f(3),
    )
    r = dict(count=rng.integers(0, 900, shape).astype(np.float32), lifetime=f(), w=f(),
             w_sum=f(), w2_sum=f())
    return s, r


def test_compress_reservoir_roundtrip_bitwise():
    """f32 -> f16 rounds to nearest-even in torch as in XLA: the packed
    fields and their f32 round trip are bitwise equal."""
    from hikari_tpu.render import restir as jr
    from hikari_tpu_torch.render import restir as tr

    s, r = _random_reservoir_fields((6, 7), np.random.default_rng(3))
    jres = jr.Reservoir(s=jr.Sample(**{k: jnp.asarray(v) for k, v in s.items()}),
                        **{k: jnp.asarray(v) for k, v in r.items()})
    tres = tr.Reservoir(s=tr.Sample(**{k: torch.from_numpy(v) for k, v in s.items()}),
                        **{k: torch.from_numpy(v) for k, v in r.items()})
    jc, tc = jr.compress_reservoir(jres), tr.compress_reservoir(tres)
    jd, td = jr.decompress_reservoir(jc), tr.decompress_reservoir(tc)
    for jx, tx in ((jc, tc), (jd, td)):
        for k in s:
            a, b = np.asarray(getattr(jx.s, k)), getattr(tx.s, k).numpy()
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=k)
        for k in r:
            a, b = np.asarray(getattr(jx, k)), getattr(tx, k).numpy()
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=k)


@pytest.mark.parametrize("fn", ["normal_basis", "luminance", "safe_normalize", "clip_to_uv"])
def test_vector_math_matches(fn):
    """Tolerance 2e-6 relative: XLA's CPU compiler contracts multiply-adds
    into FMAs; torch's CPU kernels round every operation."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(257, 4 if fn == "clip_to_uv" else 3)).astype(np.float32)
    if fn == "normal_basis":
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    want = np.asarray(jax.jit(getattr(ju, fn))(jnp.asarray(x)))
    got = getattr(tu, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-7)


def test_dot3_ordered_is_the_cpu_sum():
    """``dot3_ordered`` (summed left to right in separate operations, so
    the card gives the same bits) equals ``dot3``'s CPU ``sum(-1)`` bit for
    bit and JAX's dot within the FMA tolerance above."""
    rng = np.random.default_rng(8)
    a, b = (rng.normal(size=(4099, 3)).astype(np.float32) for _ in range(2))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(tu.dot3_ordered(ta, tb), tu.dot3(ta, tb))
    want = np.asarray(ju.dot3(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(tu.dot3_ordered(ta, tb).numpy(), want, rtol=2e-6, atol=2e-6)


def test_basis_apply_matches_einsum():
    rng = np.random.default_rng(6)
    n = rng.normal(size=(64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    local = rng.normal(size=(64, 3)).astype(np.float32)
    want = np.einsum("...ij,...j->...i", np.asarray(ju.normal_basis(jnp.asarray(n))), local)
    got = tu.basis_apply(tu.normal_basis(torch.from_numpy(n)), torch.from_numpy(local)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gradient_firewalls_match_jax():
    """clip_gradient and stable_div: identity / division forward, and the
    JAX package's clipped, scrubbed, reassociated backward (tolerance
    1e-6 relative)."""
    from hikari_tpu import diff as jd
    from hikari_tpu_torch import diff as td

    a = np.array([1.0, -2.0, 3e-7, 5.0], np.float32)
    b = np.array([2.0, 1e-30, 4e-9, 0.5], np.float32)
    g = np.array([1e5, -1e5, np.nan, 2.0], np.float32)

    def jf(x, y):
        return jd.clip_gradient(jd.stable_div(x, y), 1e3)

    _, vjp = jax.vjp(jf, jnp.asarray(a), jnp.asarray(b))
    ja, jb = (np.asarray(v) for v in vjp(jnp.asarray(g)))

    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = td.clip_gradient(td.stable_div(ta, tb), 1e3)
    np.testing.assert_array_equal(out.detach().numpy(), a / b)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ta.grad.numpy(), ja, rtol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), jb, rtol=1e-6)


def test_import_leaves_jax_out():
    """``import hikari_tpu_torch`` (and its whole frame path) must not
    load jax or hikari_tpu."""
    code = (
        "import sys, hikari_tpu_torch, hikari_tpu_torch.render.pipeline, "
        "hikari_tpu_torch.io.scenes, hikari_tpu_torch.trace.closest_hit; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'hikari_tpu' or m.startswith('hikari_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_tf32_off():
    import hikari_tpu_torch  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_grid_and_gather_helpers_match():
    """uv_grid and gather_pixels/gather_channels exact; safe_sqrt0 within
    2e-6 relative (XLA's approximate sqrt)."""
    np.testing.assert_array_equal(tu.uv_grid((5, 7)).numpy(), np.asarray(ju.uv_grid((5, 7))))
    rng = np.random.default_rng(8)
    x = rng.normal(size=300).astype(np.float32)
    np.testing.assert_allclose(tu.safe_sqrt0(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.jit(ju.safe_sqrt0)(x)), rtol=2e-6)
    img = rng.normal(size=(6, 9, 3)).astype(np.float32)
    y, xx = rng.integers(0, 6, (4, 5)), rng.integers(0, 9, (4, 5))
    np.testing.assert_array_equal(
        tu.gather_pixels(torch.from_numpy(img), torch.from_numpy(y), torch.from_numpy(xx)).numpy(),
        np.asarray(ju.gather_pixels(jnp.asarray(img), jnp.asarray(y), jnp.asarray(xx))))
    table = img.reshape(-1, 3)
    idx = rng.integers(0, len(table), (3, 4))
    np.testing.assert_array_equal(tu.gather_channels(torch.from_numpy(table), torch.from_numpy(idx)).numpy(),
                                  np.asarray(ju.gather_channels(jnp.asarray(table), jnp.asarray(idx))))


def test_take_rows_matches_indexing():
    """take_rows is table[idx], forward bit for bit; its gradient (an
    index_add) equals advanced indexing's (an accumulating index_put) on a
    small table read many times over, as a material table is."""
    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.normal(size=(4, 11)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 4, (40, 30)))
    cot = torch.from_numpy(rng.normal(size=(40, 30, 11)).astype(np.float32))
    grads = []
    for take in (tu.take_rows, lambda t, i: t[i]):
        t = table.clone().requires_grad_(True)
        out = take(t, idx)
        grads.append(torch.autograd.grad(out, t, cot)[0])
        assert out.shape == (40, 30, 11)
    assert torch.equal(tu.take_rows(table, idx), table[idx])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


def _sane_reservoir(pkg_restir, seed, array):
    """A reservoir grid with plausible values (unit normals, positions in
    the box, positive weights) as ``array`` tensors of one package."""
    rng = np.random.default_rng(seed)
    shape = (9, 11)

    def unit():
        v = rng.normal(size=shape + (3,)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    def pos(w):
        p = rng.uniform(-2, 2, shape + (4,)).astype(np.float32)
        p[..., 3] = w
        return p

    s = dict(
        radiance=rng.uniform(0, 3, shape + (4,)).astype(np.float32),
        random=rng.uniform(size=shape + (4,)).astype(np.float32),
        visible_position=pos(rng.uniform(0.01, 0.1, shape)), visible_normal=unit(),
        visible_instance=rng.integers(-1, 3, shape).astype(np.int32),
        sample_position=pos(1.0), sample_normal=unit(),
    )
    r = dict(count=rng.integers(0, 60, shape).astype(np.float32),
             lifetime=rng.uniform(0, 9, shape).astype(np.float32),
             w=rng.uniform(0, 2, shape).astype(np.float32),
             w_sum=rng.uniform(0, 5, shape).astype(np.float32),
             w2_sum=rng.uniform(0, 9, shape).astype(np.float32))
    return pkg_restir.Reservoir(s=pkg_restir.Sample(**{k: array(v) for k, v in s.items()}),
                                **{k: array(v) for k, v in r.items()})


@pytest.mark.parametrize("op", ["merge", "temporal", "check_previous", "variance",
                                "jacobian", "inv_jacobian"])
def test_reservoir_ops_match(op):
    """Reservoir operations on random grids: selections equal, floats
    within 1e-5 relative (XLA's CPU compiler fuses FMAs)."""
    from hikari_tpu.render import restir as jr
    from hikari_tpu_torch.render import restir as tr

    ja, jb = (_sane_reservoir(jr, s, jnp.asarray) for s in (1, 2))
    ta, tb = (_sane_reservoir(tr, s, torch.from_numpy) for s in (1, 2))
    p = np.random.default_rng(3).uniform(0.1, 2, (9, 11)).astype(np.float32)
    mask = np.random.default_rng(4).uniform(size=(9, 11)) < 0.7

    def run(m, a, b, arr):
        if op == "merge":
            return m.merge_reservoir(a, b, arr(p), mask=arr(mask))
        if op == "temporal":
            return m.temporal_restir(a, b.s, arr(p), 20, mask=arr(mask))
        if op == "check_previous":
            return m.check_previous_reservoir(a, b.s)
        if op == "variance":
            return m.reservoir_variance(a, 10.0)
        if op == "jacobian":
            return m.compute_jacobian(a.s, b.s)
        return m.compute_inv_jacobian(a.s, b.s)

    want = jax.jit(lambda a, b: run(jr, a, b, jnp.asarray))(ja, jb)
    got = run(tr, ta, tb, torch.from_numpy)
    jleaves = jax.tree_util.tree_leaves(want)
    tleaves = []
    tu.map_tensors(tleaves.append, got)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a)
