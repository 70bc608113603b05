"""Closest-hit search: the hand-written CUDA kernel
(``csrc/closest_hit.cu``), its wrapper and its plain PyTorch twin.

Port of ``hikari_tpu/trace/pallas_kernel.py`` (K1 ``_kernel_resident`` and
K1b ``_kernel_streamed``). ``closest_hit`` launches the kernel for CUDA
tensors and runs the twin ``closest_hit_reference`` only for CPU tensors;
on a CUDA tensor it launches or raises, it never falls back.

Tie rule (kernel and twin): among pairs with equal t the lowest prim id
wins — the JAX brute-force path's rule (see the note in the kernel source).

The kernel is built at first use from the repo's source with ``nvcc``
into ``hikari_tpu_torch/_build/`` and bound through ctypes
(``utils/nvcc.py``).
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path

import torch

from hikari_tpu_torch.config import F32_EPSILON, F32_MAX
from hikari_tpu_torch.utils.nvcc import build_library, check_kernel_arg

# Kernel launches made by ``closest_hit`` (one per call on CUDA tensors).
launches = 0

PACK_WIDTH = 16
# Pairs per chunk of the twin: bounds its (rays x triangles) temporaries.
RAY_CHUNK_PAIRS = 1 << 22

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "closest_hit.cu"

_lib = None
# ptxas report of the last build (registers, shared memory, spills).
build_log = ""


def pack_triangles(scene, count: int | None = None) -> torch.Tensor:
    """(count, 16) float32 rows: n(3) eu(3) ev(3) cn cu cv valid
    inst(int32 bits) pad(2) — one 64-byte row per triangle, the layout of
    ``hikari_tpu.trace.pallas_kernel.pack_triangles`` with the instance id
    kept as integer bits. ``count`` defaults to ``num_tris``: padding rows
    past it are dropped."""
    P = int(scene.num_tris if count is None else count)
    inst = scene.tri_inst[:P].to(torch.int32).contiguous().view(torch.float32)
    return torch.cat(
        [
            scene.tri_n[:P],
            scene.tri_eu[:P],
            scene.tri_ev[:P],
            scene.tri_cn[:P, None],
            scene.tri_cu[:P, None],
            scene.tri_cv[:P, None],
            scene.tri_valid[:P, None].to(torch.float32),
            inst[:, None],
            torch.zeros((P, 2), dtype=torch.float32, device=scene.tri_n.device),
        ],
        dim=1,
    ).contiguous()


def closest_hit_reference(o, d, maxd, excl, lo, hi, packed):
    """Plain PyTorch twin of the kernel, with its exact contract and
    operation order: o, d (R,3) f32; maxd (R,) f32; excl, lo, hi (R,) i32;
    packed (P,16) from ``pack_triangles``. Returns (t, prim i32, u, v),
    each (R,). Chunked over rays so the (rays x triangles) intermediates
    stay under ``RAY_CHUNK_PAIRS`` elements."""
    R, P = o.shape[0], packed.shape[0]
    dev = o.device
    init_t = torch.clamp(maxd, max=F32_MAX)
    t_out = init_t.clone()
    prim_out = torch.full((R,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((R,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((R,), dtype=torch.float32, device=dev)
    if R == 0 or P == 0:
        return t_out, prim_out, u_out, v_out

    col = [packed[:, k][None, :] for k in range(12)]
    nx, ny, nz, eux, euy, euz, evx, evy, evz, cn, cu, cv = col
    valid = (packed[:, 12] > 0.5)[None, :]
    inst = packed[:, 13].contiguous().view(torch.int32)[None, :]
    prim_ids = torch.arange(P, dtype=torch.int32, device=dev)[None, :]

    chunk = max(1, RAY_CHUNK_PAIRS // P)
    for s in range(0, R, chunk):
        e = min(R, s + chunk)
        ox, oy, oz = (o[s:e, k : k + 1] for k in range(3))
        dx, dy, dz = (d[s:e, k : k + 1] for k in range(3))
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
        ok = (
            valid
            & (dn.abs() >= F32_EPSILON)
            & (t > F32_EPSILON)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t < maxd[s:e, None])
            & (inst != excl[s:e, None])
            & (prim_ids >= lo[s:e, None])
            & (prim_ids < hi[s:e, None])
        )
        t = torch.where(ok, t, F32_MAX)
        j = torch.argmin(t, dim=1, keepdim=True)  # first minimum: lowest prim
        bt = t.gather(1, j)[:, 0]
        hit = bt < init_t[s:e]
        t_out[s:e] = torch.where(hit, bt, init_t[s:e])
        prim_out[s:e] = torch.where(hit, j[:, 0].to(torch.int32), -1)
        u_out[s:e] = torch.where(hit, u.gather(1, j)[:, 0], 0.0)
        v_out[s:e] = torch.where(hit, v.gather(1, j)[:, 0], 0.0)
    return t_out, prim_out, u_out, v_out


def build() -> float:
    """Compile (if needed) and load the kernel library; returns the
    seconds spent. Raises if nvcc is missing or the build fails."""
    global _lib, build_log
    if _lib is not None:
        return 0.0
    start = time.perf_counter()
    lib, build_log = build_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hikari_closest_hit.argtypes = [ptr] * 7 + [i32, i32] + [ptr] * 5
    lib.hikari_closest_hit.restype = i32
    lib.hikari_cuda_error_string.argtypes = [i32]
    lib.hikari_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return time.perf_counter() - start


def closest_hit(o, d, maxd, excl, lo, hi, packed):
    """Closest hit of every ray: (t, prim i32, u, v), each (R,). Same
    arguments as ``closest_hit_reference``. CPU tensors run the twin; CUDA
    tensors launch the kernel (one launch per call) or raise."""
    global launches
    if o.device.type == "cpu":
        return closest_hit_reference(o, d, maxd, excl, lo, hi, packed)
    if o.device.type != "cuda":
        raise NotImplementedError(f"closest_hit: no kernel for device {o.device}")
    R, P = o.shape[0], packed.shape[0]
    dev = o.device
    for name, x, dtype, shape in (
        ("o", o, torch.float32, (R, 3)),
        ("d", d, torch.float32, (R, 3)),
        ("maxd", maxd, torch.float32, (R,)),
        ("excl", excl, torch.int32, (R,)),
        ("lo", lo, torch.int32, (R,)),
        ("hi", hi, torch.int32, (R,)),
        ("packed", packed, torch.float32, (P, PACK_WIDTH)),
    ):
        check_kernel_arg("closest_hit", name, x, dtype, shape, dev)
    if packed.data_ptr() % 16:
        raise ValueError("closest_hit: packed must be 16-byte aligned")
    if R >= 2**31 or P >= 2**31 // PACK_WIDTH:
        raise ValueError("closest_hit: too many rays or triangles for int32 indexing")
    build()
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    prim = torch.empty((R,), dtype=torch.int32, device=dev)
    u = torch.empty((R,), dtype=torch.float32, device=dev)
    v = torch.empty((R,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib.hikari_closest_hit(
            o.data_ptr(), d.data_ptr(), maxd.data_ptr(), excl.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), packed.data_ptr(), P, R, t.data_ptr(), prim.data_ptr(),
            u.data_ptr(), v.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(
            f"closest_hit kernel launch failed: {_lib.hikari_cuda_error_string(err).decode()}"
        )
    if R:
        launches += 1
    return t, prim, u, v
