"""Closest-hit search: the hand-written CUDA kernel
(``csrc/closest_hit.cu``), its wrapper and its plain PyTorch twin.

Port of ``hikari_tpu/trace/pallas_kernel.py`` (K1 ``_kernel_resident`` and
K1b ``_kernel_streamed``). ``closest_hit`` launches the kernel for CUDA
tensors and runs the twin ``closest_hit_reference`` only for CPU tensors;
on a CUDA tensor it launches or raises, it never falls back.

Tie rule, the JAX kernel's. The twin keeps its structure: eight running
bests per ray, triangle ``p`` to best ``p mod 8`` (K1's sublanes), each
replaced only on a strict ``<``; then ``tie="pallas"`` halves them 8 -> 4
-> 2 -> 1 as ``pallas_kernel.py _reduce_sublanes`` does (among equal t the
sublanes win in the order 0, 4, 2, 6, 1, 5, 3, 7), and
``tie="bruteforce"`` takes the least t, then the lowest prim (the JAX
``_trace_bruteforce`` rule). The kernel keeps one best per ray with the
same winner: the least key (t, rank(p mod 8), p), rank the 3-bit reversal
of the sublane, or (t, p) under "bruteforce" (``csrc/closest_hit.cu``).

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

# Kernel launches made by ``closest_hit`` (one per call on CUDA tensors),
# and those of them whose table is larger than one of the TPU kernel's
# 2,048-triangle tiles (the regime of the streamed K1b).
launches = 0
streamed_launches = 0
TPU_TRI_TILE = 2048

PACK_WIDTH = 16
SUBLANES = 8  # the JAX kernel's per-sublane bests (tie rule)
TIE_RULES = ("pallas", "bruteforce")
# Pairs per chunk of the twin: bounds its (rays x triangles) temporaries.
RAY_CHUNK_PAIRS = 1 << 22

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "closest_hit.cu"

_lib = None
# ptxas report of the last build (registers, shared memory, spills).
build_log = ""


def pack_triangles(scene, count: int | None = None) -> torch.Tensor:
    """(count, 16) float32 rows: n(3) eu(3) ev(3) cn cu cv valid
    inst(int32 bits) prim(int32 bits) pad — one 64-byte row per triangle,
    the layout of ``hikari_tpu.trace.pallas_kernel.pack_triangles`` with
    the instance id kept as integer bits and the row's own prim id in the
    first pad word (the tile walk and the scatter kernel read it, so their
    rows may come in any order). ``count`` defaults to ``num_tris``:
    padding rows past it are dropped."""
    P = int(scene.num_tris if count is None else count)
    dev = scene.tri_n.device
    inst = scene.tri_inst[:P].to(torch.int32).contiguous().view(torch.float32)
    prim = torch.arange(P, dtype=torch.int32, device=dev).view(torch.float32)
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
            prim[:, None],
            torch.zeros((P, 1), dtype=torch.float32, device=dev),
        ],
        dim=1,
    ).contiguous()


def reduce_sublanes(t8, p8, u8, v8, tie: str = "pallas"):
    """The final 8 -> 1 step over per-sublane bests (..., 8): ``"pallas"``
    halves 8 -> 4 -> 2 -> 1, taking the upper half only where it is
    strictly nearer (``pallas_kernel.py _reduce_sublanes``);
    ``"bruteforce"`` takes the least t, then the lowest prim, scanning the
    sublanes in order as the kernel does. Returns (t, prim, u, v) (...,)."""
    if tie == "pallas":
        h = SUBLANES // 2
        while h:
            better = t8[..., h : 2 * h] < t8[..., :h]
            t8, p8, u8, v8 = (
                torch.where(better, x[..., h : 2 * h], x[..., :h]) for x in (t8, p8, u8, v8)
            )
            h //= 2
        return t8[..., 0], p8[..., 0], u8[..., 0], v8[..., 0]
    if tie != "bruteforce":
        raise ValueError(f"unknown tie rule {tie!r}: one of {TIE_RULES}")
    t, p, u, v = t8[..., 0], p8[..., 0], u8[..., 0], v8[..., 0]
    for s in range(1, SUBLANES):
        ts, ps = t8[..., s], p8[..., s]
        better = (ts < t) | ((ts == t) & (ps < p))
        t, p = torch.where(better, ts, t), torch.where(better, ps, p)
        u, v = torch.where(better, u8[..., s], u), torch.where(better, v8[..., s], v)
    return t, p, u, v


def closest_hit_reference(o, d, maxd, excl, lo, hi, packed, tie: str = "pallas"):
    """Plain PyTorch twin of the kernel, with its exact contract, operation
    order and tie rule: o, d (R,3) f32; maxd (R,) f32; excl, lo, hi (R,)
    i32; packed (P,16) from ``pack_triangles``; ``tie`` "pallas" or
    "bruteforce" (module docstring). Returns (t, prim i32, u, v), each
    (R,). Chunked over rays so the (rays x triangles) intermediates stay
    under ``RAY_CHUNK_PAIRS`` elements."""
    if tie not in TIE_RULES:
        raise ValueError(f"unknown tie rule {tie!r}: one of {TIE_RULES}")
    R, P = o.shape[0], packed.shape[0]
    dev = o.device
    init_t = torch.clamp(maxd, max=F32_MAX)
    t_out = init_t.clone()
    prim_out = torch.full((R,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((R,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((R,), dtype=torch.float32, device=dev)
    if R == 0 or P == 0:
        return t_out, prim_out, u_out, v_out

    # Pad to whole sublane rows with invalid triangles: prim p is column
    # p mod 8 of row p // 8.
    P8 = -(-P // SUBLANES) * SUBLANES
    if P8 != P:
        packed = torch.cat([packed, packed.new_zeros((P8 - P, PACK_WIDTH))])
    col = [packed[:, k][None, :] for k in range(12)]
    nx, ny, nz, eux, euy, euz, evx, evy, evz, cn, cu, cv = col
    valid = (packed[:, 12] > 0.5)[None, :]
    inst = packed[:, 13].contiguous().view(torch.int32)[None, :]
    prim_ids = torch.arange(P8, dtype=torch.int32, device=dev)[None, :]

    chunk = max(1, RAY_CHUNK_PAIRS // P8)
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
        n = e - s
        shape8 = (n, P8 // SUBLANES, SUBLANES)
        tm = torch.where(ok, t, F32_MAX).reshape(shape8)
        j = torch.argmin(tm, dim=1, keepdim=True)  # first minimum: the sublane's lowest prim
        bt = tm.gather(1, j)[:, 0]
        init8 = init_t[s:e, None].expand(n, SUBLANES)
        hit = bt < init8
        t8 = torch.where(hit, bt, init8)
        p8 = torch.where(hit, prim_ids.expand(n, P8).reshape(shape8).gather(1, j)[:, 0], -1)
        u8 = torch.where(hit, u.reshape(shape8).gather(1, j)[:, 0], 0.0)
        v8 = torch.where(hit, v.reshape(shape8).gather(1, j)[:, 0], 0.0)
        t_out[s:e], prim_out[s:e], u_out[s:e], v_out[s:e] = reduce_sublanes(t8, p8, u8, v8, tie)
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
    lib.hikari_closest_hit.argtypes = [ptr] * 7 + [i32] * 3 + [ptr] * 5
    lib.hikari_closest_hit.restype = i32
    lib.hikari_closest_hit_warps_per_sm.argtypes = [i32]
    lib.hikari_closest_hit_warps_per_sm.restype = i32
    lib.hikari_cuda_error_string.argtypes = [i32]
    lib.hikari_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return time.perf_counter() - start


def warps_per_sm(num_tris: int) -> int:
    """Resident warps per SM of the kernel's launch for this many triangles
    on the current card (the CUDA occupancy query)."""
    build()
    n = _lib.hikari_closest_hit_warps_per_sm(num_tris)
    if n < 0:
        raise RuntimeError("closest_hit: the card's occupancy query failed")
    return n


def closest_hit(o, d, maxd, excl, lo, hi, packed, tie: str = "pallas"):
    """Closest hit of every ray: (t, prim i32, u, v), each (R,). Same
    arguments as ``closest_hit_reference``. CPU tensors run the twin; CUDA
    tensors launch the kernel (one launch per call) or raise."""
    global launches, streamed_launches
    if tie not in TIE_RULES:
        raise ValueError(f"unknown tie rule {tie!r}: one of {TIE_RULES}")
    if o.device.type == "cpu":
        return closest_hit_reference(o, d, maxd, excl, lo, hi, packed, tie)
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
            hi.data_ptr(), packed.data_ptr(), P, R, int(tie == "bruteforce"), t.data_ptr(),
            prim.data_ptr(),
            u.data_ptr(), v.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(
            f"closest_hit kernel launch failed: {_lib.hikari_cuda_error_string(err).decode()}"
        )
    if R:
        launches += 1
        streamed_launches += int(P > TPU_TRI_TILE)
    return t, prim, u, v
