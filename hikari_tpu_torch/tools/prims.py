"""The primitives of ``tools/bench_pallas_prims.py`` as hand-written CUDA
kernels, their wrappers and their plain PyTorch twins:

* ``window_pack`` (``csrc/window_pack.cu``) — T1, the fused window-table
  pack (``pack_kernel_v2``/``pallas_pack_v2``); twin
  ``window_pack_reference``, ``pack_rows`` of the edge-padded column
  slices (the tool's ``xla_pack``);
* ``take_along_sum`` (``csrc/take_along.cu``) — T2 (``make_g``, one
  ``take_along_axis``) and T3 (``make_vreg_g``, ``reps`` of them summed);
  twin ``take_along_sum_reference``.

Each wrapper runs its twin for CPU tensors only; on a CUDA tensor it
launches its kernel (one launch per call, counted) or raises. The kernels
are built at first use from the repo's sources with ``nvcc`` into
``hikari_tpu_torch/_build/`` and bound through ctypes
(``utils/nvcc.py``).
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path

import torch

from hikari_tpu_torch.render.filters import pack_rows
from hikari_tpu_torch.utils.nvcc import build_library, check_kernel_arg

# Kernel launches made by ``window_pack`` and ``take_along_sum`` (one per
# call on CUDA tensors).
window_pack_launches = 0
take_along_launches = 0

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"window_pack": CSRC / "window_pack.cu", "take_along": CSRC / "take_along.cu"}
TAKE_MODES = (None, "clip", "fill")
# The kernel's dynamic shared memory without an opt-in (window_pack.cu).
_SHARED_BYTES = 48 * 1024
_RUN = 128  # image columns per block of window_pack.cu

_libs: dict = {}
# ptxas reports of the last builds (registers, shared memory, spills).
build_logs = {"window_pack": "", "take_along": ""}


def build(name: str) -> float:
    """Compile (if needed) and load one kernel library ("window_pack" or
    "take_along"); returns the seconds spent. Raises if nvcc is missing or
    the build fails."""
    if name in _libs:
        return 0.0
    start = time.perf_counter()
    lib, build_logs[name] = build_library(SOURCES[name])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"hikari_{name}")
    if name == "window_pack":
        fn.argtypes = [ptr, ptr] + [i32] * 5 + [ptr, ptr]
    else:
        fn.argtypes = [ptr, ptr] + [i32] * 7 + [ptr, ptr]
        lib.hikari_take_along_empty.argtypes = [i32, i32, ptr]
        lib.hikari_take_along_empty.restype = i32
    fn.restype = i32
    err = getattr(lib, f"hikari_{name}_error_string")
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p
    _libs[name] = lib
    return time.perf_counter() - start


def _launch(name: str, *args, entry: str | None = None) -> None:
    """Call the library's ``hikari_{entry or name}`` and raise on an error."""
    lib = _libs[name]
    err = getattr(lib, f"hikari_{entry or name}")(*args)
    if err:
        msg = getattr(lib, f"hikari_{name}_error_string")(err).decode()
        raise RuntimeError(f"{entry or name} kernel launch failed: {msg}")


def _check_dxs(dxs) -> list[int]:
    dxs = [int(dx) for dx in dxs]
    if not dxs or min(dxs) < 0:
        raise ValueError(f"window_pack: taps must be a non-empty list of dx >= 0, got {dxs}")
    return dxs


def window_pack_reference(planes, dxs):
    """Plain twin: ``pack_rows`` of every plane's edge-padded column
    slices, plane-major then tap — the tool's ``xla_pack``. planes (C, H,
    W) f32, dxs D ints >= 0. Returns (H*W, C*D) f32 with
    ``out[y*W + x, c*D + j] = planes[c, y, min(x + dxs[j], W - 1)]``."""
    dxs = _check_dxs(dxs)
    _, H, W = planes.shape
    pad = max(dxs)
    parts = []
    for p in planes:
        padded = torch.cat([p, p[:, -1:].expand(H, pad)], dim=1)
        parts.extend(padded[:, dx : dx + W] for dx in dxs)
    return pack_rows(parts)


def window_pack(planes, dxs):
    """The window table of ``window_pack_reference``. CPU tensors run the
    twin; CUDA tensors launch ``csrc/window_pack.cu`` (one launch per call)
    or raise. C*D must be a multiple of 4 on the card (16-byte stores)."""
    global window_pack_launches
    dxs = _check_dxs(dxs)
    if planes.dim() != 3:
        raise ValueError(f"window_pack: planes must be (C, H, W), got {tuple(planes.shape)}")
    C, H, W = planes.shape
    check_kernel_arg("window_pack", "planes", planes, torch.float32, (C, H, W), planes.device)
    if planes.device.type == "cpu":
        return window_pack_reference(planes, dxs)
    if planes.device.type != "cuda":
        raise NotImplementedError(f"window_pack: no kernel for device {planes.device}")
    D, halo = len(dxs), max(dxs)
    if (C * D) % 4:
        raise ValueError(f"window_pack: C*D = {C * D} must be a multiple of 4")
    if H >= 65536 or H * W * C * D >= 2**31:
        raise ValueError("window_pack: image too large for the kernel's grid and indexing")
    if C * (_RUN + halo) * 4 + D * 4 > _SHARED_BYTES:
        raise ValueError(f"window_pack: {C} planes with a halo of {halo} need too much shared "
                         "memory")
    build("window_pack")
    taps = torch.tensor(dxs, dtype=torch.int32, device=planes.device)
    out = torch.empty((H * W, C * D), dtype=torch.float32, device=planes.device)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        _launch("window_pack", planes.data_ptr(), taps.data_ptr(), C, H, W, D, halo,
                out.data_ptr(), stream)
    window_pack_launches += 1
    return out


def _take_index(idx, n: int, mode):
    """(index, valid) under ``jnp.take_along_axis``'s rule for an axis of
    length n: a negative index gains n once; "clip" clamps into [0, n-1];
    None/"fill" mark the rest invalid (read as NaN)."""
    g = torch.where(idx < 0, idx + n, idx)
    if mode == "clip":
        return g.clamp(0, n - 1), None
    valid = (g >= 0) & (g < n)
    return torch.where(valid, g, 0), valid


def _check_take(x, idx, axis: int, reps: int, mode) -> None:
    if mode not in TAKE_MODES:
        raise ValueError(f"take_along_sum: mode must be one of {TAKE_MODES}, got {mode!r}")
    if axis not in (0, 1) or x.dim() != 2 or idx.dim() != 2:
        raise ValueError("take_along_sum: x and idx must be 2-D and axis 0 or 1")
    if idx.shape[1 - axis] != x.shape[1 - axis]:
        raise ValueError(f"take_along_sum: idx {tuple(idx.shape)} and x {tuple(x.shape)} "
                         f"differ off axis {axis}")
    if reps < 0:
        raise ValueError(f"take_along_sum: reps must be >= 0, got {reps}")


def take_along_sum_reference(x, idx, axis: int, reps: int = 1, mode=None):
    """Plain twin: ``sum over r < reps of take_along_axis(x + r, idx,
    axis, mode)``, summed from 0 in r order. x (M, N) f32, idx (OM, ON) i32
    equal to x off ``axis``. With reps = 1 this is the plain gather (T2)
    except that -0.0 reads +0.0."""
    _check_take(x, idx, axis, reps, mode)
    g, valid = _take_index(idx.to(torch.int64), x.shape[axis], mode)
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=x.device)
    for r in range(reps):
        got = torch.take_along_dim(x + r, g, dim=axis)
        if valid is not None:
            got = torch.where(valid, got, float("nan"))
        acc = acc + got
    return acc


def take_along_sum(x, idx, axis: int, reps: int = 1, mode=None):
    """``take_along_sum_reference``'s result. CPU tensors run the twin;
    CUDA tensors launch ``csrc/take_along.cu`` (one launch per call) or
    raise."""
    global take_along_launches
    _check_take(x, idx, axis, reps, mode)
    M, N = x.shape
    OM, ON = idx.shape
    check_kernel_arg("take_along_sum", "x", x, torch.float32, (M, N), x.device)
    check_kernel_arg("take_along_sum", "idx", idx, torch.int32, (OM, ON), x.device)
    if x.device.type == "cpu":
        return take_along_sum_reference(x, idx, axis, reps, mode)
    if x.device.type != "cuda":
        raise NotImplementedError(f"take_along_sum: no kernel for device {x.device}")
    if M * N >= 2**31 or OM * ON >= 2**31:
        raise ValueError("take_along_sum: too many elements for int32 indexing")
    build("take_along")
    out = torch.empty((OM, ON), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch("take_along", x.data_ptr(), idx.data_ptr(), M, N, OM, ON, axis, reps,
                int(mode == "clip"), out.data_ptr(), stream)
    take_along_launches += 1
    return out


def take_along_empty(shape, device) -> None:
    """Launch an empty kernel with the grid and block that ``take_along_sum``
    takes for an output of ``shape`` on the card: its device time is the
    gathers' launch floor. Not counted as a gather launch."""
    build("take_along")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch("take_along", *map(int, shape), stream, entry="take_along_empty")
