"""Build a CUDA source of ``hikari_tpu_torch/csrc`` with ``nvcc`` into a
shared library with a plain C interface, loaded with ctypes (a plain C
interface builds in seconds; a PyTorch extension takes minutes).

The library goes into the gitignored ``hikari_tpu_torch/_build/``; its
name carries a hash of the source, the headers beside it and the flags,
so an edit or a flag change builds a new one. Every kernel is compiled
for Hopper (sm_90a) without multiply-add contraction, so it can match its
plain twin bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]


def library_path(source: Path) -> Path:
    """The library's path: its name carries a hash of the source, the
    headers beside it (``*.cuh``, which a source may include) and the flags."""
    headers = sorted(source.parent.glob("*.cuh"))
    text = source.read_bytes() + b"".join(h.read_bytes() for h in headers)
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{key[:16]}.so"


def build_library(source: Path) -> tuple[ctypes.CDLL, str]:
    """Compile ``source`` if its library is not built yet, and load it.
    Returns (library, compiler output: ptxas registers, shared memory and
    spills; "" when the library was already built). Raises if nvcc is
    missing or the build fails."""
    path = library_path(source)
    log = ""
    if not path.exists():
        from torch.utils.cpp_extension import CUDA_HOME

        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
        if nvcc is None or not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: {source.name} needs the CUDA toolkit")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)], capture_output=True, text=True
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {source.name}:\n{log}")
        os.replace(tmp, path)
    return ctypes.CDLL(str(path)), log


def ptxas_summary(log: str) -> str:
    """The ptxas lines of a build log that give registers, shared memory
    and spills, joined on one line."""
    return " | ".join(ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln)


def check_kernel_arg(kernel: str, name: str, x, dtype, shape, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's C interface takes."""
    if x.device != device:
        raise ValueError(f"{kernel}: {name} is on {x.device}, the other inputs on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
