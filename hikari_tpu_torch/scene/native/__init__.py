"""The C++ scene-compiler builder: binned-SAH BVH build and alias-table
pour (``bvh_builder.cpp``, a copy of the JAX package's), bound via ctypes.

The library is compiled at first use with ``g++`` into the gitignored
``hikari_tpu_torch/_build/``; its file name carries a hash of the source,
the flags and the host CPU, so an edit, a flag change or another CPU
builds a new one. A failed build raises: the caller asked for this
builder, and the triangle order of a compiled scene follows the builder,
so nothing switches to the numpy builder in silence.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
# The JAX package's flags. -march=native lets g++ contract multiply-adds
# into FMAs where the host has them, which moves some SAH splits (and so
# the triangle order): the same flags keep the two builders' trees equal.
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_builder = None
# Seconds the first ``get_builder`` call spent compiling and loading.
build_seconds = 0.0


def _host_cpu() -> str:
    """What -march=native compiles for: the CPU's feature flags where
    Linux lists them, else the machine type."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.machine()


def _library_path() -> Path:
    # The host CPU is part of the key: a library built for another CPU's
    # instruction set may not run here.
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode() + _host_cpu().encode()
    ).hexdigest()
    return BUILD_DIR / f"libbvh_builder_{key[:16]}.so"


class Builder:
    """ctypes front of the library: ``build`` (a ``FlatBvh``) and
    ``build_alias_table`` (prob, index), the numpy builders' contracts, and
    ``build_many`` (many ``build``s in one call)."""

    def __init__(self, lib: ctypes.CDLL):
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        lib.hikari_bvh_build.restype = ctypes.c_int64
        lib.hikari_bvh_build.argtypes = [fp, fp, ctypes.c_int64, fp, fp, ip, ip]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.hikari_bvh_build_many.restype = ctypes.c_int64
        lib.hikari_bvh_build_many.argtypes = [fp, fp, i64p, ctypes.c_int64, fp, fp, ip, ip]
        lib.hikari_alias_table_build.restype = None
        lib.hikari_alias_table_build.argtypes = [fp, ctypes.c_int64, fp, ip]
        self._lib = lib

    def build(self, mins: np.ndarray, maxs: np.ndarray):
        from hikari_tpu_torch.scene.bvh import FlatBvh

        mins = np.ascontiguousarray(mins, dtype=np.float32).reshape(-1, 3)
        maxs = np.ascontiguousarray(maxs, dtype=np.float32).reshape(-1, 3)
        n = len(mins)
        if n == 0:
            return FlatBvh.empty()
        max_nodes = 2 * n - 1
        node_mins = np.empty((max_nodes, 3), dtype=np.float32)
        node_maxs = np.empty((max_nodes, 3), dtype=np.float32)
        entry = np.empty(max_nodes, dtype=np.int32)
        exit_ = np.empty(max_nodes, dtype=np.int32)
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        count = int(self._lib.hikari_bvh_build(
            mins.ctypes.data_as(fp), maxs.ctypes.data_as(fp), n,
            node_mins.ctypes.data_as(fp), node_maxs.ctypes.data_as(fp),
            entry.ctypes.data_as(ip), exit_.ctypes.data_as(ip),
        ))
        return FlatBvh(
            node_mins[:count].copy(), node_maxs[:count].copy(), entry[:count].copy(),
            exit_[:count].copy(), np.full(count, -1, dtype=np.int32),
        )

    def build_many(self, mins: np.ndarray, maxs: np.ndarray, counts: np.ndarray):
        """One BVH per set of ``counts`` consecutive prims, each as ``build``
        gives it alone, in one call: (mins, maxs, entry, exit) of every
        set's nodes one after another (entries local to the set) and each
        set's node count (2n - 1, or 0 for an empty set)."""
        mins = np.ascontiguousarray(mins, dtype=np.float32).reshape(-1, 3)
        maxs = np.ascontiguousarray(maxs, dtype=np.float32).reshape(-1, 3)
        counts = np.asarray(counts, dtype=np.int64)
        offsets = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        if offsets[-1] != len(mins):
            raise ValueError(f"build_many: counts sum to {offsets[-1]}, not {len(mins)} prims")
        nodes = np.where(counts > 0, 2 * counts - 1, 0)
        total = int(nodes.sum())
        node_mins = np.empty((total, 3), dtype=np.float32)
        node_maxs = np.empty((total, 3), dtype=np.float32)
        entry = np.empty(total, dtype=np.int32)
        exit_ = np.empty(total, dtype=np.int32)
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        count = int(self._lib.hikari_bvh_build_many(
            mins.ctypes.data_as(fp), maxs.ctypes.data_as(fp),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(counts),
            node_mins.ctypes.data_as(fp), node_maxs.ctypes.data_as(fp),
            entry.ctypes.data_as(ip), exit_.ctypes.data_as(ip),
        ))
        if count != total:
            raise RuntimeError(f"build_many: {count} nodes, {total} expected")
        return node_mins, node_maxs, entry, exit_, nodes

    def build_alias_table(self, areas: np.ndarray):
        areas = np.ascontiguousarray(areas, dtype=np.float32)
        n = len(areas)
        prob = np.zeros(n, dtype=np.float32)
        index = np.arange(n, dtype=np.int32)
        if n:
            self._lib.hikari_alias_table_build(
                areas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
                prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                index.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        return prob, index


def get_builder() -> Builder:
    """The loaded builder, compiling it first if needed. Raises
    RuntimeError if g++ is missing or the build fails."""
    global _builder, build_seconds
    if _builder is not None:
        return _builder
    with _lock:
        if _builder is None:
            start = time.perf_counter()
            path = _library_path()
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
                try:
                    proc = subprocess.run(
                        ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                        capture_output=True, text=True, timeout=300,
                    )
                except (OSError, subprocess.SubprocessError) as e:
                    raise RuntimeError(f"g++ could not build {SOURCE.name}: {e}") from e
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"g++ failed building {SOURCE.name}:\n{proc.stdout}{proc.stderr}"
                    )
                os.replace(tmp, path)
            _builder = Builder(ctypes.CDLL(str(path)))
            build_seconds = time.perf_counter() - start
    return _builder
