"""Alias-table construction for area-weighted emissive triangle sampling.

Replaces the reference's ``GpuMesh::build_alias_table``
(src/mesh_material/mod.rs:330-376). Table semantics match the reference's
sampler (src/shaders/light.wgsl:661-664): draw bucket ``i`` uniformly, then
redirect to ``index[i]`` with probability ``prob[i]`` — the classic Walker
alias method with the reference's LIFO "pour" construction, so identical
inputs produce the identical table.
"""

from __future__ import annotations

import numpy as np


def build_alias_table(areas: np.ndarray, builder: str = "native") -> tuple[np.ndarray, np.ndarray]:
    """areas: (N,) -> (prob (N,) f32, index (N,) i32). ``builder``:
    "native" (the C++ pour of ``scene/native``) or "numpy"."""
    areas = np.asarray(areas, dtype=np.float32)
    if builder == "native":
        from hikari_bench.reference.scene import native

        return native.get_builder().build_alias_table(areas)
    if builder != "numpy":
        raise ValueError(f"unknown alias-table builder {builder!r}")
    return build_alias_table_numpy(areas)


def build_alias_table_numpy(areas: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    n = len(areas)
    prob = np.zeros(n, dtype=np.float32)
    index = np.arange(n, dtype=np.int32)
    total = float(np.sum(areas, dtype=np.float64))
    if n == 0 or total <= 0.0:
        return prob, index

    mean = total / n
    p = areas.astype(np.float64) / mean
    over = [(i, p[i]) for i in range(n) if p[i] > 1.0]
    under = [(i, p[i]) for i in range(n) if p[i] < 1.0]

    while under and over:
        oi, op = over.pop()
        ui, up = under.pop()
        delta = 1.0 - up
        op -= delta
        if op > 1.0:
            over.append((oi, op))
        elif op < 1.0:
            under.append((oi, op))
        prob[ui] = delta
        index[ui] = oi
    return prob, index


