"""Checkpoint and resume of the renderer's cross-frame state — the port of
``hikari_tpu.io.checkpoint`` in the JAX package's numpy fallback format:
one ``.npz`` whose ``leaf_i`` arrays are the ``FrameState`` leaves in the
order of the JAX ``FrameState``'s ``tree_flatten`` (dataclass field order,
depth first; ``frame_number`` a 0-d int32). A file written here loads in
``hikari_tpu.io.checkpoint.load_state``, and a JAX-layout file loads here,
so state carries across the two packages. (The JAX package writes an
orbax directory instead where orbax is installed; that format is not
read here.)
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from hikari_tpu_torch.render.restir import Reservoir, Sample
from hikari_tpu_torch.render.types import FrameState, GBuffer
from hikari_tpu_torch.scene.buffers import frame_state_from_numpy

# The record type of each nested field, for rebuilding the tree.
_NESTED = {
    "prev_gbuffer": GBuffer,
    "direct_temporal": Reservoir,
    "emissive_temporal": Reservoir,
    "indirect_temporal": Reservoir,
    "de_spatial": Reservoir,
    "indirect_spatial": Reservoir,
    "s": Sample,
}


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def state_leaves(state: FrameState) -> list[np.ndarray]:
    """The state's leaves as numpy arrays, in the JAX ``tree_flatten``
    order."""
    leaves = []

    def walk(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name in _NESTED:
                walk(v)
            elif isinstance(v, torch.Tensor):
                leaves.append(v.detach().cpu().numpy())
            else:  # the host frame counter
                leaves.append(np.asarray(v, dtype=np.int32))

    walk(state)
    return leaves


def save_state(path: str, state: FrameState) -> None:
    """Save a FrameState as ``path`` (``.npz`` appended if missing)."""
    np.savez(_npz_path(path), **{f"leaf_{i}": x for i, x in enumerate(state_leaves(state))})


def state_from_leaves(leaves, device=None, source: str = "leaves") -> FrameState:
    """The FrameState whose ``state_leaves`` are ``leaves`` (numpy arrays
    in the JAX ``tree_flatten`` order), on ``device``."""
    pos = 0

    def build(cls):
        nonlocal pos
        out = {}
        for f in dataclasses.fields(cls):
            if f.name in _NESTED:
                out[f.name] = build(_NESTED[f.name])
            elif pos < len(leaves):
                out[f.name], pos = leaves[pos], pos + 1
            else:
                raise ValueError(f"{source}: fewer leaves than a FrameState has")
        return SimpleNamespace(**out)

    tree = build(FrameState)
    if pos != len(leaves):
        raise ValueError(f"{source}: more leaves than a FrameState has")
    return frame_state_from_numpy(tree, device)


def load_state(path: str, device=None) -> FrameState:
    """Restore a FrameState saved by ``save_state`` or by the JAX
    package's npz fallback, onto ``device`` (the CUDA card unless the
    caller names another); dtypes carry over unchanged."""
    data = np.load(_npz_path(path))
    return state_from_leaves([data[f"leaf_{i}"] for i in range(len(data.files))], device, path)
