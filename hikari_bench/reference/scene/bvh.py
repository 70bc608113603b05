"""SAH BVH build + stackless entry/exit flattening (host side, numpy).

Host-side replacement for the reference's use of the Rust ``bvh = 0.7.1``
crate (Cargo.toml:21): ``BVH::build`` + ``flatten_custom(&GpuNode::pack)``
producing stackless arrays with entry/exit indices and a leaf flag
(reference src/mesh_material/mod.rs:185-201, :458-459;
traversal consuming them: src/shaders/light.wgsl:400-486).

Differences from the reference representation:
  * SoA numpy arrays (mins, maxs, entry, exit, inst) instead of an AoS
    ``GpuNode`` struct;
  * leaves encode the primitive as ``entry = -(prim + 1)`` (negative int32)
    instead of ``prim | 0x80000000`` — int32-friendly, no unsigned bit games;
  * nodes carry an extra ``inst`` field used by the stitched world-space
    scene graph (scene/compile.py) to tag TLAS "portal" nodes with their
    instance id (-1 elsewhere) so shadow rays can exclude an instance
    (reference does this at the TLAS leaf, light.wgsl:459).

Traversal contract (identical control flow to light.wgsl:400-440):

    index = start
    while index != end:
        if entry[index] < 0:              # leaf
            prim = -entry[index] - 1      # intersect primitive
            index = exit[index]
        elif ray hits aabb[index]:
            index = entry[index]          # descend
        else:
            index = exit[index]           # skip subtree

Two builders run the same algorithm: the C++ one (``scene/native``, the
default, as in the JAX package wherever its toolchain builds) and the numpy
one here. Their leaf orders can differ, and a compiled scene's triangle
order follows the BVH, so the caller names the builder.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SAH_BINS = 16
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


@dataclass
class FlatBvh:
    """Stackless BVH arrays. ``exit == len(nodes)`` means "leave the tree"
    until re-wired by stitching."""

    mins: np.ndarray  # (N, 3) f32
    maxs: np.ndarray  # (N, 3) f32
    entry: np.ndarray  # (N,) i32; leaf = -(prim+1)
    exit: np.ndarray  # (N,) i32
    inst: np.ndarray  # (N,) i32; instance id on portal nodes, else -1

    @property
    def count(self) -> int:
        return len(self.entry)

    @staticmethod
    def empty() -> "FlatBvh":
        z3 = np.zeros((0, 3), dtype=np.float32)
        zi = np.zeros((0,), dtype=np.int32)
        return FlatBvh(z3, z3.copy(), zi, zi.copy(), zi.copy())


BUILDERS = ("native", "numpy")


def build_flat_bvh(mins: np.ndarray, maxs: np.ndarray, builder: str = "native") -> FlatBvh:
    """Build a binned-SAH binary BVH over primitive AABBs and flatten it
    depth-first into entry/exit form. One primitive per leaf (matching the
    reference's bvh-crate leaves). ``builder``: "native" (C++, raises if
    g++ cannot build it) or "numpy"."""
    if builder == "native":
        from hikari_bench.reference.scene import native

        return native.get_builder().build(mins, maxs)
    if builder != "numpy":
        raise ValueError(f"unknown BVH builder {builder!r}; expected one of {BUILDERS}")
    return build_flat_bvh_numpy(mins, maxs)


def build_flat_bvh_numpy(mins: np.ndarray, maxs: np.ndarray) -> FlatBvh:
    mins = np.asarray(mins, dtype=np.float32).reshape(-1, 3)
    maxs = np.asarray(maxs, dtype=np.float32).reshape(-1, 3)
    n = len(mins)
    if n == 0:
        return FlatBvh.empty()

    centroids = 0.5 * (mins + maxs)

    # Build tree: nodes as (prim_ids array or (left, right)).
    # Iterative DFS construction so deep meshes don't hit recursion limits.
    out_mins: list = []
    out_maxs: list = []
    out_entry: list = []
    out_exit: list = []

    def emit(prims: np.ndarray) -> None:
        """Recursively build + flatten the subtree over `prims`, appending
        nodes in DFS preorder. Exit indices use absolute positions; 'leave
        subtree' naturally becomes the node index after the subtree."""
        stack = [(prims, False)]
        # We need post-processing for exits: do classic recursive via explicit
        # stack holding (prims, phase). Simpler: recursive closure with
        # sys.setrecursionlimit handled by subdividing; use real recursion
        # through a helper operating on index ranges.
        del stack

        def rec(prim_ids: np.ndarray) -> None:
            node_idx = len(out_entry)
            lo = mins[prim_ids]
            hi = maxs[prim_ids]
            bb_min = lo.min(axis=0)
            bb_max = hi.max(axis=0)
            out_mins.append(bb_min)
            out_maxs.append(bb_max)

            if len(prim_ids) == 1:
                out_entry.append(-(int(prim_ids[0]) + 1))
                out_exit.append(0)  # fixed after
                return

            split = _sah_split(prim_ids, centroids, lo, hi, bb_min, bb_max)
            left_ids, right_ids = split
            out_entry.append(node_idx + 1)
            out_exit.append(0)  # fixed after
            rec(left_ids)
            rec(right_ids)
            out_exit[node_idx] = len(out_entry)

        rec(prims)
        # Fix leaf/internal exits: exit of a node = index just past its
        # subtree. For leaves that's node_idx + subtree(=1); internals were
        # set inside rec. Walk once more to fill leaf exits.
        # (Leaf exit = next DFS index = node_idx + 1.)
        for i in range(len(out_entry)):
            if out_entry[i] < 0:
                out_exit[i] = i + 1

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * n))
    try:
        emit(np.arange(n, dtype=np.int64))
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatBvh(
        mins=np.asarray(out_mins, dtype=np.float32),
        maxs=np.asarray(out_maxs, dtype=np.float32),
        entry=np.asarray(out_entry, dtype=np.int32),
        exit=np.asarray(out_exit, dtype=np.int32),
        inst=np.full(len(out_entry), -1, dtype=np.int32),
    )


def _sah_split(prim_ids, centroids, lo, hi, bb_min, bb_max):
    """Binned SAH split; falls back to median on degenerate extents."""
    c = centroids[prim_ids]
    ext = c.max(axis=0) - c.min(axis=0)
    axis = int(np.argmax(ext))
    if ext[axis] <= 1e-12:
        # All centroids coincide: split in half by index.
        half = len(prim_ids) // 2
        return prim_ids[:half], prim_ids[half:]

    cmin = c[:, axis].min()
    scale = SAH_BINS * (1.0 - 1e-6) / ext[axis]
    bins = np.minimum(((c[:, axis] - cmin) * scale).astype(np.int32), SAH_BINS - 1)

    # Per-bin bounds + counts.
    counts = np.bincount(bins, minlength=SAH_BINS)
    bin_min = np.full((SAH_BINS, 3), np.inf, dtype=np.float64)
    bin_max = np.full((SAH_BINS, 3), -np.inf, dtype=np.float64)
    for a in range(3):
        np.minimum.at(bin_min[:, a], bins, lo[:, a])
        np.maximum.at(bin_max[:, a], bins, hi[:, a])

    # Sweep: cost(i) = NL*areaL + NR*areaR for split after bin i.
    def areas(mn, mx, cnt):
        d = np.where(cnt[:, None] > 0, mx - mn, 0.0)
        return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])

    lmin = np.minimum.accumulate(bin_min, axis=0)
    lmax = np.maximum.accumulate(bin_max, axis=0)
    lcnt = np.cumsum(counts)
    rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
    rcnt = np.cumsum(counts[::-1])[::-1]

    la = areas(lmin[:-1], lmax[:-1], lcnt[:-1])
    ra = areas(rmin[1:], rmax[1:], rcnt[1:])
    cost = lcnt[:-1] * la + rcnt[1:] * ra
    valid = (lcnt[:-1] > 0) & (rcnt[1:] > 0)
    if not valid.any():
        half = len(prim_ids) // 2
        order = np.argsort(c[:, axis], kind="stable")
        return prim_ids[order[:half]], prim_ids[order[half:]]
    cost = np.where(valid, cost, np.inf)
    best = int(np.argmin(cost))

    mask = bins <= best
    return prim_ids[mask], prim_ids[~mask]


def flat_bvh_children(bvh: FlatBvh) -> tuple[np.ndarray, np.ndarray]:
    """Recover (left, right) child indices from the DFS-preorder entry/exit
    layout: for an internal node, left = entry (the next node) and
    right = exit[left] (the index just past the left subtree). Leaves get
    (-1, -1). Used by the device-side AABB refit (scene/update.py) — the
    stackless arrays alone don't expose children."""
    n = bvh.count
    left = np.full(n, -1, dtype=np.int32)
    right = np.full(n, -1, dtype=np.int32)
    internal = bvh.entry >= 0
    if n:
        left[internal] = bvh.entry[internal]
        right[internal] = bvh.exit[np.maximum(left[internal], 0)]
    return left, right


def tree_depth(left: np.ndarray, right: np.ndarray, root: int = 0) -> int:
    """Height of the tree described by child arrays (#edges on the longest
    root->leaf path) — the number of bottom-up refit sweeps needed."""
    if len(left) == 0:
        return 0
    depth = 0
    frontier = [root]
    while frontier:
        nxt = []
        for i in frontier:
            l, r = int(left[i]), int(right[i])
            if l >= 0:
                nxt.append(l)
            if r >= 0 and r != l:
                nxt.append(r)
        if not nxt:
            break
        depth += 1
        frontier = nxt
    return depth


def offset_bvh(bvh: FlatBvh, node_offset: int, exit_remap: int) -> FlatBvh:
    """Shift a flattened subtree to live at ``node_offset`` inside a larger
    node array, rewiring every 'leave the tree' exit (== count) to
    ``exit_remap``. Entry indices of internal nodes shift too; leaf entries
    (negative) are left to the caller to re-base primitive ids."""
    count = bvh.count
    entry = bvh.entry.copy()
    internal = entry >= 0
    entry[internal] += node_offset
    exit_ = np.where(bvh.exit >= count, exit_remap, bvh.exit + node_offset)
    return FlatBvh(
        bvh.mins.copy(), bvh.maxs.copy(), entry, exit_.astype(np.int32), bvh.inst.copy()
    )


def validate_flat_bvh(bvh: FlatBvh, num_prims: int) -> None:
    """Structural invariants (the unit-test contract; SURVEY.md §4):
    every primitive appears in exactly one leaf; entry/exit indices stay
    in-range; DFS walk visiting all children terminates."""
    count = bvh.count
    if count == 0:
        assert num_prims == 0
        return
    leaf_mask = bvh.entry < 0
    prims = -bvh.entry[leaf_mask] - 1
    assert len(prims) == num_prims, f"{len(prims)} leaves != {num_prims} prims"
    assert len(np.unique(prims)) == num_prims, "duplicate prims in leaves"
    assert prims.min() >= 0 and prims.max() < num_prims

    # Exits in (0, count]; entries of internals in (0, count).
    assert (bvh.exit > 0).all() and (bvh.exit <= count).all()
    internal_entry = bvh.entry[~leaf_mask]
    if len(internal_entry):
        assert (internal_entry > 0).all() and (internal_entry < count).all()

    # Full walk taking every branch terminates and visits every leaf.
    seen = np.zeros(count, dtype=bool)
    stack = [0]
    while stack:
        i = stack.pop()
        if i >= count or seen[i]:
            continue
        seen[i] = True
        if bvh.entry[i] >= 0:
            stack.append(int(bvh.entry[i]))
        stack.append(int(bvh.exit[i]))
    assert seen.all(), "unreachable nodes in flattened BVH"

    # AABB containment: parents contain children along the DFS layout.
    for i in range(count):
        e = bvh.entry[i]
        if e >= 0:
            for child in (int(e),):
                assert (bvh.mins[i] <= bvh.mins[child] + 1e-5).all()
                assert (bvh.maxs[i] >= bvh.maxs[child] - 1e-5).all()
