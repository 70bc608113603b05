"""Host-side mesh representation and triangulation.

Equivalent of the reference's mesh-asset compile step
(``GpuMesh::try_from(Mesh)``, src/mesh_material/mod.rs:379-467): extract
position/normal/uv0 attributes and produce an indexed triangle list from
either a triangle list or a triangle strip. All host-side numpy; the device
never sees a ``Mesh`` — only the flat ``SceneBuffers`` built in
``scene/compile.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    """An indexed triangle mesh in local space.

    positions: (V, 3) f32, normals: (V, 3) f32, uvs: (V, 2) f32,
    indices: (P, 3) i32 triangle vertex indices.
    """

    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    indices: np.ndarray

    def __post_init__(self):
        self.positions = np.asarray(self.positions, dtype=np.float32).reshape(-1, 3)
        self.normals = np.asarray(self.normals, dtype=np.float32).reshape(-1, 3)
        self.uvs = np.asarray(self.uvs, dtype=np.float32).reshape(-1, 2)
        self.indices = np.asarray(self.indices, dtype=np.int32).reshape(-1, 3)
        if len(self.indices) == 0:
            raise ValueError("mesh has no primitives")  # NoPrimitive, mod.rs:446

    @property
    def num_vertices(self) -> int:
        return len(self.positions)

    def triangle_positions(self) -> np.ndarray:
        """(P, 3, 3) local-space triangle vertex positions."""
        return self.positions[self.indices]

    def triangle_areas(self, transform: np.ndarray | None = None) -> np.ndarray:
        """(P,) world-space triangle areas under an optional 4x4 transform
        (reference ``transformed_primitive_areas``, mod.rs:316-328)."""
        tri = self.triangle_positions()
        if transform is not None:
            tri = transform_points(transform, tri.reshape(-1, 3)).reshape(-1, 3, 3)
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        return 0.5 * np.abs(np.linalg.norm(np.cross(e1, e2), axis=-1))

def transform_points(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Apply 4x4 affine transform to (N,3) points."""
    return p @ m[:3, :3].T + m[:3, 3]


def transform_normals(m: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Transform normals by inverse-transpose of the 3x3 block, normalized
    (reference ``instance_normal_local_to_world``, light.wgsl:324-338)."""
    it = np.linalg.inv(m[:3, :3]).T
    out = n @ it.T
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norm, 1e-20)


# ---------------------------------------------------------------------------
# Procedural primitives (the reference gets these from Bevy's shape library;
# used by the example scenes: examples/{minimal,simple,city}.rs spawn
# shape::Plane / shape::Cube / shape::UVSphere meshes).
# ---------------------------------------------------------------------------


def quad_mesh(size: float = 1.0) -> Mesh:
    """A unit quad in the XY plane facing +Z (two triangles)."""
    h = size / 2.0
    positions = [[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]]
    normals = [[0, 0, 1]] * 4
    uvs = [[0, 1], [1, 1], [1, 0], [0, 0]]
    indices = [[0, 1, 2], [0, 2, 3]]
    return Mesh(positions, normals, uvs, indices)


def cube_mesh(size: float = 1.0) -> Mesh:
    """An axis-aligned cube with per-face normals (bevy ``shape::Cube``)."""
    h = size / 2.0
    faces = [
        # (normal, corners in CCW order seen from outside)
        ([0, 0, 1], [[-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]]),
        ([0, 0, -1], [[h, -h, -h], [-h, -h, -h], [-h, h, -h], [h, h, -h]]),
        ([1, 0, 0], [[h, -h, h], [h, -h, -h], [h, h, -h], [h, h, h]]),
        ([-1, 0, 0], [[-h, -h, -h], [-h, -h, h], [-h, h, h], [-h, h, -h]]),
        ([0, 1, 0], [[-h, h, h], [h, h, h], [h, h, -h], [-h, h, -h]]),
        ([0, -1, 0], [[-h, -h, -h], [h, -h, -h], [h, -h, h], [-h, -h, h]]),
    ]
    positions, normals, uvs, indices = [], [], [], []
    for n, corners in faces:
        base = len(positions)
        positions.extend(corners)
        normals.extend([n] * 4)
        uvs.extend([[0, 1], [1, 1], [1, 0], [0, 0]])
        indices.append([base, base + 1, base + 2])
        indices.append([base, base + 2, base + 3])
    return Mesh(positions, normals, uvs, indices)
