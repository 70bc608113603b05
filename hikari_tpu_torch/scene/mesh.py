"""Host-side mesh representation and triangulation.

Equivalent of the reference's mesh-asset compile step
(``GpuMesh::try_from(Mesh)``, src/mesh_material/mod.rs:379-467): extract
position/normal/uv0 attributes and produce an indexed triangle list from
either a triangle list or a triangle strip. All host-side numpy; the device
never sees a ``Mesh`` — only the flat ``SceneBuffers`` built in
``scene/compile.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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

    @property
    def num_triangles(self) -> int:
        return len(self.indices)

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

    @staticmethod
    def from_triangle_strip(positions, normals, uvs, strip_indices=None) -> "Mesh":
        """Triangle-strip topology with alternating winding (reference
        src/mesh_material/mod.rs:430-448)."""
        positions = np.asarray(positions, dtype=np.float32).reshape(-1, 3)
        if strip_indices is None:
            strip_indices = np.arange(len(positions), dtype=np.int32)
        s = np.asarray(strip_indices, dtype=np.int32)
        tris = [
            [s[i], s[i + 1], s[i + 2]] if i % 2 == 0 else [s[i + 1], s[i], s[i + 2]]
            for i in range(len(s) - 2)
        ]
        return Mesh(positions, normals, uvs, np.array(tris, dtype=np.int32))


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


def plane_mesh(size: float = 1.0) -> Mesh:
    """A plane in the XZ plane facing +Y (bevy ``shape::Plane``)."""
    h = size / 2.0
    positions = [[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]]
    normals = [[0, 1, 0]] * 4
    uvs = [[0, 0], [1, 0], [1, 1], [0, 1]]
    indices = [[0, 2, 1], [0, 3, 2]]
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


def building_mesh(
    floors: int = 8, cols: int = 5, seed: int = 0
) -> Mesh:
    """A detailed tower in the unit cube [-0.5, 0.5]^3: a base box plus a
    (cols x floors) grid of protruding window boxes on all four facades —
    12 + 48*floors*cols triangles (floors=8, cols=5: 1932). The geometry
    class the reference's City stage exercises (examples/city.rs:
    streamed building models with facade detail), built procedurally so
    the acceptance config reaches reference scale (>=500k tris) without
    the absent City scene.bin. Fully vectorized construction."""
    rng = np.random.default_rng(seed)
    base = cube_mesh(1.0)
    tpl_p = np.asarray(base.positions, dtype=np.float64)  # (24, 3)
    tpl_n = np.asarray(base.normals, dtype=np.float64)
    tpl_uv = np.asarray(base.uvs, dtype=np.float64)
    tpl_i = np.asarray(base.indices, dtype=np.int64)  # (12, 3)

    # Window boxes: centers on a facade grid, protruding 0.02 outward.
    w = 0.7 / cols * 0.55  # window width (x or z extent along facade)
    h = 0.8 / floors * 0.5  # window height
    d = 0.04  # protrusion depth
    xs = (np.arange(cols) + 0.5) / cols - 0.5  # facade-local centers
    ys = (np.arange(floors) + 0.5) / floors - 0.5
    gx, gy = np.meshgrid(xs * 0.9, ys * 0.9, indexing="ij")
    gx = gx.ravel()
    gy = gy.ravel()
    jitter = rng.uniform(0.9, 1.0, size=gx.size)
    scales, centers = [], []
    for face in range(4):
        # faces: +z, -z, +x, -x
        if face < 2:
            s = np.stack([np.full_like(gx, w), np.full_like(gx, h),
                          np.full_like(gx, d)], axis=-1)
            c = np.stack([gx, gy, np.where(face == 0, 0.5, -0.5)
                          * np.ones_like(gx)], axis=-1)
        else:
            s = np.stack([np.full_like(gx, d), np.full_like(gx, h),
                          np.full_like(gx, w)], axis=-1)
            c = np.stack([np.where(face == 2, 0.5, -0.5)
                          * np.ones_like(gx), gy, gx], axis=-1)
        s = s * jitter[:, None]
        scales.append(s)
        centers.append(c)
    scales = np.concatenate(scales)  # (N, 3)
    centers = np.concatenate(centers)
    n_boxes = scales.shape[0]

    pos = tpl_p[None] * scales[:, None] + centers[:, None]  # (N, 24, 3)
    nrm = np.broadcast_to(tpl_n[None], pos.shape)
    uv = np.broadcast_to(tpl_uv[None], (n_boxes, 24, 2))
    idx = tpl_i[None] + 24 * np.arange(1, n_boxes + 1)[:, None, None]

    positions = np.concatenate([tpl_p, pos.reshape(-1, 3)])
    normals = np.concatenate([tpl_n, nrm.reshape(-1, 3)])
    uvs = np.concatenate([tpl_uv, uv.reshape(-1, 2)])
    indices = np.concatenate([tpl_i, idx.reshape(-1, 3)])
    return Mesh(positions, normals, uvs, indices)


def uv_sphere_mesh(radius: float = 1.0, sectors: int = 36, stacks: int = 18) -> Mesh:
    """A UV sphere (bevy ``shape::UVSphere``-like)."""
    positions, normals, uvs = [], [], []
    for i in range(stacks + 1):
        phi = np.pi * i / stacks  # 0..pi from +Y pole
        for j in range(sectors + 1):
            theta = 2.0 * np.pi * j / sectors
            n = [
                np.sin(phi) * np.cos(theta),
                np.cos(phi),
                np.sin(phi) * np.sin(theta),
            ]
            positions.append([radius * c for c in n])
            normals.append(n)
            uvs.append([j / sectors, i / stacks])
    indices = []
    for i in range(stacks):
        for j in range(sectors):
            a = i * (sectors + 1) + j
            b = a + sectors + 1
            if i != 0:
                indices.append([a, b, a + 1])
            if i != stacks - 1:
                indices.append([a + 1, b, b + 1])
    return Mesh(positions, normals, uvs, indices)


def terrain_mesh(n: int = 256, size: float = 1.0, height: float = 0.15, seed: int = 3) -> Mesh:
    """A displaced (n+1)x(n+1) grid in the XZ plane facing +Y: 2*n^2
    triangles of fBm-style terrain (a sum of random sinusoids, vectorized
    and deterministic). The million-triangle stress geometry of the
    large-scene tracer benches; n=708 gives 1,002,528 triangles."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-0.5, 0.5, n + 1, dtype=np.float64) * size
    X, Z = np.meshgrid(xs, xs, indexing="ij")  # (n+1, n+1)

    Y = np.zeros_like(X)
    amp, freq = 1.0, 2.0 * np.pi / size
    for _ in range(6):  # octaves
        for _ in range(3):  # random directions per octave
            kx, kz = rng.normal(size=2)
            k = np.hypot(kx, kz) or 1.0
            phase = rng.uniform(0, 2 * np.pi)
            Y += amp * np.sin((kx * X + kz * Z) * freq / k + phase)
        amp *= 0.5
        freq *= 2.0
    Y *= height / max(np.abs(Y).max(), 1e-9)

    positions = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)

    # Vertex normals from central-difference height gradients.
    dy_dx = np.gradient(Y, axis=0) / (size / n)
    dy_dz = np.gradient(Y, axis=1) / (size / n)
    normals = np.stack([-dy_dx, np.ones_like(Y), -dy_dz], axis=-1).reshape(-1, 3)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)

    U, V = np.meshgrid(np.linspace(0, 1, n + 1), np.linspace(0, 1, n + 1), indexing="ij")
    uvs = np.stack([U, V], axis=-1).reshape(-1, 2)

    # Two triangles per cell (+Y winding: counter-clockwise seen from above).
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v00 = (ii * (n + 1) + jj).ravel()
    v10 = v00 + (n + 1)
    v01 = v00 + 1
    v11 = v10 + 1
    tris = np.concatenate(
        [np.stack([v00, v01, v11], axis=-1), np.stack([v00, v11, v10], axis=-1)], axis=0
    ).astype(np.int32)
    return Mesh(positions, normals, uvs, tris)
