"""Host-side mesh SoA + procedural test primitives.

Port of ``raytracerfacility_tpu/scene/mesh.py`` (numpy, copied; the vertex
normals use the numpy path of the reference's ``compute_vertex_normals``).

``Mesh`` mirrors the UniEngine vertex layout the reference consumes
(position/normal/tangent/color/texcoord + the padding "data" channel that the
instancing kernel smuggles per-instance data through,
ref RayTracer.cu:1148-1175, RayDataDefinations.hpp:152-162).

The procedural primitives stand in for UniEngine's asset pipeline so tests
and benchmarks have scenes to render (the reference relied on engine scenes;
it ships no meshes).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray  # (N, 3) f32
    triangles: np.ndarray  # (T, 3) int32
    normals: np.ndarray | None = None  # (N, 3)
    tangents: np.ndarray | None = None  # (N, 3)
    colors: np.ndarray | None = None  # (N, 4)
    tex_coords: np.ndarray | None = None  # (N, 2)
    data: np.ndarray | None = None  # (N, 4) aux channel

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float32)
        self.triangles = np.asarray(self.triangles, np.int32)
        n = self.positions.shape[0]
        if self.normals is None:
            self.normals = compute_vertex_normals(self.positions, self.triangles)
        else:
            self.normals = np.asarray(self.normals, np.float32)
        if self.tangents is None:
            self.tangents = _default_tangents(self.normals)
        else:
            self.tangents = np.asarray(self.tangents, np.float32)
        if self.colors is None:
            self.colors = np.ones((n, 4), np.float32)
        else:
            self.colors = np.asarray(self.colors, np.float32)
            if self.colors.shape[-1] == 3:
                self.colors = np.concatenate(
                    [self.colors, np.ones((n, 1), np.float32)], axis=-1
                )
        if self.tex_coords is None:
            self.tex_coords = np.zeros((n, 2), np.float32)
        else:
            self.tex_coords = np.asarray(self.tex_coords, np.float32)
        if self.data is None:
            self.data = np.zeros((n, 4), np.float32)
        else:
            self.data = np.asarray(self.data, np.float32)

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]


def compute_vertex_normals(positions: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (for procedural meshes)."""
    v0 = positions[triangles[:, 0]]
    v1 = positions[triangles[:, 1]]
    v2 = positions[triangles[:, 2]]
    face_n = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(positions)
    for corner in range(3):
        np.add.at(normals, triangles[:, corner], face_n)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(norm, 1e-12)).astype(np.float32)


def _default_tangents(normals: np.ndarray) -> np.ndarray:
    """Arbitrary tangents orthogonal to the normals."""
    helper = np.where(
        np.abs(normals[:, 0:1]) > 0.99,
        np.array([[0.0, 0.0, 1.0]], np.float32),
        np.array([[1.0, 0.0, 0.0]], np.float32),
    )
    t = np.cross(normals, helper)
    norm = np.linalg.norm(t, axis=-1, keepdims=True)
    return (t / np.maximum(norm, 1e-12)).astype(np.float32)


def make_plane(size: float = 1.0, color=(1.0, 1.0, 1.0, 1.0)) -> Mesh:
    """Unit quad in the XZ plane facing +Y."""
    s = size / 2.0
    positions = np.array(
        [[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32
    )
    triangles = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    normals = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    colors = np.tile(np.asarray(color, np.float32), (4, 1))
    return Mesh(positions, triangles, normals=normals, colors=colors, tex_coords=uvs)


def make_cube(size: float = 1.0, color=(1.0, 1.0, 1.0, 1.0)) -> Mesh:
    """Axis-aligned cube with per-face normals (24 vertices)."""
    s = size / 2.0
    faces = [
        # (normal, u axis, v axis)
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
        ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ]
    positions, normals, uvs, tris = [], [], [], []
    for fi, (n, ua, va) in enumerate(faces):
        n = np.array(n, np.float32)
        ua = np.array(ua, np.float32)
        va = np.array(va, np.float32)
        base = len(positions)
        for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            positions.append(n * s + ua * du * s + va * dv * s)
            normals.append(n)
            uvs.append([(du + 1) / 2, (dv + 1) / 2])
        tris.append([base, base + 1, base + 2])
        tris.append([base, base + 2, base + 3])
    colors = np.tile(np.asarray(color, np.float32), (24, 1))
    return Mesh(
        np.array(positions, np.float32),
        np.array(tris, np.int32),
        normals=np.array(normals, np.float32),
        colors=colors,
        tex_coords=np.array(uvs, np.float32),
    )


def make_sphere(radius: float = 0.5, rings: int = 16, sectors: int = 32,
                color=(1.0, 1.0, 1.0, 1.0)) -> Mesh:
    """UV sphere."""
    ring = np.linspace(0.0, np.pi, rings + 1)
    sector = np.linspace(0.0, 2 * np.pi, sectors + 1)
    theta, phi = np.meshgrid(ring, sector, indexing="ij")
    x = np.sin(theta) * np.cos(phi)
    y = np.cos(theta)
    z = np.sin(theta) * np.sin(phi)
    positions = np.stack([x, y, z], axis=-1).reshape(-1, 3) * radius
    normals = positions / max(radius, 1e-12)
    uvs = np.stack(
        [phi / (2 * np.pi), theta / np.pi], axis=-1
    ).reshape(-1, 2)
    tris = []
    cols = sectors + 1
    for r in range(rings):
        for s in range(sectors):
            a = r * cols + s
            b = a + cols
            tris.append([a, b, a + 1])
            tris.append([a + 1, b, b + 1])
    colors = np.tile(np.asarray(color, np.float32), (positions.shape[0], 1))
    return Mesh(
        positions.astype(np.float32),
        np.array(tris, np.int32),
        normals=normals.astype(np.float32),
        colors=colors,
        tex_coords=uvs.astype(np.float32),
    )


def make_cornell_box(size: float = 2.0) -> list[tuple[Mesh, np.ndarray, tuple]]:
    """Cornell-style box: returns [(mesh, 4x4 transform, rgb color)] walls.

    Stand-in for the reference's demo scene (src/app uses live engine
    content); used by tests and the 512x512 baseline config.
    """
    s = size
    identity = np.eye(4, dtype=np.float32)

    def wall(translate, rotate_axis=None, angle=0.0):
        m = np.eye(4, dtype=np.float32)
        if rotate_axis is not None:
            c, sn = np.cos(angle), np.sin(angle)
            x, y, z = rotate_axis
            rot = np.array(
                [
                    [c + x * x * (1 - c), x * y * (1 - c) - z * sn, x * z * (1 - c) + y * sn],
                    [y * x * (1 - c) + z * sn, c + y * y * (1 - c), y * z * (1 - c) - x * sn],
                    [z * x * (1 - c) - y * sn, z * y * (1 - c) + x * sn, c + z * z * (1 - c)],
                ],
                np.float32,
            )
            m[:3, :3] = rot
        m[:3, 3] = translate
        return m

    plane = make_plane(s)
    out = [
        (plane, wall((0, 0, 0)), (0.73, 0.73, 0.73)),  # floor
        (plane, wall((0, s, 0), (1, 0, 0), np.pi), (0.73, 0.73, 0.73)),  # ceiling
        (plane, wall((0, s / 2, -s / 2), (1, 0, 0), np.pi / 2), (0.73, 0.73, 0.73)),  # back
        (plane, wall((-s / 2, s / 2, 0), (0, 0, 1), -np.pi / 2), (0.65, 0.05, 0.05)),  # left
        (plane, wall((s / 2, s / 2, 0), (0, 0, 1), np.pi / 2), (0.12, 0.45, 0.15)),  # right
    ]
    del identity
    return out
