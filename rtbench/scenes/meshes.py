"""Frozen scene generators of the benchmark.

Copies of the port's procedural meshes (``scene/mesh.py``: ``make_plane``,
``make_cube``, ``make_sphere``, ``make_cornell_box``; ``scene/procedural.py``:
``make_sorghum_plant``, ``make_canopy_instances``), kept here so that an
edit of the program's generators cannot move the yardstick. Each returns
plain numpy arrays; the same arrays go to the program (through its scene
store) and to the plain reference.

A mesh is a dict: ``positions`` (V, 3) float32, ``triangles`` (T, 3)
int32, ``normals`` (V, 3) float32, ``tex_coords`` (V, 2) float32.
"""

from __future__ import annotations

import numpy as np


def mesh(positions, triangles, normals, tex_coords) -> dict:
    return {"positions": np.asarray(positions, np.float32),
            "triangles": np.asarray(triangles, np.int32),
            "normals": np.asarray(normals, np.float32),
            "tex_coords": np.asarray(tex_coords, np.float32)}


def make_plane(size: float = 1.0) -> dict:
    """Unit quad in the XZ plane facing +Y."""
    s = size / 2.0
    positions = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]],
                         np.float32)
    triangles = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    normals = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return mesh(positions, triangles, normals, uvs)


def make_cube(size: float = 1.0) -> dict:
    """Axis-aligned cube with per-face normals (24 vertices)."""
    s = size / 2.0
    faces = [
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
        ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ]
    positions, normals, uvs, tris = [], [], [], []
    for n, ua, va in faces:
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
    return mesh(np.array(positions, np.float32), np.array(tris, np.int32),
                np.array(normals, np.float32), np.array(uvs, np.float32))


def make_sphere(radius: float = 0.5, rings: int = 16, sectors: int = 32) -> dict:
    """UV sphere."""
    ring = np.linspace(0.0, np.pi, rings + 1)
    sector = np.linspace(0.0, 2 * np.pi, sectors + 1)
    theta, phi = np.meshgrid(ring, sector, indexing="ij")
    x = np.sin(theta) * np.cos(phi)
    y = np.cos(theta)
    z = np.sin(theta) * np.sin(phi)
    positions = np.stack([x, y, z], axis=-1).reshape(-1, 3) * radius
    normals = positions / max(radius, 1e-12)
    uvs = np.stack([phi / (2 * np.pi), theta / np.pi], axis=-1).reshape(-1, 2)
    tris = []
    cols = sectors + 1
    for r in range(rings):
        for s in range(sectors):
            a = r * cols + s
            b = a + cols
            tris.append([a, b, a + 1])
            tris.append([a + 1, b, b + 1])
    return mesh(positions.astype(np.float32), np.array(tris, np.int32),
                normals.astype(np.float32), uvs.astype(np.float32))


def _rotation(axis, angle) -> np.ndarray:
    c, sn = np.cos(angle), np.sin(angle)
    x, y, z = axis
    return np.array(
        [[c + x * x * (1 - c), x * y * (1 - c) - z * sn, x * z * (1 - c) + y * sn],
         [y * x * (1 - c) + z * sn, c + y * y * (1 - c), y * z * (1 - c) - x * sn],
         [z * x * (1 - c) - y * sn, z * y * (1 - c) + x * sn, c + z * z * (1 - c)]],
        np.float32)


def make_cornell_box(size: float = 2.0) -> list:
    """The five walls: [(plane mesh, 4x4 transform, rgb)] (floor, ceiling,
    back, red left, green right)."""
    s = size

    def wall(translate, rotate_axis=None, angle=0.0):
        m = np.eye(4, dtype=np.float32)
        if rotate_axis is not None:
            m[:3, :3] = _rotation(rotate_axis, angle)
        m[:3, 3] = translate
        return m

    plane = make_plane(s)
    grey = (0.73, 0.73, 0.73)
    return [
        (plane, wall((0, 0, 0)), grey),
        (plane, wall((0, s, 0), (1, 0, 0), np.pi), grey),
        (plane, wall((0, s / 2, -s / 2), (1, 0, 0), np.pi / 2), grey),
        (plane, wall((-s / 2, s / 2, 0), (0, 0, 1), -np.pi / 2), (0.65, 0.05, 0.05)),
        (plane, wall((s / 2, s / 2, 0), (0, 0, 1), np.pi / 2), (0.12, 0.45, 0.15)),
    ]


def _leaf_ribbon(length, width, arch, twist, segments):
    """One arched leaf: a ribbon swept along a droop curve, in the leaf
    frame (base at the origin, growing toward +Y, drooping toward +X)."""
    t = np.linspace(0.0, 1.0, segments + 1, dtype=np.float32)
    ang = t * arch
    y = np.cumsum(np.diff(np.concatenate([[0.0], t * 0 + length / segments]))
                  * np.cos(ang)).astype(np.float32)
    x = np.cumsum(np.concatenate([[0.0], np.diff(t)]) * length
                  * np.sin(ang)).astype(np.float32)
    w = width * (0.25 + 1.5 * t * (1.0 - t) ** 0.7)
    w[-1] = 0.001 * width
    phi = twist * t
    side = np.stack([np.sin(phi), np.zeros_like(phi), np.cos(phi)], axis=1)
    spine = np.stack([x, y, np.zeros_like(x)], axis=1)
    left = spine - side * w[:, None] * 0.5
    right = spine + side * w[:, None] * 0.5
    pos = np.empty((2 * (segments + 1), 3), np.float32)
    pos[0::2] = left
    pos[1::2] = right
    nrm = np.cross(side, np.gradient(spine, axis=0))
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-8)
    normals = np.repeat(nrm, 2, axis=0).astype(np.float32)
    uv = np.zeros((2 * (segments + 1), 2), np.float32)
    uv[1::2, 0] = 1.0
    uv[:, 1] = np.repeat(t, 2)
    idx = []
    for i in range(segments):
        a, b, c, d = 2 * i, 2 * i + 1, 2 * i + 2, 2 * i + 3
        idx.append((a, b, c))
        idx.append((b, d, c))
    return pos, normals, uv, np.asarray(idx, np.uint32)


def _stalk(height, radius, sides, segments):
    t = np.linspace(0.0, 1.0, segments + 1, dtype=np.float32)
    ang = np.linspace(0.0, 2.0 * np.pi, sides, endpoint=False, dtype=np.float32)
    r = radius * (1.0 - 0.5 * t)
    pos, nrm = [], []
    for i, ti in enumerate(t):
        pos.append(np.stack([np.cos(ang) * r[i], np.full_like(ang, ti * height),
                             np.sin(ang) * r[i]], axis=1))
        nrm.append(np.stack([np.cos(ang), np.zeros_like(ang), np.sin(ang)], axis=1))
    pos = np.concatenate(pos).astype(np.float32)
    nrm = np.concatenate(nrm).astype(np.float32)
    idx = []
    for i in range(segments):
        for j in range(sides):
            a = i * sides + j
            b = i * sides + (j + 1) % sides
            c = (i + 1) * sides + j
            d = (i + 1) * sides + (j + 1) % sides
            idx.append((a, b, c))
            idx.append((b, d, c))
    uv = np.zeros((pos.shape[0], 2), np.float32)
    return pos, nrm, uv, np.asarray(idx, np.uint32)


def make_sorghum_plant(seed: int = 0, leaves: int = 14, leaf_segments: int = 12) -> dict:
    """One sorghum plant: a stalk and a whorl of arched leaves
    (``leaves`` x 2 x ``leaf_segments`` + 48 stalk triangles)."""
    rng = np.random.default_rng(seed)
    parts_p, parts_n, parts_uv, parts_i = [], [], [], []
    base = 0

    def add(pos, nrm, uv, idx):
        nonlocal base
        parts_p.append(pos)
        parts_n.append(nrm)
        parts_uv.append(uv)
        parts_i.append(idx + base)
        base += pos.shape[0]

    height = 1.2 + 0.5 * rng.random()
    add(*_stalk(height, 0.025, sides=6, segments=4))
    for k in range(leaves):
        frac = (k + 1.0) / (leaves + 1.0)
        length = (0.5 + 0.7 * rng.random()) * (1.2 - 0.5 * frac)
        width = 0.05 + 0.03 * rng.random()
        arch = 0.9 + 0.9 * rng.random() + 0.6 * frac
        twist = (rng.random() - 0.5) * 0.8
        pos, nrm, uv, idx = _leaf_ribbon(length, width, arch, twist, leaf_segments)
        theta = k * 2.399963 + rng.random() * 0.3
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        pos = pos @ rot.T
        pos[:, 1] += frac * height * 0.9
        add(pos, nrm @ rot.T, uv, idx)
    return mesh(np.concatenate(parts_p), np.concatenate(parts_i).astype(np.int32),
                np.concatenate(parts_n), np.concatenate(parts_uv))


def make_canopy_instances(rows: int, cols: int, spacing: float = 0.35,
                          seed: int = 0) -> np.ndarray:
    """(rows*cols, 4, 4) plant transforms on a jittered grid: a turn about
    Y, a scale of 0.85-1.15 and a position."""
    rng = np.random.default_rng(seed)
    mats = []
    for i in range(rows):
        for j in range(cols):
            m = np.eye(4, dtype=np.float32)
            theta = rng.random() * 2 * np.pi
            c, s = np.cos(theta), np.sin(theta)
            scale = 0.85 + 0.3 * rng.random()
            m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) * scale
            m[0, 3] = (i - rows / 2.0) * spacing + (rng.random() - 0.5) * 0.1
            m[2, 3] = (j - cols / 2.0) * spacing + (rng.random() - 0.5) * 0.1
            mats.append(m)
    return np.stack(mats)
