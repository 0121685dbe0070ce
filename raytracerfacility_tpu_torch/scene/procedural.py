"""Procedural scenes.

Port of ``raytracerfacility_tpu/scene/procedural.py``: the sorghum canopy
(``build_canopy_scene`` and its plant and instance generators, BASELINE
config 6), ``build_strands_scene`` (BASELINE config 7) and
``build_btf_sphere_scene`` with ``make_plane_under_sphere`` (the
CompressedBTF sphere of BASELINE config 3 over a plane). The same seeds
draw the same numpy random streams, so meshes and matrices equal the
reference's.
"""

from __future__ import annotations

import numpy as np

from raytracerfacility_tpu_torch.enums import GeometryType, MaterialType, RendererType
from raytracerfacility_tpu_torch.mlvq.synthetic import synthetic_btf
from raytracerfacility_tpu_torch.scene.materials import MaterialProperties
from raytracerfacility_tpu_torch.scene.mesh import Mesh, make_plane, make_sphere
from raytracerfacility_tpu_torch.scene.scene import RayTracerScene


def _leaf_ribbon(length, width, arch, twist, segments, rng):
    """A single arched leaf: a ribbon swept along a droop curve. Returns
    (positions (V,3), normals (V,3), uv (V,2), indices (F,3)) in the leaf
    frame: base at the origin, growing toward +Y and drooping toward +X."""
    t = np.linspace(0.0, 1.0, segments + 1, dtype=np.float32)
    ang = t * arch
    y = np.cumsum(np.diff(np.concatenate([[0.0], t * 0 + length / segments]))
                  * np.cos(ang)).astype(np.float32)
    x = np.cumsum(np.concatenate([[0.0], np.diff(t)]) * length
                  * np.sin(ang)).astype(np.float32)
    # width profile: widest at 1/3, tapering to the tip
    w = width * (0.25 + 1.5 * t * (1.0 - t) ** 0.7)
    w[-1] = 0.001 * width
    phi = twist * t
    # the ribbon's side direction turns slightly along the leaf (twist)
    side = np.stack([np.sin(phi), np.zeros_like(phi), np.cos(phi)], axis=1)
    spine = np.stack([x, y, np.zeros_like(x)], axis=1)
    left = spine - side * w[:, None] * 0.5
    right = spine + side * w[:, None] * 0.5
    pos = np.empty((2 * (segments + 1), 3), np.float32)
    pos[0::2] = left
    pos[1::2] = right
    # normals: perpendicular to the spine tangent and the side
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
        nrm.append(np.stack([np.cos(ang), np.zeros_like(ang), np.sin(ang)],
                            axis=1))
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


def make_sorghum_plant(seed: int = 0, leaves: int = 14,
                       leaf_segments: int = 12) -> Mesh:
    """One sorghum plant: a stalk and a whorl of arched leaves (``leaves``
    x 2 x ``leaf_segments`` + 48 stalk triangles)."""
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
        pos, nrm, uv, idx = _leaf_ribbon(length, width, arch, twist,
                                         leaf_segments, rng)
        # turn about Y by the phyllotaxis angle, attach at its height
        theta = k * 2.399963 + rng.random() * 0.3  # golden angle spiral
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        pos = pos @ rot.T
        pos[:, 1] += frac * height * 0.9
        add(pos, nrm @ rot.T, uv, idx)
    return Mesh(positions=np.concatenate(parts_p),
                triangles=np.concatenate(parts_i).astype(np.int32),
                normals=np.concatenate(parts_n),
                tex_coords=np.concatenate(parts_uv))


def make_canopy_instances(rows: int, cols: int, spacing: float = 0.35,
                          seed: int = 0) -> np.ndarray:
    """(rows*cols, 4, 4) plant transforms on a jittered grid: a turn about
    Y, a scale of 0.85-1.15 and a position (the Instanced renderer path,
    ref RayTracer.cu:1148-1175)."""
    rng = np.random.default_rng(seed)
    mats = []
    for i in range(rows):
        for j in range(cols):
            m = np.eye(4, dtype=np.float32)
            theta = rng.random() * 2 * np.pi
            c, s = np.cos(theta), np.sin(theta)
            scale = 0.85 + 0.3 * rng.random()
            m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                 np.float32) * scale
            m[0, 3] = (i - rows / 2.0) * spacing + (rng.random() - 0.5) * 0.1
            m[2, 3] = (j - cols / 2.0) * spacing + (rng.random() - 0.5) * 0.1
            mats.append(m)
    return np.stack(mats)


def build_canopy_scene(rows: int = 10, cols: int = 10, variants: int = 4,
                       seed: int = 0, leaf_segments: int = 12) -> RayTracerScene:
    """A sorghum canopy: ``variants`` distinct plants instanced over a
    rows x cols grid (one INSTANCED geometry per variant, over consecutive
    runs of the grid's transforms), plus a ground plane. About rows x cols
    x 384 triangles at the default ``leaf_segments``."""
    scene = RayTracerScene()
    scene.upsert_material(1, version=0, properties=MaterialProperties(
        albedo_color=(0.35, 0.55, 0.18), roughness=1.0, metallic=0.0))
    scene.upsert_material(2, version=0, properties=MaterialProperties(
        albedo_color=(0.35, 0.25, 0.15), roughness=1.0, metallic=0.0))
    all_mats = make_canopy_instances(rows, cols, seed=seed)
    per = (rows * cols + variants - 1) // variants
    for v in range(variants):
        plant = make_sorghum_plant(seed=seed * 97 + v, leaf_segments=leaf_segments)
        chunk = all_mats[v * per:(v + 1) * per]
        if chunk.shape[0] == 0:
            continue
        scene.upsert_geometry(10 + v, version=0, mesh=plant,
                              renderer_type=RendererType.INSTANCED,
                              instance_matrices=chunk)
        scene.upsert_instance(100 + v, version=0, geometry=10 + v, material=1)
    scene.upsert_geometry(50, version=0, mesh=make_plane(rows * 0.4 + 2.0))
    scene.upsert_instance(150, version=0, geometry=50, material=2)
    return scene


def build_strands_scene(n_strands: int = 800, seed: int = 7) -> RayTracerScene:
    """Hair tuft of cubic B-spline strands over a ground plane: each strand
    is one cubic segment of 4 control points (root to drooping tip), baked
    into 6 sphere-swept sub-segments. Deterministic for a seed, and the
    same scene as the reference's for the same arguments."""
    rng = np.random.default_rng(seed)
    points, segments = [], []
    for _ in range(n_strands):
        root = np.array([rng.normal(0, 0.25), 0.0, rng.normal(0, 0.25)],
                        np.float32)
        sway = rng.normal(0, 0.12, size=2)
        ctrl = [root,
                root + [sway[0] * 0.3, 0.45, sway[1] * 0.3],
                root + [sway[0] * 0.8, 0.85, sway[1] * 0.8],
                root + [sway[0] * 1.4, 1.0 + rng.normal(0, 0.1),
                        sway[1] * 1.4]]
        radii = (0.012, 0.009, 0.006, 0.003)
        segments.append(len(points))
        for p, r in zip(ctrl, radii):
            points.append([*p, r, 0.35, 0.25, 0.12, 1.0])
    scene = RayTracerScene()
    scene.upsert_geometry(
        1, version=0, renderer_type=RendererType.CURVE,
        geometry_type=GeometryType.CUBIC_BSPLINE,
        strand_points=np.asarray(points, np.float32),
        curve_segments=np.asarray(segments, np.int32))
    scene.upsert_material(2, version=0, properties=MaterialProperties(
        albedo_color=(0.35, 0.25, 0.12), roughness=0.9, metallic=0.0))
    scene.upsert_instance(3, version=0, geometry=1, material=2)
    scene.upsert_geometry(4, version=0, mesh=make_plane(4.0))
    scene.upsert_material(5, version=0, properties=MaterialProperties(
        albedo_color=(0.55, 0.55, 0.55), roughness=1.0, metallic=0.0))
    scene.upsert_instance(6, version=0, geometry=4, material=5)
    return scene


def build_btf_sphere_scene(seed: int = 2) -> RayTracerScene:
    """A CompressedBTF (MLVQ) sphere over a grey plane (ref
    procedural.py:237-258): the synthetic database of ``seed`` on the
    config-3 sphere."""
    scene = RayTracerScene()
    scene.upsert_geometry(1, version=0, mesh=make_sphere(0.6, rings=24, sectors=48))
    scene.upsert_material(2, version=0, material_type=MaterialType.COMPRESSED_BTF,
                          btf=synthetic_btf(seed=seed))
    scene.upsert_instance(3, version=0, geometry=1, material=2)
    scene.upsert_geometry(4, version=0, mesh=make_plane_under_sphere())
    scene.upsert_material(5, version=0, properties=MaterialProperties(
        albedo_color=(0.5, 0.5, 0.5), roughness=1.0, metallic=0.0))
    scene.upsert_instance(6, version=0, geometry=4, material=5)
    return scene


def make_plane_under_sphere() -> Mesh:
    """A 3 x 3 plane 0.65 below the origin (ref procedural.py:261-268)."""
    m = make_plane(3.0)
    p = m.positions.copy()
    p[:, 1] -= 0.65
    return Mesh(positions=p, triangles=m.triangles, normals=m.normals,
                tex_coords=m.tex_coords)
