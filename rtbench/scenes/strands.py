"""BASELINE config 7's scene (``bench.py:297-321``, ported as
``scenes.strands_scene`` over ``scene/procedural.py::build_strands_scene``):
a hair tuft of ``n_strands`` cubic B-spline strands over a 4 m ground
plane. Each strand is one cubic segment of 4 control points, root to
drooping tip, about 1 m tall, radii 0.012, 0.009, 0.006 and 0.003 m, its
root drawn N(0, 0.25 m) in x and z; the strands' material has roughness
0.9, the plane's is Lambertian grey. The camera looks from (0, 0.9, 2.4)
at (0, 0.55, 0) with a 50-degree field of view; the flat Scene sky at
skylight 1. At 800 strands (seed 7) the bake makes 4,800 sphere-swept
linear segments, 6 a strand, and the plane's 2 triangles.

A frozen copy of the port's generator, kept here so that an edit of the
program's generators cannot move the yardstick: the same numbers go to
the program (through its scene store: the plane's mesh, then the strands
as one CURVE geometry) and to the plain reference (``reference/strands.py``,
which orders its primitives the same way).

The spec: ``objects`` holds the plane (a mesh, as the other scenes'
objects); ``strands`` holds the curve geometry: ``points`` (4S, 8)
float32 (x, y, z, radius, then an RGBA colour the shade does not read),
``segments`` (S,) int32 (the first control point of each strand),
``mode`` (``cubic``) and ``material``.
"""

from __future__ import annotations

import numpy as np

from rtbench.scenes.meshes import make_plane

RADII = (0.012, 0.009, 0.006, 0.003)
_STRAND = {"albedo": (0.35, 0.25, 0.12), "roughness": 0.9, "metallic": 0.0,
           "emission": 0.0}
_GROUND = {"albedo": (0.55, 0.55, 0.55), "roughness": 1.0, "metallic": 0.0,
           "emission": 0.0}


def strands(n_strands: int, seed: int) -> tuple:
    """(points (4 n_strands, 8) float32, segments (n_strands,) int32): the
    control points of ``build_strands_scene(n_strands, seed)``."""
    rng = np.random.default_rng(seed)
    points, segments = [], []
    for _ in range(n_strands):
        root = np.array([rng.normal(0, 0.25), 0.0, rng.normal(0, 0.25)], np.float32)
        sway = rng.normal(0, 0.12, size=2)
        ctrl = [root,
                root + [sway[0] * 0.3, 0.45, sway[1] * 0.3],
                root + [sway[0] * 0.8, 0.85, sway[1] * 0.8],
                root + [sway[0] * 1.4, 1.0 + rng.normal(0, 0.1), sway[1] * 1.4]]
        segments.append(len(points))
        for p, r in zip(ctrl, RADII):
            points.append([*p, r, 0.35, 0.25, 0.12, 1.0])
    return np.asarray(points, np.float32), np.asarray(segments, np.int32)


def build(n_strands: int = 800, seed: int = 7) -> dict:
    points, segments = strands(n_strands, seed)
    return {"objects": [{"mesh": make_plane(4.0), "instance": np.eye(4, dtype=np.float32),
                         "sub": None, "material": dict(_GROUND)}],
            "strands": {"points": points, "segments": segments, "mode": "cubic",
                        "material": dict(_STRAND)},
            "camera": {"eye": (0.0, 0.9, 2.4), "target": (0.0, 0.55, 0.0), "fov": 50.0},
            "environment": {"skylight_intensity": 1.0, "color": (1.0, 1.0, 1.0),
                            "gamma": 1.0, "ambient_light_intensity": 0.1},
            "probes": None}
