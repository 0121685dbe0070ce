"""BASELINE config 2's scene (``__graft_entry__._bench_scene``, ported as
``scenes.bench_scene``): a 2 x 2 Cornell box (red left, green right
wall), a glossy metallic sphere of radius 0.35 (24 rings, 48 sectors) and
a 6 x 6 grid of 0.12 cubes as one instanced geometry; 2,816 triangles.
The camera looks from (0, 1.1, 2.6) at (0, 0.8, 0) with a 70-degree
field of view; the flat Scene sky at skylight 1."""

from __future__ import annotations

import numpy as np

from rtbench.scenes.meshes import make_cornell_box, make_cube, make_sphere


def _material(albedo, roughness, metallic) -> dict:
    return {"albedo": tuple(float(a) for a in albedo), "roughness": float(roughness),
            "metallic": float(metallic), "emission": 0.0}


def build(fov: float = 70.0) -> dict:
    objects = [{"mesh": mesh, "instance": transform, "sub": None,
                "material": _material(color, 1.0, 0.0)}
               for mesh, transform, color in make_cornell_box(2.0)]
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = (-0.4, 0.35, 0.2)
    objects.append({"mesh": make_sphere(0.35, rings=24, sectors=48), "instance": t,
                    "sub": None, "material": _material((0.9, 0.75, 0.3), 0.25, 0.8)})
    grid = []
    for gx in range(6):
        for gz in range(6):
            m = np.eye(4, dtype=np.float32)
            m[:3, 3] = (-0.75 + 0.3 * gx, 0.06, -0.75 + 0.3 * gz)
            grid.append(m)
    objects.append({"mesh": make_cube(0.12), "instance": np.eye(4, dtype=np.float32),
                    "sub": np.stack(grid),
                    "material": _material((0.4, 0.5, 0.9), 0.6, 0.2)})
    return {"objects": objects,
            "camera": {"eye": (0.0, 1.1, 2.6), "target": (0.0, 0.8, 0.0), "fov": fov},
            "environment": {"skylight_intensity": 1.0, "color": (1.0, 1.0, 1.0),
                            "gamma": 1.0, "ambient_light_intensity": 0.1},
            "probes": None}
