"""BASELINE config 4's scene (``bench.py:197-241``, ported as
``scenes.canopy_illumination``): a rows x cols sorghum canopy of 4 plant
variants (one instanced geometry each over consecutive runs of the
jittered grid's transforms) over a ground plane, and one light probe per
plant triangle; the flat Scene sky at skylight 1. At 17 x 17: 289
plants, 110,976 probes and 110,978 triangles."""

from __future__ import annotations

import numpy as np

from rtbench.scenes.meshes import make_canopy_instances, make_plane, make_sorghum_plant

_LEAF = {"albedo": (0.35, 0.55, 0.18), "roughness": 1.0, "metallic": 0.0, "emission": 0.0}
_GROUND = {"albedo": (0.35, 0.25, 0.15), "roughness": 1.0, "metallic": 0.0, "emission": 0.0}


def build(rows: int = 17, cols: int = 17, variants: int = 4) -> dict:
    mats = make_canopy_instances(rows, cols, seed=0)
    per = (rows * cols + variants - 1) // variants
    plants = [make_sorghum_plant(seed=v) for v in range(variants)]
    objects, probes = [], []
    for v in range(variants):
        chunk = mats[v * per:(v + 1) * per]
        if chunk.shape[0] == 0:
            continue
        objects.append({"mesh": plants[v], "instance": np.eye(4, dtype=np.float32),
                        "sub": chunk, "material": dict(_LEAF)})
        probes.extend((plants[v], m) for m in chunk)
    objects.append({"mesh": make_plane(rows * 0.4 + 2.0),
                    "instance": np.eye(4, dtype=np.float32), "sub": None,
                    "material": dict(_GROUND)})
    return {"objects": objects, "camera": None,
            "environment": {"skylight_intensity": 1.0, "color": (1.0, 1.0, 1.0),
                            "gamma": 1.0, "ambient_light_intensity": 0.1},
            "probes": probes}
