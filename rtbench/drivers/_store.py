"""Hand a benchmark scene to the program through its public scene store
(``RayTracerScene.upsert_*``), and the program's kernel libraries and
launch counters."""

from __future__ import annotations

import time

import numpy as np


def scene_store(spec: dict):
    """A ``RayTracerScene`` holding the objects of a benchmark scene: one
    geometry, material and instance each; an object with ``sub``
    matrices becomes an INSTANCED geometry."""
    from raytracerfacility_tpu_torch.enums import RendererType
    from raytracerfacility_tpu_torch.scene import MaterialProperties, RayTracerScene
    from raytracerfacility_tpu_torch.scene.mesh import Mesh

    store = RayTracerScene()
    for k, obj in enumerate(spec["objects"]):
        m = obj["mesh"]
        mesh = Mesh(positions=m["positions"], triangles=m["triangles"],
                    normals=m["normals"], tex_coords=m["tex_coords"])
        extras = {}
        if obj["sub"] is not None:
            extras = {"renderer_type": RendererType.INSTANCED,
                      "instance_matrices": np.asarray(obj["sub"], np.float32)}
        store.upsert_geometry(1000 + k, version=0, mesh=mesh, **extras)
        mat = obj["material"]
        store.upsert_material(2000 + k, version=0, properties=MaterialProperties(
            albedo_color=tuple(mat["albedo"]), roughness=mat["roughness"],
            metallic=mat["metallic"], emission=mat.get("emission", 0.0)))
        store.upsert_instance(3000 + k, version=0, geometry=1000 + k,
                              material=2000 + k, transform=obj["instance"])
    return store


def environment(spec: dict):
    from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties

    env = spec["environment"]
    return EnvironmentProperties(skylight_intensity=env["skylight_intensity"],
                                 color=tuple(env["color"]), gamma=env["gamma"],
                                 ambient_light_intensity=env["ambient_light_intensity"])


def load_kernels(device: str, split: dict) -> None:
    """Build (first run in a checkout) and load every kernel library."""
    t0 = time.perf_counter()
    if device != "cpu":
        from raytracerfacility_tpu_torch import kernels

        kernels.build()
        for name in kernels.SOURCES:
            kernels.library(name)
    split["kernels"] = time.perf_counter() - t0


def reset_launches() -> None:
    from raytracerfacility_tpu_torch import kernels

    kernels.reset_launches()


def launches_per_call(calls: int) -> dict:
    """The program's launch counters since the last reset, per call, for
    the kernels that ran."""
    from raytracerfacility_tpu_torch import kernels

    return {k: v / max(calls, 1) for k, v in kernels.LAUNCHES.items() if v}


def triangles(spec: dict) -> int:
    """World triangles of a benchmark scene, counted from its inputs."""
    return int(sum(o["mesh"]["triangles"].shape[0]
                   * (1 if o["sub"] is None else len(o["sub"]))
                   for o in spec["objects"]))
