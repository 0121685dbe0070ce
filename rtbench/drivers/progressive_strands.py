"""Driver of ``render_frames_counted`` on a scene of strands: the
progressive frames of ``progressive.py`` over the configuration's cubic
B-spline strands, which the program traces on its wavefront engine (K3 on
sphere-swept curves, then the curve shade).

The session and the control are ``progressive``'s with two parts of its
module replaced while they run: the scene store (``_store.scene_store``,
which builds meshes only) by :func:`scene_store`, which hands the program
the scene's meshes and then its strands as one CURVE geometry; and the
plain reference by :func:`reference` (``reference/strands.py``). Traffic
parameters, what the seed picks, the recorded answers and the numbers
compared are ``progressive.py``'s. After the warm-up the program's launch
counters are cleared; ``counters()`` adds the strands' segments and, where
the program counts them (``pathtracer.curve_hits``), its closest hits on
curve rows since then.
"""

from __future__ import annotations

import contextlib
import types

import torch

from rtbench.core import registry
from rtbench.drivers import _store, progressive
from rtbench.reference import render, strands


def scene_store(spec: dict):
    """A ``RayTracerScene`` holding the benchmark scene's objects
    (``_store.scene_store``), then its strands: one CURVE geometry of
    cubic B-splines, with its material and an identity instance."""
    from raytracerfacility_tpu_torch.enums import GeometryType, RendererType
    from raytracerfacility_tpu_torch.scene import MaterialProperties

    store = _store.scene_store(spec)
    s = spec["strands"]
    store.upsert_geometry(900, version=0, renderer_type=RendererType.CURVE,
                          geometry_type=GeometryType.CUBIC_BSPLINE,
                          strand_points=s["points"], curve_segments=s["segments"])
    mat = s["material"]
    store.upsert_material(901, version=0, properties=MaterialProperties(
        albedo_color=tuple(mat["albedo"]), roughness=mat["roughness"],
        metallic=mat["metallic"], emission=mat.get("emission", 0.0)))
    store.upsert_instance(902, version=0, geometry=900, material=901)
    return store


@contextlib.contextmanager
def _strands_parts():
    """``progressive``'s scene store and reference replaced by this
    driver's for the length of the block."""
    saved = progressive._store, progressive.reference
    progressive._store = types.SimpleNamespace(**{**vars(_store),
                                                  "scene_store": scene_store})
    progressive.reference = reference
    try:
        yield
    finally:
        progressive._store, progressive.reference = saved


class Session(progressive.Session):
    def __init__(self, cell, seed, device, split):
        with _strands_parts():
            super().__init__(cell, seed, device, split)

    def counters(self):
        from raytracerfacility_tpu_torch.models import pathtracer

        out = super().counters()
        out["curve_segments"] = strands.SUBDIVISIONS * len(self.spec["strands"]["segments"])
        if hasattr(pathtracer, "curve_hits"):  # a program that counts them
            hits = pathtracer.curve_hits(self.device)
            out["curve_hits"] = hits
            out["curve_hits_per_sample"] = hits / (out["samples_per_call"] * self.calls)
        return out

    def check(self):
        with _strands_parts():
            return super().check()


def reference(cell, seed, calls, device, dtype=torch.float32) -> dict:
    """``progressive.reference`` on the strands: the sampled pixels' colour
    after each call (calls, P, 3) and their first-hit normal and albedo in
    the last frame."""
    t = cell["traffic"]
    width, height, frames = int(t["width"]), int(t["height"]), int(t["frames_per_call"])
    spec = registry.scene(cell["config"])
    prims = strands.bake(spec, device, dtype)
    pix = progressive._pixels(seed, width, height, int(cell["check"]["pixels"]), device)
    start = seed % int(t["start_frames"])
    ids = list(range(start, start + calls * frames))
    block = max(frames, (progressive.FRAMES_PER_BLOCK // frames) * frames)
    out, prev, last = [], None, None
    for b0 in range(0, len(ids), block):
        col, nrm, alb, _, _ = strands.render_pixels(
            prims, spec, width, height, int(cell["config"]["bounces"]), pix,
            ids[b0:b0 + block], dtype)
        enc, prev = render.accumulate(col, ids[b0], prev=prev, frames_per_call=frames)
        out.append(enc)
        last = (nrm[-1], alb[-1])
    return {"color": torch.cat(out), "normal": last[0], "albedo": last[1]}


def control(cell, seed, calls, device, dtype=torch.bfloat16) -> dict:
    """``progressive.control`` with this driver's reference: the reference
    computed in ``dtype`` put in the program's place."""
    with _strands_parts():
        return progressive.control(cell, seed, calls, device, dtype)


def setup(cell, seed, device, split):
    return Session(cell, seed, device, split)
