"""The plain reference against the program's plain CPU path on small
scenes (this test imports both; the reference imports nothing of the
program)."""

import numpy as np
import torch

from rtbench.core import registry
from rtbench.drivers import _store
from rtbench.reference import render


def _cfg2(width, height):
    cell = registry.cell("cfg2.progressive_1080p")
    return cell, registry.scene(cell["config"])


def test_progressive_frames_match_the_program():
    from raytracerfacility_tpu_torch.models import pathtracer
    from raytracerfacility_tpu_torch.ops.camera import CameraProperties

    width, height, start, frames = 24, 16, 5, 3
    cell, spec = _cfg2(width, height)
    scene = _store.scene_store(spec).build("cpu")
    cam = CameraProperties(fov=spec["camera"]["fov"], size=(width, height))
    cam.look_at_target(spec["camera"]["eye"], spec["camera"]["target"])
    config = pathtracer.RenderConfig(width=width, height=height, bounces=8)
    frame = pathtracer.init_frame(width, height, "cpu")
    frame = type(frame)(color=frame.color, normal=frame.normal, albedo=frame.albedo,
                        frame_id=start)
    out, rays = pathtracer.render_frames_counted(
        scene, cam.state("cpu"), _store.environment(spec).state("cpu"), config, frame,
        frames)
    pix = torch.arange(width * height)
    col, nrm, alb, segs = render.render_pixels(render.bake(spec, "cpu"), spec, width,
                                               height, 8, pix,
                                               list(range(start, start + frames)))
    enc, _ = render.accumulate(col, start, frames_per_call=frames)
    got = out.color.reshape(-1, 4)[:, :3]
    assert (got - enc[-1]).abs().max() <= 1e-6
    assert (out.normal.reshape(-1, 4)[:, :3] - nrm[-1]).abs().max() <= 1e-6
    assert (out.albedo.reshape(-1, 4)[:, :3] - alb[-1]).abs().max() <= 1e-6
    assert segs == int(rays)


def test_probe_energies_match_the_program():
    from raytracerfacility_tpu_torch.models import illumination, pathtracer
    from raytracerfacility_tpu_torch.scene.mesh import Mesh

    spec = registry.scene({"scene": "sorghum_canopy",
                           "scene_params": {"rows": 2, "cols": 2, "variants": 4}})
    scene = _store.scene_store(spec).build("cpu")
    items = [(Mesh(positions=m["positions"], triangles=m["triangles"],
                   normals=m["normals"], tex_coords=m["tex_coords"]), w)
             for m, w in spec["probes"]]
    probes = illumination.TriangleIlluminationEstimator().prepare_light_probe_group(
        items, "cpu")
    config = pathtracer.RenderConfig(bounces=2, samples=2)
    out = illumination.estimate_illumination(
        scene, _store.environment(spec).state("cpu"), config, probes, seed=77)
    pos, nrm, area = render.probe_triangles(spec["probes"], "cpu")
    e, d, _ = render.estimate_probes(render.bake(spec, "cpu"), spec, pos, nrm,
                                     torch.arange(pos.shape[0]), 77, 2, 2)
    scale = float(e.abs().mean())
    gap = (out.energy - e).abs().flatten()
    assert float(torch.quantile(gap, 0.99)) <= 1e-5 * scale
    assert np.allclose(probes.areas().double().numpy(), area.numpy(), rtol=1e-5)

