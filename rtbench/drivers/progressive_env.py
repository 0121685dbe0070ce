"""Driver of ``render_frames_counted`` under a ray-dependent environment:
the progressive frames of ``progressive.py`` lit by the configuration's
``lighting`` (the Nishita sky of ``Skydome``), so that every segment runs
K1's miss-plane form and the miss hook.

Traffic parameters and what the seed picks: as ``progressive.py``. After
the warm-up the program's launch counters and its missed-ray total are
cleared (``kernels.reset_launches``); ``counters()`` adds the rays the
hook found missed, when the program counts them.

Check (``cells/<cell>.json``): as ``progressive.py``'s, against the plain
reference under the same sky (``reference/sky.py``).
"""

from __future__ import annotations

import time

import torch

from rtbench.core import registry
from rtbench.core.window import sync
from rtbench.drivers import _store, progressive
from rtbench.reference import render, sky


def environment(spec: dict, lighting: dict):
    """The program's ``EnvironmentProperties`` of a scene's flat colour
    under the configuration's ``lighting``."""
    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
    from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties

    return EnvironmentProperties(
        lighting_type=EnvironmentalLightingType[lighting["type"]],
        skylight_intensity=lighting["skylight"], gamma=lighting["gamma"],
        ambient_light_intensity=lighting["ambient"],
        sun_direction=tuple(lighting["sun_direction"]),
        color=tuple(spec["environment"]["color"]),
        earth_radius=lighting["earth_radius_km"],
        atmosphere_radius=lighting["atmosphere_radius_km"],
        hr=lighting["hr_m"], hm=lighting["hm_m"], g=lighting["g"],
        num_samples=lighting["view_samples"],
        num_samples_light=lighting["light_samples"])


class Session(progressive.Session):
    def __init__(self, cell, seed, device, split):
        from raytracerfacility_tpu_torch.models import pathtracer
        from raytracerfacility_tpu_torch.ops.camera import CameraProperties

        self.pathtracer = pathtracer
        self.cell, self.seed, self.device = cell, seed, device
        t = cell["traffic"]
        self.width, self.height = int(t["width"]), int(t["height"])
        self.frames = int(t["frames_per_call"])
        self.bounces = int(cell["config"]["bounces"])
        lighting = cell["config"]["lighting"]
        _store.load_kernels(device, split)

        t0 = time.perf_counter()
        self.spec = registry.scene(cell["config"])
        self.scene = _store.scene_store(self.spec).build(device)
        cam = CameraProperties(fov=self.spec["camera"]["fov"],
                               size=(self.width, self.height))
        cam.look_at_target(self.spec["camera"]["eye"], self.spec["camera"]["target"])
        self.camera = cam.state(device)
        props = environment(self.spec, lighting)
        self.env = props.state(device)
        self.config = pathtracer.RenderConfig(
            width=self.width, height=self.height, bounces=self.bounces, samples=1,
            lighting_type=props.lighting_type,
            atmosphere_samples=props.num_samples,
            atmosphere_samples_light=props.num_samples_light)
        sync(device)
        split["bake"] = time.perf_counter() - t0

        self.start = seed % int(t["start_frames"])
        t0 = time.perf_counter()
        for _ in range(int(t["warmup_calls"])):
            scratch = pathtracer.init_frame(self.width, self.height, device)
            pathtracer.render_frames_counted(self.scene, self.camera, self.env,
                                             self.config, scratch, self.frames)
        sync(device)
        split["warmup"] = time.perf_counter() - t0

        self.frame = pathtracer.init_frame(self.width, self.height, device)
        self.frame = type(self.frame)(color=self.frame.color, normal=self.frame.normal,
                                      albedo=self.frame.albedo, frame_id=self.start)
        self.pix = progressive._pixels(seed, self.width, self.height,
                                       int(cell["check"]["pixels"]), device)
        self.rays = torch.zeros((), dtype=torch.int64, device=device)
        self.answers = {}
        self.calls = 0
        # the launch counters and, where the program keeps it, its
        # missed-ray total
        _store.reset_launches()

    def counters(self):
        out = super().counters()
        from raytracerfacility_tpu_torch.ops import environment as env_ops

        if hasattr(env_ops, "missed_rays"):  # a program that counts them
            missed = env_ops.missed_rays(self.device)
            out["missed_rays"] = missed
            out["missed_rays_per_sample"] = missed / (out["samples_per_call"] * self.calls)
            out["missed_primary_rays_per_sample"] = (
                env_ops.missed_rays(self.device, written_out=True)
                / (out["samples_per_call"] * self.calls))
        return out

    def check(self):
        recorded = sorted(self.answers)
        program = {"color": torch.stack([self.answers[k] for k in recorded]),
                   "normal": self.frame.normal.reshape(-1, 4)[self.pix, :3].clone(),
                   "albedo": self.frame.albedo.reshape(-1, 4)[self.pix, :3].clone()}
        calls = self.calls
        # the program's state goes before the reference runs
        del self.scene, self.frame, self.answers, self.camera, self.env
        if self.device != "cpu":
            torch.cuda.empty_cache()
        ref = reference(self.cell, self.seed, calls, self.device)
        ref["color"] = ref["color"][recorded]
        return progressive.numbers(program, ref, self.cell["check"]["limits"])


def reference(cell, seed, calls, device, dtype=torch.float32) -> dict:
    """``progressive.reference`` under the configuration's sky: the sampled
    pixels' colour after each call (calls, P, 3), their first-hit normal
    and albedo in the last frame, and the missed ray-segments of every
    frame traced."""
    t = cell["traffic"]
    width, height, frames = int(t["width"]), int(t["height"]), int(t["frames_per_call"])
    spec = registry.scene(cell["config"])
    lighting = cell["config"]["lighting"]
    tris = render.bake(spec, device, dtype)
    pix = progressive._pixels(seed, width, height, int(cell["check"]["pixels"]), device)
    start = seed % int(t["start_frames"])
    ids = list(range(start, start + calls * frames))
    block = max(frames, (progressive.FRAMES_PER_BLOCK // frames) * frames)
    out, prev, last, missed = [], None, None, 0
    for b0 in range(0, len(ids), block):
        col, nrm, alb, _, miss = sky.render_pixels_env(
            tris, spec, lighting, width, height, int(cell["config"]["bounces"]), pix,
            ids[b0:b0 + block], dtype)
        enc, prev = render.accumulate(col, ids[b0], prev=prev, frames_per_call=frames)
        out.append(enc)
        last = (nrm[-1], alb[-1])
        missed += miss
    return {"color": torch.cat(out), "normal": last[0], "albedo": last[1],
            "missed": missed}


def control(cell, seed, calls, device, dtype=torch.bfloat16) -> dict:
    """The control: the reference computed in ``dtype`` put in the
    program's place, judged as the program is."""
    low = {k: v.to(torch.float32) for k, v in
           reference(cell, seed, calls, device, dtype).items() if k != "missed"}
    return progressive.numbers(low, reference(cell, seed, calls, device),
                               cell["check"]["limits"])


def setup(cell, seed, device, split):
    return Session(cell, seed, device, split)
