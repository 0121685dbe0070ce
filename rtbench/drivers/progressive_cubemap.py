"""Driver of ``render_frames_counted`` under Scene lighting with a skybox
cubemap: the progressive frames of ``progressive.py`` lit by the
configuration's ``lighting``, so that every segment runs K1's miss-plane
form and the miss hook's cubemap gather.

The environment is built as a user builds it,
``EnvironmentProperties(lighting_type=SCENE, cubemap=faces).state(device)``,
which uploads the faces; making the faces and the upload count in the
bake. Traffic parameters and what the seed picks: as ``progressive.py``,
and the faces' texels: (6, size, size, 4) float32, RGB uniform in the
configuration's ``cubemap_values`` and alpha 1, drawn from the seed.

After the warm-up the program's launch counters and its missed-ray total
are cleared; ``counters()`` adds the rays the hook found missed, as the
sky's driver does, and the faces' bytes. The cubemap's own launch count
(``miss_radiance_kernel<cubemap>``) shows in the route line, where the
program keeps it.

Check (``cells/<cell>.json``): as ``progressive.py``'s, against the plain
reference under the same faces (``reference/cubemap.py``). The control
computes the reference's light in bfloat16 on float32 rays, the precision
below the configuration's where the cubemap acts: the whole path in
bfloat16 turns camera directions into NaN, which reads as infinite and
calibrates nothing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench.core import registry
from rtbench.core.window import sync
from rtbench.drivers import _store, progressive, progressive_env
from rtbench.reference import cubemap, render

# the seed's stream of the faces, apart from the checked pixels'
FACE_STREAM = 1


def faces(seed: int, lighting: dict) -> np.ndarray:
    """The configuration's faces drawn from ``seed``: (6, size, size, 4)
    float32, RGB uniform in [lo, hi) of ``cubemap_values``, alpha 1."""
    size = int(lighting["cubemap_face"])
    lo, hi = (np.float32(v) for v in lighting["cubemap_values"])
    rng = np.random.default_rng((seed, FACE_STREAM))
    out = np.ones((6, size, size, 4), np.float32)
    out[..., :3] = lo + rng.random((6, size, size, 3), dtype=np.float32) * (hi - lo)
    return out


def environment(spec: dict, lighting: dict, seed: int):
    """The program's ``EnvironmentProperties`` under the configuration's
    Scene lighting with the seed's faces."""
    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
    from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties

    return EnvironmentProperties(
        lighting_type=EnvironmentalLightingType[lighting["type"]],
        skylight_intensity=lighting["skylight"], gamma=lighting["gamma"],
        ambient_light_intensity=lighting["ambient"],
        color=tuple(spec["environment"]["color"]), cubemap=faces(seed, lighting))


class Session(progressive_env.Session):
    def __init__(self, cell, seed, device, split):
        from raytracerfacility_tpu_torch.models import pathtracer
        from raytracerfacility_tpu_torch.ops.camera import CameraProperties

        self.pathtracer = pathtracer
        self.cell, self.seed, self.device = cell, seed, device
        t = cell["traffic"]
        self.width, self.height = int(t["width"]), int(t["height"])
        self.frames = int(t["frames_per_call"])
        self.bounces = int(cell["config"]["bounces"])
        _store.load_kernels(device, split)

        t0 = time.perf_counter()
        self.spec = registry.scene(cell["config"])
        self.scene = _store.scene_store(self.spec).build(device)
        cam = CameraProperties(fov=self.spec["camera"]["fov"],
                               size=(self.width, self.height))
        cam.look_at_target(self.spec["camera"]["eye"], self.spec["camera"]["target"])
        self.camera = cam.state(device)
        props = environment(self.spec, cell["config"]["lighting"], seed)
        self.env = props.state(device)
        self.cubemap_bytes = self.env.cubemap.numel() * self.env.cubemap.element_size()
        self.config = pathtracer.RenderConfig(
            width=self.width, height=self.height, bounces=self.bounces, samples=1,
            lighting_type=props.lighting_type)
        del props  # the host's copy of the faces
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
        _store.reset_launches()

    def counters(self):
        return {**super().counters(), "cubemap_bytes": self.cubemap_bytes}

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


def reference(cell, seed, calls, device, dtype=torch.float32, light_dtype=None) -> dict:
    """``progressive.reference`` under the configuration's cubemap: the
    sampled pixels' colour after each call (calls, P, 3), their first-hit
    normal and albedo in the last frame, and the missed ray-segments of
    every frame traced; the light in ``light_dtype`` (by default
    ``dtype``)."""
    t = cell["traffic"]
    width, height, frames = int(t["width"]), int(t["height"]), int(t["frames_per_call"])
    spec = registry.scene(cell["config"])
    lighting = cell["config"]["lighting"]
    tris = render.bake(spec, device, dtype)
    cube = torch.as_tensor(faces(seed, lighting), device=device)
    pix = progressive._pixels(seed, width, height, int(cell["check"]["pixels"]), device)
    start = seed % int(t["start_frames"])
    ids = list(range(start, start + calls * frames))
    block = max(frames, (progressive.FRAMES_PER_BLOCK // frames) * frames)
    out, prev, last, missed = [], None, None, 0
    for b0 in range(0, len(ids), block):
        col, nrm, alb, _, miss = cubemap.render_pixels_cube(
            tris, spec, cube, lighting, width, height, int(cell["config"]["bounces"]),
            pix, ids[b0:b0 + block], dtype, light_dtype)
        enc, prev = render.accumulate(col, ids[b0], prev=prev, frames_per_call=frames)
        out.append(enc)
        last = (nrm[-1], alb[-1])
        missed += miss
    return {"color": torch.cat(out), "normal": last[0], "albedo": last[1],
            "missed": missed}


def control(cell, seed, calls, device, dtype=torch.bfloat16) -> dict:
    """The control: the reference with its light computed in ``dtype`` on
    float32 rays put in the program's place, judged as the program is."""
    low = reference(cell, seed, calls, device, light_dtype=dtype)
    return progressive.numbers(low, reference(cell, seed, calls, device),
                               cell["check"]["limits"])


def setup(cell, seed, device, split):
    return Session(cell, seed, device, split)
