"""Driver of ``render_frames_counted``: progressive frames, accumulation
carried across calls.

Traffic parameters: ``width``, ``height``, ``frames_per_call``,
``warmup_calls`` and ``start_frames``: the seed picks the frame id that
accumulation starts from, ``seed % start_frames`` (the frame id seeds every
pixel's RNG stream and weights the history), and the pixels the check
samples. Nothing else depends on the seed.

Check (``cells/<cell>.json``): ``pixels`` sampled from the seed; after
every recorded call (each call of the measured window, and the last call
of a traced run) their gamma-encoded colour, and after the last call
their first-hit normal and albedo, against the plain reference's, which
traces every frame of those pixels from the benchmark's own scene.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench.core import registry
from rtbench.core.window import sync
from rtbench.drivers import _store
from rtbench.reference import compare, render

# frames of the sampled pixels the reference traces in one block
FRAMES_PER_BLOCK = 64


def _pixels(seed: int, width: int, height: int, count: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    pix = rng.choice(width * height, size=min(count, width * height), replace=False)
    return torch.tensor(np.sort(pix), dtype=torch.int64, device=device)


class Session:
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
        self.env = _store.environment(self.spec).state(device)
        self.config = pathtracer.RenderConfig(width=self.width, height=self.height,
                                              bounces=self.bounces, samples=1)
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
        self.pix = _pixels(seed, self.width, self.height,
                           int(cell["check"]["pixels"]), device)
        self.rays = torch.zeros((), dtype=torch.int64, device=device)
        self.answers = {}
        self.calls = 0
        _store.reset_launches()

    def call(self):
        self.frame, rays = self.pathtracer.render_frames_counted(
            self.scene, self.camera, self.env, self.config, self.frame, self.frames)
        self.rays = self.rays + rays
        self.calls += 1

    def record(self):
        """The sampled pixels' colour after the latest call."""
        color = self.frame.color.reshape(-1, 4)[self.pix, :3]
        self.answers[self.calls - 1] = color.clone()

    def live_rays(self) -> int:
        return int(self.rays)

    def route(self):
        return _store.launches_per_call(self.calls)

    def counters(self):
        live = int(self.rays)
        samples = self.width * self.height * self.frames
        return {"samples_per_call": samples, "frames_per_call": self.frames,
                "live_rays": live, "live_rays_per_sample": live / (samples * self.calls),
                "triangles": _store.triangles(self.spec), "calls": self.calls,
                "start_frame": self.start}

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
        return numbers(program, ref, self.cell["check"]["limits"])


def reference(cell, seed, calls, device, dtype=torch.float32) -> dict:
    """The plain reference's answers of a run of ``calls`` calls: the
    sampled pixels' colour after each call (calls, P, 3) and their
    first-hit normal and albedo in the last frame."""
    t = cell["traffic"]
    width, height, frames = int(t["width"]), int(t["height"]), int(t["frames_per_call"])
    spec = registry.scene(cell["config"])
    tris = render.bake(spec, device, dtype)
    pix = _pixels(seed, width, height, int(cell["check"]["pixels"]), device)
    start = seed % int(t["start_frames"])
    ids = list(range(start, start + calls * frames))
    block = max(frames, (FRAMES_PER_BLOCK // frames) * frames)
    out, prev, last = [], None, None
    for b0 in range(0, len(ids), block):
        col, nrm, alb, _ = render.render_pixels(tris, spec, width, height,
                                                int(cell["config"]["bounces"]), pix,
                                                ids[b0:b0 + block], dtype)
        enc, prev = render.accumulate(col, ids[b0], prev=prev, frames_per_call=frames)
        out.append(enc)
        last = (nrm[-1], alb[-1])
    return {"color": torch.cat(out), "normal": last[0], "albedo": last[1]}


def numbers(program: dict, ref: dict, limits: dict) -> dict:
    """The cell's numbers: the colour's gaps over every recorded call and
    sampled pixel (99th percentile and mean), and the 99th percentile of the
    first-hit normal's and albedo's gaps in the last frame."""
    p99, mean = compare.gap_stats(program["color"], ref["color"])
    n99, _ = compare.gap_stats(program["normal"], ref["normal"])
    a99, _ = compare.gap_stats(program["albedo"], ref["albedo"])
    return compare.checks({"color_p99": p99, "color_mean": mean,
                           "aov_p99": max(n99, a99)}, limits)


def control(cell, seed, calls, device, dtype=torch.bfloat16) -> dict:
    """The control: the reference computed in ``dtype`` put in the
    program's place, judged as the program is."""
    low = {k: v.to(torch.float32) for k, v in
           reference(cell, seed, calls, device, dtype).items()}
    return numbers(low, reference(cell, seed, calls, device),
                   cell["check"]["limits"])


def setup(cell, seed, device, split):
    return Session(cell, seed, device, split)
