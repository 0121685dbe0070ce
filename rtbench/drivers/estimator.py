"""Driver of ``TriangleIlluminationEstimator.sample_light_probe_group``:
per-triangle illumination over a canopy, a fresh estimator seed every
call, the flux read on the host.

Traffic parameters: ``samples`` (hemisphere samples a probe face) and
``warmup_calls``. The seed picks the estimator seeds of the calls
(``call_seed``) and the probes and calls the check samples; no size
depends on it.

Check (``cells/<cell>.json``): ``probes`` sampled from the seed, their
energy and direction recorded after every recorded call (each call of the
measured window, and the last call of a traced run); ``calls`` of those
drawn from the seed (the last among them) are traced again by the plain
reference; the last call's flux against a float64 reduction of the
program's energies over the benchmark's own probe areas. The flux check
covers the reduction alone: the energies it sums are the program's, and
are checked against the reference on the sampled probes only.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench.core import registry
from rtbench.core.window import sync
from rtbench.drivers import _store
from rtbench.reference import compare, render

MASK32 = 0xFFFFFFFF
# probe rays (probes x 2 faces x samples) the control traces in one block
CONTROL_RAYS = 1 << 17


def call_seed(seed: int, k: int) -> int:
    """The estimator seed of call ``k`` (warm-up calls are negative)."""
    return (seed * 0x9E3779B1 + (k + 2) * 0x85EBCA6B) & MASK32


def _sample(seed: int, n: int, count: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 1])
    return np.sort(rng.choice(n, size=min(count, n), replace=False))


def _check_calls(seed: int, recorded: list, count: int) -> list:
    """``count`` of the ``recorded`` calls drawn from the seed, the last
    recorded call among them."""
    rng = np.random.default_rng([seed, 2])
    rest = recorded[:-1]
    picked = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False)
    return sorted(rest[i] for i in picked.tolist()) + [recorded[-1]]


class Session:
    def __init__(self, cell, seed, device, split):
        from raytracerfacility_tpu_torch.models import illumination, pathtracer
        from raytracerfacility_tpu_torch.scene.mesh import Mesh

        self.illumination = illumination
        self.cell, self.seed, self.device = cell, seed, device
        t = cell["traffic"]
        self.samples = int(t["samples"])
        _store.load_kernels(device, split)

        t0 = time.perf_counter()
        self.spec = registry.scene(cell["config"])
        self.scene = _store.scene_store(self.spec).build(device)
        self.env = _store.environment(self.spec).state(device)
        self.config = pathtracer.RenderConfig(bounces=int(cell["config"]["bounces"]),
                                              samples=self.samples)
        meshes = {}
        items = []
        for m, w in self.spec["probes"]:
            if id(m) not in meshes:
                meshes[id(m)] = Mesh(positions=m["positions"], triangles=m["triangles"],
                                     normals=m["normals"], tex_coords=m["tex_coords"])
            items.append((meshes[id(m)], w))
        self.est = illumination.TriangleIlluminationEstimator()
        self.est.prepare_light_probe_group(items, device)
        self.n_probes = self.est.probes.num_probes
        sync(device)
        split["bake"] = time.perf_counter() - t0

        # the program's live-ray total of each call, read through its
        # counted entry
        self._counted = illumination.estimate_illumination_counted
        self.rays = torch.zeros((), dtype=torch.int64, device=device)

        def counted(*args, **kwargs):
            out, rays = self._counted(*args, **kwargs)
            self.rays = self.rays + rays
            return out, rays

        illumination.estimate_illumination_counted = counted

        t0 = time.perf_counter()
        for k in range(-int(t["warmup_calls"]), 0):
            self.est.sample_light_probe_group(self.scene, self.env, self.config,
                                              seed=call_seed(seed, k))
        sync(device)
        split["warmup"] = time.perf_counter() - t0

        self.idx = torch.tensor(_sample(seed, self.n_probes, int(cell["check"]["probes"])),
                                device=device)
        self.rays.zero_()
        self.energy, self.direction = {}, {}
        self.calls = 0
        _store.reset_launches()

    def call(self):
        self.est.sample_light_probe_group(self.scene, self.env, self.config,
                                          seed=call_seed(self.seed, self.calls))
        self.calls += 1

    def record(self):
        """The sampled probes' energy and direction after the latest call."""
        self.energy[self.calls - 1] = self.est.probes.energy[self.idx].clone()
        self.direction[self.calls - 1] = self.est.probes.direction[self.idx].clone()

    def live_rays(self) -> int:
        return int(self.rays)

    def route(self):
        return _store.launches_per_call(self.calls)

    def counters(self):
        live = int(self.rays)
        samples = self.n_probes * 2 * self.samples
        return {"samples_per_call": samples, "live_rays": live,
                "live_rays_per_sample": live / (samples * self.calls),
                "triangles": _store.triangles(self.spec), "probes": self.n_probes,
                "calls": self.calls}

    def check(self):
        self.illumination.estimate_illumination_counted = self._counted
        picked = _check_calls(self.seed, sorted(self.energy),
                              int(self.cell["check"]["calls"]))
        program = {"energy": torch.stack([self.energy[k] for k in picked]),
                   "direction": torch.stack([self.direction[k] for k in picked]),
                   "all_energy": self.est.probes.energy.clone(),
                   "flux": torch.tensor(np.asarray(self.est.total_flux, np.float64))}
        del self.scene, self.est, self.energy, self.direction, self.env
        if self.device != "cpu":
            torch.cuda.empty_cache()
        ref = reference(self.cell, self.seed, picked, self.device)
        return numbers(program, ref, self.cell["check"]["limits"])


def reference(cell, seed, picked, device, dtype=torch.float32) -> dict:
    """The plain reference's energy and direction of the sampled probes
    in the ``picked`` calls (C, P, 3), and the probe areas (float64)."""
    spec = registry.scene(cell["config"])
    tris = render.bake(spec, device, dtype)
    pos, nrm, area = render.probe_triangles(spec["probes"], device, dtype)
    idx = torch.tensor(_sample(seed, pos.shape[0], int(cell["check"]["probes"])),
                       device=device)
    energy, direction = [], []
    for k in picked:
        e, d, _ = render.estimate_probes(tris, spec, pos, nrm, idx, call_seed(seed, k),
                                         int(cell["traffic"]["samples"]),
                                         int(cell["config"]["bounces"]), dtype)
        energy.append(e)
        direction.append(d)
    return {"energy": torch.stack(energy), "direction": torch.stack(direction),
            "area": area}


def numbers(program: dict, ref: dict, limits: dict) -> dict:
    """The cell's numbers: the energy's gaps (99th percentile and mean)
    over the sampled probes of the checked calls, relative to the mean
    magnitude of the reference's energy; the 99th percentile of the
    direction's gaps where the reference's energy is not 0; the last
    call's flux against the reference's reduction of the program's
    energies (the largest relative gap of the three channels)."""
    scale = float(ref["energy"].to(torch.float64).abs().mean()) or 1.0
    e99, emean = compare.gap_stats(program["energy"], ref["energy"])
    lit = ref["energy"].abs().sum(-1) > 0
    d99, _ = compare.gap_stats(program["direction"][lit], ref["direction"][lit])
    area = ref["area"].to(program["all_energy"].device)
    flux = (program["all_energy"].to(torch.float64) * area[:, None]).sum(0).cpu()
    flux_rel = float(((program["flux"].to(torch.float64) - flux).abs()
                      / flux.abs().clamp(min=1e-30)).max())
    return compare.checks({"energy_p99": e99 / scale, "energy_mean": emean / scale,
                           "direction_p99": d99, "flux_rel": flux_rel}, limits)


def control(cell, seed, calls, device, dtype=torch.bfloat16) -> dict:
    """The control: the reference computed in ``dtype`` put in the
    program's place, judged as the program is over a window of ``calls``
    calls. Its flux is the ``dtype`` reduction of its own energies over
    every probe (the whole reference run in ``dtype``)."""
    spec = registry.scene(cell["config"])
    picked = _check_calls(seed, list(range(calls)), int(cell["check"]["calls"]))
    low = reference(cell, seed, picked, device, dtype)
    tris = render.bake(spec, device, dtype)
    pos, nrm, area = render.probe_triangles(spec["probes"], device, dtype)
    every = torch.arange(pos.shape[0], device=device)
    energy = []
    block = max(1, CONTROL_RAYS // (2 * int(cell["traffic"]["samples"])))
    for b0 in range(0, every.numel(), block):
        e, _, _ = render.estimate_probes(tris, spec, pos, nrm, every[b0:b0 + block],
                                         call_seed(seed, picked[-1]),
                                         int(cell["traffic"]["samples"]),
                                         int(cell["config"]["bounces"]), dtype)
        energy.append(e)
    energy = torch.cat(energy)
    flux = (energy * area.to(dtype)[:, None]).sum(0)
    program = {"energy": low["energy"].float(), "direction": low["direction"].float(),
               "all_energy": energy.float(), "flux": flux.double().cpu()}
    return numbers(program, reference(cell, seed, picked, device),
                   cell["check"]["limits"])


def setup(cell, seed, device, split):
    return Session(cell, seed, device, split)
