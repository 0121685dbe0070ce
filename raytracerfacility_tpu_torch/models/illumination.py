"""Per-triangle illumination estimation (the __raygen__IE launch type).

Port of ``raytracerfacility_tpu/models/illumination.py``: ``LightProbes``,
``probes_from_mesh``, ``concat_probes``, ``estimate_illumination``,
``LightProbeGroup`` and ``TriangleIlluminationEstimator``:

* probe prep: one probe per world-space triangle with front/back flags and
  Heron's-formula area (ref TriangleIlluminationEstimator.cpp:94-140,
  RayTracer.hpp:187-211);
* the estimator: per probe, face and sample a uniform barycentric point
  and a uniform hemisphere direction, a full path trace, then the mean of
  E * |N.L| and the energy-weighted mean direction (ref
  ptx/IlluminationEstimation.cu:30-129);
* flux aggregation and the vertex-colour bake (ref
  TriangleIlluminationEstimator.cpp:8-48, 84-92).

The (probe, face, sample) triple is one flat ray pool with a TEA-hashed RNG
stream per ray, as in the reference, made by ``ops/probe.py::probe_rays``
(on the card one ``probe_ray_kernel`` launch).
``models/pathtracer.py::trace_pool`` traces it as a probe pool, on the
engine the reference picks (ref
illumination.py:150-205): with packed path tables the segmented engine
with one exact reorder before segment 0 (``ops/seg.py``, K1) when the
scene has 8 chunks or more, or whatever its size under a cubemap or the
Nishita sky at one sample (then with K1's miss-plane form and the miss
hook, ``miss_radiance_kernel``), else the whole-path kernel (K2), and
K2-SLS under SingleLightSource lighting; without them (curves,
``build_bvh=True``), and under a cubemap or the sky at more samples, the
wavefront engine (K3 or K5). Probe rays start at tmin 1e-3, the camera's
at 0. The reference's jit wrapper ``estimate_illumination_jit`` is a
plain call here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracerfacility_tpu_torch import tracing
from raytracerfacility_tpu_torch.models.pathtracer import RenderConfig, trace_pool
from raytracerfacility_tpu_torch.ops.environment import EnvironmentState
from raytracerfacility_tpu_torch.ops.math3d import dot
from raytracerfacility_tpu_torch.ops.probe import probe_rays
from raytracerfacility_tpu_torch.scene.compiled import CompiledScene
from raytracerfacility_tpu_torch.utils.validation import check_finite

# primary tmin of probe rays (ref illumination.py:162, the XLA engine's)
_PROBE_TMIN = 1e-3


@dataclasses.dataclass(frozen=True)
class LightProbes:
    """SoA ``IlluminationSampler`` array (ref RayTracer.hpp:187-211):
    float32 tensors on one device, the face flags bool."""

    a_position: torch.Tensor  # (P, 3)
    b_position: torch.Tensor
    c_position: torch.Tensor
    a_normal: torch.Tensor  # (P, 3)
    b_normal: torch.Tensor
    c_normal: torch.Tensor
    front_face: torch.Tensor  # (P,) bool
    back_face: torch.Tensor  # (P,) bool
    # outputs
    energy: torch.Tensor  # (P, 3)
    direction: torch.Tensor  # (P, 3)

    @property
    def num_probes(self) -> int:
        return self.a_position.shape[0]

    def areas(self) -> torch.Tensor:
        """Heron's formula (ref RayTracer.hpp:204-210)."""
        norm = torch.linalg.vector_norm
        a = norm(self.a_position - self.b_position, dim=-1)
        b = norm(self.b_position - self.c_position, dim=-1)
        c = norm(self.c_position - self.a_position, dim=-1)
        p = (a + b + c) * 0.5
        return torch.sqrt(torch.clamp(p * (p - a) * (p - b) * (p - c), min=0.0))


# the field names, which are also the keys of LightProbeGroup's .npz files
PROBE_FIELDS = tuple(f.name for f in dataclasses.fields(LightProbes))


def probes_from_arrays(arrays, device) -> LightProbes:
    """LightProbes from a mapping of :data:`PROBE_FIELDS` to arrays (the
    reference's fields as numpy, or a saved group): float32 (P, 3) vectors
    and bool (P,) face flags on ``device``."""
    missing = [k for k in PROBE_FIELDS if k not in arrays]
    if missing:
        raise ValueError(f"light probe fields missing: {missing}")
    out = {}
    p = np.asarray(arrays["a_position"]).shape[0]
    for k in PROBE_FIELDS:
        flag = k.endswith("_face")
        a = np.asarray(arrays[k], bool if flag else np.float32)
        if a.shape != ((p,) if flag else (p, 3)):
            raise ValueError(f"light probe field {k} has shape {a.shape} for {p} probes")
        out[k] = torch.tensor(a, device=device)
    return LightProbes(**out)


def probes_from_mesh(mesh, transform: np.ndarray, device, front_face: bool = True,
                     back_face: bool = True) -> LightProbes:
    """One probe per triangle of a mesh under a world transform, on
    ``device`` (ref TriangleIlluminationEstimator.cpp:107-137). Front/back
    flags follow the material cull mode in the reference; callers pass them
    explicitly."""
    tm = np.asarray(transform, np.float32)
    pos = mesh.positions @ tm[:3, :3].T + tm[:3, 3]
    nrm = mesh.normals @ tm[:3, :3].T
    t = mesh.triangles
    p = t.shape[0]
    zeros = np.zeros((p, 3), np.float32)
    return probes_from_arrays(dict(
        a_position=pos[t[:, 0]], b_position=pos[t[:, 1]], c_position=pos[t[:, 2]],
        a_normal=nrm[t[:, 0]], b_normal=nrm[t[:, 1]], c_normal=nrm[t[:, 2]],
        front_face=np.full(p, front_face), back_face=np.full(p, back_face),
        energy=zeros, direction=zeros), device)


def concat_probes(groups: list[LightProbes]) -> LightProbes:
    return LightProbes(**{k: torch.cat([getattr(g, k) for g in groups])
                          for k in PROBE_FIELDS})


def estimate_illumination_counted(
    scene: CompiledScene,
    env: EnvironmentState,
    config: RenderConfig,
    probes: LightProbes,
    seed: int = 0,
    push_normal_distance: float = 0.001,
    probe_offset: int = 0,
):
    """:func:`estimate_illumination` that also returns the live rays traced
    over all segments (an int64 scalar tensor on the scene's device)."""
    p, s = probes.num_probes, config.samples
    with tracing.span("estimator.prep"):
        origin, ray_dir, normal, rng = probe_rays(probes, s, seed, push_normal_distance,
                                                  probe_offset)

    n_rays = p * 2 * s
    radiance, _, _, _, rays = trace_pool(
        scene, env, config, origin.reshape(n_rays, 3), ray_dir.reshape(n_rays, 3),
        rng.reshape(n_rays), _PROBE_TMIN, probe=True)
    with tracing.span("estimator.reduce"):
        path_radiance = radiance.reshape(p, 2, s, 3)

        ndotl = torch.abs(dot(normal, ray_dir))[..., None]
        # face masking per probe flags
        face_on = torch.stack([probes.front_face, probes.back_face], dim=1)[..., None, None]
        sample_energy = torch.where(face_on, path_radiance * ndotl, 0.0)  # (P, 2, S, 3)
        weighted_dir = torch.where(
            face_on,
            ray_dir * torch.linalg.vector_norm(sample_energy, dim=-1, keepdim=True),
            0.0)

        sample_count = torch.sum(face_on[:, :, 0, 0], dim=1) * s  # (P,)
        total_energy = torch.sum(sample_energy, dim=(1, 2))  # (P, 3)
        total_dir = torch.sum(weighted_dir, dim=(1, 2))  # (P, 3)
        seen = (sample_count > 0)[:, None]
        denom = torch.clamp(sample_count, min=1)[:, None].to(torch.float32)
        energy = torch.where(seen, total_energy / denom, probes.energy)
        norm = torch.linalg.vector_norm(total_dir, dim=-1, keepdim=True)
        direction = torch.where(seen & (norm > 0),
                                total_dir / torch.clamp(norm, min=1e-20), probes.direction)
    return dataclasses.replace(probes, energy=energy, direction=direction), rays


def estimate_illumination(scene, env, config, probes, seed=0,
                          push_normal_distance=0.001, probe_offset=0) -> LightProbes:
    """The __raygen__IE equivalent (ref ptx/IlluminationEstimation.cu:30-129).

    Returns probes with ``energy`` (mean of E * |N.L| over all traced
    samples) and ``direction`` (energy-magnitude-weighted mean ray
    direction, normalized) filled in. ``probe_offset`` biases the RNG
    stream index (a probe's global index when the probes are split)."""
    return estimate_illumination_counted(scene, env, config, probes, seed,
                                         push_normal_distance, probe_offset)[0]


@dataclasses.dataclass
class LightProbeGroup:
    """A probe buffer and its estimator launch (ref LightProbeGroup.cpp:8-15);
    ``save``/``load`` keep it as ``.npz`` with the reference's field names,
    so files move between the two packages."""

    light_probes: LightProbes | None = None

    def calculate_illumination(self, scene, env, config, seed=0,
                               push_normal_distance=0.001) -> LightProbes:
        if self.light_probes is None:
            raise ValueError("the group has no light probes")
        self.light_probes = estimate_illumination(
            scene, env, config, self.light_probes, seed, push_normal_distance)
        return self.light_probes

    def save(self, path: str) -> None:
        if self.light_probes is None:
            raise ValueError("the group has no light probes")
        np.savez(path, **{k: getattr(self.light_probes, k).cpu().numpy()
                          for k in PROBE_FIELDS})

    @classmethod
    def load(cls, path: str, device) -> "LightProbeGroup":
        with np.load(path) as z:
            return cls(light_probes=probes_from_arrays(
                {k: z[k] for k in z.files}, device))


@dataclasses.dataclass
class TriangleIlluminationEstimator:
    """Host front end of the reference component
    (ref TriangleIlluminationEstimator.cpp): prepare probes over meshes,
    sample, aggregate flux, bake vertex colours."""

    total_area: float = 0.0
    total_flux: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    average_flux: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    probes: LightProbes | None = None
    _mesh_list: list = dataclasses.field(default_factory=list)

    def prepare_light_probe_group(self, meshes_with_transforms: list[tuple],
                                  device) -> LightProbes:
        """``meshes_with_transforms``: [(mesh, 4x4 transform)] or
        [(mesh, transform, front_face, back_face)]; probes on ``device``.
        The total area counts each enabled face
        (ref TriangleIlluminationEstimator.cpp:94-140)."""
        groups, faces = [], []
        self._mesh_list = []
        for item in meshes_with_transforms:
            mesh, transform = item[0], item[1]
            front = item[2] if len(item) > 2 else True
            back = item[3] if len(item) > 3 else True
            groups.append(probes_from_mesh(mesh, transform, device, front, back))
            faces.append(int(front) + int(back))
            self._mesh_list.append(mesh)
        # one host read for every group's area
        areas = torch.stack([g.areas().sum() for g in groups]).tolist()
        total_area = 0.0
        for area, f in zip(areas, faces):
            total_area += area * f
        self.total_area = total_area
        self.probes = concat_probes(groups)
        return self.probes

    @tracing.spanned("estimator.call")
    def sample_light_probe_group(self, scene: CompiledScene, env: EnvironmentState,
                                 config: RenderConfig, seed: int = 0,
                                 push_normal_distance: float = 0.001) -> LightProbes:
        """Ref TriangleIlluminationEstimator.cpp:84-92. The flux is summed
        on the device; the host reads its three numbers."""
        if self.probes is None:
            raise ValueError("prepare_light_probe_group first")
        self.probes = estimate_illumination(scene, env, config, self.probes, seed,
                                            push_normal_distance)
        check_finite("EstimateIllumination", energy=self.probes.energy,
                     direction=self.probes.direction)
        with tracing.span("estimator.reduce"):
            flux = torch.sum(self.probes.energy * self.probes.areas()[:, None],
                             dim=0)
            with tracing.span("estimator.sync.flux"):
                self.total_flux = flux.cpu().numpy()
            self.average_flux = (self.total_flux / self.total_area
                                 if self.total_area > 0
                                 else np.zeros(3, np.float32))
        return self.probes

    def color_descendents_vertices(self) -> list[np.ndarray]:
        """Bake probe energies back into per-vertex colours by averaging the
        energies of each vertex's incident triangles
        (ref TriangleIlluminationEstimator.cpp:8-48). Returns one (N, 4)
        colour array per prepared mesh and writes it into ``mesh.colors``."""
        if self.probes is None:
            raise ValueError("prepare_light_probe_group first")
        energies = self.probes.energy.cpu().numpy()
        out = []
        offset = 0
        for mesh in self._mesh_list:
            t = mesh.triangles
            count = np.zeros(mesh.num_vertices, np.int64)
            accum = np.zeros((mesh.num_vertices, 4), np.float32)
            probe_col = np.concatenate(
                [energies[offset:offset + t.shape[0]],
                 np.ones((t.shape[0], 1), np.float32)], axis=-1)
            for corner in range(3):
                np.add.at(count, t[:, corner], 1)
                np.add.at(accum, t[:, corner], probe_col)
            mesh.colors = (accum / np.maximum(count, 1)[:, None]).astype(np.float32)
            out.append(mesh.colors)
            offset += t.shape[0]
        return out
