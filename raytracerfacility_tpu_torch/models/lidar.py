"""Virtual laser scanner (LiDAR): the point-cloud launch type.

Port of ``raytracerfacility_tpu/models/lidar.py``: ``PointCloudSamples``,
``scan_point_cloud`` and ``PointCloudScanner`` (``scan``, ``clear``,
``construct_point_cloud``). The scanner lays a column x row grid of
parallel beams on its rotated plane (ref PointCloudScanner.cpp:70-95),
takes one closest hit a beam with any-hit disabled (ref
ptx/PointCloudScanning.cu:44-75: K3 on the packed table, K5 on an LBVH,
through ``models.pathtracer.trace_closest``), interpolates the hit record
and keeps the hits, relative to the scanner, with their colours and
entity handles (ref PointCloudScanner.cpp:97-103). Everything runs on the
compiled scene's device up to the final host filter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracerfacility_tpu_torch.models.pathtracer import trace_closest
from raytracerfacility_tpu_torch.ops.camera import quat_rotate
from raytracerfacility_tpu_torch.ops.math3d import dot, rotate_about_axis
from raytracerfacility_tpu_torch.ops.shading import interpolate_hit
from raytracerfacility_tpu_torch.scene.compiled import CompiledScene
from raytracerfacility_tpu_torch.utils.validation import check_finite

SCAN_TMIN = 1e-3  # ref ptx/PointCloudScanning.cu:58-71
SCAN_TMAX = 1e20


@dataclasses.dataclass(frozen=True)
class PointCloudSamples:
    """SoA ``PointCloudSample`` (ref RayTracer.hpp:222-232); misses carry
    the reference's fill values (colour 1, everything else 0)."""

    start: torch.Tensor  # (R, 3) beam origins
    direction: torch.Tensor  # (R, 3) beam directions
    hit: torch.Tensor  # (R,) bool
    handle_words: torch.Tensor  # (R, 2) int64 (lo, hi) of the entity handle
    position: torch.Tensor  # (R, 3)
    normal: torch.Tensor  # (R, 3)
    tangent: torch.Tensor  # (R, 3)
    color: torch.Tensor  # (R, 4)
    tex_coord: torch.Tensor  # (R, 2)
    data: torch.Tensor  # (R, 4)


def scan_point_cloud(scene: CompiledScene, start: torch.Tensor,
                     direction: torch.Tensor) -> PointCloudSamples:
    """One closest-hit query a beam in (1e-3, 1e20), then the full hit
    record (tangent, colour, texcoord and data included)."""
    res = trace_closest(scene, start, direction, SCAN_TMIN, SCAN_TMAX,
                        coherent=True)
    hit = interpolate_hit(scene, res.prim, res.u, res.v, direction, start, res.t)
    m = res.hit[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=start.device)
    return PointCloudSamples(
        start=start,
        direction=direction,
        hit=res.hit,
        handle_words=torch.where(m, scene.instance_handle[hit.instance], 0),
        position=torch.where(m, hit.position, zero),
        normal=torch.where(m, hit.normal, zero),
        tangent=torch.where(m, hit.tangent, zero),
        color=torch.where(m, hit.color, 1.0),
        tex_coord=torch.where(m, hit.tex_coord, zero),
        data=torch.where(m, hit.data, zero),
    )


@dataclasses.dataclass
class PointCloudScanner:
    """Host front end of the reference component (ref
    PointCloudScanner.hpp:10-28). The pose is (position, rotation
    quaternion (w, x, y, z)); the scan plane spans the scanner's left and
    up axes and the beams run along its front, turned by ``rotate_angle``
    degrees about up."""

    size: tuple[float, float] = (1.0, 1.0)
    distance: tuple[float, float] = (0.01, 0.01)
    rotate_angle: float = 0.0

    points: np.ndarray | None = None  # (K, 3) scanner-relative hit positions
    point_colors: np.ndarray | None = None  # (K, 4)
    handles: np.ndarray | None = None  # (K,) uint64

    def scan(self, scene: CompiledScene, position=(0.0, 0.0, 0.0),
             rotation=(1.0, 0.0, 0.0, 0.0)) -> int:
        """Sweep the grid over ``scene`` (what ``RayTracerScene.build``
        returns) on its device; returns the number of hits (ref
        PointCloudScanner.cpp:70-104)."""
        position = np.asarray(position, np.float32)
        rotation = np.asarray(rotation, np.float32)
        front = quat_rotate(rotation, np.array([0, 0, -1], np.float32))
        up = quat_rotate(rotation, np.array([0, 1, 0], np.float32))
        left = quat_rotate(rotation, np.array([1, 0, 0], np.float32))

        column = int(self.size[0] / self.distance[0])
        row = int(self.size[1] / self.distance[1])
        if column <= 0 or row <= 0:
            self.points = np.zeros((0, 3), np.float32)
            self.point_colors = np.zeros((0, 4), np.float32)
            self.handles = np.zeros(0, np.uint64)
            return 0

        device = scene.device

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        actual = rotate_about_axis(t(front), t(up / np.linalg.norm(up)),
                                   t(np.radians(self.rotate_angle)))
        actual = actual / torch.sqrt(dot(actual, actual))
        # column-major grid: beam (ci, ri) at ci * row + ri
        ci = torch.arange(column, dtype=torch.float32, device=device)[:, None] \
            - float(column // 2)
        ri = torch.arange(row, dtype=torch.float32, device=device)[None, :] \
            - float(row // 2)
        start = (t(position) + t(left) * (ci * self.distance[0])[..., None]
                 + t(up) * (ri * self.distance[1])[..., None]).reshape(-1, 3)
        samples = scan_point_cloud(scene, start, actual.expand_as(start))
        check_finite("ScanPointCloud", position=samples.position,
                     color=samples.color)
        hit = samples.hit.cpu().numpy()
        self.points = samples.position.cpu().numpy()[hit] - position
        self.point_colors = samples.color.cpu().numpy()[hit]
        words = samples.handle_words.cpu().numpy()[hit].astype(np.uint64)
        self.handles = words[:, 0] | (words[:, 1] << np.uint64(32))
        return int(hit.sum())

    def clear(self) -> None:
        self.points = None
        self.point_colors = None
        self.handles = None

    def construct_point_cloud(self) -> np.ndarray:
        """Ref PointCloudScanner.cpp:106-110."""
        return np.array(self.points) if self.points is not None else np.zeros((0, 3))
