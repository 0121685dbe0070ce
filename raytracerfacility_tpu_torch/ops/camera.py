"""Camera model: pose -> inverse projection-view, and primary-ray generation.

Port of ``raytracerfacility_tpu/ops/camera.py`` (``perspective``,
``look_at``, ``quat_rotate``, ``CameraProperties``, ``CameraState``,
``generate_camera_rays``). Host side mirrors ``CameraProperties::Set``
(ref RayTracer.cu:28-46) in numpy; the device side mirrors the raygen
NDC->world ray construction with per-sample jitter and thin-lens DOF
(ref ptx/CameraRendering.cu:63-85), vectorized over the pixel grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracerfacility_tpu_torch.ops.math3d import (
    TWO_PI,
    cos_sin,
    normalize,
    true_div,
)
from raytracerfacility_tpu_torch.ops.rng import lcg_next


def perspective(fovy_rad: float, aspect: float, near: float, far: float) -> np.ndarray:
    """glm::perspective (right-handed, clip z in [-1, 1])."""
    tan_half = np.tan(fovy_rad / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = 1.0 / tan_half
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glm::lookAt (right-handed)."""
    eye = np.asarray(eye, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -s @ eye
    m[1, 3] = -u @ eye
    m[2, 3] = f @ eye
    return m


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector v by quaternion q = (w, x, y, z)."""
    w, x, y, z = q
    u = np.array([x, y, z], np.float32)
    return (
        2.0 * (u @ v) * u
        + (w * w - u @ u) * v
        + 2.0 * w * np.cross(u, v)
    ).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class CameraState:
    """Device-side camera parameters (float32 tensors on one device).
    Mirrors the device-visible part of ``CameraProperties``
    (ref RayTracer.hpp:30-96)."""

    inverse_projection_view: torch.Tensor  # (4, 4)
    position: torch.Tensor  # (3,)  ref m_from
    horizontal: torch.Tensor  # (3,)  DOF basis
    vertical: torch.Tensor  # (3,)
    aperture: torch.Tensor  # ()
    focal_length: torch.Tensor  # ()
    gamma: torch.Tensor  # ()
    max_distance: torch.Tensor  # ()


@dataclasses.dataclass
class CameraProperties:
    """Host-side camera with pose/projection bookkeeping + modification
    tracking, mirroring ``CameraProperties`` setters (ref RayTracer.cu:94-164).
    """

    fov: float = 120.0  # ref RayTracer.hpp:50 (degrees; projection uses fov/2)
    aperture: float = 0.0
    focal_length: float = 1.0
    gamma: float = 2.2
    max_distance: float = 50.0
    accumulate: bool = True
    denoiser_strength: float = 1.0
    size: tuple[int, int] = (512, 512)  # (width, height)

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    rotation: np.ndarray = dataclasses.field(  # quaternion (w, x, y, z)
        default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    )
    modified: bool = True

    def set_pose(self, position, rotation=None) -> None:
        position = np.asarray(position, np.float32)
        if rotation is not None:
            rotation = np.asarray(rotation, np.float32)
            if not np.array_equal(rotation, self.rotation):
                self.modified = True
            self.rotation = rotation
        if not np.array_equal(position, self.position):
            self.modified = True
        self.position = position

    def look_at_target(self, position, target, up=(0.0, 1.0, 0.0)) -> None:
        """Convenience: derive the quaternion from an eye/target pair."""
        position = np.asarray(position, np.float32)
        target = np.asarray(target, np.float32)
        front = target - position
        front = front / np.linalg.norm(front)
        up = np.asarray(up, np.float32)
        right = np.cross(front, up)
        right /= np.linalg.norm(right)
        true_up = np.cross(right, front)
        # rotation matrix with columns (right, up, -front) -> quaternion
        m = np.stack([right, true_up, -front], axis=1)
        w = np.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2.0
        if w > 1e-6:
            x = (m[2, 1] - m[1, 2]) / (4 * w)
            y = (m[0, 2] - m[2, 0]) / (4 * w)
            z = (m[1, 0] - m[0, 1]) / (4 * w)
        else:  # fall back for 180-degree rotations
            x, y, z = 1.0, 0.0, 0.0
        self.set_pose(position, np.array([w, x, y, z], np.float32))

    def resize(self, size: tuple[int, int]) -> None:
        if tuple(size) != tuple(self.size):
            self.size = tuple(size)
            self.modified = True

    def state(self, device) -> CameraState:
        """Build the CameraState on ``device``. Ref RayTracer.cu:28-46."""
        front = quat_rotate(self.rotation, np.array([0, 0, -1], np.float32))
        front /= np.linalg.norm(front)
        up = quat_rotate(self.rotation, np.array([0, 1, 0], np.float32))
        up /= np.linalg.norm(up)
        width, height = self.size
        aspect = float(width) / float(height)
        proj = perspective(np.radians(self.fov * 0.5), aspect, 0.1, 100.0)
        view = look_at(self.position, self.position + front, up)
        inv = np.linalg.inv(proj @ view).astype(np.float32)
        cos_fov_y = np.radians(self.fov * 0.5)  # ref keeps the radian value
        right = np.cross(front, up)
        horizontal = cos_fov_y * aspect * (right / np.linalg.norm(right))
        vertical = cos_fov_y * up

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return CameraState(
            inverse_projection_view=t(inv),
            position=t(self.position),
            horizontal=t(horizontal),
            vertical=t(vertical),
            aperture=t(self.aperture),
            focal_length=t(self.focal_length),
            gamma=t(self.gamma),
            max_distance=t(self.max_distance),
        )


def generate_camera_rays(
    camera: CameraState,
    state: torch.Tensor,
    ix: torch.Tensor,
    iy: torch.Tensor,
    width: int,
    height: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample jittered thin-lens primary rays.

    ``ix, iy`` are float32 pixel coordinates (any shape); ``state`` a
    matching RNG pool (uint32 values in int64). Returns ``(new_state,
    origins (...,3), directions (...,3))``. Ref: ptx/CameraRendering.cu:63-85.
    Draw order matches: jitter x, jitter y, aperture angle.
    """
    half_x = float(np.float32(width / 2.0))
    half_y = float(np.float32(height / 2.0))
    state, jx = lcg_next(state)
    state, jy = lcg_next(state)
    sx = true_div(ix + jx - half_x, half_x)
    sy = true_div(iy + jy - half_y, half_y)

    inv = camera.inverse_projection_view  # (4, 4), row-major, column vectors

    # explicit broadcasting mul-adds in the reference's order, not a matmul:
    # the w row of the inverse projection cancels catastrophically
    # (-4.995 + 5.005), so the summation order is part of the result
    def apply(ndc_z):
        col = (
            sx[..., None] * inv[:, 0]
            + sy[..., None] * inv[:, 1]
            + ndc_z * inv[:, 2]
            + inv[:, 3]
        )
        return col[..., :3] / col[..., 3:4]

    start = apply(-1.0)
    end = apply(1.0)
    primary_dir = normalize(end - start)

    convergence = start + primary_dir * camera.focal_length
    state, u_angle = lcg_next(state)
    angle = u_angle * float(np.float32(TWO_PI / 2.0)) * 2.0  # rand * pi * 2
    cos_a, sin_a = cos_sin(angle)
    aperture_point = start + camera.aperture * (
        camera.horizontal * sin_a[..., None]
        + camera.vertical * cos_a[..., None]
    )
    ray_dir = normalize(convergence - aperture_point)
    return state, aperture_point, ray_dir
