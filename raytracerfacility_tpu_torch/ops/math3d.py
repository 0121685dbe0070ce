"""Batched 3D math and Monte-Carlo sampling used by the camera and the
shading steps.

Port of the part of ``raytracerfacility_tpu/ops/math3d.py`` the ported
paths read: ``TWO_PI``, ``dot``, ``cross``, ``length``, ``normalize``,
``safe_normalize``, ``reflect``, ``tangent_space``,
``sample_hemisphere`` and ``rotate_about_axis``; and :func:`inv_dir`
(``ops/traverse.py::_safe_inv``), :func:`parallel_slabs` and
:func:`true_div`. Vectors sit in the trailing axis; three-element sums
are written out as ``(x + y) + z``.
"""

from __future__ import annotations

import torch

from raytracerfacility_tpu_torch.ops.rng import lcg_next

TWO_PI = 6.2831853071795864769


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing xyz axis, in the fixed order (x + y) + z."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(v, v))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """glm-style normalize (no epsilon; 0-vectors give non-finite output,
    like the reference). ``1 / sqrt`` rather than ``rsqrt``: both are
    correctly rounded here and in the CUDA kernels, where ``rsqrtf`` is
    approximate."""
    return v * (1.0 / torch.sqrt(dot(v, v)))[..., None]


def safe_normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Normalize that returns 0 for (near-)zero vectors."""
    sq = dot(v, v)
    return v * (1.0 / torch.sqrt(torch.clamp(sq, min=eps)))[..., None] \
        * (sq > eps)[..., None]


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Ref: RayTracerUtilities.cuh:89-92."""
    return incident - 2.0 * dot(incident, normal)[..., None] * normal


def inv_dir(d: torch.Tensor) -> torch.Tensor:
    """Reciprocal of a ray direction whose components are held at least
    1e-20 from zero, keeping their sign: the slab tests' inverse (ref
    traverse.py:55-61, the kernels' ``inv_dir``)."""
    eps = torch.where(d < 0.0, -1e-20, 1e-20)
    return 1.0 / torch.where(d.abs() < 1e-20, eps, d)


# |inv_dir| of a held direction component (csrc/path_common.cuh kHeldInv), and
# the slab bound that stands for "every t" (kParallelBig)
HELD_INV = float(1.0 / torch.tensor(1e-20))
PARALLEL_BIG = 3.0e38


def parallel_slabs(t1, t2, lo, hi, o, iv):
    """Close the slabs of the axes a ray runs parallel to (its inverse
    held by :func:`inv_dir`): (-big, big) when the ray lies in the slab or
    on a face of it, (big, big) outside; ``(b - o) * 1e20`` would give a
    ray on the upper face an exit at t = 0 (csrc/path_common.cuh
    ``parallel_slab``). All arguments broadcast over a trailing xyz axis;
    returns the new (t1, t2)."""
    par = iv.abs() >= HELD_INV
    if not bool(par.any()):
        return t1, t2
    inside = (lo <= o) & (o <= hi)
    return (torch.where(par, torch.where(inside, -PARALLEL_BIG, PARALLEL_BIG), t1),
            torch.where(par, PARALLEL_BIG, t2))


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as a division on every device: PyTorch's CUDA
    division by a host scalar multiplies by its rounded reciprocal
    instead, one rounding more than the CPU's and the reference's."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def cos_sin(phi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of float32 angles, taken in float64 and rounded to
    float32, as the kernels in ``csrc/`` take them. torch's float32 trig
    rounds differently on the CPU (vectorized body against scalar tail, so
    a ray's result would depend on its position in the pool) and on CUDA
    (``cosf``); the rounded float64 value is the same everywhere."""
    p = phi.to(torch.float64)
    return torch.cos(p).to(phi.dtype), torch.sin(p).to(phi.dtype)


def rotate_about_axis(v: torch.Tensor, axis: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of ``v`` about unit ``axis`` by ``angle``
    radians (glm::rotate(vec3, ...)), with its cos and sin from
    :func:`cos_sin`."""
    c, s = cos_sin(angle)
    if c.ndim < v.ndim:
        c = c[..., None]
        s = s[..., None]
    return v * c + cross(axis, v) * s + axis * dot(axis, v)[..., None] * (1.0 - c)


def pow64(x: torch.Tensor, e) -> torch.Tensor:
    """x ** e taken in float64 and rounded to x's dtype, the same on every
    device (torch's float32 ``pow`` rounds differently on the CPU and on
    CUDA)."""
    e = e.to(torch.float64) if torch.is_tensor(e) else e
    return torch.pow(x.to(torch.float64), e).to(x.dtype)


def tangent_space(normal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal (tangent, binormal) around ``normal``: helper +X unless
    |n.x| > 0.99, then +Z (ref RayTracerUtilities.cuh:110-120)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    use_z = torch.abs(nx) > 0.99
    hx = torch.where(use_z, 0.0, 1.0)
    hz = torch.where(use_z, 1.0, 0.0)
    # t = normalize(cross(n, h)) with h = (hx, 0, hz)
    t = torch.stack([ny * hz, nz * hx - nx * hz, -ny * hx], dim=-1)
    t = t * (1.0 / torch.sqrt(torch.clamp(dot(t, t), min=1e-20)))[..., None]
    b = cross(normal, t)
    b = b * (1.0 / torch.sqrt(torch.clamp(dot(b, b), min=1e-20)))[..., None]
    return t, b


def sample_hemisphere(state: torch.Tensor, normal: torch.Tensor, alpha=None):
    """Direction in the cone around ``normal``: cos(theta) uniform in
    [1 - (1 - alpha)^2, 1], so alpha = 0 is the hemisphere and alpha = 1
    collapses to ``normal`` (ref RayTracerUtilities.cuh:122-133). Without
    ``alpha``, cos(theta) is the draw itself: the uniform-cos variant of
    RayTracerUtilities.cuh:135-145, which the illumination estimator uses
    (it gives another direction for the same draw than alpha = 0). Two LCG
    draws, cos(theta) then phi. ``state`` holds uint32 values in int64.
    Returns ``(new_state, direction (..., 3))``. The shading steps of the
    kernels in ``csrc/`` compute the same arithmetic."""
    state, u_cos = lcg_next(state)
    state, u_phi = lcg_next(state)
    if alpha is None:
        cos_t = u_cos
    else:
        one_minus = 1.0 - alpha
        cos_t = 1.0 - u_cos * one_minus * one_minus
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    c, s = cos_sin(TWO_PI * u_phi)
    lx, ly, lz = c * sin_t, s * sin_t, cos_t
    t, b = tangent_space(normal)
    out = (t * lx[..., None] + b * ly[..., None]) + normal * lz[..., None]
    return state, out
