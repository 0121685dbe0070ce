"""Texture sampling: bilinear fetches from a texture stack and the cubemap
lookup.

Port of ``raytracerfacility_tpu/ops/texture.py``: ``sample_stack_bilinear``
(the ``tex2D`` fetch of normalized coordinates with wrap addressing and
linear filtering, ref RayTracer.cu:305-338) and ``sample_cubemap`` (the
six-face selection of RayTracerUtilities.cuh:54-80). ``build_texture_stack``
serves texture-mapped materials, which the port does not render yet, and
is left out.

Wrap addressing wraps inside a face at the face's own edges, as the
reference's does: a bilinear fetch at a cubemap face's border blends with
the opposite border of the same face, not with the neighbouring face.
"""

from __future__ import annotations

import torch


def sample_stack_bilinear(texels: torch.Tensor, sizes: torch.Tensor,
                          index: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch with wrap addressing and half-texel centres (ref
    texture.py:51-92): texel i's centre sits at ``(i + 0.5) / size``.
    ``texels`` (K, H, W, 4) float32, ``sizes`` (K, 2) int (h, w) of each
    texture, ``index`` (...,) texture id per lane (clamped to [0, K)),
    ``uv`` (..., 2). Returns (..., 4)."""
    index = torch.clamp(index, 0, texels.shape[0] - 1).to(torch.int64)
    hw = sizes.to(torch.int64)[index]  # (..., 2)
    hi, wi = hw[..., 0], hw[..., 1]
    h, w = hi.to(torch.float32), wi.to(torch.float32)
    # wrap the normalized coordinates, then texel space on texel centres
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), wi)
    x1i = torch.remainder(x0i + 1, wi)
    y0i = torch.remainder(y0.to(torch.int64), hi)
    y1i = torch.remainder(y0i + 1, hi)
    t00 = texels[index, y0i, x0i]
    t10 = texels[index, y0i, x1i]
    t01 = texels[index, y1i, x0i]
    t11 = texels[index, y1i, x1i]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def cubemap_face_uv(direction: torch.Tensor):
    """Face and uv of a cubemap fetch along ``direction`` (..., 3) (ref
    texture.py:102-129): the major axis picks the face, ordered +X, -X,
    +Y, -Y, +Z, -Z, ties going to z, then y. Returns (face (...,) int64,
    uv (..., 2))."""
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = dx.abs(), dy.abs(), dz.abs()
    z_major = (az >= ax) & (az >= ay)
    y_major = ~z_major & (ay >= ax)
    where = torch.where
    face = where(z_major, where(dz < 0.0, 5, 4),
                 where(y_major, where(dy < 0.0, 3, 2), where(dx < 0.0, 1, 0)))
    major = where(z_major, az, where(y_major, ay, ax))
    # 0.5 / major as one rounded division (torch's scalar / tensor is a
    # reciprocal times the scalar)
    ma = torch.full_like(major, 0.5) / major
    u = where(z_major, where(dz < 0.0, -dx, dx),
              where(y_major, dx, where(dx < 0.0, dz, -dz)))
    v = where(z_major, -dy, where(y_major, where(dy > 0.0, dz, -dz), -dy))
    return face, torch.stack([u * ma + 0.5, v * ma + 0.5], dim=-1)


def sample_cubemap(faces: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Cubemap fetch (ref texture.py:94-133): ``faces`` (6, H, W, 4)
    ordered +X, -X, +Y, -Y, +Z, -Z; the face and uv of
    :func:`cubemap_face_uv`, then :func:`sample_stack_bilinear` on that
    face. Returns (..., 4)."""
    face, uv = cubemap_face_uv(direction)
    sizes = torch.tensor([[faces.shape[1], faces.shape[2]]] * 6,
                         dtype=torch.int64, device=faces.device)
    return sample_stack_bilinear(faces, sizes, face, uv)
