"""The illumination estimator's probe rays.

Port of the ray setup of ``raytracerfacility_tpu/models/illumination.py``'s
``estimate_illumination`` (ref ptx/IlluminationEstimation.cu:30-80): for
each probe, face and sample of a (P, 2, S) pool, a TEA-hashed RNG stream
from the ray's id and the seed, a uniform barycentric point on the
probe's triangle with its blended normal (negated on the back face), a
uniform-cos hemisphere direction around that normal, and the origin
pushed along it.

On the card :func:`probe_rays` is one launch of ``probe_ray_kernel``
(``csrc/probe.cu``), its seed, probe offset, samples and push passed by
value, in place of the plain version's some 164 torch dispatches around
one ``tea_init_kernel`` and its seed word's copy to the device, which
waits for the queue.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raytracerfacility_tpu_torch import kernels, tracing
from raytracerfacility_tpu_torch.ops.math3d import sample_hemisphere
from raytracerfacility_tpu_torch.ops.rng import lcg_init, lcg_next

_MASK32 = 0xFFFFFFFF
# the probe fields the rays read, in the kernel's argument order
VERTEX_FIELDS = ("a_position", "b_position", "c_position",
                 "a_normal", "b_normal", "c_normal")


def probe_rays(probes, samples: int, seed: int, push_normal_distance: float,
               probe_offset: int = 0):
    """The probe rays of ``probes`` (``models/illumination.py::LightProbes``,
    or anything with its six (P, 3) float32 :data:`VERTEX_FIELDS`):
    ``(origin, direction, normal, rng)``, float32 (P, 2, S, 3) and the
    uint32-valued int64 RNG states (P, 2, S). Ray (p, f, s) hashes the id
    ``((p + probe_offset) * 2S + f * S + s) & 0xFFFFFFFF`` with ``seed``'s
    low 32 bits; ``normal`` is the face's normal the direction was drawn
    around, negated on face 1.

    CPU tensors take the plain version. On the card it launches
    ``probe_ray_kernel`` on the current stream (inputs as
    :func:`probe_inputs` checks them). Any other device raises."""
    fields = [getattr(probes, k) for k in VERTEX_FIELDS]
    device = fields[0].device
    if all(t.device.type == "cpu" for t in fields):
        return _probe_rays_plain(probes, samples, seed, push_normal_distance,
                                 probe_offset)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    fields = probe_inputs(probes, samples)
    p = fields[0].shape[0]
    n = p * 2 * samples
    origin, direction, normal = (torch.empty((p, 2, samples, 3), dtype=torch.float32,
                                             device=device) for _ in range(3))
    rng = torch.empty((p, 2, samples), dtype=torch.int64, device=device)
    if n == 0:
        return origin, direction, normal, rng
    push_bits = int(np.array(push_normal_distance, np.float32).view(np.int32))
    err = kernels.library("probe").rtf_probe_rays(
        *(t.data_ptr() for t in fields), origin.data_ptr(), direction.data_ptr(),
        normal.data_ptr(), rng.data_ptr(), n, samples, _int32(seed),
        _int32(probe_offset * 2 * samples), push_bits,
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    kernels.LAUNCHES["probe_ray_kernel"] += 1
    kernels.check(err, "probe_ray_kernel")
    return origin, direction, normal, rng


def probe_inputs(probes, samples: int) -> list:
    """The kernel's view of :func:`probe_rays`'s inputs: the six vertex
    fields, contiguous. Raises ValueError unless each is a float32 (P, 3)
    tensor of the same P on one device, ``samples`` is not negative, and
    the pool holds fewer than 2**31 rays."""
    fields = [getattr(probes, k) for k in VERTEX_FIELDS]
    p = fields[0].shape[0] if fields[0].dim() else -1
    for name, t in zip(VERTEX_FIELDS, fields):
        if t.dtype != torch.float32 or tuple(t.shape) != (p, 3):
            raise ValueError(f"probe_ray_kernel takes float32 (P, 3) fields; {name} "
                             f"is {t.dtype} {tuple(t.shape)}")
        if t.device != fields[0].device:
            raise ValueError(f"probe fields on {t.device} and {fields[0].device}")
    if samples < 0:
        raise ValueError(f"probe_ray_kernel takes no negative samples, not {samples}")
    if p * 2 * samples >= 2**31:
        raise ValueError(f"probe_ray_kernel takes fewer than 2**31 rays, not "
                         f"{p * 2 * samples}")
    return [t.contiguous() for t in fields]


def _int32(word: int) -> int:
    """The low 32 bits of ``word`` as a signed int32 (ctypes' c_int)."""
    word &= _MASK32
    return word - 2**32 if word >= 2**31 else word


def _probe_rays_plain(probes, samples, seed, push_normal_distance, probe_offset):
    """Plain version of :func:`probe_rays`."""
    device = probes.a_position.device
    p, s = probes.a_position.shape[0], samples
    # ray pool: (P, 2 faces, S samples)
    probe_idx = (torch.arange(p, dtype=torch.int64, device=device)[:, None, None]
                 + probe_offset)
    face_idx = torch.arange(2, dtype=torch.int64, device=device)[None, :, None]
    sample_idx = torch.arange(s, dtype=torch.int64, device=device)[None, None, :]
    ray_id = (probe_idx * (2 * s) + face_idx * s + sample_idx) & _MASK32
    if device.type == "cpu":
        seed_word = torch.tensor(seed & _MASK32)
    else:
        # a host-to-device copy from pageable memory: it waits for the queue
        with tracing.span("estimator.sync.seed"):
            seed_word = torch.tensor(seed & _MASK32, device=device)
    rng = lcg_init(ray_id, seed_word)

    # uniform barycentric coords, not folded into the triangle, exactly
    # like the reference (IlluminationEstimation.cu:56-60 draws two raw
    # uniforms)
    rng, ca = lcg_next(rng)
    rng, cb = lcg_next(rng)
    w = (1.0 - ca - cb)[..., None]
    ca, cb = ca[..., None], cb[..., None]

    def blend(a, b, c):
        return w * a[:, None, None] + ca * b[:, None, None] + cb * c[:, None, None]

    position = blend(probes.a_position, probes.b_position, probes.c_position)
    normal = blend(probes.a_normal, probes.b_normal, probes.c_normal)
    # face 0 = front (+normal), face 1 = back (-normal)
    normal = normal * torch.where(face_idx == 0, 1.0, -1.0)[..., None]
    rng, ray_dir = sample_hemisphere(rng, normal)  # uniform variant
    origin = position + normal * push_normal_distance
    return origin, ray_dir, normal, rng
