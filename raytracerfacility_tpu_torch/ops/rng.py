"""Counter-free per-ray RNG: TEA hash init + 24-bit LCG draws.

Port of ``raytracerfacility_tpu/ops/rng.py`` (``lcg_init``, ``lcg_next``),
bit-exact. Behavioural parity with the reference's
``LinearCongruenceGenerator<16>`` (LinearCongruenceGenerator.hpp:6-36).

torch has no general uint32 arithmetic, so RNG states are carried as
``int64`` tensors holding values in ``[0, 2**32)``: every add, multiply and
shift is followed by ``& 0xFFFFFFFF``, and ``>> 5`` on a non-negative int64
is the logical shift the reference's uint32 ``>>`` performs. The CUDA kernels
take the same bits as ``int32`` planes (:func:`to_int32` /
:func:`from_int32`).
"""

from __future__ import annotations

import torch

_TEA_ROUNDS = 16
_MASK32 = 0xFFFFFFFF
_LCG_A = 1664525
_LCG_C = 1013904223
_MASK24 = 0x00FFFFFF
_INV_2_24 = float(1.0 / 0x01000000)


def lcg_init(val0: torch.Tensor, val1: torch.Tensor) -> torch.Tensor:
    """Hash two uint32-valued int64 tensors (e.g. pixel index, frame id)
    into RNG states. Ref: LinearCongruenceGenerator.hpp:15-26 (``Init``)."""
    v0 = val0.to(torch.int64) & _MASK32
    v1 = val1.to(torch.int64) & _MASK32
    v0, v1 = torch.broadcast_tensors(v0, v1)
    s0 = 0
    for _ in range(_TEA_ROUNDS):
        s0 = (s0 + 0x9E3779B9) & _MASK32
        v0 = (v0 + (
            (((v1 << 4) + 0xA341316C) & _MASK32)
            ^ ((v1 + s0) & _MASK32)
            ^ ((v1 >> 5) + 0xC8013EA4) & _MASK32
        )) & _MASK32
        v1 = (v1 + (
            (((v0 << 4) + 0xAD90777D) & _MASK32)
            ^ ((v0 + s0) & _MASK32)
            ^ ((v0 >> 5) + 0x7E95761E) & _MASK32
        )) & _MASK32
    return v0


def lcg_next(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One LCG draw. Returns ``(new_state, uniform float32 in [0, 1))``.
    Ref: LinearCongruenceGenerator.hpp:28-33 (``operator()``)."""
    state = (state * _LCG_A + _LCG_C) & _MASK32
    value = (state & _MASK24).to(torch.float32) * _INV_2_24
    return state, value


def to_int32(state: torch.Tensor) -> torch.Tensor:
    """uint32-valued int64 -> int32 with the same 32 bits."""
    return (((state & _MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def from_int32(state: torch.Tensor) -> torch.Tensor:
    """int32 -> uint32-valued int64 with the same 32 bits."""
    return state.to(torch.int64) & _MASK32
