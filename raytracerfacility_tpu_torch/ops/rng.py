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

On the card :func:`lcg_init` is one launch of ``tea_init_kernel``
(``csrc/rng.cu``) in place of the plain version's 386 elementwise ones.
"""

from __future__ import annotations

import ctypes

import torch

from raytracerfacility_tpu_torch import kernels

_TEA_ROUNDS = 16
_MASK32 = 0xFFFFFFFF
_LCG_A = 1664525
_LCG_C = 1013904223
_MASK24 = 0x00FFFFFF
_INV_2_24 = float(1.0 / 0x01000000)


def lcg_init(val0: torch.Tensor, val1: torch.Tensor) -> torch.Tensor:
    """Hash two uint32-valued int64 tensors (e.g. pixel index, frame id),
    broadcast together, into RNG states: an int64 tensor of the broadcast
    shape holding uint32 values; only the low 32 bits of each input word
    count. Ref: LinearCongruenceGenerator.hpp:15-26 (``Init``).

    CPU tensors take the plain version. On the card it launches
    ``tea_init_kernel`` on the current stream: both inputs int64 on one
    CUDA device, fewer than 2**31 words. It reads ``val0`` in place when
    its broadcast is contiguous, and ``val1`` in place when its broadcast
    gives one word to each run of consecutive words (a per-slot seed, a
    0-dim seed, or one word a word); any other layout is made contiguous
    first. Any other device or input raises."""
    if val0.device.type == "cpu" and val1.device.type == "cpu":
        return _lcg_init_plain(val0, val1)
    if val0.device.type != "cuda" or val1.device != val0.device:
        raise ValueError(f"no kernel for devices {val0.device}, {val1.device}")
    v0, v1, run = tea_inputs(val0, val1)
    out = torch.empty(v0.shape, dtype=torch.int64, device=v0.device)
    if out.numel() == 0:
        return out
    err = kernels.library("rng").rtf_tea_init(
        v0.data_ptr(), v1.data_ptr(), out.data_ptr(), out.numel(), run,
        ctypes.c_void_p(torch.cuda.current_stream(out.device).cuda_stream))
    kernels.LAUNCHES["tea_init_kernel"] += 1
    kernels.check(err, "tea_init_kernel")
    return out


def tea_inputs(val0: torch.Tensor, val1: torch.Tensor):
    """The kernel's view of :func:`lcg_init`'s inputs: (``val0`` broadcast
    and contiguous, ``val1``'s words, the run of consecutive output words
    that each of them seeds). Raises ValueError unless both are int64,
    their shapes broadcast, and the broadcast holds fewer than 2**31
    words."""
    if val0.dtype != torch.int64 or val1.dtype != torch.int64:
        raise ValueError(f"tea_init_kernel takes int64 words, not {val0.dtype}, "
                         f"{val1.dtype}")
    try:
        v0, v1 = torch.broadcast_tensors(val0, val1)
    except RuntimeError as e:
        raise ValueError(f"lcg_init's shapes {tuple(val0.shape)} and "
                         f"{tuple(val1.shape)} do not broadcast") from e
    if v0.numel() >= 2**31:
        raise ValueError(f"tea_init_kernel takes fewer than 2**31 words, not "
                         f"{v0.numel()}")
    run = broadcast_run(v1)
    if run is None:
        v1, run = v1.contiguous(), 1
    return v0.contiguous(), v1, run


def broadcast_run(t: torch.Tensor):
    """The run length r when ``t``, read in row-major order, gives one word
    of a contiguous block to each run of r consecutive elements (its
    trailing dims broadcast with stride 0, its leading dims contiguous):
    1 for a contiguous tensor, ``t.numel()`` for one word broadcast.
    None for any other layout."""
    dims = [(size, stride) for size, stride in zip(t.shape, t.stride()) if size != 1]
    run = 1
    while dims and dims[-1][1] == 0:
        run *= dims.pop()[0]
    expect = 1
    for size, stride in reversed(dims):
        if stride != expect:
            return None
        expect *= size
    return run


def _lcg_init_plain(val0: torch.Tensor, val1: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`lcg_init`."""
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
