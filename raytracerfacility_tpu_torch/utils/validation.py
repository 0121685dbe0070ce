"""Post-launch validation policy (the CUDA_SYNC_CHECK slot).

Port of the part of ``raytracerfacility_tpu/utils/validation.py`` that the
ported launch types call: ``ValidationError``, ``validation_enabled``,
``set_validation`` and ``check_finite``. The reference wraps every launch
in CUDA_SYNC_CHECK (ref include/.../RayTracer/Optix7.hpp:10-56); here a
launch boundary checks its output tensors for non-finite values.

Off by default (a device-to-host read per launch); enable with
``RTF_VALIDATE=1`` or :func:`set_validation`. A failure raises
``ValidationError`` naming the launch and the offending buffer.
"""

from __future__ import annotations

import os

import torch

from raytracerfacility_tpu_torch import tracing

_enabled: bool | None = None


class ValidationError(RuntimeError):
    pass


def validation_enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("RTF_VALIDATE") == "1"
    return _enabled


def set_validation(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def check_finite(launch: str, **buffers) -> None:
    """Validate launch outputs when enabled. ``buffers`` maps buffer names
    to tensors (None is skipped, as are integer and bool tensors); raises
    :class:`ValidationError` on any non-finite element."""
    if not validation_enabled():
        return
    for name, buf in buffers.items():
        if buf is None or not torch.is_floating_point(buf):
            continue
        bad = ~torch.isfinite(buf)
        bad_count = bad.sum()
        with tracing.span("validate.sync.finite"):
            count = int(bad_count)
        if count:
            idx = tuple(int(i) for i in torch.nonzero(bad)[0])
            raise ValidationError(
                f"launch '{launch}': buffer '{name}' has {count} non-finite "
                f"element(s); first at index {idx}")
