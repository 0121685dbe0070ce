"""Display encode on the device.

Port of ``raytracerfacility_tpu/utils/display.py::encode_u8``: the
gamma-encoded f32 frame is quantized to uint8 where it lives, so the
host copy is 3 bytes a pixel instead of 16. The quantization is
:func:`raytracerfacility_tpu_torch.utils.image.write_png`'s (clip to
[0, 1], scale by 255, truncate), so a PNG written from either is
byte-identical.
"""

from __future__ import annotations

import torch


def encode_u8(image: torch.Tensor) -> torch.Tensor:
    """Gamma-encoded (H, W, >=3) float32 image -> (H, W, 3) uint8 on its
    device."""
    return (torch.clamp(image[..., :3], 0.0, 1.0) * 255.0).to(torch.uint8)
