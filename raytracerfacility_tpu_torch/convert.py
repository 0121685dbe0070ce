"""Move state from the JAX package into the port, as numpy arrays.

The system runs no model; the compiled scene takes the place of weights.
These functions take the reference's packed path tables and frame buffers
(converted to numpy by the caller, so this module never imports JAX) and
return the port's tensors, so the same scene and frame can be fed to both
packages.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracerfacility_tpu_torch.models.pathtracer import FrameBuffers
from raytracerfacility_tpu_torch.ops.fused import _COLS


def fused_tables_from_numpy(table, sub_aabbs, chunk_aabbs, mat_table,
                            chunk: int, device) -> tuple:
    """The reference's ``CompiledScene.fused`` tables (``pallas_fused.py::
    pack_fused_tables``: (N, 20) table, (N/sub, 8) sub-run AABBs, chunk
    AABBs, (M_pad, 8) material table) as the port's tables on ``device``.
    The port keeps the same layout, so this checks shapes and copies."""
    arrays = [np.ascontiguousarray(a, np.float32)
              for a in (table, sub_aabbs, chunk_aabbs, mat_table)]
    table, sub_aabbs, chunk_aabbs, mat_table = arrays
    rows = table.shape[0]
    if table.ndim != 2 or table.shape[1] != _COLS:
        raise ValueError(f"table must be (N, {_COLS}), got {table.shape}")
    if rows % chunk or rows % sub_aabbs.shape[0]:
        raise ValueError(f"{rows} table rows do not tile chunk={chunk} and "
                         f"{sub_aabbs.shape[0]} sub-runs")
    if chunk_aabbs.shape[0] < rows // chunk:
        raise ValueError("fewer chunk AABBs than chunks")
    for a in (sub_aabbs, chunk_aabbs, mat_table):
        if a.ndim != 2 or a.shape[1] != 8:
            raise ValueError(f"AABB and material tables must be (n, 8), got {a.shape}")
    return tuple(torch.tensor(a, device=device) for a in arrays)


def frame_from_numpy(color, normal, albedo, frame_id: int, device) -> FrameBuffers:
    """The reference's ``FrameBuffers`` fields (each (H, W, 4)) as the
    port's, so progressive accumulation can continue from a reference
    frame."""
    def t(a):
        a = np.asarray(a, np.float32)
        if a.ndim != 3 or a.shape[-1] != 4:
            raise ValueError(f"frame buffers must be (H, W, 4), got {a.shape}")
        return torch.tensor(a, device=device)

    return FrameBuffers(color=t(color), normal=t(normal), albedo=t(albedo),
                        frame_id=int(frame_id))
