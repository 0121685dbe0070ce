"""Move state from the JAX package into the port, as numpy arrays.

The compiled scene takes the place of weights; the one network is the
denoiser. These functions take the reference's packed path tables, frame
buffers, light probes, environment, BTF databases and denoiser
parameters (converted to
numpy by the caller, so this module never imports JAX) and return the
port's tensors, so the same scene, frame, probes, environment and network
can be fed to both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracerfacility_tpu_torch.mlvq.btf import ARRAYS, BTFData
from raytracerfacility_tpu_torch.models.illumination import (
    PROBE_FIELDS,
    LightProbes,
    probes_from_arrays,
)
from raytracerfacility_tpu_torch.models.pathtracer import FrameBuffers
from raytracerfacility_tpu_torch.ops.environment import AtmosphereState, EnvironmentState
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


def probes_from_numpy(probes, device) -> LightProbes:
    """The reference's ``LightProbes`` (any object with its ten fields as
    attributes, or a mapping of them, each convertible by ``np.asarray``)
    as the port's ``LightProbes`` on ``device``."""
    get = probes.__getitem__ if isinstance(probes, dict) else (
        lambda k: getattr(probes, k))
    return probes_from_arrays({k: np.asarray(get(k)) for k in PROBE_FIELDS}, device)


_ENV_FIELDS = {"skylight_intensity": (), "ambient_light_intensity": (),
               "light_size": (), "gamma": (), "sun_direction": (3,), "color": (3,)}
_ATMOSPHERE_FIELDS = ("earth_radius", "atmosphere_radius", "hr", "hm", "g")


def environment_from_numpy(env, device) -> EnvironmentState:
    """The reference's ``EnvironmentState`` (any object with its fields as
    attributes, ``atmosphere`` an object with ``AtmosphereState``'s five,
    each convertible by ``np.asarray``) as the port's on ``device``: the
    scalars 0-d and the vectors (3,) float32, the cubemap (6, H, W, 4)
    float32 or None."""
    def t(x, shape):
        a = np.asarray(x, np.float32)
        if a.shape != shape:
            raise ValueError(f"environment field of shape {a.shape}, expected {shape}")
        return torch.tensor(a, device=device)

    fields = {k: t(getattr(env, k), shape) for k, shape in _ENV_FIELDS.items()}
    cubemap = getattr(env, "cubemap", None)
    if cubemap is not None:
        cubemap = np.ascontiguousarray(cubemap, np.float32)
        if cubemap.ndim != 4 or cubemap.shape[0] != 6 or cubemap.shape[3] != 4:
            raise ValueError(f"a cubemap must be (6, H, W, 4), got {cubemap.shape}")
        cubemap = torch.tensor(cubemap, device=device)
    atm = env.atmosphere
    atmosphere = AtmosphereState(**{k: t(getattr(atm, k), ())
                                    for k in _ATMOSPHERE_FIELDS})
    return EnvironmentState(**fields, cubemap=cubemap, atmosphere=atmosphere)


_BTF_SCALARS = tuple(f.name for f in dataclasses.fields(BTFData)
                     if f.name not in dict(ARRAYS) and f.name != "beta_angles")


def btf_data_from_numpy(ref_data) -> BTFData:
    """The reference's ``BTFData`` (any object with its fields as
    attributes, the arrays convertible by ``np.asarray``) as the port's:
    the header parameters as Python scalars, the 13 arrays and
    ``beta_angles`` as contiguous copies of their types (``beta_angles``
    None when the reference's is)."""
    data = BTFData(**{k: getattr(ref_data, k) for k in _BTF_SCALARS})
    for name, dtype in ARRAYS:
        arr = getattr(ref_data, name)
        setattr(data, name, None if arr is None else np.array(arr, dtype))
    beta = getattr(ref_data, "beta_angles", None)
    data.beta_angles = None if beta is None else np.array(beta, np.float32)
    return data


# flax module paths of the reference's DenoiserUNet, in call order, and
# the port's module names (models/denoiser.py)
_DENOISER_MODULES = {"ConvBlock_0": "enc0", "ConvBlock_1": "enc1",
                     "ConvBlock_2": "enc2", "ConvBlock_3": "dec1",
                     "ConvBlock_4": "dec0", "Conv_0": "head"}


def _denoiser_name(flax_name: str) -> str:
    """'params/ConvBlock_3/Conv_1/kernel' -> 'dec1.conv1.weight'."""
    parts = flax_name.split("/")
    if parts[0] != "params" or parts[1] not in _DENOISER_MODULES:
        raise ValueError(f"not a DenoiserUNet parameter: {flax_name!r}")
    names = [_DENOISER_MODULES[parts[1]]]
    if parts[1] != "Conv_0":
        if len(parts) != 4 or parts[2] not in ("Conv_0", "Conv_1"):
            raise ValueError(f"not a DenoiserUNet parameter: {flax_name!r}")
        names.append("conv" + parts[2][-1])
    elif len(parts) != 3:
        raise ValueError(f"not a DenoiserUNet parameter: {flax_name!r}")
    leaf = {"kernel": "weight", "bias": "bias"}.get(parts[-1])
    if leaf is None:
        raise ValueError(f"not a DenoiserUNet parameter: {flax_name!r}")
    return ".".join(names + [leaf])


def denoiser_state_dict_from_flax(flat: dict) -> dict:
    """The reference's denoiser parameters ('/'-joined flax paths, as in
    its npz checkpoints; HWIO kernels) as a state dict of the port's
    ``DenoiserUNet`` (OIHW kernels), float32 on the CPU."""
    out = {}
    for name, value in flat.items():
        t = torch.tensor(np.asarray(value, np.float32))
        if name.endswith("/kernel"):
            if t.ndim != 4 or t.shape[:2] != (3, 3):
                raise ValueError(f"{name}: kernel must be (3, 3, Cin, Cout), "
                                 f"got {tuple(t.shape)}")
            t = t.permute(3, 2, 0, 1).contiguous()
        out[_denoiser_name(name)] = t
    return out


def denoiser_flax_from_state_dict(state: dict) -> dict:
    """Inverse of :func:`denoiser_state_dict_from_flax`: numpy arrays
    under flax paths, HWIO kernels."""
    modules = {v: k for k, v in _DENOISER_MODULES.items()}
    out = {}
    for name, value in state.items():
        parts = name.split(".")
        path = ["params", modules[parts[0]]]
        if parts[0] != "head":
            path.append("Conv_" + parts[1][-1])
        a = value.detach().to("cpu", torch.float32)
        if parts[-1] == "weight":
            a = a.permute(2, 3, 1, 0)
        out["/".join(path + ["kernel" if parts[-1] == "weight" else "bias"])] = (
            a.contiguous().numpy())
    return out
