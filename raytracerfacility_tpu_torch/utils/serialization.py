"""YAML persistence of a parsed CompressedBTF database (``.cbtf``).

Port of the ``.cbtf`` part of ``raytracerfacility_tpu/utils/serialization.py``
(ref :134-177; the reference's CompressedBTF::Serialize,
CompressedBTF.cpp:739-801): the header parameters as YAML scalars and each
array as base64 raw little-endian bytes with its dtype and shape, so a
file written by either package reads in the other. ``yaml`` is imported
by the functions that need it.
"""

from __future__ import annotations

import base64

import numpy as np

from raytracerfacility_tpu_torch.mlvq.btf import BTFData

_BTF_ARRAYS = (
    "pdf6_slices", "pdf6_scales", "pdf1_basis", "colors", "index_ab",
    "pdf2_colors", "pdf2_slices", "pdf2_scales", "index_lum_color",
    "pdf3_scales", "pdf3_slices", "pdf4_scales", "pdf4_slices",
    "beta_angles",
)

_BTF_SCALARS = (
    "use_cos_beta", "num_of_beta", "num_of_alpha", "num_of_theta",
    "num_of_phi", "hdr", "hdr_value", "multiplier", "tex_coord_multiplier",
    "gamma", "code_btf_flag", "num_rows", "num_cols", "rows_offset",
    "cols_offset",
)


def _encode(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": base64.b64encode(arr.tobytes()).decode("ascii")}


def _decode(node: dict) -> np.ndarray:
    raw = base64.b64decode(node["data"])
    return np.frombuffer(raw, dtype=np.dtype(node["dtype"])).reshape(node["shape"])


def _scalar(v):
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return v


def save_cbtf(data: BTFData, path: str) -> None:
    """Write ``data`` with its arrays as binary blobs."""
    import yaml

    doc = {k: _scalar(getattr(data, k)) for k in _BTF_SCALARS}
    for k in _BTF_ARRAYS:
        arr = getattr(data, k)
        if arr is not None:
            doc[k] = _encode(np.asarray(arr))
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)


def load_cbtf(path: str) -> BTFData:
    """Read a database that :func:`save_cbtf` (or the reference's) wrote."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    data = BTFData(**{k: doc[k] for k in _BTF_SCALARS if k in doc})
    for k in _BTF_ARRAYS:
        if k in doc:
            setattr(data, k, _decode(doc[k]))
    return data
