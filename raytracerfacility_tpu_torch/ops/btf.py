"""BTF colours of a wavefront segment: the MLVQ decode on the device.

Port of the reference's ``models/pathtracer.py:209-301 _btf_colors``
(the hit shader's BTF branch, ref RayFunctions.cuh:173-257 through
SurfaceCompressedBTF::GetValue, RayDataDefinations.hpp:326-351, with its
/ 256 at :347): for every lane of ``mask`` the decode of its material's
database at the lane's texture coordinate and its view and illumination
directions in the tangent frame of the geometric normal and tangent;
ones on every other lane.

:func:`pack_btf_tables` puts every BTF material of a scene into one
float32 and one int32 buffer with a descriptor a material (offsets and
static parameters), so one launch serves every material; the reference
loops over a tuple of per-material tables. :func:`btf_colors` lists the
decode lanes with ``environment.compact_misses`` (``miss_compact_kernel``
on the card, its count left on the device) and launches
``btf_decode_kernel`` (``csrc/btf.cu``) over the list: no size threshold,
bucket cascade or unsort, which the reference needs on the TPU
(``RTF_BTF_BUCKET``). On CPU tensors it runs :func:`_btf_colors_plain`,
the same function in torch ops (``mlvq/btf.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.mlvq.btf import (
    btf_get_value,
    compute_angles,
    f32,
    table_from_data,
)
from raytracerfacility_tpu_torch.ops.environment import (
    _compact_misses_plain,
    compact_misses,
)

# descriptor columns (csrc/btf.cu IDesc, FDesc): the int arrays' offsets
# into the int buffer, the float arrays' into the float buffer, then the
# static parameters
INT_ARRAYS = ("pdf6_slices", "index_ab", "pdf2_colors", "pdf2_slices",
              "index_lum_color", "pdf3_slices", "pdf4_slices")
FLOAT_ARRAYS = ("pdf6_scales", "pdf1_basis", "colors", "pdf2_scales",
                "pdf3_scales", "pdf4_scales", "beta_angles")
INT_PARAMS = ("num_of_beta", "num_of_alpha", "num_of_theta", "num_of_phi",
              "num_rows", "num_cols", "rows_offset", "cols_offset",
              "use_cos_beta", "hdr", "code_btf_flag")
IDESC, FDESC = 32, 16


@dataclasses.dataclass(frozen=True)
class PackedBTF:
    """Every BTF material of a scene: ``tables`` (one ``BTFTable`` a
    material, in BTF-slot order) for the plain version, and the kernel's
    buffers: ``floats`` and ``ints`` (every material's arrays end to
    end), ``idesc`` (M, 32) int32 and ``fdesc`` (M, 16) float32."""

    tables: tuple
    floats: torch.Tensor
    ints: torch.Tensor
    idesc: torch.Tensor
    fdesc: torch.Tensor

    def __len__(self) -> int:
        return len(self.tables)


def _float_params(t) -> list:
    """hdr_value, multiplier, tex_coord_multiplier, gamma, the four grid
    steps and the YCbCr offsets, each as the float32 the plain version
    uses."""
    offset = f32(1.0 / 256.0) if t.code_btf_flag else 1.0
    steps = [f32(180.0 / (t.num_of_beta - 1)), f32(180.0 / (t.num_of_alpha - 1)),
             f32(90.0 / (t.num_of_theta - 1)), f32(360.0 / t.num_of_phi)]
    return ([t.hdr_value, t.multiplier, t.tex_coord_multiplier, t.gamma] + steps
            + [f32(f32(c) * offset) for c in (222.921, 135.576, 276.836)])


def pack_btf_tables(tables, device) -> PackedBTF:
    """Pack a scene's BTF materials (``BTFData``, in slot order) on
    ``device``."""
    tables = [table_from_data(t, device) for t in tables]
    floats, ints, idesc, fdesc = [], [], [], []
    nf = ni = 0
    for t in tables:
        arrays = {k: getattr(t, k).cpu().numpy() for k in INT_ARRAYS + FLOAT_ARRAYS}
        row = np.zeros(IDESC, np.int64)
        for j, k in enumerate(INT_ARRAYS):
            row[j] = ni
            ints.append(arrays[k].astype(np.int32))
            ni += arrays[k].size
        for j, k in enumerate(FLOAT_ARRAYS):
            row[len(INT_ARRAYS) + j] = nf
            floats.append(arrays[k].astype(np.float32))
            nf += arrays[k].size
        base = len(INT_ARRAYS) + len(FLOAT_ARRAYS)
        row[base:base + len(INT_PARAMS)] = [int(getattr(t, k)) for k in INT_PARAMS]
        idesc.append(row)
        frow = np.zeros(FDESC, np.float32)
        params = _float_params(t)
        frow[:len(params)] = params
        fdesc.append(frow)
    if max(nf, ni) >= 2**31:
        raise ValueError("the BTF tables exceed 32-bit offsets")
    return PackedBTF(
        tables=tuple(tables),
        floats=torch.tensor(np.concatenate(floats), device=device),
        ints=torch.tensor(np.concatenate(ints), device=device),
        idesc=torch.tensor(np.stack(idesc).astype(np.int32), device=device),
        fdesc=torch.tensor(np.stack(fdesc), device=device))


def _btf_colors_plain(scene, mask, btf_index, tex_coord, view_dir, illum_dir,
                      normal, tangent):
    """Plain version of :func:`btf_colors`: the lanes listed by the plain
    compaction, decoded by the torch functions of ``mlvq/btf.py``."""
    listed, count = _compact_misses_plain(mask.to(torch.float32).contiguous())
    idx = listed[:int(count[0])].long()
    out = torch.ones((mask.shape[0], 3), dtype=torch.float32, device=mask.device)
    view_theta, view_phi = compute_angles(view_dir[idx], normal[idx], tangent[idx])
    illum_theta, illum_phi = compute_angles(illum_dir[idx], normal[idx],
                                            tangent[idx])
    slot = btf_index[idx]
    for k, table in enumerate(scene.btf.tables):
        sel = slot == k
        if bool(sel.any()):
            out[idx[sel]] = btf_get_value(
                table, tex_coord[idx][sel], illum_theta[sel], illum_phi[sel],
                view_theta[sel], view_phi[sel]) / 256.0
    return out


def check_btf_inputs(btf: PackedBTF, mask, btf_index, planes) -> None:
    """Raise unless the kernel can take these tensors: on one device, the
    mask (n,) bool, ``btf_index`` (n,) int32, the texture coordinates
    (n, 2) and the four directions (n, 3) float32 and contiguous (the
    caller makes them so), the tables on the same device."""
    n = mask.shape[0] if mask.dim() == 1 else -1
    device = mask.device
    bad = (mask.dim() != 1 or mask.dtype != torch.bool
           or btf_index.shape != (n,) or btf_index.dtype != torch.int32
           or not btf_index.is_contiguous() or btf_index.device != device
           or btf.floats.device != device)
    for t, cols in planes:
        bad = bad or (t.shape != (n, cols) or t.dtype != torch.float32
                      or not t.is_contiguous() or t.device != device)
    if bad or n >= 2**31 // 3:
        raise ValueError(
            "btf_colors takes an (n,) bool mask, (n,) int32 slots, (n, 2) "
            "texture coordinates and (n, 3) directions, float32 and "
            "contiguous, on the tables' device")


def btf_colors(scene, mask, btf_index, tex_coord, view_dir, illum_dir, normal,
               tangent):
    """(n, 3) BTF colours of ``scene.btf`` (a :class:`PackedBTF`): on each
    lane of the (n,) bool ``mask`` the decode of material slot
    ``btf_index`` / 256, ones on the other lanes and on lanes whose slot
    names no table. ``view_dir`` and ``illum_dir`` point away from the
    surface; ``normal`` and ``tangent`` are the geometric frame (BTF
    materials skip normal mapping).

    Replaces no TPU kernel: the reference decodes in XLA
    (``mlvq/btf.py:316 btf_get_value``). On the H100 two launches:
    ``compact_misses`` lists the lanes of ``mask`` and their count on the
    device, then ``btf_decode_kernel`` decodes the list, one thread a
    lane, the chain in registers (bound by its dependent table gathers);
    the host reads nothing between them."""
    if mask.device.type == "cpu":
        return _btf_colors_plain(scene, mask, btf_index, tex_coord, view_dir,
                                 illum_dir, normal, tangent)
    if mask.device.type != "cuda":
        raise ValueError(f"no kernel for device {mask.device}")
    btf = scene.btf
    btf_index, tex_coord, view_dir, illum_dir, normal, tangent = (
        t.contiguous() for t in (btf_index, tex_coord, view_dir, illum_dir,
                                 normal, tangent))
    check_btf_inputs(btf, mask, btf_index, [(tex_coord, 2), (view_dir, 3),
                                           (illum_dir, 3), (normal, 3),
                                           (tangent, 3)])
    n = mask.shape[0]
    out = torch.ones((n, 3), dtype=torch.float32, device=mask.device)
    if n == 0:
        return out
    listed, count = compact_misses(mask.to(torch.float32))
    launch_decode(btf, listed, count, n, btf_index, tex_coord, view_dir,
                  illum_dir, normal, tangent, out)
    return out


def launch_decode(btf: PackedBTF, listed, count, n, btf_index, tex_coord,
                  view_dir, illum_dir, normal, tangent, out) -> None:
    """``btf_decode_kernel`` over the lanes ``compact_misses`` listed
    (``count`` of at most ``n``), on inputs :func:`btf_colors` checked."""
    err = kernels.library("btf").rtf_btf_decode(
        listed.data_ptr(), count.data_ptr(), btf_index.data_ptr(),
        tex_coord.data_ptr(), view_dir.data_ptr(), illum_dir.data_ptr(),
        normal.data_ptr(), tangent.data_ptr(), out.data_ptr(),
        btf.floats.data_ptr(), btf.ints.data_ptr(), btf.idesc.data_ptr(),
        btf.fdesc.data_ptr(), n, len(btf),
        ctypes.c_void_p(torch.cuda.current_stream(out.device).cuda_stream))
    kernels.LAUNCHES["btf_decode_kernel"] += 1
    kernels.check(err, "btf_decode_kernel")
