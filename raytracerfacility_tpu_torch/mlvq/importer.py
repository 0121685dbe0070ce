"""UBO-format CompressedBTF text-database importer.

Port of ``raytracerfacility_tpu/mlvq/importer.py`` (numpy, copied), which
ports ``CompressedBTF::ImportFromFolder`` (ref CompressedBTF.cpp:74-390):
``all_materialInfo.txt`` header (basic params, original-database info, angle
parameterization, search settings, HDR block), the per-material
``<name>_materialInfo.txt``, the beta-angle table construction
(ref :162-196), and the 13 ``Parse{Int,Float}Data`` array files
(ref :334-381; format: "rows cols min max" header line then rows*cols
whitespace-separated values).
"""

from __future__ import annotations

import os

import numpy as np

from raytracerfacility_tpu_torch.mlvq.btf import BTFData


def parse_array(path: str, dtype) -> tuple[int, int, np.ndarray]:
    """Ref ParseFloatData / ParseIntData (CompressedBTF.cpp:7-56).

    Uses the native C++ parser (``native/``) when it builds, else its
    numpy fallback."""
    from raytracerfacility_tpu_torch import native

    rows, cols, data = native.parse_numeric_file(path, dtype)
    if data.size != rows * cols:
        raise ValueError(f"{path}: expected {rows * cols} values, got {data.size}")
    return rows, cols, data


def import_btf_folder(path: str) -> BTFData:
    """Parse a material directory into :class:`BTFData`."""
    info_path = os.path.join(path, "all_materialInfo.txt")
    with open(info_path) as f:
        tokens = f.read().split()

    pos = 0

    def take(n):
        nonlocal pos
        out = tokens[pos : pos + n]
        pos += n
        return out

    # name, loadMaterials, maxMaterials, flagAllMaterials,
    # flagUse34DviewRep, flagUsePDF2compactRep (ref :123-129)
    (_name, _load, _maxm, _flag_all, _flag34, _flag_compact) = take(6)
    # ncolour, nview, nillu, tileSize (ref :132-138)
    take(4)
    # angle parameterization: useCosBeta, stepsPerBeta, ?, stepsPerAlpha, ?,
    # stepsPerTheta, ?, stepsPerPhi, ?, ?, ?, codeBtfFlag (ref :145-160, 192)
    params = [int(x) for x in take(12)]
    use_cos_beta = bool(params[0])
    num_of_beta = params[1]
    num_of_alpha = params[3]
    num_of_theta = params[5]
    num_of_phi = params[7]
    code_btf_flag = bool(params[11])
    # search settings: 10 + 10 ints, 12 metric floats (ref :200-227)
    take(10)
    take(10)
    take(12)
    # HDR block: name, 3 paths, ro co pr pc, hdrValue (ref :262-279)
    material_name = tokens[pos]
    hdr_block = take(9)
    hdr_value = float(hdr_block[8])

    # per-material info file (ref :284-318)
    mat_info = os.path.join(path, f"{material_name}_materialInfo.txt")
    with open(mat_info) as f:
        mtokens = f.read().split()
    if mtokens[0] != material_name:
        raise ValueError(
            f"material name mismatch: {mtokens[0]} != {material_name}"
        )
    ro, co, pr, pc = (int(x) for x in mtokens[4:8])
    hdr_value = float(mtokens[8])
    hdr = not (abs(hdr_value - 1.0) < 1e-6 or abs(hdr_value) < 1e-6)
    if not hdr:
        hdr_value = 1.0

    data = BTFData(
        use_cos_beta=use_cos_beta,
        num_of_beta=num_of_beta,
        num_of_alpha=num_of_alpha,
        num_of_theta=num_of_theta,
        num_of_phi=num_of_phi,
        hdr=hdr,
        hdr_value=hdr_value,
        multiplier=hdr_value if hdr else 1.0,  # ref :382-386
        code_btf_flag=code_btf_flag,
    )

    mat_prefix = os.path.join(path, material_name)
    all_prefix = os.path.join(path, "all")

    rows, cols, data.pdf6_slices = parse_array(
        mat_prefix + "_PDF6Dslices.txt", np.int32
    )
    data.num_rows, data.num_cols = rows, cols
    data.rows_offset, data.cols_offset = ro, co
    del pr, pc  # pr/pc mirror rows/cols in valid databases
    _, _, data.pdf6_scales = parse_array(mat_prefix + "_PDF6Dscale.txt", np.float32)
    _, _, data.pdf1_basis = parse_array(all_prefix + "_PDF1Dslice.txt", np.float32)
    _, _, data.colors = parse_array(all_prefix + "_colors.txt", np.float32)
    _, _, data.index_ab = parse_array(all_prefix + "_indexAB.txt", np.int32)
    _, _, data.pdf2_colors = parse_array(all_prefix + "_PDF2Dcolours.txt", np.int32)
    _, _, data.pdf2_slices = parse_array(all_prefix + "_PDF2Dslices.txt", np.int32)
    _, _, data.pdf2_scales = parse_array(all_prefix + "_PDF2Dscale.txt", np.float32)
    _, _, data.index_lum_color = parse_array(
        all_prefix + "_PDF2Dindices.txt", np.int32
    )
    _, _, data.pdf3_scales = parse_array(all_prefix + "_PDF3Dscale.txt", np.float32)
    _, _, data.pdf3_slices = parse_array(all_prefix + "_PDF3Dslices.txt", np.int32)
    _, _, data.pdf4_scales = parse_array(all_prefix + "_PDF4Dscale.txt", np.float32)
    _, _, data.pdf4_slices = parse_array(all_prefix + "_PDF4Dslices.txt", np.int32)
    data.beta_angles = data.compute_beta_angles()
    return data


def export_btf_folder(data: BTFData, path: str, material_name: str = "mat") -> None:
    """Write a database in the same text format (round-trip / test support)."""
    os.makedirs(path, exist_ok=True)

    def write_array(name, arr, rows, cols, dtype):
        arr = np.asarray(arr).reshape(rows, cols)
        with open(os.path.join(path, name), "w") as f:
            f.write(f"{rows} {cols} {arr.min()} {arr.max()}\n")
            for row in arr:
                f.write(" ".join(str(v) for v in row) + "\n")

    hdr_value = data.hdr_value if data.hdr else 1.0
    with open(os.path.join(path, "all_materialInfo.txt"), "w") as f:
        f.write("db\n1\n1\n0\n0\n0\n")
        f.write("3\n81\n81\n64\n")
        f.write(
            f"{int(data.use_cos_beta)} {data.num_of_beta} 0 {data.num_of_alpha} 0 "
            f"{data.num_of_theta} 0 {data.num_of_phi} 0 0 0 "
            f"{int(data.code_btf_flag)}\n"
        )
        f.write(" ".join(["0"] * 10) + "\n")
        f.write(" ".join(["0"] * 10) + "\n")
        f.write("0 " + " ".join(["0.0"] * 11) + "\n")
        f.write(
            f"{material_name} in out tmp {data.rows_offset} {data.cols_offset} "
            f"{data.num_rows} {data.num_cols} {hdr_value}\n"
        )
    with open(os.path.join(path, f"{material_name}_materialInfo.txt"), "w") as f:
        f.write(
            f"{material_name} in out tmp {data.rows_offset} {data.cols_offset} "
            f"{data.num_rows} {data.num_cols} {hdr_value}\n"
        )

    nb, na, nt, nphi = (
        data.num_of_beta,
        data.num_of_alpha,
        data.num_of_theta,
        data.num_of_phi,
    )
    write_array(
        f"{material_name}_PDF6Dslices.txt", data.pdf6_slices,
        data.num_rows, data.num_cols, np.int32,
    )
    write_array(
        f"{material_name}_PDF6Dscale.txt", data.pdf6_scales,
        data.num_rows, data.num_cols, np.float32,
    )
    write_array("all_PDF1Dslice.txt", data.pdf1_basis,
                data.pdf1_basis.size // nb, nb, np.float32)
    write_array("all_colors.txt", data.colors, data.colors.size // 2, 2, np.float32)
    write_array("all_indexAB.txt", data.index_ab,
                data.index_ab.size // nb, nb, np.int32)
    write_array("all_PDF2Dcolours.txt", data.pdf2_colors,
                data.pdf2_colors.size // na, na, np.int32)
    write_array("all_PDF2Dslices.txt", data.pdf2_slices,
                data.pdf2_slices.size // na, na, np.int32)
    write_array("all_PDF2Dscale.txt", data.pdf2_scales,
                data.pdf2_scales.size // na, na, np.float32)
    write_array("all_PDF2Dindices.txt", data.index_lum_color,
                data.index_lum_color.size // 2, 2, np.int32)
    write_array("all_PDF3Dscale.txt", data.pdf3_scales,
                data.pdf3_scales.size // nt, nt, np.float32)
    write_array("all_PDF3Dslices.txt", data.pdf3_slices,
                data.pdf3_slices.size // nt, nt, np.int32)
    write_array("all_PDF4Dscale.txt", data.pdf4_scales,
                data.pdf4_scales.size // nphi, nphi, np.float32)
    write_array("all_PDF4Dslices.txt", data.pdf4_slices,
                data.pdf4_slices.size // nphi, nphi, np.int32)
