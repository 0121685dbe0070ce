"""CompressedBTF files between the port and the JAX package: ``.cbtf``
written by one and read by the other, the text-database exporter's output
read by both importers, and the port's native number parser against its
numpy fallback. No measured database is in the repository: the files are
written here from the synthetic databases. Gate: every field equal."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from raytracerfacility_tpu.mlvq.importer import import_btf_folder as ref_import
from raytracerfacility_tpu.mlvq.synthetic import synthetic_btf as ref_synthetic
from raytracerfacility_tpu.utils.serialization import load_cbtf as ref_load_cbtf
from raytracerfacility_tpu.utils.serialization import save_cbtf as ref_save_cbtf
from raytracerfacility_tpu_torch import native
from raytracerfacility_tpu_torch.convert import btf_data_from_numpy
from raytracerfacility_tpu_torch.mlvq import BTFData, export_btf_folder, import_btf_folder
from raytracerfacility_tpu_torch.mlvq.synthetic import synthetic_btf
from raytracerfacility_tpu_torch.utils.serialization import load_cbtf, save_cbtf

FIELDS = [f.name for f in dataclasses.fields(BTFData)]


def _assert_same(a, b, arrays_only=False):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        elif not arrays_only:
            assert x == y, name


@pytest.mark.parametrize("hdr", [False, True], ids=["ldr", "hdr"])
def test_synthetic_equals_reference(hdr):
    """The same seed draws the same database in both packages, and
    ``convert.btf_data_from_numpy`` carries the reference's across."""
    ref = ref_synthetic(seed=5, hdr=hdr)
    _assert_same(synthetic_btf(seed=5, hdr=hdr), ref)
    _assert_same(btf_data_from_numpy(ref), ref)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cbtf_between_packages(writer, tmp_path):
    """``.cbtf`` written by one package reads in the other, field for
    field (the code flag and an HDR database set, to cover every scalar)."""
    path = str(tmp_path / "mat.cbtf")
    if writer == "port":
        data = synthetic_btf(seed=4, hdr=True)
        data.code_btf_flag = True
        save_cbtf(data, path)
        _assert_same(ref_load_cbtf(path), data)
        _assert_same(load_cbtf(path), data)
    else:
        data = ref_synthetic(seed=4, hdr=True)
        data.code_btf_flag = True
        ref_save_cbtf(data, path)
        _assert_same(load_cbtf(path), data)


def test_importer_round_trip(tmp_path):
    """The port's exporter writes a text database that the reference's
    importer and the port's read to the same fields; the reference's
    exporter's output reads in the port's importer."""
    from raytracerfacility_tpu.mlvq.importer import export_btf_folder as ref_export

    data = synthetic_btf(seed=3)
    export_btf_folder(data, str(tmp_path / "port"), "sample")
    theirs = ref_import(str(tmp_path / "port"))
    mine = import_btf_folder(str(tmp_path / "port"))
    _assert_same(mine, theirs)
    _assert_same(mine, data, arrays_only=True)
    for name in ("use_cos_beta", "num_of_beta", "num_of_alpha", "num_of_theta",
                 "num_of_phi", "num_rows", "num_cols", "rows_offset", "cols_offset",
                 "hdr", "code_btf_flag"):
        assert getattr(mine, name) == getattr(data, name), name
    ref_export(ref_synthetic(seed=3), str(tmp_path / "ref"), "sample")
    _assert_same(import_btf_folder(str(tmp_path / "ref")), mine)


def test_native_parser_matches_numpy(tmp_path):
    """The C++ parser (built with g++ on first use) and the numpy fallback
    read every array file of an exported database, each as the importer
    types it, to the same values."""
    data = synthetic_btf(seed=2, hdr=True)
    export_btf_folder(data, str(tmp_path), "sample")
    assert native.get_lib() is not None, "the native parser did not build"
    files = [p for p in sorted(tmp_path.glob("*.txt"))
             if not p.name.endswith("materialInfo.txt")]
    assert len(files) == 13
    for path in files:
        floats = any(k in path.name for k in ("scale", "PDF1Dslice", "colors"))
        dtype = np.float32 if floats else np.int32
        rows, cols, values = native.parse_numeric_file(str(path), dtype)
        want = native.parse_numeric_file_numpy(str(path), dtype)
        assert (rows, cols) == want[:2] and values.dtype == want[2].dtype
        assert np.array_equal(values, want[2]), path.name
