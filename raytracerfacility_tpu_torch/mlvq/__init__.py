"""MLVQ CompressedBTF materials (port of ``raytracerfacility_tpu/mlvq``):
the decode chain (``btf.py``), the synthetic database (``synthetic.py``)
and the text-database importer (``importer.py``)."""

from raytracerfacility_tpu_torch.mlvq.btf import (
    BTFData,
    BTFTable,
    btf_get_value,
    compute_angles,
    pack_btf_table,
    table_from_data,
)
from raytracerfacility_tpu_torch.mlvq.importer import (
    export_btf_folder,
    import_btf_folder,
)
from raytracerfacility_tpu_torch.mlvq.synthetic import synthetic_btf

__all__ = [
    "BTFData",
    "BTFTable",
    "btf_get_value",
    "compute_angles",
    "export_btf_folder",
    "import_btf_folder",
    "pack_btf_table",
    "synthetic_btf",
    "table_from_data",
]
