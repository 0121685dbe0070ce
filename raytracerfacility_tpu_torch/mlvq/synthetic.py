"""Synthetic CompressedBTF generator: a small random-but-valid MLVQ
database with the full six-level index chain populated, for tests and
benchmarks that need a BTF material without a measured dataset.

Port of ``raytracerfacility_tpu/mlvq/synthetic.py`` (numpy, copied): the
same seed draws the same numpy stream, so the same arrays."""

from __future__ import annotations

import numpy as np

from raytracerfacility_tpu_torch.mlvq.btf import BTFData


def synthetic_btf(seed: int = 0, hdr: bool = False) -> BTFData:
    rng = np.random.default_rng(seed)
    nb, na, nt, nphi = 7, 5, 4, 6
    n_pdf1, n_colors, n_iab = 6, 10, 5
    n_p2c, n_p2l, n_p2, n_p3, n_p4 = 4, 4, 5, 3, 2
    rows = cols = 4
    data = BTFData(
        use_cos_beta=True,
        num_of_beta=nb,
        num_of_alpha=na,
        num_of_theta=nt,
        num_of_phi=nphi,
        hdr=hdr,
        hdr_value=4.0 if hdr else 1.0,
        multiplier=4.0 if hdr else 1.0,
        num_rows=rows,
        num_cols=cols,
        rows_offset=1,
        cols_offset=2,
        pdf6_slices=rng.integers(1, n_p4 + 1, rows * cols).astype(np.int32),
        pdf6_scales=rng.uniform(0.5, 2.0, rows * cols).astype(np.float32),
        pdf1_basis=rng.uniform(0.0, 1.0, n_pdf1 * nb).astype(np.float32),
        colors=rng.uniform(100.0, 160.0, n_colors * 2).astype(np.float32),
        index_ab=rng.integers(0, n_colors, n_iab * nb).astype(np.int32),
        pdf2_colors=rng.integers(0, n_iab, n_p2c * na).astype(np.int32),
        pdf2_slices=rng.integers(0, n_pdf1, n_p2l * na).astype(np.int32),
        pdf2_scales=rng.uniform(50.0, 300.0, n_p2l * na).astype(np.float32),
        index_lum_color=np.stack(
            [rng.integers(0, n_p2l, n_p2), rng.integers(0, n_p2c, n_p2)],
            axis=1
        ).astype(np.int32).ravel(),
        pdf3_scales=rng.uniform(0.5, 2.0, n_p3 * nt).astype(np.float32),
        pdf3_slices=rng.integers(0, n_p2, n_p3 * nt).astype(np.int32),
        pdf4_scales=rng.uniform(0.5, 2.0, n_p4 * nphi).astype(np.float32),
        pdf4_slices=rng.integers(0, n_p3, n_p4 * nphi).astype(np.int32),
    )
    data.beta_angles = data.compute_beta_angles()
    return data
