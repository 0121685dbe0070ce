"""MLVQ CompressedBTF decode: the six-level PDF chain as tensor gathers.

Port of ``raytracerfacility_tpu/mlvq/btf.py``: ``BTFData`` (host numpy,
the same fields and ``compute_beta_angles``), ``BTFTable`` (the tensors of
one material on an explicit device, with the static parameters beside
them), ``table_from_data``, ``pack_btf_table``, ``btf_get_value`` and
``compute_angles``. The chain (ref MLVQ/*.cuh, SURVEY.md section 2.4):

    PDF6 (texel) -> PDF4 (phi, wraparound) -> PDF3 (theta)
    -> PDF2 (luminance and a-b colour over alpha)
    -> PDF1 Hermite in beta and IndexAB -> YCbCr or LogLuv -> RGB

The reference's windowed gathers (``_take_win``) become plain index
arithmetic. Semantics follow the reference exactly: ``jnp.mod`` is floored
(``torch.remainder``), ``astype(int32)`` truncates toward zero,
``jnp.radians``/``jnp.degrees`` are float32 products, three-element sums
run (x + y) + z, divisions by a constant divide (``true_div``; PyTorch's
CUDA ``x / c`` multiplies by a rounded reciprocal). This module is the
plain version of the decode kernel (``csrc/btf.cu``, launched by
``ops/btf.py``), which repeats its operations in the same order. Every
transcendental function (sin, cos, asin, acos, atan2, exp, pow) is taken
in float64 and rounded to float32, here and in the kernel: torch's
float32 ``pow`` and ``atan2`` round differently on the CPU's vectorized
body and its scalar tail, so a lane's result would depend on its place
in the batch, and on CUDA they are other functions again; the rounded
float64 value is the same everywhere (as ``ops/math3d.py``'s ``pow64``
and ``cos_sin`` take it).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytracerfacility_tpu_torch.ops.math3d import pow64, true_div

# float32 (pi / 180) and (180 / pi): jnp.radians and jnp.degrees
DEG2RAD = float(np.float32(math.pi / 180.0))
RAD2DEG = float(np.float32(180.0 / math.pi))

# the 13 arrays of a database, in the reference's order, and their types
ARRAYS = (
    ("pdf6_slices", np.int32), ("pdf6_scales", np.float32),
    ("pdf1_basis", np.float32), ("colors", np.float32),
    ("index_ab", np.int32), ("pdf2_colors", np.int32),
    ("pdf2_slices", np.int32), ("pdf2_scales", np.float32),
    ("index_lum_color", np.int32), ("pdf3_scales", np.float32),
    ("pdf3_slices", np.int32), ("pdf4_scales", np.float32),
    ("pdf4_slices", np.int32),
)


@dataclasses.dataclass
class BTFData:
    """Host-side parsed database (one material). Array shapes follow the
    text database (ref CompressedBTF.cpp:339-377): rows x cols as stored,
    flattened C-order."""

    use_cos_beta: bool
    num_of_beta: int
    num_of_alpha: int
    num_of_theta: int
    num_of_phi: int
    hdr: bool = False
    hdr_value: float = 1.0
    multiplier: float = 1.0
    tex_coord_multiplier: float = 1.0
    gamma: float = 2.2
    code_btf_flag: bool = False
    num_rows: int = 0
    num_cols: int = 0
    rows_offset: int = 0
    cols_offset: int = 0
    pdf6_slices: np.ndarray = None  # (rows*cols,) int32, 1-based
    pdf6_scales: np.ndarray = None  # (rows*cols,) f32
    pdf1_basis: np.ndarray = None  # (numPdf1D * numOfBeta,) f32
    colors: np.ndarray = None  # (numColors * 2,) f32 (a-b pairs)
    index_ab: np.ndarray = None  # (numIndexSlices * numOfBeta,) int32
    pdf2_colors: np.ndarray = None  # (numPdf2DColor * numOfAlpha,) int32
    pdf2_slices: np.ndarray = None  # (numPdf2DLum * numOfAlpha,) int32
    pdf2_scales: np.ndarray = None  # (numPdf2DLum * numOfAlpha,) f32
    index_lum_color: np.ndarray = None  # (numPdf2D * 2,) int32
    pdf3_scales: np.ndarray = None  # (numPdf3D * numOfTheta,) f32
    pdf3_slices: np.ndarray = None  # (numPdf3D * numOfTheta,) int32
    pdf4_scales: np.ndarray = None  # (numPdf4D * numOfPhi,) f32
    pdf4_slices: np.ndarray = None  # (numPdf4D * numOfPhi,) int32
    beta_angles: np.ndarray = None  # (numOfBeta,) f32 degrees

    def compute_beta_angles(self) -> np.ndarray:
        """Ref CompressedBTF.cpp:162-187."""
        n = self.num_of_beta
        if self.use_cos_beta:
            sin_beta = np.minimum(-1.0 + 2.0 * np.arange(n) / (n - 1), 1.0)
            angles = np.degrees(np.arcsin(sin_beta)).astype(np.float32)
            angles[0] = -90.0
            angles[(n - 1) // 2] = 0.0
            angles[n - 1] = 90.0
        else:
            step = 180.0 / (n - 1)
            angles = (np.arange(n) * step - 90.0).astype(np.float32)
            angles[(n - 1) // 2] = 0.0
            angles[n - 1] = 90.0
        return angles


@dataclasses.dataclass(frozen=True)
class BTFTable:
    """One material's arrays on a device, with its static parameters
    (the reference's pytree leaves and aux fields)."""

    pdf6_slices: torch.Tensor
    pdf6_scales: torch.Tensor
    pdf1_basis: torch.Tensor  # one duplicated element at each end
    colors: torch.Tensor
    index_ab: torch.Tensor
    pdf2_colors: torch.Tensor
    pdf2_slices: torch.Tensor
    pdf2_scales: torch.Tensor
    index_lum_color: torch.Tensor
    pdf3_scales: torch.Tensor
    pdf3_slices: torch.Tensor
    pdf4_scales: torch.Tensor
    pdf4_slices: torch.Tensor
    beta_angles: torch.Tensor

    use_cos_beta: bool = True
    num_of_beta: int = 0
    num_of_alpha: int = 0
    num_of_theta: int = 0
    num_of_phi: int = 0
    num_rows: int = 0
    num_cols: int = 0
    rows_offset: int = 0
    cols_offset: int = 0
    hdr: bool = False
    hdr_value: float = 1.0
    multiplier: float = 1.0
    tex_coord_multiplier: float = 1.0
    gamma: float = 2.2
    code_btf_flag: bool = False


def table_arrays(data: BTFData) -> dict:
    """The 14 arrays of :class:`BTFTable` as numpy (ref btf.py:140-160):
    ``pdf1_basis`` gains one duplicated element at each end, so the
    Hermite window at base - 1 .. base + 2 (globally clamped in the
    reference's decoder) is always in bounds: new[i] == old[i - 1]."""
    beta = (data.beta_angles if data.beta_angles is not None
            else data.compute_beta_angles())
    out = {name: np.ascontiguousarray(getattr(data, name), dtype)
           for name, dtype in ARRAYS}
    p1b = out["pdf1_basis"]
    out["pdf1_basis"] = np.concatenate([p1b[:1], p1b, p1b[-1:]])
    out["beta_angles"] = np.ascontiguousarray(beta, np.float32)
    return out


def table_from_data(data: BTFData, device) -> BTFTable:
    """``data``'s tables on ``device`` (ref btf.py:140-181)."""
    arrays = table_arrays(data)
    return BTFTable(
        **{k: torch.tensor(v, device=device) for k, v in arrays.items()},
        use_cos_beta=bool(data.use_cos_beta),
        num_of_beta=int(data.num_of_beta),
        num_of_alpha=int(data.num_of_alpha),
        num_of_theta=int(data.num_of_theta),
        num_of_phi=int(data.num_of_phi),
        num_rows=int(data.num_rows),
        num_cols=int(data.num_cols),
        rows_offset=int(data.rows_offset),
        cols_offset=int(data.cols_offset),
        hdr=bool(data.hdr),
        hdr_value=float(data.hdr_value),
        multiplier=float(data.multiplier),
        tex_coord_multiplier=float(data.tex_coord_multiplier),
        gamma=float(data.gamma),
        code_btf_flag=bool(data.code_btf_flag),
    )


def pack_btf_table(btfs: list, device) -> tuple:
    """A tuple of per-material tables on ``device`` (ref btf.py:184-191)."""
    return tuple(b if isinstance(b, BTFTable) else table_from_data(b, device)
                 for b in btfs)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def f32(x: float) -> float:
    """A Python float rounded to float32 (a constant the reference
    computes in float32, such as 222.921 * offset)."""
    return float(np.float32(x))


def _f64(fn, *args):
    """``fn`` of float32 tensors taken in float64, rounded to float32."""
    return fn(*(a.to(torch.float64) for a in args)).to(torch.float32)


def _pdf1_hermite(t: BTFTable, slice_idx, low, w):
    """Cubic Hermite (Fergusson) interpolation in beta (ref
    MLVQ/PDF1D.cuh:24-69) over the padded ``pdf1_basis``."""
    nb = t.num_of_beta
    base = (slice_idx * nb + low).long()
    pm1, p0 = t.pdf1_basis[base], t.pdf1_basis[base + 1]
    p1, p2 = t.pdf1_basis[base + 2], t.pdf1_basis[base + 3]
    m0 = torch.where(low == 0, p1 - p0, 0.5 * (p1 - pm1))
    m1 = torch.where(low == nb - 2, p1 - p0, 0.5 * (p2 - p0))
    t2 = w * w
    t3 = t2 * w
    h01 = -2.0 * t3 + 3.0 * t2
    h00 = 1.0 - h01
    h11 = t3 - t2
    h10 = h11 - t2 + w
    return h00 * p0 + h10 * m0 + h01 * p1 + h11 * m1


def _index_ab(t: BTFTable, slice_idx, low, w):
    """Linear interpolation of a-b colour indices (ref
    MLVQ/IndexAB.cuh:26-45, VectorColor.cuh:25-30)."""
    base = (slice_idx * t.num_of_beta + low).long()
    c0 = t.index_ab[base].long() * 2
    c1 = t.index_ab[base + 1].long() * 2
    a = (1.0 - w) * t.colors[c0] + w * t.colors[c1]
    b = (1.0 - w) * t.colors[c0 + 1] + w * t.colors[c1 + 1]
    return a, b


def _pdf2(t: BTFTable, pdf2_idx, alpha_low, alpha_w, beta_low, beta_w):
    """PDF2DSeperate: luminance and a-b colour to the user colour model
    (ref MLVQ/PDF2D.cuh:46-59, 86-102, 123-141)."""
    na = t.num_of_alpha
    lc = pdf2_idx.long() * 2
    lum_idx, col_idx = t.index_lum_color[lc], t.index_lum_color[lc + 1]
    cbase = (col_idx * na + alpha_low).long()
    a1, b1 = _index_ab(t, t.pdf2_colors[cbase], beta_low, beta_w)
    a2, b2 = _index_ab(t, t.pdf2_colors[cbase + 1], beta_low, beta_w)
    cm1 = a1 * (1.0 - alpha_w) + a2 * alpha_w
    cm2 = b1 * (1.0 - alpha_w) + b2 * alpha_w
    lbase = (lum_idx * na + alpha_low).long()
    l1 = t.pdf2_scales[lbase] * _pdf1_hermite(t, t.pdf2_slices[lbase], beta_low,
                                              beta_w)
    l2 = t.pdf2_scales[lbase + 1] * _pdf1_hermite(t, t.pdf2_slices[lbase + 1],
                                                  beta_low, beta_w)
    cm0 = (1.0 - alpha_w) * l1 + alpha_w * l2
    return _user_cm_to_rgb(t, cm0, cm1, cm2)


def _user_cm_to_rgb(t: BTFTable, y, cb, cr):
    """Ref MLVQ/CIELab.cuh:8-50 (YCbCr) and :52-167 (LogLuv, HDR)."""
    if t.hdr:
        return _logluv_to_rgb(y, cb, cr, normalized=t.code_btf_flag)
    offset = f32(1.0 / 256.0) if t.code_btf_flag else 1.0
    r = y * 1.1643828 + cr * 1.5960273 - f32(f32(222.921) * offset)
    g = (y * 1.1643828 - cb * 0.39176172 - cr * 0.81296875
         + f32(f32(135.576) * offset))
    b = y * 1.1643828 + cb * 2.0172344 - f32(f32(276.836) * offset)
    return (torch.clamp(r, min=0.0), torch.clamp(g, min=0.0),
            torch.clamp(b, min=0.0))


def _logluv_to_rgb(lum, u, v, normalized: bool):
    """Ref MLVQ/CIELab.cuh:52-167 (Mantiuk 2006 inverse log-luminance)."""
    y = torch.where(
        lum < 98.381, 0.056968 * lum,
        torch.where(
            lum < 1204.7,
            7.3014e-30 * pow64(torch.clamp(lum + 884.17, min=0.0), f32(9.9872)),
            32.994 * _f64(torch.exp, 0.0047811 * torch.clamp(lum, max=4000.0))))
    pos = v > 0.0
    safe_v = torch.where(pos, v, 1.0)
    x = torch.where(pos, 2.25 * u / safe_v * y, 0.0)
    z = torch.where(pos, y * (torch.full_like(safe_v, 1230.0) / safe_v - 5.0)
                    - true_div(x, 3.0), 0.0)
    if normalized:
        x, y, z = x / 256.0, y / 256.0, z / 256.0
    r = x * 3.2406 + y * -1.5372 + z * -0.4986
    g = x * -0.9689 + y * 1.8758 + z * 0.0415
    b = x * 0.0557 + y * -0.2040 + z * 1.0570
    out = []
    for c in (r, g, b):
        c = torch.clamp(c, min=0.0)
        out.append(torch.where(c > 0.0031308,
                               1.055 * pow64(c, f32(1.0 / 2.4)) - 0.055,
                               12.92 * c))
    return tuple(out)


def _cell(x, step: float, hi: int):
    """(low, weight) of ``x`` on a uniform grid of float32 step ``step``:
    low = clip(int(x / step), 0, hi)."""
    low = torch.clamp(true_div(x, step).to(torch.int32), 0, hi)
    return low, true_div(x - low * step, step)


def btf_get_value(t: BTFTable, tex_coord, illumination_theta, illumination_phi,
                  view_theta, view_phi) -> torch.Tensor:
    """``BTFBase::GetValueDeg`` (ref MLVQ/BTFBase.cuh:49-81) over (...,)
    angles in degrees and (..., 2) texture coordinates: linear RGB (..., 3)
    BEFORE the caller's / 256 (ref RayDataDefinations.hpp:347)."""
    # spatial index with tiling (ref PDF6D.cuh:36-46)
    u = tex_coord[..., 0] * t.tex_coord_multiplier
    v = tex_coord[..., 1] * t.tex_coord_multiplier
    x = (u * t.num_cols).to(torch.int32) - t.cols_offset
    y = (v * t.num_rows).to(torch.int32) - t.rows_offset
    x = torch.remainder(x, t.num_cols)
    y = torch.remainder(y, t.num_rows)

    # clockwise -> counter-clockwise phi (ref PDF6D.cuh:49-51)
    view_phi_r = torch.remainder(360.0 - view_phi, 360.0)
    illum_phi_r = torch.remainder((360.0 - illumination_phi) - (90.0 + view_phi_r),
                                  360.0)

    # theta/phi -> beta/alpha (ref SharedCoordinates.cuh:130-167)
    it_rad = illumination_theta * DEG2RAD
    ip_rad = illum_phi_r * DEG2RAD
    cos_ip, sin_ip = _f64(torch.cos, ip_rad), _f64(torch.sin, ip_rad)
    sin_it = _f64(torch.sin, it_rad)
    xx = cos_ip * sin_it
    yy = sin_ip * sin_it
    # code_btf_flag: the reference's tc.m_phi is uninitialized here; 0
    beta_src, alpha_src = (yy, -xx) if t.code_btf_flag else (xx, yy)
    beta = _f64(torch.asin, torch.clamp(beta_src, -1.0, 1.0))
    cos_beta = _f64(torch.cos, beta)
    alpha = torch.where(
        cos_beta < 0.001, 0.0,
        _f64(torch.asin, torch.clamp(alpha_src / torch.clamp(cos_beta, min=0.001),
                                     -1.0, 1.0)))
    beta = torch.clamp(beta * RAD2DEG, -90.0, 90.0)
    alpha = torch.clamp(alpha * RAD2DEG, -90.0, 90.0)
    theta = torch.clamp(view_theta, 0.0, 90.0)
    phi = torch.clamp(view_phi_r, 0.0, 360.0)

    # interpolation cells (ref SharedCoordinates.cuh:56-127)
    nb, na, nt, nphi = t.num_of_beta, t.num_of_alpha, t.num_of_theta, t.num_of_phi
    if t.use_cos_beta:
        beta_low = torch.clamp(
            ((_f64(torch.sin, beta * DEG2RAD) + 1.0) / 2.0 * (nb - 1)).to(torch.int32),
            0, nb - 2)
        b0 = t.beta_angles[beta_low.long()]
        b1 = t.beta_angles[beta_low.long() + 1]
        beta_w = (beta - b0) / (b1 - b0)
    else:
        step_beta = f32(180.0 / (nb - 1))
        beta_low, beta_w = _cell(beta + 90.0, step_beta, nb - 2)
    alpha_low, alpha_w = _cell(alpha + 90.0, f32(180.0 / (na - 1)), na - 2)
    theta_low, theta_w = _cell(theta, f32(90.0 / (nt - 1)), nt - 2)
    phi_low, phi_w = _cell(phi, f32(360.0 / nphi), nphi - 1)

    # PDF6 -> PDF4 (ref PDF6D.cuh:85-94)
    texel = (y * t.num_cols + x).long()
    pdf4_idx = t.pdf6_slices[texel] - 1
    scale6 = t.pdf6_scales[texel]

    def pdf3_eval(pdf3_idx):
        # PDF3: theta interpolation (ref PDF3D.cuh:31-46)
        base = (pdf3_idx * nt + theta_low).long()
        r1, g1, b1_ = _pdf2(t, t.pdf3_slices[base], alpha_low, alpha_w, beta_low,
                            beta_w)
        r2, g2, b2_ = _pdf2(t, t.pdf3_slices[base + 1], alpha_low, alpha_w,
                            beta_low, beta_w)
        s1 = t.pdf3_scales[base] * (1.0 - theta_w)
        s2 = t.pdf3_scales[base + 1] * theta_w
        return r1 * s1 + r2 * s2, g1 * s1 + g2 * s2, b1_ * s1 + b2_ * s2

    # PDF4: two phi slices with wraparound (ref PDF4D.cuh:33-63)
    phi_hi = torch.where(phi_low == nphi - 1, 0, phi_low + 1)
    base4_lo = (pdf4_idx * nphi + phi_low).long()
    base4_hi = (pdf4_idx * nphi + phi_hi).long()
    r1, g1, b1 = pdf3_eval(t.pdf4_slices[base4_lo])
    r2, g2, b2 = pdf3_eval(t.pdf4_slices[base4_hi])
    s1 = t.pdf4_scales[base4_lo] * (1.0 - phi_w)
    s2 = t.pdf4_scales[base4_hi] * phi_w
    out = torch.stack([r1 * s1 + r2 * s2, g1 * s1 + g2 * s2, b1 * s1 + b2 * s2],
                      dim=-1) * scale6[..., None]

    # BTFBase post-ops (ref BTFBase.cuh:72-80)
    out = out * t.multiplier
    if t.hdr:
        out = true_div(out, t.hdr_value)
    out = pow64(torch.clamp(out, min=0.0), f32(t.gamma))

    # out-of-hemisphere queries are black (ref BTFBase.cuh:58-61); NaN
    # angles give 0 too (the reference's choice, btf.py:444-450)
    invalid = (illumination_theta > 90.0) | (view_theta > 90.0)
    bad = ~(torch.isfinite(beta) & torch.isfinite(alpha)
            & torch.isfinite(view_theta) & torch.isfinite(phi))
    return torch.where((invalid | bad)[..., None], 0.0, out)


def compute_angles(direction, normal, tangent):
    """Tangent-space (theta, phi) in degrees of (..., 3) directions (ref
    SurfaceCompressedBTF::ComputeAngles, RayDataDefinations.hpp:290-324;
    ref btf.py:453-473)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    tx_, ty_, tz_ = tangent[..., 0], tangent[..., 1], tangent[..., 2]
    bx, by, bz = ny * tz_ - nz * ty_, nz * tx_ - nx * tz_, nx * ty_ - ny * tx_
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    tx = tx_ * dx + ty_ * dy + tz_ * dz
    ty = bx * dx + by * dy + bz * dz
    tz = nx * dx + ny * dy + nz * dz
    below = tz < 0.0
    theta = _f64(torch.acos, torch.clamp(tz, -1.0, 1.0)) * RAD2DEG
    phi = _f64(torch.atan2, ty, tx) * RAD2DEG + 360.0
    phi = torch.where(phi > 360.0, phi - 360.0, phi)
    theta = torch.where(below, 90.0, theta)
    phi = torch.where(below, 0.0, phi)
    nan = ~torch.isfinite(tx)
    return torch.where(nan, 0.0, theta), torch.where(nan, 0.0, phi)
