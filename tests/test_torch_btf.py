"""MLVQ CompressedBTF materials in the port against the JAX package on the
CPU: the tables, the decode, the tangent-space angles, the compaction of
``ops/btf.py``, the texture coordinates and tangents the decode reads,
BASELINE config 3 under Scene lighting and SingleLightSource, and the
camera facade's BTF golden.

Tolerances:

- tables: equal, element for element;
- decode: ``tests/test_btf_bucketed.py``'s gate, lanes within rtol 1e-5
  and atol 1e-4 with at most 1% cell-boundary flips (a lane whose angle
  or texel lies within an ulp of a cell boundary takes the neighbouring
  cell when XLA's float32 sin, cos and asin and the port's rounded
  float64 ones differ by an ulp); the scalar float64 oracle of
  ``tests/test_mlvq.py`` at its own rtol 2e-4, atol 2e-3;
- angles: within 1e-4 degrees;
- compaction: bit for bit;
- texture coordinates and tangents: ``tests/test_torch_lidar.py``'s
  interpolation tolerances (1e-6 on triangles; on curves 1e-5 and 1e-4
  on the tangent);
- frames: the gates of ``tests/test_fused.py:58-73`` on the difference
  relative to the reference's value where that exceeds 1 (the synthetic
  database decodes to colours up to about 1e5, about 200 after the
  frame's gamma; the bench scenes' frames lie in [0, 1]). The albedo AOV
  of a BTF hit holds the decoded colour itself, so it takes the colour's
  gates: under Scene lighting a sampled direction below the surface is
  illuminated at theta 90, where the reference's beta/alpha conversion
  takes asin at +-1 and an ulp of XLA's sin or asin moves alpha by about
  0.02 degrees (measured: albedo p99 1.7e-3, p99.9 7.4e-3 relative);
  normals at the AOV gate; live rays within max(2, 0.1%);
- golden: SSIM > 0.98, ``tests/test_golden.py``'s gate.
"""

from __future__ import annotations

import dataclasses
import pathlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracerfacility_tpu.enums import (
    EnvironmentalLightingType as RefLighting,
    MaterialType as RefMaterialType,
)
from raytracerfacility_tpu.mlvq import btf as ref_btf
from raytracerfacility_tpu.mlvq.synthetic import synthetic_btf as ref_synthetic
from raytracerfacility_tpu.models import pathtracer as ref_pt
from raytracerfacility_tpu.models.renderer import EnvironmentProperties as RefEnv
from raytracerfacility_tpu.ops.camera import CameraProperties as RefCamera
from raytracerfacility_tpu.ops.shading import interpolate_hit as ref_interpolate
from raytracerfacility_tpu.models.pathtracer import trace_closest as ref_trace_closest
from raytracerfacility_tpu.scene import RayTracerScene as RefScene
from raytracerfacility_tpu.scene import make_sphere as ref_make_sphere
from raytracerfacility_tpu.scene.procedural import build_strands_scene as ref_strands
from raytracerfacility_tpu.utils.image import ssim
from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.convert import btf_data_from_numpy
from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType, MaterialType
from raytracerfacility_tpu_torch.mlvq import btf
from raytracerfacility_tpu_torch.mlvq.synthetic import synthetic_btf
from raytracerfacility_tpu_torch.models import pathtracer as pt
from raytracerfacility_tpu_torch.models import renderer
from raytracerfacility_tpu_torch.models.renderer import (
    EnvironmentProperties,
    RayProperties,
    RayTracerCamera,
)
from raytracerfacility_tpu_torch.ops import btf as ops_btf
from raytracerfacility_tpu_torch.ops.camera import CameraProperties
from raytracerfacility_tpu_torch.ops.shading import interpolate_hit
from raytracerfacility_tpu_torch.scene.procedural import build_strands_scene
from raytracerfacility_tpu_torch.scenes import btf_sphere, cornell_eval
from tests.test_mlvq import scalar_decode
from tests.test_torch_lidar import PORT, REF, _simple
from tests.torch_parity import assert_aov_close, assert_count_close, unfused

CASES = [(seed, hdr, code) for seed in (2, 5) for hdr in (False, True)
         for code in (False, True)]
CASE_IDS = [f"seed{s}-{'hdr' if h else 'ldr'}-{'code' if c else 'plain'}"
            for s, h, c in CASES]
N_QUERIES = 4096
SUN = (0.45, 0.75, 0.35)
GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"


def _databases(seed, hdr, code):
    """The same synthetic database in both packages."""
    ref, port = ref_synthetic(seed=seed, hdr=hdr), synthetic_btf(seed=seed, hdr=hdr)
    ref.code_btf_flag = port.code_btf_flag = code
    return ref, port


def _queries(seed, n=N_QUERIES):
    """Seeded decode queries: texture coordinates in [-2, 2] (negative
    texel indices before the floored remainder), theta in [0, 100]
    (a tenth out of the hemisphere), phi in [-30, 400] (both sides of the
    wraparound), and 1% NaN angles."""
    g = np.random.default_rng(1000 + seed)
    uv = g.uniform(-2.0, 2.0, (n, 2)).astype(np.float32)
    it, vt = (g.uniform(0.0, 100.0, n).astype(np.float32) for _ in range(2))
    ip, vp = (g.uniform(-30.0, 400.0, n).astype(np.float32) for _ in range(2))
    nan = g.choice(n, n // 100, replace=False)
    it[nan[::2]] = np.nan
    vp[nan[1::2]] = np.nan
    return uv, it, ip, vt, vp


@pytest.mark.parametrize("seed,hdr,code", CASES, ids=CASE_IDS)
def test_tables_equal_reference(seed, hdr, code):
    ref, port = _databases(seed, hdr, code)
    theirs = ref_btf.table_from_data(ref)
    mine = btf.table_from_data(port, "cpu")
    for name in btf.table_arrays(port):
        a, b = getattr(mine, name).numpy(), np.asarray(getattr(theirs, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert mine.pdf1_basis.shape[0] == port.pdf1_basis.size + 2
    for f in dataclasses.fields(btf.BTFTable):
        if not isinstance(getattr(mine, f.name), torch.Tensor):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    # the converted reference database packs the same tables
    converted = btf.table_from_data(btf_data_from_numpy(ref), "cpu")
    for name in btf.table_arrays(port):
        assert torch.equal(getattr(converted, name), getattr(mine, name)), name


@pytest.mark.parametrize("seed,hdr,code", CASES, ids=CASE_IDS)
def test_decode_matches_reference(seed, hdr, code):
    ref, port = _databases(seed, hdr, code)
    q = _queries(seed)
    theirs = np.asarray(ref_btf.btf_get_value(ref_btf.table_from_data(ref),
                                              *(jnp.asarray(a) for a in q)))
    mine = btf.btf_get_value(btf.table_from_data(port, "cpu"),
                             *(torch.tensor(a) for a in q)).numpy()
    uv, it, ip, vt, vp = q
    blank = (it > 90.0) | (vt > 90.0) | np.isnan(it) | np.isnan(vp)
    assert (mine[blank] == 0.0).all() and (theirs[blank] == 0.0).all()
    assert np.isfinite(mine).all() and (mine[~blank] > 0.0).any()
    close = np.isclose(mine, theirs, rtol=1e-5, atol=1e-4).all(axis=-1)
    flips = int((~close).sum())
    assert flips <= 0.01 * N_QUERIES, f"{flips} boundary flips"


def test_decode_matches_scalar_oracle():
    data = synthetic_btf()
    table = btf.table_from_data(data, "cpu")
    g = np.random.default_rng(42)
    n = 64
    uv = g.uniform(0, 1, (n, 2)).astype(np.float32)
    ith = g.uniform(0, 89, n).astype(np.float32)
    iph = g.uniform(0, 360, n).astype(np.float32)
    vth = g.uniform(0, 89, n).astype(np.float32)
    vph = g.uniform(0, 360, n).astype(np.float32)
    got = btf.btf_get_value(table, *(torch.tensor(a) for a in (uv, ith, iph, vth,
                                                                vph))).numpy()
    for i in range(n):
        want = scalar_decode(data, uv[i], ith[i], iph[i], vth[i], vph[i])
        np.testing.assert_allclose(got[i], want, rtol=2e-4, atol=2e-3,
                                   err_msg=f"sample {i}")


def _frames(n, seed):
    """Unit view and illumination directions, geometric normals and their
    tangents (as ``tests/test_btf_bucketed.py`` draws them)."""
    g = np.random.default_rng(seed)

    def unit(a):
        return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)

    normal = unit(g.normal(size=(n, 3)))
    tangent = unit(np.cross(normal, np.roll(normal, 1, axis=-1)))
    return unit(g.normal(size=(n, 3))), unit(g.normal(size=(n, 3))), normal, tangent


def test_compute_angles_matches_reference():
    view, _, normal, tangent = _frames(N_QUERIES, 3)
    view[:8] = normal[:8]  # theta 0
    view[8:16] = -normal[8:16]  # below: theta 90, phi 0
    view[16] = np.nan
    theirs = ref_btf.compute_angles(*(jnp.asarray(a) for a in (view, normal, tangent)))
    mine = btf.compute_angles(*(torch.tensor(a) for a in (view, normal, tangent)))
    theta, phi = (np.asarray(a) for a in theirs)
    np.testing.assert_allclose(mine[0].numpy(), theta, rtol=0, atol=1e-4)
    # phi where it is defined: at theta 0 it is the angle of the tangent
    # components' rounding noise (about 1e-8), in either package
    pole = np.zeros(N_QUERIES, bool)
    pole[:8] = True
    np.testing.assert_allclose(mine[1].numpy()[~pole], phi[~pole], rtol=0, atol=1e-4)
    assert (theta[pole] < 0.1).all() and (mine[0].numpy()[pole] < 0.1).all()
    assert (mine[0][8:16] == 90.0).all() and (mine[1][8:17] == 0.0).all()
    assert mine[0][16] == 0.0


def _two_materials():
    return SimpleNamespace(btf=ops_btf.pack_btf_tables(
        [synthetic_btf(seed=3), synthetic_btf(seed=4, hdr=True)], "cpu"))


def test_compaction_equals_dense_decode():
    """``btf_colors`` on the CPU (the plain compaction, then the decode of
    the listed lanes) against the decode of every lane of every table,
    selected per lane: two BTF materials, lanes of no table (slot -1, a
    Default material) and unmasked lanes, which stay ones."""
    scene = _two_materials()
    n = 2048
    g = np.random.default_rng(7)
    view, illum, normal, tangent = (torch.tensor(a) for a in _frames(n, 8))
    uv = torch.tensor(g.uniform(0, 1, (n, 2)).astype(np.float32))
    mask = torch.tensor(g.uniform(size=n) < 0.6)
    slot = torch.tensor(g.integers(-1, 2, n).astype(np.int32))
    got = ops_btf.btf_colors(scene, mask, slot, uv, view, illum, normal, tangent)

    vt, vp = btf.compute_angles(view, normal, tangent)
    it, ip = btf.compute_angles(illum, normal, tangent)
    want = torch.ones((n, 3))
    for k, table in enumerate(scene.btf.tables):
        dense = btf.btf_get_value(table, uv, it, ip, vt, vp) / 256.0
        sel = mask & (slot == k)
        want[sel] = dense[sel]
    assert torch.equal(got, want)
    assert (got[~mask] == 1.0).all() and (got[mask & (slot < 0)] == 1.0).all()
    for k in range(2):  # both materials decoded, and differently
        assert (got[mask & (slot == k)] != 1.0).any()
    assert kernels.LAUNCHES["btf_decode_kernel"] == 0
    # an all-false mask decodes nothing
    none = ops_btf.btf_colors(scene, torch.zeros(n, dtype=torch.bool), slot, uv,
                              view, illum, normal, tangent)
    assert (none == 1.0).all()


def _hit_scenes(case):
    """``tests/test_torch_lidar.py``'s scenes and rays (a ground plane with
    seeded texture coordinates; 4 strands over a plane), the reference's
    compiled without a BVH (its brute-force oracle traces them)."""
    g = np.random.default_rng(4)
    if case == "strands":
        ref = ref_strands(n_strands=4, seed=7).build(build_bvh=False)
        port = build_strands_scene(n_strands=4, seed=7).build("cpu")
        rows = np.nonzero(np.asarray(ref.geometry.kind) == 1)[0]
        target = (np.asarray(ref.geometry.v0)[rows]
                  + 0.5 * np.asarray(ref.geometry.e1)[rows])
        target = np.concatenate([target, g.uniform(-1.5, 1.5, (64, 3)) * [1, 0, 1]])
        o = np.tile(np.array([[0.0, 0.9, 2.4]]), (target.shape[0], 1))
    else:
        ref = _simple(REF, True).build(build_bvh=False)
        port = _simple(PORT, True).build("cpu")
        o = g.uniform(-2.5, 2.5, (512, 3)) * [1, 0, 1] + [0, 1.5, 0]
        target = g.uniform(-1.9, 1.9, (512, 3)) * [1, 0, 1]
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return ref, port, o.astype(np.float32), d


@pytest.mark.parametrize("case", ["plane_attrs", "strands"])
def test_tex_coord_and_tangent_match_reference(case):
    """``interpolate_hit(with_tangent=True, with_vertex_attrs=False)``, the
    wavefront engine's call under ``enable_btf``: the texture coordinates
    (always interpolated; lerped along curve rows) and tangents of the
    reference's, on its own hit records."""
    ref, port, o, d = _hit_scenes(case)
    res = ref_trace_closest(ref, jnp.asarray(o), jnp.asarray(d),
                            jnp.float32(1e-3), jnp.float32(1e20))
    prim, u, v, t = (np.asarray(x) for x in (res.prim, res.u, res.v, res.t))
    hit = prim >= 0

    def ref_fn(scene, prim, u, v, d, o, t):
        return ref_interpolate(scene, prim, u, v, d, origin=o, t_hit=t,
                               with_tangent=True, with_vertex_attrs=False)

    theirs = unfused(ref_fn, ref, *(jnp.asarray(x) for x in (prim, u, v, d, o, t)))
    mine = interpolate_hit(port, *(torch.tensor(x) for x in (prim, u, v, d, o, t)),
                           with_tangent=True, with_vertex_attrs=False)
    assert mine.color is None and mine.data is None
    for name in ("tex_coord", "tangent"):
        tol = 1e-6 if case != "strands" else (1e-4 if name == "tangent" else 1e-5)
        np.testing.assert_allclose(getattr(mine, name).numpy()[hit],
                                   np.asarray(getattr(theirs, name))[hit],
                                   rtol=0, atol=tol, err_msg=name)
    assert np.unique(mine.tex_coord.numpy()[hit], axis=0).shape[0] > 1
    if case == "strands":
        kinds = np.asarray(ref.geometry.kind)[np.clip(prim, 0, None)]
        assert (hit & (kinds == 1)).any() and (hit & (kinds == 0)).any()


def _relative(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


def _colour_gates(rel, what):
    """tests/test_fused.py:58-73's colour gate on a relative difference."""
    assert np.quantile(rel, 0.99) < 2e-3, (what, float(np.quantile(rel, 0.99)))
    assert np.quantile(rel, 0.999) < 5e-2, (what, float(np.quantile(rel, 0.999)))
    assert rel.mean() < 3e-4, (what, float(rel.mean()))


@pytest.mark.parametrize("sls", [False, True], ids=["scene", "sls"])
def test_config3_frame_matches_reference(sls):
    """BASELINE config 3 (``scenes.btf_sphere``) at 32x32, 2 bounces,
    1 spp, 2 pooled frames against the reference's wavefront engine
    (1,024 rays a frame: its dense decode), compiled unfused."""
    w = 32
    scene = RefScene()
    scene.upsert_geometry(1, version=0, mesh=ref_make_sphere(0.6, rings=24, sectors=48))
    scene.upsert_material(2, version=0, material_type=RefMaterialType.COMPRESSED_BTF,
                          btf=ref_synthetic(seed=2))
    scene.upsert_instance(3, version=0, geometry=1, material=2)
    cam = RefCamera(fov=60.0, size=(w, w))
    cam.look_at_target((0.0, 0.4, 2.2), (0.0, 0.0, 0.0))
    lighting = dict(lighting_type=RefLighting.SINGLE_LIGHT_SOURCE) if sls else {}
    renv = (RefEnv(lighting_type=RefLighting.SINGLE_LIGHT_SOURCE, sun_direction=SUN,
                   light_size=0.05) if sls else RefEnv())
    config = ref_pt.RenderConfig(width=w, height=w, bounces=2, samples=1,
                                 enable_btf=True, enable_textures=False,
                                 enable_vertex_color=False, **lighting)
    ref_frame, ref_rays = unfused(
        lambda *a: ref_pt.render_frames_counted(*a[:3], config, a[3], 2),
        scene.build(build_bvh=False), cam.state(), renv.state(),
        ref_pt.init_frame(w, w))

    store, pcam, penv, pconfig = btf_sphere(w, w)
    if sls:
        penv = EnvironmentProperties(
            lighting_type=EnvironmentalLightingType.SINGLE_LIGHT_SOURCE,
            sun_direction=SUN, light_size=0.05)
        pconfig = dataclasses.replace(
            pconfig, lighting_type=EnvironmentalLightingType.SINGLE_LIGHT_SOURCE)
    compiled = store.build("cpu")
    assert compiled.fused is None and compiled.btf is not None
    frame, rays = pt.render_frames_counted(compiled, pcam.state("cpu"),
                                           penv.state("cpu"), pconfig,
                                           pt.init_frame(w, w, "cpu"), 2)
    _colour_gates(_relative(frame.color.numpy(), ref_frame.color), "colour")
    _colour_gates(_relative(frame.albedo.numpy(), ref_frame.albedo), "albedo")
    assert_aov_close(frame.normal.numpy(), np.asarray(ref_frame.normal), "normal")
    assert_count_close(rays, ref_rays)
    # non-vacuous: the sphere is lit and decoded (albedo far from ones)
    albedo = frame.albedo.numpy()[..., :3]
    assert float(np.asarray(ref_frame.color).std()) > 1.0 and albedo.max() > 10.0


def test_facade_renders_btf_golden(monkeypatch):
    """The camera facade derives ``enable_btf`` from the compiled scene and
    renders ``tests/test_golden.py``'s "btf" case (the Cornell box with
    the cube in ``synthetic_btf(seed=2)``, 64x64, 2 bounces, 2 spp, 8
    frames) against ``tests/goldens/btf.npy``."""
    store, _, _ = cornell_eval()
    store.upsert_material(51, version=1, material_type=MaterialType.COMPRESSED_BTF,
                          btf=synthetic_btf(seed=2))
    cam = CameraProperties(fov=90.0, size=(64, 64))
    cam.look_at_target((0.0, 1.0, 2.4), (0.0, 0.9, 0.0))
    facade = RayTracerCamera(store, camera=cam, device="cpu")
    facade.denoiser = None  # the golden is the raw path-traced output
    configs = []
    real = renderer.render_frame
    monkeypatch.setattr(renderer, "render_frame",
                        lambda *a: configs.append(a[3]) or real(*a))
    for _ in range(8):
        img = facade.render(EnvironmentProperties(), RayProperties(bounces=2, samples=2))
    assert len(configs) == 8 and all(c.enable_btf for c in configs)
    golden = np.load(GOLDENS / "btf.npy").astype(np.float32)
    assert np.isfinite(img).all()
    score = ssim(img[..., :3], golden)
    assert score > 0.98, f"SSIM {score:.4f} against the golden"
