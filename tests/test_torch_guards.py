"""Guards of the PyTorch port: it never imports JAX (the camera facade,
the denoiser, the LiDAR scanner, the cubemap and sky environments and the
BTF materials with their importer and ``.cbtf`` files included), a CUDA
request never runs on the CPU, no wrapper falls back to its plain version
off the CPU, and renders outside the ported envelope raise
NotImplementedError."""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.enums import (
    EnvironmentalLightingType,
    MaterialType,
    RendererType,
)
from raytracerfacility_tpu_torch.models import pathtracer as pt
from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
from raytracerfacility_tpu_torch.ops import (
    brute,
    btf,
    environment,
    fused,
    inst,
    seg,
    traverse,
)
from raytracerfacility_tpu_torch.ops.bvh import BVH
from raytracerfacility_tpu_torch.scene import MaterialProperties
from raytracerfacility_tpu_torch.scene.builder import compile_shared_instanced
from raytracerfacility_tpu_torch.scenes import bench_scene, btf_sphere, strands_scene

REPO = pathlib.Path(__file__).resolve().parent.parent

_RENDER_8X8 = """
import sys
from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
from raytracerfacility_tpu_torch.models.pathtracer import (
    RenderConfig, init_frame, render_frames_counted)
from raytracerfacility_tpu_torch.scenes import bench_scene, strands_scene
for make in (bench_scene, lambda w, h: strands_scene(w, h, n_strands=40)):
    for lighting in EnvironmentalLightingType.SCENE, EnvironmentalLightingType.SINGLE_LIGHT_SOURCE:
        scene, cam, env = make(8, 8)
        frame, rays = render_frames_counted(
            scene.build("cpu"), cam.state("cpu"), env.state("cpu"),
            RenderConfig(width=8, height=8, bounces=2, lighting_type=lighting),
            init_frame(8, 8, "cpu"), 2)
        assert frame.color.shape == (8, 8, 4) and int(rays) > 0
import numpy as np
from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
for make in (bench_scene, lambda w, h: strands_scene(w, h, n_strands=4)):
    for lighting, props in ((EnvironmentalLightingType.SKYDOME, EnvironmentProperties()),
                            (EnvironmentalLightingType.SCENE, EnvironmentProperties(
                                cubemap=np.ones((6, 4, 4, 3), np.float32)))):
        scene, cam, _ = make(8, 8)
        frame, rays = render_frames_counted(
            scene.build("cpu"), cam.state("cpu"), props.state("cpu"),
            RenderConfig(width=8, height=8, bounces=1, lighting_type=lighting),
            init_frame(8, 8, "cpu"), 1)
        assert frame.color.shape == (8, 8, 4) and int(rays) > 0
from raytracerfacility_tpu_torch.ops.inst import trace_closest_instanced
from raytracerfacility_tpu_torch.scene.builder import compile_shared_instanced
from raytracerfacility_tpu_torch.scene.procedural import build_canopy_scene
import torch
tables = compile_shared_instanced(build_canopy_scene(rows=2, cols=2, variants=2), "cpu")
res, inst = trace_closest_instanced(
    tables, torch.tensor([[0.0, 2.0, 2.0]]).expand(64, 3),
    torch.nn.functional.normalize(torch.randn(64, 3) * 0.3 + torch.tensor([0.0, -1.0, -1.0]), dim=1),
    1e-3, 100.0)
assert int(res.hit.sum()) > 0 and bool(((inst >= 0) == res.hit).all())
from raytracerfacility_tpu_torch.ops.traverse import trace_any_bvh, trace_closest_bvh
scene, cam, env = bench_scene(8, 8)
compiled = scene.build("cpu", build_bvh=True)
assert compiled.pallas_tris is None and compiled.bvh.num_nodes == 2 * 2816 - 1
o = torch.tensor([[0.0, 1.1, 2.6]]).expand(64, 3)
d = torch.nn.functional.normalize(torch.randn(64, 3) * 0.3 + torch.tensor([0.0, -0.2, -1.0]), dim=1)
res = trace_closest_bvh(compiled.bvh, o, d, 0.0, 1e20)
assert int(res.hit.sum()) > 0 and bool((trace_any_bvh(compiled.bvh, o, d, 0.0, 1e20) == res.hit).all())
frame, rays = render_frames_counted(
    compiled, cam.state("cpu"), env.state("cpu"),
    RenderConfig(width=8, height=8, bounces=2), init_frame(8, 8, "cpu"), 1)
assert frame.color.shape == (8, 8, 4) and int(rays) > 64
from raytracerfacility_tpu_torch.models.illumination import TriangleIlluminationEstimator
from raytracerfacility_tpu_torch.scenes import canopy_illumination
scene, items, env, config = canopy_illumination(rows=2, cols=2)
est = TriangleIlluminationEstimator()
est.prepare_light_probe_group(items, "cpu")
est.sample_light_probe_group(scene.build("cpu"), env.state("cpu"), config, seed=1)
assert est.total_flux.sum() > 0
from raytracerfacility_tpu_torch.models.denoiser import default_denoiser
from raytracerfacility_tpu_torch.models.lidar import PointCloudScanner
from raytracerfacility_tpu_torch.models.renderer import RayProperties, RayTracerCamera
scene, cam, env = bench_scene(8, 8)
facade = RayTracerCamera(scene, camera=cam, device="cpu")
img = facade.render(env, RayProperties(bounces=2))
assert facade.denoiser.params is not None and img.shape == (8, 8, 4)
assert PointCloudScanner(size=(0.5, 0.5), distance=(0.1, 0.1)).scan(
    scene.build("cpu"), position=(0.0, 1.0, 2.5)) > 0
assert default_denoiser("cpu").denoise(*(torch.rand(8, 8, 3),) * 3).shape == (8, 8, 3)
from raytracerfacility_tpu_torch.mlvq import import_btf_folder  # noqa: F401
from raytracerfacility_tpu_torch.scenes import btf_sphere
from raytracerfacility_tpu_torch.utils.serialization import load_cbtf  # noqa: F401
scene, cam, env, cfg = btf_sphere(8, 8)
frame, rays = render_frames_counted(scene.build("cpu"), cam.state("cpu"),
                                    env.state("cpu"), cfg, init_frame(8, 8, "cpu"), 1)
assert bool(torch.isfinite(frame.color).all()) and int(rays) > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "raytracerfacility_tpu"))
print("LOADED", bad)
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _RENDER_8X8], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_cuda_request_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    scene, cam, env = bench_scene(8, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        scene.build("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        cam.state("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        pt.init_frame(8, 8, "cuda")
    from raytracerfacility_tpu_torch.models.denoiser import Denoiser, default_denoiser
    from raytracerfacility_tpu_torch.models.lidar import PointCloudScanner
    from raytracerfacility_tpu_torch.models.renderer import RayTracerCamera

    with pytest.raises((RuntimeError, AssertionError)):
        RayTracerCamera(scene, camera=cam)
    with pytest.raises((RuntimeError, AssertionError)):
        default_denoiser()
    with pytest.raises((RuntimeError, AssertionError)):
        Denoiser().load_state_dict(default_denoiser("cpu").params)
    with pytest.raises((RuntimeError, AssertionError)):
        PointCloudScanner().scan(scene.build("cuda"))


def test_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is not on the CPU never gets the plain version."""
    scene, _, _ = bench_scene(8, 8)
    tables = tuple(t.to("meta") for t in scene.build("cpu").fused)
    env = torch.zeros(16, device="meta")
    st = torch.zeros((fused.NPLANES, 64), device="meta")
    rng = torch.zeros(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        seg.segment(tables, env, st, rng, 64, True, True, 256)
    with pytest.raises(ValueError):
        seg.segment(tables, env, st, rng, 64, True, True, 256,
                    miss=torch.zeros(64, device="meta"))
    sky = EnvironmentProperties(lighting_type=EnvironmentalLightingType.SKYDOME)
    with pytest.raises(ValueError):
        environment.miss_radiance(st, st[10:13], torch.zeros(64, device="meta"),
                                  sky.state("meta"), EnvironmentalLightingType.SKYDOME)
    with pytest.raises(ValueError):
        fused.fused_path(tables, torch.zeros((7, 64), device="meta"), rng,
                         env, 2, 256)
    with pytest.raises(ValueError):
        fused.fused_sls(tables, torch.zeros((7, 64), device="meta"), rng,
                        env, 256)
    trace = tuple(t.to("meta") for t in scene.build("cpu").pallas_tris)
    with pytest.raises(ValueError):
        brute.trace_planes(trace, [torch.zeros(64, device="meta")] * 8, 64,
                           any_hit=False)
    tables = {k: v.to("meta") if torch.is_tensor(v) else v for k, v in
              compile_shared_instanced(scene, "cpu").items()}
    with pytest.raises(ValueError):
        inst.trace_planes(tables, [torch.zeros(64, device="meta")] * 8, 64)
    lbvh = scene.build("cpu", build_bvh=True).bvh
    lbvh = BVH(nodes=lbvh.nodes.to("meta"), tris=lbvh.tris.to("meta"),
               tri_prim=lbvh.tri_prim.to("meta"))
    for any_hit in (False, True):
        with pytest.raises(ValueError):
            traverse.trace_planes(lbvh, [torch.zeros(64, device="meta")] * 8, 64,
                                  any_hit)
    with pytest.raises(ValueError):
        seg.block_perm(torch.zeros(2, dtype=torch.int32, device="meta"),
                       torch.zeros((13, 256), device="meta"),
                       torch.zeros(256, dtype=torch.int32, device="meta"),
                       torch.zeros(256, dtype=torch.int64, device="meta"), 128)
    btf_scene, _, _, _ = btf_sphere(8, 8)
    packed = btf_scene.build("cpu").btf
    meta = SimpleNamespace(btf=dataclasses.replace(packed, **{
        k: getattr(packed, k).to("meta") for k in ("floats", "ints", "idesc", "fdesc")}))
    with pytest.raises(ValueError):
        btf.btf_colors(meta, torch.zeros(64, dtype=torch.bool, device="meta"),
                       torch.zeros(64, dtype=torch.int32, device="meta"),
                       torch.zeros((64, 2), device="meta"),
                       *[torch.zeros((64, 3), device="meta")] * 4)


@pytest.mark.parametrize("bad", ["perm_dtype", "perm_length", "block", "dtype",
                                 "alignment", "aliased"])
def test_perm_inputs_are_validated(bad):
    """K6 copies whole 16-byte vectors of each block, reading and writing
    at once: planes it would misread, or outputs that are inputs, never
    launch."""
    st = torch.zeros((13, 1024))
    rng = torch.zeros(1024, dtype=torch.int32)
    orig = torch.zeros(1024, dtype=torch.int64)
    perm = torch.zeros(4, dtype=torch.int32)
    bsize = 256
    out = (torch.empty_like(st), torch.empty_like(rng), torch.empty_like(orig))
    device = torch.device("cpu")
    seg.check_perm_inputs(perm, st, rng, orig, bsize, out, device)
    if bad == "perm_dtype":
        perm = perm.to(torch.int64)
    elif bad == "perm_length":
        perm = perm[:3]
    elif bad == "block":
        bsize = 1024 // 3
    elif bad == "dtype":
        orig = orig.to(torch.int32)
    elif bad == "alignment":  # a view 4 bytes into its storage
        st = torch.zeros(13 * 1024 + 1)[1:].view(13, 1024)
    else:
        out = (out[0], rng, out[2])
    with pytest.raises(ValueError):
        seg.check_perm_inputs(perm, st, rng, orig, bsize, out, device)


@pytest.mark.parametrize("bad", ["chunk", "columns", "env", "offsets"])
def test_kernel_inputs_are_validated(bad):
    """The kernels index tables by chunk and sub-run and planes by 32-bit
    offsets: shapes that would take them out of bounds never launch."""
    scene, _, _ = bench_scene(8, 8)
    tables = scene.build("cpu").fused
    env = torch.zeros(16)
    chunk, rays = 256, 1024
    fused.check_kernel_inputs(tables, env, chunk, rays, 13, torch.device("cpu"))
    if bad == "chunk":
        chunk = 300
    elif bad == "columns":
        tables = (tables[0][:, :12].contiguous(),) + tuple(tables[1:])
    elif bad == "env":
        env = torch.zeros(8)
    else:
        rays = 2**28
    with pytest.raises(ValueError):
        fused.check_kernel_inputs(tables, env, chunk, rays, 13,
                                  torch.device("cpu"))


@pytest.mark.parametrize("bad", ["chunk_range", "range_dtype", "box_rows"])
def test_instanced_tables_are_validated(bad):
    """K4 indexes its object chunks by each instance's chunk range and its
    world boxes by instance: tables that would take it out of bounds never
    launch."""
    scene, _, _ = bench_scene(8, 8)
    tables = compile_shared_instanced(scene, "cpu")
    inst.check_tables(tables, torch.device("cpu"))
    if bad == "chunk_range":
        ranges = tables["inst_chunks"].clone()
        ranges[-1, 1] += 1
        tables["inst_chunks"] = ranges
    elif bad == "range_dtype":
        tables["inst_chunks"] = tables["inst_chunks"].to(torch.int64)
    else:
        tables["inst_box"] = tables["inst_box"][:-1].contiguous()
    with pytest.raises(ValueError):
        inst.check_tables(tables, torch.device("cpu"))


@pytest.mark.parametrize("bad", ["device", "dtype", "columns", "contiguity",
                                 "alignment"])
def test_bvh_tables_are_validated(bad):
    """K5 loads a node as two float4 and a row as three, by 32-bit node
    and row indices: tables it would misread never launch."""
    scene, _, _ = bench_scene(8, 8)
    lbvh = scene.build("cpu", build_bvh=True).bvh
    device = torch.device("cpu")
    traverse.check_bvh(lbvh, device)
    nodes, tris = lbvh.nodes, lbvh.tris
    if bad == "device":
        device = torch.device("meta")
    elif bad == "dtype":
        nodes = nodes.double()
    elif bad == "columns":
        tris = tris[:, :9].contiguous()
    elif bad == "contiguity":
        nodes = torch.cat([nodes, nodes], 1)[:, :8]
    else:  # a view 4 bytes into its storage
        flat = torch.cat([torch.zeros(1), tris.reshape(-1)])
        tris = flat[1:].view(-1, 12)
    with pytest.raises(ValueError):
        traverse.check_bvh(BVH(nodes=nodes, tris=tris, tri_prim=lbvh.tri_prim),
                           device)


@pytest.mark.parametrize("bad", ["count", "dtype", "contiguity", "length",
                                 "device"])
def test_trace_planes_are_validated(bad):
    """The trace kernels (K3, K4, K5) read eight contiguous float32 ray
    planes of at least n rays on the tables' device."""
    planes = [torch.zeros(64) for _ in range(8)]
    device = torch.device("cpu")
    brute.check_planes(planes, 64, device)
    if bad == "count":
        planes = planes[:7]
    elif bad == "dtype":
        planes[3] = planes[3].double()
    elif bad == "contiguity":
        planes[6] = torch.zeros(128)[::2]
    elif bad == "length":
        planes[7] = planes[7][:63]
    else:
        device = torch.device("meta")
    with pytest.raises(ValueError):
        brute.check_planes(planes, 64, device)


def test_package_data_ships_kernel_sources():
    """An installed package carries every source kernels.py compiles:
    pyproject's package data names them, and they sit where kernels.py
    looks for them, beside the installed module."""
    import fnmatch
    import tomllib

    config = tomllib.loads((REPO / "pyproject.toml").read_text())
    patterns = config["tool"]["setuptools"]["package-data"][
        "raytracerfacility_tpu_torch"]
    csrc = pathlib.Path(kernels.__file__).parent / "csrc"
    needed = {*(p.name for p in csrc.glob("*.cuh")), *kernels.SOURCES.values()}
    assert needed == {p.name for p in csrc.iterdir()}
    assert {"path_common.cuh", "sweep.cuh"} <= needed
    for name in needed:
        assert (csrc / name).is_file()
        assert any(fnmatch.fnmatch(f"csrc/{name}", pat) for pat in patterns), name
    # and the denoiser checkpoint models/denoiser.py loads
    from raytracerfacility_tpu_torch.models import denoiser

    package = pathlib.Path(kernels.__file__).parent
    weights = pathlib.Path(denoiser.WEIGHTS).relative_to(package).as_posix()
    assert (package / weights).is_file()
    assert any(fnmatch.fnmatch(weights, pat) for pat in patterns), weights


def test_library_path_hashes_every_header(monkeypatch, tmp_path):
    """On a copy of ``csrc/``, an edit to any header renames every library
    whose source includes it (and the others too: every file is hashed),
    so no stale build survives a header change."""
    import re
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(pathlib.Path(kernels.__file__).parent / "csrc", csrc)
    monkeypatch.setattr(kernels, "_CSRC", csrc)
    includes = {name: set(re.findall(r'#include "([^"]+)"', (csrc / src).read_text()))
                for name, src in kernels.SOURCES.items()}
    assert {"path", "brute"} <= {n for n, inc in includes.items() if "sweep.cuh" in inc}
    for header in sorted(p.name for p in csrc.glob("*.cuh")):
        before = {name: kernels.library_path(name) for name in kernels.SOURCES}
        original = (csrc / header).read_bytes()
        (csrc / header).write_bytes(original + b"\n// edited\n")
        after = {name: kernels.library_path(name) for name in kernels.SOURCES}
        for name, inc in includes.items():
            if header in inc:
                assert after[name] != before[name], (header, name)
        (csrc / header).write_bytes(original)
        assert {name: kernels.library_path(name) for name in kernels.SOURCES} == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


def _render(scene, env_props, **config):
    cfg = pt.RenderConfig(width=8, height=8, bounces=1, **config)
    _, cam, _ = bench_scene(8, 8)
    return pt.render_frame_counted(
        scene.build("cpu"), cam.state("cpu"), env_props.state("cpu"), cfg,
        pt.init_frame(8, 8, "cpu"))


@pytest.mark.parametrize("case", ["alpha_test", "btf_config", "subsurface_config"])
def test_render_outside_envelope_raises(case, monkeypatch):
    """What the port still refuses: alpha testing and subsurface.
    ``enable_btf`` is ported: on a scene without BTF materials it renders
    on the wavefront engine (the path engines do not shade BTF) the frame
    that engine renders without it."""
    scene, cam, env = bench_scene(8, 8)
    config = {}
    if case == "alpha_test":
        config["alpha_test"] = True
    elif case == "btf_config":
        compiled = scene.build("cpu")
        cfg = pt.RenderConfig(width=8, height=8, bounces=1)
        args = (cam.state("cpu"), env.state("cpu"))
        wave, _ = pt.render_frame_counted(dataclasses.replace(compiled, fused=None),
                                          *args, cfg, pt.init_frame(8, 8, "cpu"))
        calls = []
        for name in ("render_pool_fused", "render_pool_sorted"):
            monkeypatch.setattr(pt, name, lambda *a, **k: calls.append(a))
        real = pt.trace_radiance_counted
        monkeypatch.setattr(pt, "trace_radiance_counted",
                            lambda *a, **k: calls.append("wavefront") or real(*a, **k))
        frame, rays = pt.render_frame_counted(
            compiled, *args, dataclasses.replace(cfg, enable_btf=True),
            pt.init_frame(8, 8, "cpu"))
        assert calls == ["wavefront"] and int(rays) > 0
        for name in ("color", "normal", "albedo"):
            assert torch.equal(getattr(frame, name), getattr(wave, name)), name
        return
    else:
        config["enable_subsurface"] = True
    with pytest.raises(NotImplementedError):
        _render(scene, env, **config)


@pytest.mark.parametrize("bad", ["flat", "miss_dtype", "rows", "short", "stride",
                                 "cubemap_channels", "cubemap_alignment"])
def test_miss_inputs_are_validated(bad):
    """The miss kernel reads path-state planes by row stride, the miss
    plane by ray and the cubemap's texels as float4: inputs it would
    misread never launch, and the flat colour never reaches it."""
    st = torch.zeros((13, 256))
    rad, miss, out = st[10:13], torch.zeros(200), torch.zeros((3, 200))
    cube = torch.zeros((6, 4, 4, 4))
    device = torch.device("cpu")
    environment.check_miss_inputs(st, rad, miss, out, cube, device)
    if bad == "flat":
        with pytest.raises(ValueError):
            environment.miss_radiance(st, rad, miss, EnvironmentProperties().state("cpu"),
                                      EnvironmentalLightingType.SCENE)
        return
    if bad == "miss_dtype":
        miss = miss.double()
    elif bad == "rows":
        st = st[:9]
    elif bad == "short":
        out = out[:, :199]
    elif bad == "stride":
        rad = torch.zeros((200, 3)).T
    elif bad == "cubemap_channels":
        cube = cube[..., :3].contiguous()
    else:  # a view 4 bytes into its storage
        cube = torch.zeros(6 * 4 * 4 * 4 + 1)[1:].view(6, 4, 4, 4)
    with pytest.raises(ValueError):
        environment.check_miss_inputs(st, rad, miss, out, cube, device)


@pytest.mark.parametrize("case", [
    "texture", "btf_material", "vertex_color", "subsurface", "skinned",
    "tessellated_curve"])
def test_scene_outside_envelope_raises(case):
    """What the bake still refuses. A CompressedBTF material is ported:
    without a database it bakes as the reference's does (slot -1, no
    tables; its lanes shade as ones), without the path engines' tables,
    and renders on the wavefront engine."""
    scene, cam, env = bench_scene(8, 8)
    if case == "texture":
        scene.upsert_material(51, version=1,
                              albedo_texture=np.ones((4, 4, 4), np.float32))
    elif case == "btf_material":
        scene.upsert_material(51, version=1,
                              material_type=MaterialType.COMPRESSED_BTF)
        compiled = scene.build("cpu")
        slot = int(compiled.instance_material[
            list(scene.instances).index(52)])  # the sphere's material
        assert compiled.fused is None and compiled.btf is None
        assert compiled.pallas_tris is not None
        assert int(compiled.materials.material_type[slot]) == MaterialType.COMPRESSED_BTF
        assert int(compiled.materials.btf_index[slot]) == -1
        frame, rays = pt.render_frame_counted(
            compiled, cam.state("cpu"), env.state("cpu"),
            pt.RenderConfig(width=8, height=8, bounces=1, enable_btf=True),
            pt.init_frame(8, 8, "cpu"))
        assert bool(torch.isfinite(frame.color).all()) and int(rays) > 0
        return
    elif case == "vertex_color":
        scene.upsert_material(51, version=1,
                              material_type=MaterialType.VERTEX_COLOR)
    elif case == "subsurface":
        scene.upsert_material(51, version=1, properties=MaterialProperties(
            subsurface_factor=0.5))
    elif case == "skinned":
        scene.upsert_geometry(50, version=1, renderer_type=RendererType.SKINNED)
    else:
        scene, _, _ = strands_scene(8, 8, n_strands=4)
        scene.upsert_geometry(1, version=1, renderer_type=RendererType.CURVE,
                              curve_mode="tessellate")
    with pytest.raises(NotImplementedError):
        scene.build("cpu")
