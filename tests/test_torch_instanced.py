"""The port's shared-geometry instanced trace (``ops/inst.py``, K4's plain
version; ``scene/builder.py::compile_shared_instanced``) against the JAX
package's (``ops/pallas_inst.py`` in interpret mode), on the scenes of
tests/test_instanced.py, a 3 x 3 sorghum canopy, and the forest of
scripts/bench_instanced.py.

Gates: packed tables equal array for array; hit, prim and instance exact;
t within rtol 3e-5 / atol 1e-6 and u, v within 1e-5 (tests/
test_instanced.py's gates: the reference's Mosaic and XLA code contract
the transform's multiply-adds differently). Against the denormalized bake
(world-space math, K3), hits agree on > 99% of rays and t within 2e-3.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracerfacility_tpu.ops.pallas_inst import (
    pack_instanced_tables as ref_pack,
    trace_closest_instanced as ref_trace,
)
from raytracerfacility_tpu_torch.ops import brute, inst
from raytracerfacility_tpu_torch.scene import builder
from raytracerfacility_tpu_torch.scene.procedural import build_canopy_scene
from raytracerfacility_tpu_torch.scenes import forest
from tests import torch_parity  # noqa: F401  (one torch thread per worker)
from tests.test_instanced import _rays, _scene

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_KEYS = ("table", "sub_aabbs", "obj_chunks", "inst", "step_chunk",
            "step_inst", "step_aabbs")


def _assert_tables_equal(mine, ref):
    for key in REF_KEYS:
        np.testing.assert_array_equal(mine[key].cpu().numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert (mine["chunk"], mine["sub"]) == (ref["chunk"], ref["sub"])


def _assert_traces_equal(mine, mine_iid, ref, ref_iid):
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(mine.hit.numpy(), hit)
    np.testing.assert_array_equal(mine.prim.numpy()[hit], np.asarray(ref.prim)[hit])
    np.testing.assert_array_equal(mine_iid.numpy(), np.asarray(ref_iid))
    np.testing.assert_allclose(mine.t.numpy(), np.asarray(ref.t), rtol=3e-5, atol=1e-6)
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(mine, k).numpy()[hit],
                                   np.asarray(getattr(ref, k))[hit],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _window(r):
    return np.full(r, 1e-3, np.float32), np.full(r, 100.0, np.float32)


def test_pack_matches_reference():
    geoms, inst_geom, mats = _scene()
    mine = inst.pack_instanced_tables(geoms, inst_geom, mats, chunk=128, sub=16,
                                      device="cpu")
    _assert_tables_equal(mine, ref_pack(geoms, inst_geom, mats, chunk=128, sub=16))
    # the port's own keys: each instance's chunk range and the hull of its
    # step boxes
    steps = mine["step_aabbs"][:mine["step_chunk"].shape[0]]
    for i in range(len(mats)):
        mask = mine["step_inst"] == i
        c = mine["step_chunk"][mask]
        assert mine["inst_chunks"][i].tolist() == [int(c[0]), c.shape[0]]
        assert torch.equal(mine["inst_box"][i, 0:3], steps[mask, 0:3].min(0).values)
        assert torch.equal(mine["inst_box"][i, 3:6], steps[mask, 3:6].max(0).values)
    with pytest.raises(ValueError):
        inst.pack_instanced_tables(geoms, inst_geom, mats, chunk=100, sub=16,
                                   device="cpu")


def test_trace_matches_reference():
    """The 900 rays of test_instanced.py::test_instanced_parity_oracle."""
    geoms, inst_geom, mats = _scene()
    tables = inst.pack_instanced_tables(geoms, inst_geom, mats, chunk=128, sub=16,
                                        device="cpu")
    o, d = (np.array(x) for x in _rays(900))
    tmin, tmax = _window(900)
    ref, ref_iid = ref_trace(ref_pack(geoms, inst_geom, mats, chunk=128, sub=16),
                             *(jnp.asarray(x) for x in (o, d, tmin, tmax)))
    mine, iid = inst.trace_closest_instanced(
        tables, *(torch.from_numpy(x) for x in (o, d, tmin, tmax)))
    assert int(mine.hit.sum()) > 150 and len(torch.unique(iid[mine.hit])) >= 3
    _assert_traces_equal(mine, iid, ref, ref_iid)
    # a miss keeps tmax; rays cut short of every hit miss
    assert bool((mine.t[~mine.hit] == 100.0).all())
    short, short_iid = inst.trace_closest_instanced(
        tables, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmin),
        torch.from_numpy(np.minimum(tmax, mine.t.numpy())))
    assert not bool(short.hit.any()) and bool((short_iid == -1).all())


def _canopy_rays(r=600):
    """The rays of test_instanced.py::test_compile_shared_instanced_from_scene."""
    rng = np.random.default_rng(12)
    o = np.array([[0.0, 2.2, 2.2]], np.float32) + np.zeros((r, 3), np.float32)
    d = (rng.standard_normal((r, 3)) * 0.5).astype(np.float32)
    d[:, 1] -= 1.2  # look down into the canopy and the ground
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, *_window(r)


@pytest.fixture(scope="module")
def canopy():
    from raytracerfacility_tpu.scene.builder import (
        compile_shared_instanced as ref_compile,
    )
    from raytracerfacility_tpu.scene.procedural import (
        build_canopy_scene as ref_canopy,
    )

    ref_scene = ref_canopy(rows=3, cols=3, variants=2)
    scene = build_canopy_scene(rows=3, cols=3, variants=2)
    ref_tables = ref_compile(ref_scene, chunk=256, sub=32)
    rays = _canopy_rays()
    return dict(ref_scene=ref_scene, scene=scene, ref_tables=ref_tables,
                tables=builder.compile_shared_instanced(scene, "cpu", chunk=256, sub=32),
                ref=ref_trace(ref_tables, *(jnp.asarray(x) for x in rays)),
                rays=[torch.from_numpy(x) for x in rays])


def test_canopy_scene_matches_reference(canopy):
    ref_scene, scene = canopy["ref_scene"], canopy["scene"]
    assert list(scene.geometries) == list(ref_scene.geometries)
    for key, geom in scene.geometries.items():
        ref_geom = ref_scene.geometries[key]
        assert geom.renderer_type == ref_geom.renderer_type
        for field in ("positions", "triangles", "normals", "tex_coords"):
            np.testing.assert_array_equal(getattr(geom.mesh, field),
                                          getattr(ref_geom.mesh, field), err_msg=field)
        if geom.instance_matrices is not None:
            np.testing.assert_array_equal(geom.instance_matrices,
                                          ref_geom.instance_matrices)
    assert [(i.geometry_key, i.material_key) for i in scene.instances.values()] == [
        (i.geometry_key, i.material_key) for i in ref_scene.instances.values()]


def test_compile_shared_instanced_matches_reference(canopy):
    tables, ref_tables = canopy["tables"], canopy["ref_tables"]
    _assert_tables_equal(tables, ref_tables)
    assert tables["inst"].shape[0] == 10  # 9 plants and the ground
    np.testing.assert_array_equal(tables["instance_material"].numpy(),
                                  ref_tables["instance_material"])
    mine, iid = inst.trace_closest_instanced(tables, *canopy["rays"])
    assert int(mine.hit.sum()) > 100 and len(torch.unique(iid[mine.hit])) >= 3
    _assert_traces_equal(mine, iid, *canopy["ref"])


def test_instanced_matches_denormalized_k3(canopy):
    """K4's plain version against K3's over the world-space bake of the
    same canopy (the gates of test_instanced.py:210-216)."""
    mine, _ = inst.trace_closest_instanced(canopy["tables"], *canopy["rays"])
    world = brute.trace_closest(canopy["scene"].build("cpu").pallas_tris,
                                *canopy["rays"])
    assert int(world.hit.sum()) > 100
    assert float((mine.hit == world.hit).float().mean()) > 0.99
    both = mine.hit & world.hit
    np.testing.assert_allclose(mine.t[both].numpy(), world.t[both].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_compile_shared_instanced_refuses_curves():
    from raytracerfacility_tpu_torch.scenes import strands_scene

    scene, _, _ = strands_scene(8, 8, n_strands=4)
    with pytest.raises(ValueError, match="mesh geometry"):
        builder.compile_shared_instanced(scene, "cpu")


def test_denormalized_bake_ceiling(monkeypatch):
    """The scene of test_incremental.py::test_denormalized_bake_ceiling_error
    is refused before any bake, naming the shared-geometry engine."""
    from raytracerfacility_tpu_torch.enums import RendererType
    from raytracerfacility_tpu_torch.scene import RayTracerScene, make_sphere

    scene = RayTracerScene()
    mesh = make_sphere(0.5, rings=32, sectors=64)
    n_inst = builder.MAX_WORLD_ROWS // mesh.num_triangles + 2
    scene.upsert_geometry(1, version=0, mesh=mesh,
                          renderer_type=RendererType.INSTANCED,
                          instance_matrices=np.tile(np.eye(4, dtype=np.float32),
                                                    (n_inst, 1, 1)))
    scene.upsert_material(2, version=0)
    scene.upsert_instance(3, version=0, geometry=1, material=2)

    def no_bake(geom):
        raise AssertionError("baked before the ceiling check")

    monkeypatch.setattr(builder, "_geometry_object_bake", no_bake)
    with pytest.raises(ValueError, match="compile_shared_instanced"):
        scene.build("cpu")


class _Captured(Exception):
    pass


def test_forest_matches_bench_script(monkeypatch):
    """scenes.forest(16, 4096) against the arrays that
    scripts/bench_instanced.py hands its pack and its trace."""
    spec = importlib.util.spec_from_file_location(
        "bench_instanced", REPO / "scripts" / "bench_instanced.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    seen = {}
    real_pack = script.pack_instanced_tables

    def pack(geoms, inst_geom, mats, **kw):
        seen["geoms"], seen["mats"] = geoms, mats
        return real_pack([tuple(g[:1024] for g in geoms[0])], inst_geom[:1],
                         mats[:1], **kw)

    def trace(tables, o, d, tmin, tmax):
        seen["rays"] = (o, d, tmin, tmax)
        raise _Captured

    monkeypatch.setattr(script, "pack_instanced_tables", pack)
    monkeypatch.setattr(script, "trace_closest_instanced", trace)
    monkeypatch.setattr(sys, "argv", ["bench_instanced.py", "16", "4096"])
    with pytest.raises(_Captured):
        script.main()
    geom, mats, *rays = forest(16, 4096)
    for mine, ref in zip(geom, seen["geoms"][0]):
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(mats, np.stack(seen["mats"]))
    for mine, ref in zip(rays, seen["rays"]):
        np.testing.assert_array_equal(mine, np.asarray(ref))
