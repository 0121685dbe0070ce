"""The port's scene store, bake and packed path tables against the JAX
package's, on the bench scene, plus the convert.py round trip.

Gates: Morton-order permutation, original ids (column 9) and material
slots (column 19) exact; geometry and normal columns within 1e-6 absolute
(the same float32 bake in both, where XLA's CPU code may contract a
multiply-add); the material table exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracerfacility_tpu.ops.bvh import morton_codes as ref_morton_codes
from raytracerfacility_tpu_torch.convert import (
    frame_from_numpy,
    fused_tables_from_numpy,
)
from raytracerfacility_tpu_torch.ops.bvh import morton_codes
from raytracerfacility_tpu_torch.scenes import bench_scene
from tests.torch_parity import port_tables_from_reference, reference_bench


@pytest.fixture(scope="module")
def both():
    ref, _, _ = reference_bench(32, 32)
    scene, _, _ = bench_scene(32, 32)
    return ref, scene.build("cpu")


def test_geometry_bake_matches(both):
    ref, port = both
    assert port.num_tris == ref.num_tris == 2746
    g, rg = port.geometry, ref.geometry
    for name in ("v0", "e1", "e2", "normal", "tangent"):
        np.testing.assert_allclose(getattr(g, name).numpy(),
                                   np.asarray(getattr(rg, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(g.instance.numpy(), np.asarray(rg.instance))
    np.testing.assert_array_equal(port.instance_material.numpy(),
                                  np.asarray(ref.instance_material))
    np.testing.assert_array_equal(port.instance_handle.numpy(),
                                  np.asarray(ref.instance_handle).astype(np.int64))
    np.testing.assert_array_equal(port.materials.albedo.numpy(),
                                  np.asarray(ref.materials.albedo))


@pytest.mark.parametrize("cols,exact", [
    (slice(9, 10), True),    # original primitive id: the Morton order
    (slice(19, 20), True),   # material slot
    (slice(0, 9), False),    # v0, e1, e2
    (slice(10, 19), False),  # n0, n1 - n0, n2 - n0
])
def test_fused_table_columns_match(both, cols, exact):
    ref, port = both
    assert port.fused_chunk == ref.fused_chunk == 256
    mine = port.fused[0].numpy()[:, cols]
    theirs = np.asarray(ref.fused[0])[:, cols]
    assert mine.shape == theirs.shape
    if exact:
        np.testing.assert_array_equal(mine, theirs)
    else:
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-6)


def test_cull_boxes_and_materials_match(both):
    ref, port = both
    for k, name in ((1, "sub_aabbs"), (2, "chunk_aabbs")):
        np.testing.assert_allclose(port.fused[k].numpy(),
                                   np.asarray(ref.fused[k]),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(port.fused[3].numpy(),
                                  np.asarray(ref.fused[3]))


def test_morton_codes_match():
    g = np.random.default_rng(2)
    pts = g.uniform(-2.0, 3.0, (2048, 3)).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    mine = morton_codes(torch.as_tensor(pts), torch.as_tensor(lo),
                        torch.as_tensor(hi)).numpy()
    ref = np.asarray(ref_morton_codes(jnp.asarray(pts), jnp.asarray(lo),
                                      jnp.asarray(hi)))
    np.testing.assert_array_equal(mine, ref.astype(np.int64))


def test_convert_round_trip(both):
    ref, port = both
    tables = port_tables_from_reference(ref)
    for mine, theirs in zip(tables, ref.fused):
        assert mine.dtype == torch.float32
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    # the port's own tables go through unchanged
    again = fused_tables_from_numpy(*(t.numpy() for t in port.fused),
                                    chunk=port.fused_chunk, device="cpu")
    for a, b in zip(again, port.fused):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        fused_tables_from_numpy(np.zeros((100, 20)), np.zeros((4, 8)),
                                np.zeros((8, 8)), np.zeros((8, 8)),
                                chunk=256, device="cpu")

    g = np.random.default_rng(3)
    bufs = [g.uniform(0, 1, (4, 5, 4)).astype(np.float32) for _ in range(3)]
    frame = frame_from_numpy(*bufs, frame_id=7, device="cpu")
    assert frame.frame_id == 7
    for mine, theirs in zip((frame.color, frame.normal, frame.albedo), bufs):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    with pytest.raises(ValueError):
        frame_from_numpy(bufs[0][..., :3], *bufs[1:], frame_id=0, device="cpu")


def test_scene_store_rebuilds_only_when_dirty():
    scene, _, _ = bench_scene(8, 8)
    a = scene.build("cpu")
    assert scene.build("cpu") is a
    scene.upsert_instance(52, version=1, geometry=50, material=51)
    b = scene.build("cpu")
    assert b is not a
    # the sphere moved to the origin: same triangle count, other geometry
    assert b.num_tris == a.num_tris
    assert not torch.equal(b.geometry.v0, a.geometry.v0)
