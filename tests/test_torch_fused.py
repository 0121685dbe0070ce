"""The port's whole-path engine (ops/fused.py, plain K2) against the JAX
package's ``render_pool_fused(lighting=0)`` (its Pallas kernel in
interpret mode) on the same ray pool and identical tables.

Gates (tests/torch_parity.py): radiance by the frame-colour quantiles,
AOVs |d| 99.9th percentile < 5e-3, live ray-segments within max(2, 0.1%).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracerfacility_tpu.ops.camera import generate_camera_rays
from raytracerfacility_tpu.ops.pallas_fused import render_pool_fused as ref_pool
from raytracerfacility_tpu.ops.rng import lcg_init
from raytracerfacility_tpu_torch.ops import fused
from tests.torch_parity import (
    assert_aov_close,
    assert_color_close,
    assert_count_close,
    port_tables_from_reference,
    reference_bench,
    reference_env_vector,
)

W, H = 32, 24


@pytest.fixture(scope="module")
def pool():
    """A 32x24 camera pool with a few invalid rays, from the reference's
    camera code."""
    compiled, cam, env = reference_bench(W, H)
    iy, ix = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    pix = (ix + W * iy).astype(np.uint32)
    rng = lcg_init(jnp.asarray(pix), jnp.full(pix.shape, 9, jnp.uint32))
    rng, o, d = generate_camera_rays(cam.state(), rng, jnp.asarray(ix),
                                     jnp.asarray(iy), W, H)
    n = W * H
    valid = np.ones(n, np.float32)
    valid[np.random.default_rng(6).choice(n, 20, replace=False)] = 0.0
    arrays = (np.array(o).reshape(n, 3), np.array(d).reshape(n, 3),
              np.array(rng).reshape(n), valid)
    return compiled, reference_env_vector(env.state()), arrays


@pytest.mark.parametrize("bounces", [1, 3])
def test_plain_k2_matches_reference(pool, bounces):
    compiled, env_vec, (o, d, rng, valid) = pool
    ref = ref_pool(compiled.fused, jnp.asarray(o), jnp.asarray(d),
                   jnp.asarray(rng), jnp.asarray(valid), jnp.asarray(env_vec),
                   bounces=bounces, lighting=0, interpret=True,
                   chunk=compiled.fused_chunk)
    mine = fused.render_pool_fused(
        port_tables_from_reference(compiled), torch.as_tensor(o),
        torch.as_tensor(d), torch.as_tensor(rng.astype(np.int64)),
        torch.as_tensor(valid), torch.as_tensor(env_vec), bounces=bounces,
        chunk=compiled.fused_chunk)
    assert_color_close(mine[0].numpy(), np.asarray(ref[0]), "radiance")
    for k, name in ((1, "normal"), (2, "albedo"), (3, "position")):
        assert_aov_close(mine[k].numpy(), np.asarray(ref[k]), name)
    assert_count_close(mine[4], ref[4])
    # invalid rays: no radiance, no-hit AOVs, not counted
    dead = valid == 0
    assert (mine[0].numpy()[dead] == 0).all()
    assert (mine[3].numpy()[dead] == 999999.0).all()
    assert float(np.asarray(ref[0]).std()) > 0.02  # non-vacuous


def test_k2_counts_live_ray_segments(pool):
    """bounces=0 runs one segment: the count is the valid rays."""
    compiled, env_vec, (o, d, rng, valid) = pool
    out = fused.render_pool_fused(
        port_tables_from_reference(compiled), torch.as_tensor(o),
        torch.as_tensor(d), torch.as_tensor(rng.astype(np.int64)),
        torch.as_tensor(valid), torch.as_tensor(env_vec), bounces=0,
        chunk=compiled.fused_chunk)
    assert int(out[4]) == int(valid.sum())


def test_single_light_source_pool_raises(pool):
    """K2's SingleLightSource phase runs its plain version on CPU tensors
    only: a pool on another device (here ``meta``) raises instead of
    falling back (its parity with the reference is in test_torch_sls.py)."""
    compiled, env_vec, (o, d, rng, valid) = pool
    args = (torch.as_tensor(o), torch.as_tensor(d),
            torch.as_tensor(rng.astype(np.int64)), torch.as_tensor(valid),
            torch.as_tensor(env_vec))
    tables = port_tables_from_reference(compiled)
    out = fused.render_pool_fused(tables, *args, bounces=1,
                                  chunk=compiled.fused_chunk, lighting=1)
    assert int(out[4]) == int(valid.sum())
    with pytest.raises(ValueError):
        fused.render_pool_fused(tuple(t.to("meta") for t in tables),
                                *(a.to("meta") for a in args), bounces=1,
                                chunk=compiled.fused_chunk, lighting=1)


def test_pack_material_table_layout():
    from raytracerfacility_tpu_torch.scene.compiled import MaterialTable

    mats = MaterialTable(
        albedo=torch.tensor([[0.1, 0.2, 0.3], [0.4, 0.5, 0.6], [0.7, 0.8, 0.9]]),
        roughness=torch.tensor([0.5, 0.6, 0.7]),
        metallic=torch.tensor([0.0, 0.8, 0.2]),
        emission=torch.tensor([0.0, 0.0, 2.0]))
    t = fused.pack_material_table(mats)
    assert t.shape == (8, 8)
    assert torch.equal(t[:3, 0:3], mats.albedo)
    assert torch.equal(t[:3, 3], mats.roughness)
    assert torch.equal(t[:3, 4], mats.metallic)
    assert torch.equal(t[:3, 5], mats.emission)
    assert not t[3:].any() and not t[:, 6:].any()
