"""The port's TEA/LCG RNG and camera rays against the JAX package and the
independent numpy transcription in tests/test_oracle.py.

RNG states must be bit-exact (integer arithmetic). Camera rays agree
within 1e-6 absolute: the same float32 operations in the same order,
where XLA's CPU code may contract a multiply-add into an FMA.
"""

from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp

from raytracerfacility_tpu.ops import camera as ref_camera
from raytracerfacility_tpu.ops import rng as ref_rng
from raytracerfacility_tpu_torch.ops import camera, rng
from tests.test_oracle import lcg as oracle_lcg
from tests.test_oracle import tea_init as oracle_tea_init


def _u32(a):
    return torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64))


def test_lcg_init_bit_exact():
    g = np.random.default_rng(0)
    v0 = g.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    v1 = g.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    v0[:4] = [0, 0xFFFFFFFF, 0x80000000, 7]
    mine = rng.lcg_init(_u32(v0), _u32(v1)).numpy()
    ref = np.asarray(ref_rng.lcg_init(jnp.asarray(v0), jnp.asarray(v1)))
    np.testing.assert_array_equal(mine, ref.astype(np.int64))
    for k in range(16):
        assert mine[k] == oracle_tea_init(int(v0[k]), int(v1[k]))


def test_lcg_next_bit_exact():
    g = np.random.default_rng(1)
    s = g.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    s[:3] = [0, 0xFFFFFFFF, 0x7FFFFFFF]
    st = _u32(s)
    ref = jnp.asarray(s)
    for _ in range(3):
        st, val = rng.lcg_next(st)
        ref, rval = ref_rng.lcg_next(ref)
        np.testing.assert_array_equal(st.numpy(), np.asarray(ref).astype(np.int64))
        np.testing.assert_array_equal(val.numpy(), np.asarray(rval))
    state = int(s[5])
    st5 = _u32(s[5:6])
    for _ in range(4):
        state, value = oracle_lcg(state)
        st5, v5 = rng.lcg_next(st5)
        assert int(st5[0]) == state and float(v5[0]) == value


def test_int32_round_trip():
    s = _u32([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
    i = rng.to_int32(s)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(
        i.numpy(), np.asarray([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                              np.uint32).view(np.int32))
    np.testing.assert_array_equal(rng.from_int32(i).numpy(), s.numpy())


def test_camera_rays_match_reference():
    """Bench camera at 32x24: the same pixel grid and seeds through both
    packages' lcg_init + generate_camera_rays."""
    import __graft_entry__ as ge
    from raytracerfacility_tpu_torch.scenes import bench_scene

    w, h = 32, 24
    _, ref_cam, _ = ge._bench_scene(w, h)
    _, cam, _ = bench_scene(w, h)
    ref_state = ref_cam.state()
    state = cam.state("cpu")
    np.testing.assert_array_equal(state.inverse_projection_view.numpy(),
                                  np.asarray(ref_state.inverse_projection_view))

    iy, ix = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    pix = (ix + w * iy).astype(np.uint32)
    seeds = np.full(pix.shape, 3, np.uint32)
    r_rng, r_o, r_d = ref_camera.generate_camera_rays(
        ref_state, ref_rng.lcg_init(jnp.asarray(pix), jnp.asarray(seeds)),
        jnp.asarray(ix), jnp.asarray(iy), w, h)
    p_rng, p_o, p_d = camera.generate_camera_rays(
        state, rng.lcg_init(_u32(pix), _u32(seeds)),
        torch.as_tensor(ix), torch.as_tensor(iy), w, h)
    np.testing.assert_array_equal(p_rng.numpy(), np.asarray(r_rng).astype(np.int64))
    np.testing.assert_allclose(p_o.numpy(), np.asarray(r_o), rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_d.numpy(), np.asarray(r_d), rtol=0, atol=1e-6)
    assert np.isfinite(p_d.numpy()).all()


def test_camera_aperture_rays_match_reference():
    """Thin-lens rays (aperture > 0) take the third draw and sin/cos."""
    w, h = 16, 16
    cam = camera.CameraProperties(fov=60.0, size=(w, h), aperture=0.05,
                                  focal_length=2.0)
    cam.look_at_target((0.3, 1.0, 2.0), (0.0, 0.5, 0.0))
    ref = ref_camera.CameraProperties(fov=60.0, size=(w, h), aperture=0.05,
                                      focal_length=2.0)
    ref.look_at_target((0.3, 1.0, 2.0), (0.0, 0.5, 0.0))
    iy, ix = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    seeds = (ix + w * iy).astype(np.uint32)
    _, r_o, r_d = ref_camera.generate_camera_rays(
        ref.state(), jnp.asarray(seeds), jnp.asarray(ix), jnp.asarray(iy), w, h)
    _, p_o, p_d = camera.generate_camera_rays(
        cam.state("cpu"), _u32(seeds), torch.as_tensor(ix),
        torch.as_tensor(iy), w, h)
    np.testing.assert_allclose(p_o.numpy(), np.asarray(r_o), rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_d.numpy(), np.asarray(r_d), rtol=0, atol=1e-6)
