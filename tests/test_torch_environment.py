"""The port's environment lighting (ops/texture.py, ops/environment.py)
against the JAX package's: the texture-stack and cubemap fetches, the CIE
sky, the Nishita sky (both of tests/test_nishita_clamp.py's cases on the
port's function and on the miss kernel's plain version), the sky's
per-sample terms summed in the 16-lane kernel's order, the miss shader
in all three modes, the plain miss radiance, ``EnvironmentProperties``
with the atmosphere fields, the defaults' device, and
``convert.environment_from_numpy``.

Inputs are made from a seed with numpy: a few hundred directions that
include the six axes, face edges and corners, and rays below the horizon.

Tolerances: the fetches and the flat modes are equal (the same float32
operations in the same order). The sky is compared with the reference
compiled unfused (tests/torch_parity.py::unfused): its height is a
difference of two numbers near the Earth's radius (6.36e6 m, where a
float32 resolves 0.5 m) that then passes through exp(-h / 1200), and the
two packages' float32 exp and pow round differently, so it agrees within
1e-4 relative and 1e-6 absolute (measured: 3.5e-6 relative, 1.5e-6 absolute
at a largest radiance of 0.70). The CIE sky within 1e-5 relative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracerfacility_tpu.enums import EnvironmentalLightingType as RefLighting
from raytracerfacility_tpu.models.renderer import EnvironmentProperties as RefProps
from raytracerfacility_tpu.ops import environment as ref_env
from raytracerfacility_tpu.ops import texture as ref_tex
from raytracerfacility_tpu_torch.convert import environment_from_numpy
from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
from raytracerfacility_tpu_torch.ops import environment, texture
from raytracerfacility_tpu_torch.ops.fused import NPLANES, init_state
from tests.torch_parity import unfused

SUN = (0.2, 0.8, 0.3)


def _directions(n=400, seed=0):
    """Unit directions: the six axes, face edges and cube corners, then
    random ones (about half below the horizon)."""
    g = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(2.0)
    fixed = [np.eye(3)[i] * sign for i in range(3) for sign in (1.0, -1.0)]
    fixed += [(s, s, 0.0), (-s, 0.0, s), (0.0, -s, -s), (s, -s, 0.0)]
    fixed += [np.array(c) / np.sqrt(3.0) for c in
              ((1, 1, 1), (-1, 1, -1), (1, -1, -1), (-1, -1, 1))]
    d = g.standard_normal((n - len(fixed), 3))
    d = np.concatenate([np.array(fixed, np.float64), d])
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _cubemap(h, w, seed=1):
    return np.random.default_rng(seed).uniform(0.0, 1.5, (6, h, w, 4)).astype(np.float32)


def _envs(cubemap=None, **kw):
    """The same environment in both packages (through convert.py)."""
    ref = ref_env.EnvironmentState.default(
        sun_direction=jnp.asarray(np.array(SUN, np.float32) / np.linalg.norm(SUN)),
        cubemap=None if cubemap is None else jnp.asarray(cubemap),
        **{k: jnp.float32(v) for k, v in kw.items()})
    return ref, environment_from_numpy(jax.tree_util.tree_map(np.asarray, ref), "cpu")


@pytest.mark.parametrize("h,w", [(8, 8), (5, 7)])
def test_sample_cubemap_matches_reference(h, w):
    faces = _cubemap(h, w)
    d = _directions()
    ref = np.asarray(ref_tex.sample_cubemap(jnp.asarray(faces), jnp.asarray(d)))
    mine = texture.sample_cubemap(torch.tensor(faces), torch.tensor(d)).numpy()
    np.testing.assert_array_equal(mine, ref)
    face, _ = texture.cubemap_face_uv(torch.tensor(d[:6]))
    assert face.tolist() == [0, 1, 2, 3, 4, 5]  # +X -X +Y -Y +Z -Z


def test_sample_stack_bilinear_matches_reference():
    """Wrap addressing inside each texture of a padded stack, uv outside
    [0, 1] included."""
    g = np.random.default_rng(2)
    texels = g.uniform(size=(3, 6, 9, 4)).astype(np.float32)
    sizes = np.array([[6, 9], [4, 5], [3, 9]], np.int32)
    index = g.integers(-1, 4, size=500).astype(np.int32)
    uv = g.uniform(-2.0, 3.0, size=(500, 2)).astype(np.float32)
    ref = np.asarray(ref_tex.sample_stack_bilinear(
        jnp.asarray(texels), jnp.asarray(sizes), jnp.asarray(index), jnp.asarray(uv)))
    mine = texture.sample_stack_bilinear(torch.tensor(texels), torch.tensor(sizes),
                                         torch.tensor(index), torch.tensor(uv))
    np.testing.assert_array_equal(mine.numpy(), ref)


def test_cie_sky_intensity_matches_reference():
    d = _directions()
    sun = np.array(SUN, np.float32) / np.linalg.norm(SUN)
    zenith = np.array([0.0, 1.0, 0.0], np.float32)
    ref = np.asarray(ref_env.cie_sky_intensity(jnp.asarray(d), jnp.asarray(sun),
                                               jnp.asarray(zenith)))
    mine = environment.cie_sky_intensity(torch.tensor(d), torch.tensor(sun),
                                         torch.tensor(zenith)).numpy()
    assert np.isfinite(mine).all()
    np.testing.assert_allclose(mine, ref, rtol=1e-5)


def test_nishita_sky_matches_reference():
    d = _directions()
    pos = (np.random.default_rng(3).standard_normal((d.shape[0], 3)) * 50.0
           ).astype(np.float32)
    renv, penv = _envs()
    ref = np.asarray(unfused(lambda p, v, e: ref_env.nishita_sky(p, v, e),
                             jnp.asarray(pos), jnp.asarray(d), renv))
    mine = environment.nishita_sky(torch.tensor(pos), torch.tensor(d), penv).numpy()
    assert np.isfinite(mine).all()
    np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-6)
    assert (ref.sum(1) > 0).mean() > 0.4  # non-vacuous: the sky shines


SKY_LANES = 16  # csrc/env.cu kSkyLanes: lanes a missed ray under the sky


def _sky_in_lanes(pos, d, env, ns, nl):
    """``nishita_sky`` summed as ``miss_radiance_kernel`` sums the sky: lane
    s of a 16-lane group holds view sample s, in rounds of 16; lane 0 adds
    its density weight to the carry of the last round and each lane adds
    its own to the previous lane's total; the attenuated weights are
    gathered in sample order."""
    valid, phase_r, phase_m, hr_i, hm_i, light_r, light_m, light_valid = (
        environment._nishita_terms(pos, d, env, ns, nl))
    optical_r, optical_m = torch.empty_like(hr_i), torch.empty_like(hm_i)
    carry_r, carry_m = torch.zeros_like(hr_i[:, 0]), torch.zeros_like(hm_i[:, 0])
    for first in range(0, ns, SKY_LANES):
        total_r, total_m = carry_r, carry_m
        for s in range(first, min(first + SKY_LANES, ns)):
            total_r, total_m = total_r + hr_i[:, s], total_m + hm_i[:, s]
            optical_r[:, s], optical_m[:, s] = total_r, total_m
        carry_r, carry_m = total_r, total_m
    od_r, od_m = optical_r + light_r, optical_m + light_m
    out = []
    for c in range(3):
        beta_r, beta_m = float(environment._BETA_R[c]), float(environment._BETA_M[c])
        att = torch.exp(-(beta_r * od_r + float(environment._BETA_M_EXT[c]) * od_m))
        w_r = torch.where(light_valid, att * hr_i, 0.0)
        w_m = torch.where(light_valid, att * hm_i, 0.0)
        sum_r, sum_m = w_r[:, 0], w_m[:, 0]
        for s in range(1, ns):
            sum_r, sum_m = sum_r + w_r[:, s], sum_m + w_m[:, s]
        out.append((sum_r * beta_r * phase_r + sum_m * beta_m * phase_m) * 20.0)
    return torch.where(valid[:, None], torch.stack(out, dim=-1), 0.0)


@pytest.mark.parametrize("ns,nl", [(16, 8), (20, 8), (7, 3)])
def test_nishita_sky_summed_in_lanes_equals_serial_sums(ns, nl):
    """The per-view-sample terms, summed in the 16-lane kernel's order (more
    than 16 samples in rounds, fewer on some lanes), equal ``nishita_sky``
    bit for bit: the lanes add the same terms in the same order."""
    d = _directions()
    pos = (np.random.default_rng(7).standard_normal((d.shape[0], 3)) * 50.0
           ).astype(np.float32)
    _, penv = _envs()
    pos, d = torch.tensor(pos), torch.tensor(d)
    want = environment.nishita_sky(pos, d, penv, ns, nl)
    assert torch.equal(_sky_in_lanes(pos, d, penv, ns, nl), want)
    assert float(want.sum(1).gt(0).float().mean()) > 0.4


def _horizon_dirs(n, up_min, up_max, seed=0):
    """tests/test_nishita_clamp.py::_dirs: y uniform in [up_min, up_max]."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    y = up_min + (up_max - up_min) * rng.random(n).astype(np.float32)
    horiz = np.sqrt(np.maximum(1.0 - y * y, 1e-8))
    xz = d[:, [0, 2]]
    xz /= np.linalg.norm(xz, axis=1, keepdims=True)
    return np.stack([xz[:, 0] * horiz, y, xz[:, 1] * horiz], axis=1).astype(np.float32)


def _skies(d):
    """The port's nishita_sky and the miss kernel's plain version (with
    unit throughput and skylight, gamma 1) from the ground at the origin."""
    _, penv = _envs()
    n = d.shape[0]
    sky = environment.nishita_sky(torch.zeros(n, 3), torch.tensor(d), penv)
    st = init_state(torch.zeros(n, 3), torch.tensor(d), torch.ones(n))
    rad = torch.zeros(3, n)
    environment.miss_radiance(st, rad, torch.ones(n), penv,
                              EnvironmentalLightingType.SKYDOME)
    return sky.numpy(), rad.T.numpy()


def test_nishita_clamp_inactive_above_horizon():
    """tests/test_nishita_clamp.py's first case on the port: above the
    horizon every exponent is far below the clamp, and the sky shines."""
    d = _horizon_dirs(256, 0.02, 1.0)
    earth_r, atmo_r = 6360.0 * 1000.0, 6420.0 * 1000.0
    orig = np.array([0.0, earth_r, 0.0])
    b = 2.0 * d.astype(np.float64) @ orig
    t1 = (-b + np.sqrt(b * b - 4 * (orig @ orig - atmo_r**2))) / 2.0
    t_mid = (np.arange(16)[None] + 0.5) * (t1 / 16.0)[:, None]
    height = np.linalg.norm(orig + t_mid[..., None] * d[:, None], axis=-1) - earth_r
    assert (-height / 7994.0).max() < 1.0  # nowhere near the 60 clamp
    for sky in _skies(d):
        assert np.isfinite(sky).all()
        assert (sky.sum(axis=1) > 0).mean() > 0.9


def test_nishita_below_horizon_finite_and_dark():
    """tests/test_nishita_clamp.py's second case on the port: rays that
    march below the ground stay finite and dark against the sky."""
    down = _horizon_dirs(256, 0.05, 1.0)
    down[:, 1] *= -1.0
    up = _horizon_dirs(256, 0.2, 1.0, seed=1)
    for below, above in zip(_skies(down), _skies(up)):
        assert np.isfinite(below).all()
        assert below.mean() < 0.05 * above.mean(), (below.mean(), above.mean())


MODES = {"scene_flat": (RefLighting.SCENE, False),
         "scene_cubemap": (RefLighting.SCENE, True),
         "skydome": (RefLighting.SKYDOME, False),
         "single_light_source": (RefLighting.SINGLE_LIGHT_SOURCE, True)}


@pytest.mark.parametrize("mode", list(MODES))
def test_calculate_environmental_light_matches_reference(mode):
    """The miss shader with skylight 0.9 and gamma 2.2 (the inverse-gamma
    pow in float64 on the port's side). SingleLightSource ignores the
    cubemap it is given."""
    lighting, with_cubemap = MODES[mode]
    d = _directions()
    pos = (np.random.default_rng(4).standard_normal((d.shape[0], 3))).astype(np.float32)
    renv, penv = _envs(_cubemap(8, 8) if with_cubemap else None,
                       skylight_intensity=0.9, gamma=2.2)
    ref = np.asarray(unfused(
        lambda p, v, e: ref_env.calculate_environmental_light(p, v, e, lighting),
        jnp.asarray(pos), jnp.asarray(d), renv))
    mine = environment.calculate_environmental_light(
        torch.tensor(pos), torch.tensor(d), penv, int(lighting)).numpy()
    assert mine.shape == ref.shape and np.isfinite(mine).all()
    if lighting == RefLighting.SKYDOME:
        np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-6)
    else:  # one pow, in float64 on the port's side
        np.testing.assert_allclose(mine, ref, rtol=2e-7, atol=0)
    if mode in ("scene_cubemap", "skydome"):  # non-vacuous: the light varies
        assert float(ref.std()) > 0.05


@pytest.mark.parametrize("lighting", ["cubemap", "skydome"])
def test_miss_radiance_plain_adds_in_place(lighting, monkeypatch):
    """The plain miss radiance in chunks (cut to 37 rays here): on the
    missed rays radiance += throughput * light and out = light, and no
    other ray or plane is touched; the light is the miss shader's."""
    monkeypatch.setattr(environment, "PLAIN_CHUNK", 37)
    g = np.random.default_rng(5)
    n = 300
    d = _directions(n)
    st = init_state(torch.tensor(g.standard_normal((n, 3)).astype(np.float32)),
                    torch.tensor(d), torch.ones(n))
    st[7:13] = torch.tensor(g.uniform(size=(6, n)).astype(np.float32))
    kind = (EnvironmentalLightingType.SCENE if lighting == "cubemap"
            else EnvironmentalLightingType.SKYDOME)
    _, env = _envs(_cubemap(8, 8) if lighting == "cubemap" else None, gamma=2.2)
    miss = torch.tensor((g.uniform(size=n) < 0.4).astype(np.float32))
    before = st.clone()
    out = torch.full((3, n), -1.0)
    environment.miss_radiance(st, st[10:13], miss, env, kind, out=out)
    m = miss > 0
    light = environment.calculate_environmental_light(
        before[0:3].T, before[3:6].T, env, kind).T
    assert torch.equal(st[10:13, m], before[10:13, m] + before[7:10, m] * light[:, m])
    assert torch.equal(out[:, m], light[:, m])
    assert torch.equal(st[:, ~m], before[:, ~m]) and bool((out[:, ~m] == -1.0).all())
    assert torch.equal(st[:10], before[:10]) and st.shape[0] == NPLANES


def test_compact_misses_lists_the_missed_lanes():
    """The plain version of the miss kernels' compaction pass: the lanes
    with miss > 0 in order, then their count (the kernel appends the same
    lanes in no set order); a plane the kernel cannot take raises."""
    miss = torch.tensor((np.random.default_rng(8).uniform(size=300) < 0.3)
                        .astype(np.float32))
    miss[5] = -1.0  # not > 0: not missed
    listed, count = environment.compact_misses(miss)
    k = int(count[0])
    assert listed.dtype == count.dtype == torch.int32 and listed.shape == (300,)
    assert torch.equal(listed[:k].long(), torch.nonzero(miss > 0)[:, 0]) and k > 50
    for bad in (miss[::2], miss.double(), miss[None]):
        with pytest.raises(ValueError):
            environment.compact_misses(bad)


def test_environment_properties_state_and_changed():
    props = EnvironmentProperties(lighting_type=EnvironmentalLightingType.SKYDOME,
                                  hr=8000.0, g=0.7, num_samples=8)
    ref = RefProps(lighting_type=RefLighting.SKYDOME, hr=8000.0, g=0.7,
                   num_samples=8)
    mine, theirs = props.state("cpu"), ref.state()
    for k in ("earth_radius", "atmosphere_radius", "hr", "hm", "g"):
        assert float(getattr(mine.atmosphere, k)) == float(getattr(theirs.atmosphere, k))
    assert mine.cubemap is None
    for field, value in (("earth_radius", 6371.0), ("atmosphere_radius", 6500.0),
                         ("hr", 7000.0), ("hm", 1000.0), ("g", 0.8),
                         ("num_samples", 32), ("num_samples_light", 4)):
        other = EnvironmentProperties(**{**props.__dict__, field: value})
        assert props.changed(other) and other.changed(props), field
    assert not props.changed(EnvironmentProperties(**props.__dict__))
    # a 3-channel cubemap gets an alpha of ones, as the reference's state()
    cube = np.random.default_rng(6).uniform(size=(6, 4, 5, 3)).astype(np.float32)
    cm = EnvironmentProperties(cubemap=cube).state("cpu").cubemap
    np.testing.assert_array_equal(cm.numpy(), np.asarray(RefProps(cubemap=cube).state().cubemap))
    assert cm.shape == (6, 4, 5, 4) and bool((cm[..., 3] == 1.0).all())


def test_environment_defaults_need_a_device():
    """The defaults name their device, as ``Scene.build(device)`` does:
    without one they raise, with one they lie on it."""
    with pytest.raises(TypeError):
        environment.EnvironmentState.default()
    with pytest.raises(TypeError):
        environment.AtmosphereState.default()
    with pytest.raises(TypeError):
        environment.EnvironmentState.default(gamma=torch.tensor(2.2))
    env = environment.EnvironmentState.default("cpu", gamma=torch.tensor(2.2))
    assert env.sun_direction.device.type == "cpu"
    assert float(env.gamma) == float(torch.tensor(2.2))
    assert environment.AtmosphereState.default("cpu").hr.device.type == "cpu"


def test_environment_from_numpy():
    renv, penv = _envs(_cubemap(4, 6), skylight_intensity=0.7, gamma=2.2)
    for k in ("skylight_intensity", "ambient_light_intensity", "light_size",
              "gamma", "sun_direction", "color", "cubemap"):
        np.testing.assert_array_equal(getattr(penv, k).numpy(),
                                      np.asarray(getattr(renv, k)), err_msg=k)
        assert getattr(penv, k).dtype == torch.float32
    for k in ("earth_radius", "atmosphere_radius", "hr", "hm", "g"):
        assert float(getattr(penv.atmosphere, k)) == float(getattr(renv.atmosphere, k))
    default = environment.EnvironmentState.default(device="cpu")
    assert float(default.atmosphere.hm) == 1200.0 and default.cubemap is None
    bad = jax.tree_util.tree_map(np.asarray, renv).replace(cubemap=np.zeros((6, 4, 4, 3)))
    with pytest.raises(ValueError):
        environment_from_numpy(bad, "cpu")
