"""The estimator's probe-ray kernel (``csrc/probe.cu`` ``probe_ray_kernel``)
and its wrapper (``ops/probe.py``).

On the CPU: CPU tensors take the plain version and launch nothing; any
other device raises; the input check (on meta tensors); the kernel's
library and launch counter are registered; the plain version equals the
estimator's former inline prep bit for bit. Marked ``card`` (skipped
without a CUDA device): the kernel against the plain version bit for bit
at config 4's pools and on edge words, and its launch count a config-4
estimate.

This file imports no JAX, so the card tests run on a machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_probe_kernel.py -q``
(``test_torch_illumination.py`` holds the estimator to the JAX package).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.models import illumination as il
from raytracerfacility_tpu_torch.ops import probe
from raytracerfacility_tpu_torch.ops.math3d import sample_hemisphere
from raytracerfacility_tpu_torch.ops.rng import lcg_init, lcg_next
from raytracerfacility_tpu_torch.scene import make_plane, make_sphere
from test_torch_rng_kernel import EDGE_WORDS, PROBES

KERNEL = "probe_ray_kernel"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _random_probes(n, device, seed=11):
    """``n`` probes of random triangles and corner normals: unit normals,
    every 7th probe's near +-X (the tangent frame's +Z helper), every 13th
    probe's zero (the frame's clamp)."""
    g = np.random.default_rng(seed)
    fields = {}
    for k in probe.VERTEX_FIELDS:
        if k.endswith("position"):
            v = g.uniform(-5.0, 5.0, (n, 3))
        else:
            v = g.normal(size=(n, 3))
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            v[::7] = np.sign(g.normal(size=(len(v[::7]), 1))) * [1.0, 0.01, -0.02]
            v[::13] = 0.0
        fields[k] = torch.tensor(v, dtype=torch.float32, device=device)
    return types.SimpleNamespace(**fields)


def _parents_prep(probes, s, seed, push, offset):
    """The estimator's probe rays as ``estimate_illumination_counted`` made
    them inline before ``ops/probe.py``, from the RNG and hemisphere ops."""
    device = probes.a_position.device
    p = probes.a_position.shape[0]
    probe_idx = torch.arange(p, dtype=torch.int64, device=device)[:, None, None] + offset
    face_idx = torch.arange(2, dtype=torch.int64, device=device)[None, :, None]
    sample_idx = torch.arange(s, dtype=torch.int64, device=device)[None, None, :]
    ray_id = (probe_idx * (2 * s) + face_idx * s + sample_idx) & 0xFFFFFFFF
    rng = lcg_init(ray_id, torch.tensor(seed & 0xFFFFFFFF, device=device))
    rng, ca = lcg_next(rng)
    rng, cb = lcg_next(rng)
    w = (1.0 - ca - cb)[..., None]
    ca, cb = ca[..., None], cb[..., None]

    def blend(a, b, c):
        return w * a[:, None, None] + ca * b[:, None, None] + cb * c[:, None, None]

    position = blend(probes.a_position, probes.b_position, probes.c_position)
    normal = blend(probes.a_normal, probes.b_normal, probes.c_normal)
    normal = normal * torch.where(face_idx == 0, 1.0, -1.0)[..., None]
    rng, ray_dir = sample_hemisphere(rng, normal)
    return position + normal * push, ray_dir, normal, rng


def _assert_bits_equal(got, want):
    for name, g, w in zip(("origin", "direction", "normal", "rng"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), (name, int((g != w).sum()))


def _meta_probes(p, dtype=torch.float32, shapes=None):
    shapes = shapes or {}
    return types.SimpleNamespace(**{
        k: torch.zeros(shapes.get(k, (p, 3)), dtype=dtype, device="meta")
        for k in probe.VERTEX_FIELDS})


# ------------------------------------------------------------------ CPU


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_library(name="path"):
        raise AssertionError(f"library {name} loaded for a CPU tensor")

    monkeypatch.setattr(kernels, "library", no_library)
    kernels.reset_launches()
    probes = _random_probes(40, "cpu")
    out = probe.probe_rays(probes, 3, 2**32 + 9, 0.001, 5)
    assert [tuple(t.shape) for t in out] == [(40, 2, 3, 3)] * 3 + [(40, 2, 3)]
    _assert_bits_equal(out, probe._probe_rays_plain(probes, 3, 9, 0.001, 5))
    assert kernels.LAUNCHES[KERNEL] == 0 and kernels.LAUNCHES["tea_init_kernel"] == 0


@pytest.mark.parametrize("devices", [("meta",) * 6, ("cpu",) * 5 + ("meta",)])
def test_other_devices_raise(devices):
    probes = types.SimpleNamespace(**{
        k: torch.zeros((4, 3), device=d) for k, d in zip(probe.VERTEX_FIELDS, devices)})
    with pytest.raises(ValueError):
        probe.probe_rays(probes, 1, 0, 0.001)


@pytest.mark.parametrize("case", ["float64", "float16", "(P, 4)", "(P,)", "other P",
                                  "negative samples", "2**31 rays"])
def test_input_check(case):
    samples = 1
    if case.startswith("float"):
        probes = _meta_probes(8, dtype=getattr(torch, case))
    elif case == "(P, 4)":
        probes = _meta_probes(8, shapes={"b_normal": (8, 4)})
    elif case == "(P,)":
        probes = _meta_probes(8, shapes={"a_position": (8,)})
    elif case == "other P":
        probes = _meta_probes(8, shapes={"c_position": (9, 3)})
    elif case == "negative samples":
        probes, samples = _meta_probes(8), -1
    else:
        probes, samples = _meta_probes(2**28), 4
    with pytest.raises(ValueError):
        probe.probe_inputs(probes, samples)
    # the largest pool it takes, and the main path's
    for p, s in ((2**30 - 1, 1), (PROBES, 8), (PROBES, 1)):
        fields = probe.probe_inputs(_meta_probes(p), s)
        assert len(fields) == 6 and all(t.is_contiguous() for t in fields)


def test_the_kernel_is_registered():
    assert kernels.SOURCES["probe"] == "probe.cu"
    assert KERNEL in kernels.LAUNCHES
    assert kernels._ARGTYPES["probe"] == {"rtf_probe_rays": (10, 5)}
    source = (kernels._CSRC / "probe.cu").read_text()
    assert KERNEL in source and "int rtf_probe_rays(" in source
    # the TEA rounds are one header's, shared with tea_init_kernel
    for src in ("probe.cu", "rng.cu"):
        text = (kernels._CSRC / src).read_text()
        assert '#include "tea.cuh"' in text and "0x9E3779B9u" not in text
    kernels.reset_launches()
    assert kernels.LAUNCHES[KERNEL] == 0


@pytest.mark.parametrize("mesh, samples, offset, push", [
    ("plane", 32, 0, 0.001), ("plane", 1, 2**32 - 3, 0.0),
    ("sphere", 2, 7, 0.001), ("sphere", 3, -(2**40), 0.25),
])
def test_plain_version_equals_the_estimators_former_prep(mesh, samples, offset, push):
    """On the plane of ``tests/test_torch_illumination.py``'s estimator
    scene (a 1 x 1 plane lifted to y = 1) and on a sphere."""
    lift = np.eye(4, dtype=np.float32)
    lift[:3, 3] = (0.0, 1.0, 0.0)
    shape = make_plane(1.0) if mesh == "plane" else make_sphere(0.4, rings=4, sectors=6)
    probes = il.probes_from_mesh(shape, lift, "cpu")
    for seed in (1, 2**31 + 5):
        _assert_bits_equal(probe.probe_rays(probes, samples, seed, push, offset),
                           _parents_prep(probes, samples, seed, push, offset))


# ----------------------------------------------------------------- card


def _assert_kernel_equals_plain(probes, samples, seed, push, offset):
    kernels.reset_launches()
    got = probe.probe_rays(probes, samples, seed, push, offset)
    assert kernels.LAUNCHES[KERNEL] == 1 and kernels.LAUNCHES["tea_init_kernel"] == 0
    _assert_bits_equal(got, probe._probe_rays_plain(probes, samples, seed, push, offset))
    return got


@pytest.mark.card
@pytest.mark.parametrize("samples", [1, 8])
@pytest.mark.parametrize("push", [0.001, 0.0])
def test_kernel_equals_plain_at_config_4_pools(card, samples, push):
    probes = _random_probes(PROBES, card)
    _assert_kernel_equals_plain(probes, samples, 0x9E3779B1 + 5, push, 3 * PROBES + 17)


@pytest.mark.card
def test_kernel_equals_plain_on_edge_words(card):
    probes = _random_probes(1024, card, seed=5)
    for seed, offset in zip(EDGE_WORDS, reversed(EDGE_WORDS)):
        _assert_kernel_equals_plain(probes, 2, seed, 0.001, offset)
    # against the CPU: the same RNG states; the floats within a rounding (the
    # CPU's float64 cos and sin may round a last bit otherwise)
    got = _assert_kernel_equals_plain(probes, 3, 2**32 - 1, 0.001, 2**31)
    cpu = types.SimpleNamespace(**{k: getattr(probes, k).cpu() for k in probe.VERTEX_FIELDS})
    want = probe._probe_rays_plain(cpu, 3, 2**32 - 1, 0.001, 2**31)
    assert torch.equal(got[3].cpu(), want[3])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=1e-6)


@pytest.mark.card
@pytest.mark.parametrize("samples", [1, 8])
def test_one_launch_a_config_4_estimate(card, samples):
    from raytracerfacility_tpu_torch.scenes import canopy_illumination

    scene, items, env, config = canopy_illumination()
    probes = il.TriangleIlluminationEstimator().prepare_light_probe_group(items, card)
    assert probes.num_probes == PROBES
    kernels.reset_launches()
    out, rays = il.estimate_illumination_counted(
        scene.build(card), env.state(card),
        dataclasses.replace(config, samples=samples), probes, seed=2**31 + 5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[KERNEL] == 1 and kernels.LAUNCHES["tea_init_kernel"] == 0
    assert kernels.LAUNCHES["seg_segment_kernel"] == config.bounces + 1
    assert bool(torch.isfinite(out.energy).all()) and int(rays) >= PROBES * 2 * samples
