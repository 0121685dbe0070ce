"""``lcg_init``'s TEA seeding kernel (``csrc/rng.cu`` ``tea_init_kernel``)
and its wrapper (``ops/rng.py``).

On the CPU: CPU tensors take the plain version and launch nothing; any
other device raises; the input check and the layout the kernel reads in
place (``tea_inputs``, ``broadcast_run``, on meta tensors); the kernel's
library and launch counter are registered. Marked ``card`` (skipped
without a CUDA device): the kernel against the plain version bit for bit
at the main path's shapes and on edge words, and its launch count a
1080p call and an estimator call (none: the estimator's probe-ray kernel
seeds its rays).

This file imports no JAX, so the card tests run on a machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rng_kernel.py -q``
(``test_torch_rng_camera.py`` holds the plain version to the JAX package).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.ops import rng

# the main path's layouts: the camera's (slots, H, W) pixel indices with a
# per-slot seed, the estimator's (probes, 2 faces, samples) ray ids with a
# 0-dim seed
PROBES = 110_976
EDGE_WORDS = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, -1, -(2**31), -(2**63),
              2**63 - 1, 2**32, 2**32 + 7, 2**40 + 2**31, 0x9E3779B9, 0xA341316C]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _camera_inputs(slots, height, width, device):
    pixel = torch.arange(height * width, dtype=torch.int64, device=device)
    seed = ((3 + 0x85EBCA6B * torch.arange(slots, dtype=torch.int64, device=device))
            & 0xFFFFFFFF)[:, None, None]
    shape = (slots, height, width)
    return pixel.reshape(height, width).expand(shape), seed.expand(shape)


def _probe_inputs(probes, samples, device, seed=0xDEADBEEF):
    ray_id = torch.arange(probes * 2 * samples, dtype=torch.int64,
                          device=device).reshape(probes, 2, samples)
    return ray_id, torch.tensor(seed, dtype=torch.int64, device=device)


def _meta(*shape, dtype=torch.int64):
    return torch.zeros(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------------ CPU


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_library(name="path"):
        raise AssertionError(f"library {name} loaded for a CPU tensor")

    monkeypatch.setattr(kernels, "library", no_library)
    kernels.reset_launches()
    g = np.random.default_rng(3)
    v0 = torch.from_numpy(g.integers(-(2**40), 2**40, 512))
    v1 = torch.from_numpy(g.integers(-(2**40), 2**40, 512))
    out = rng.lcg_init(v0, v1)
    assert out.dtype == torch.int64 and out.shape == (512,)
    assert torch.equal(out, rng._lcg_init_plain(v0, v1))
    # only the low 32 bits of each word count
    assert torch.equal(out, rng.lcg_init(v0 & 0xFFFFFFFF, v1 & 0xFFFFFFFF))
    assert kernels.LAUNCHES["tea_init_kernel"] == 0


@pytest.mark.parametrize("devices", [("meta", "meta"), ("meta", "cpu"), ("cpu", "meta")])
def test_other_devices_raise(devices):
    with pytest.raises(ValueError):
        rng.lcg_init(torch.zeros(8, dtype=torch.int64, device=devices[0]),
                     torch.zeros(8, dtype=torch.int64, device=devices[1]))


@pytest.mark.parametrize("dtypes", [(torch.int32, torch.int64),
                                    (torch.int64, torch.int32),
                                    (torch.float32, torch.int64),
                                    (torch.int64, torch.uint8)])
def test_input_check_rejects_other_dtypes(dtypes):
    with pytest.raises(ValueError):
        rng.tea_inputs(_meta(16, dtype=dtypes[0]), _meta(16, dtype=dtypes[1]))


@pytest.mark.parametrize("shapes", [((5,), (3,)), ((4, 6), (4,)), ((2, 3, 4), (3, 3, 1))])
def test_input_check_rejects_mismatched_lengths(shapes):
    with pytest.raises(ValueError):
        rng.tea_inputs(_meta(*shapes[0]), _meta(*shapes[1]))


def test_input_check_rejects_2_31_words():
    big = torch.zeros((), dtype=torch.int64, device="meta").expand(2**31)
    with pytest.raises(ValueError):
        rng.tea_inputs(big, torch.zeros((), dtype=torch.int64, device="meta"))
    v0, _, run = rng.tea_inputs(big[:2**31 - 1],
                                torch.zeros((), dtype=torch.int64, device="meta"))
    assert v0.shape == (2**31 - 1,) and run == 2**31 - 1


@pytest.mark.parametrize("layout, run", [
    ("camera, one slot", 1080 * 1920),
    ("camera, four slots", 1080 * 1920),
    ("estimator, 8 samples", PROBES * 2 * 8),
    ("estimator, 1 sample", PROBES * 2),
    ("one word a word", 1),
    ("0-dim with 0-dim", 1),
])
def test_main_path_layouts_are_read_in_place(layout, run):
    slots = 4 if "four" in layout else 1
    if layout.startswith("camera"):
        val0, val1 = _camera_inputs(slots, 1080, 1920, "meta")
    elif layout.startswith("estimator"):
        val0, val1 = _probe_inputs(PROBES, 8 if "8" in layout else 1, "meta")
    elif layout == "one word a word":
        val0, val1 = _meta(64, 32), _meta(64, 32)
    else:
        val0, val1 = _meta(), _meta()
    v0, v1, got = rng.tea_inputs(val0, val1)
    assert got == run
    assert v0.is_contiguous() and v0.shape == torch.broadcast_shapes(val0.shape,
                                                                     val1.shape)
    assert v0.numel() % run == 0 and v0.numel() // run in (1, slots, v0.numel())
    # val1 is its own storage, never a copy (val0 too, but with four slots:
    # the pixel indices repeat a frame and are made contiguous)
    assert v1.untyped_storage().nbytes() == val1.untyped_storage().nbytes()
    if slots == 1:
        assert v0.untyped_storage().nbytes() == val0.untyped_storage().nbytes()


@pytest.mark.parametrize("layout", ["val0-like repeat", "transposed", "inner broadcast",
                                    "step", "leading broadcast"])
def test_other_val1_layouts_are_made_contiguous(layout):
    if layout == "val0-like repeat":  # (slots, H, W) strides (0, W, 1)
        val1 = _meta(6, 8).expand(3, 6, 8)
    elif layout == "transposed":
        val1 = _meta(8, 6).t()
    elif layout == "inner broadcast":  # (4, 5, 6) strides (6, 0, 1)
        val1 = _meta(4, 1, 6).expand(4, 5, 6)
    elif layout == "step":
        val1 = _meta(96)[::2].reshape(6, 8)
    else:  # one row under every (slot, row): strides (0, 0, 1)
        val1 = _meta(8).expand(3, 6, 8)
    assert rng.broadcast_run(val1) is None
    _, v1, run = rng.tea_inputs(_meta(*val1.shape), val1)
    assert run == 1 and v1.is_contiguous() and v1.shape == val1.shape


@pytest.mark.parametrize("shape, strides, run", [
    ((), (), 1), ((7,), (1,), 1), ((7,), (0,), 7), ((3, 5), (1, 0), 5),
    ((3, 1, 5), (1, 1, 0), 5), ((2, 3, 4, 5), (3, 1, 0, 0), 20),
    ((1, 4, 1, 6), (99, 0, 7, 0), 24), ((2, 3), (3, 1), 1),
])
def test_broadcast_run(shape, strides, run):
    n = int(np.prod(shape)) if shape else 1
    t = torch.empty_strided(shape, strides, dtype=torch.int64, device="meta")
    assert rng.broadcast_run(t) == run and n % run == 0


def test_the_kernel_is_registered():
    assert kernels.SOURCES["rng"] == "rng.cu"
    assert "tea_init_kernel" in kernels.LAUNCHES
    assert kernels._ARGTYPES["rng"] == {"rtf_tea_init": (3, 2)}
    source = (kernels._CSRC / "rng.cu").read_text()
    assert "tea_init_kernel" in source and "int rtf_tea_init(" in source
    kernels.reset_launches()
    assert kernels.LAUNCHES["tea_init_kernel"] == 0


# ----------------------------------------------------------------- card


def _assert_kernel_equals_plain(val0, val1):
    kernels.reset_launches()
    got = rng.lcg_init(val0, val1)
    assert kernels.LAUNCHES["tea_init_kernel"] == 1
    want = rng._lcg_init_plain(val0, val1)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want), int((got != want).sum())
    return got


@pytest.mark.card
@pytest.mark.parametrize("slots", [1, 4])
def test_kernel_equals_plain_on_camera_pools(card, slots):
    got = _assert_kernel_equals_plain(*_camera_inputs(slots, 1080, 1920, card))
    assert bool((got >= 0).all()) and bool((got < 2**32).all())


@pytest.mark.card
@pytest.mark.parametrize("samples", [8, 1])
def test_kernel_equals_plain_on_probe_pools(card, samples):
    _assert_kernel_equals_plain(*_probe_inputs(PROBES, samples, card))


@pytest.mark.card
def test_kernel_equals_plain_on_edge_words(card):
    words = torch.tensor(EDGE_WORDS, dtype=torch.int64)
    val0, val1 = (t.contiguous() for t in torch.meshgrid(words, words, indexing="ij"))
    # every pair of edge words, one word a word; against the CPU too
    got = _assert_kernel_equals_plain(val0.to(card), val1.to(card))
    assert torch.equal(got.cpu(), rng._lcg_init_plain(val0, val1))
    # a per-run seed: each edge word seeds a run of 64 words
    _assert_kernel_equals_plain(
        torch.arange(len(EDGE_WORDS) * 64, device=card).reshape(-1, 64) + 2**32 - 500,
        words.to(card)[:, None].expand(-1, 64))
    # a 0-dim seed of each edge word
    for w in EDGE_WORDS:
        _assert_kernel_equals_plain(words.to(card), torch.tensor(w, device=card))
    # layouts made contiguous first: both broadcast views, a transposed val1
    pair = torch.meshgrid(words.to(card), words.to(card), indexing="ij")
    _assert_kernel_equals_plain(*pair)
    _assert_kernel_equals_plain(val0.to(card), val1.to(card).t())


@pytest.mark.card
def test_seeding_launches_once_a_pool(card):
    from raytracerfacility_tpu_torch.models.illumination import TriangleIlluminationEstimator
    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig, init_frame, render_frames_counted)
    from raytracerfacility_tpu_torch.scene import make_sphere
    from raytracerfacility_tpu_torch.scenes import bench_scene

    scene, cam, env = bench_scene(1920, 1080)
    compiled = scene.build(card)
    kernels.reset_launches()
    frame, _ = render_frames_counted(compiled, cam.state(card), env.state(card),
                                     RenderConfig(width=1920, height=1080, bounces=8),
                                     init_frame(1920, 1080, card), 4)
    torch.cuda.synchronize()
    assert frame.frame_id == 4
    assert kernels.LAUNCHES["tea_init_kernel"] == 4

    lift = np.eye(4, dtype=np.float32)
    lift[:3, 3] = (0.0, 0.8, 0.0)
    est = TriangleIlluminationEstimator()
    est.prepare_light_probe_group([(make_sphere(0.3, rings=8, sectors=12), lift)], card)
    kernels.reset_launches()
    est.sample_light_probe_group(compiled, env.state(card),
                                 RenderConfig(bounces=2, samples=8), seed=2**31 + 5)
    # the estimator seeds its rays inside probe_ray_kernel (ops/probe.py)
    assert kernels.LAUNCHES["tea_init_kernel"] == 0
    assert kernels.LAUNCHES["probe_ray_kernel"] == 1
    assert bool(torch.isfinite(est.probes.energy).all())
