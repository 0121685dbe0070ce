"""Shared helpers of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py): building one scene in both packages and
the cross-engine tolerances.

The tolerances are the reference's own gates between its engines
(tests/test_fused.py:58-73). Identical RNG streams and accept windows
leave only float rounding differences (FMA contraction in XLA's CPU
code, other sin/cos/pow implementations), and a rounding difference that
flips one bounce direction moves that pixel a lot (chaotic amplification),
so the gates bound the bulk tightly and the tails loosely.
"""

from __future__ import annotations

import fcntl
import os

import numpy as np
import torch

# the suite runs in several worker processes: one intra-op thread each
# keeps the port's plain (CPU) kernels from oversubscribing the cores
torch.set_num_threads(1)


def _build_reference_native_library() -> None:
    """Build the JAX package's host library once, whole, before any test.

    ``raytracerfacility_tpu.native`` compiles it on first use with g++
    writing straight to its final path, so a second worker that arrives
    meanwhile sees a file newer than the source and loads it half written
    ("file too short"). Every worker imports this module while it collects
    (the test_torch_*.py modules import it at the top) and pytest-xdist
    starts no test until all have collected, so building here under an
    exclusive lock leaves a whole library that every later build call finds
    up to date."""
    from raytracerfacility_tpu import native

    os.makedirs(native._BUILD_DIR, exist_ok=True)
    with open(os.path.join(native._BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            native.get_lib()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_build_reference_native_library()


def reference_bench(width: int, height: int):
    """The JAX package's bench scene compiled with its path tables, plus
    its CameraProperties and EnvironmentProperties."""
    import __graft_entry__ as ge

    old = os.environ.get("RTF_TPU_FUSED")
    os.environ["RTF_TPU_FUSED"] = "1"
    try:
        scene, cam, env = ge._bench_scene(width, height)
        compiled = scene.build(build_bvh=False)
    finally:
        if old is None:
            del os.environ["RTF_TPU_FUSED"]
        else:
            os.environ["RTF_TPU_FUSED"] = old
    assert compiled.fused is not None
    return compiled, cam, env


def port_tables_from_reference(compiled, device="cpu"):
    """The reference's packed tables as the port's, through convert.py."""
    from raytracerfacility_tpu_torch.convert import fused_tables_from_numpy

    return fused_tables_from_numpy(
        *(np.asarray(t) for t in compiled.fused), chunk=compiled.fused_chunk,
        device=device)


def reference_strands(n_strands: int, width: int, height: int,
                      pallas: bool = False):
    """The JAX package's config-7 strands scene (``bench.py:297-321``)
    with ``n_strands`` strands, compiled, with its camera and environment
    properties. ``pallas`` packs the Pallas trace table, whose any-hit
    query handles curve rows (the XLA oracle's any-hit treats them as
    triangles)."""
    from raytracerfacility_tpu.models.renderer import EnvironmentProperties
    from raytracerfacility_tpu.ops.camera import CameraProperties
    from raytracerfacility_tpu.scene.procedural import build_strands_scene

    old = os.environ.get("RTF_TPU_PALLAS_BRUTE")
    os.environ["RTF_TPU_PALLAS_BRUTE"] = "1" if pallas else "0"
    try:
        compiled = build_strands_scene(n_strands=n_strands, seed=7).build()
    finally:
        if old is None:
            del os.environ["RTF_TPU_PALLAS_BRUTE"]
        else:
            os.environ["RTF_TPU_PALLAS_BRUTE"] = old
    cam = CameraProperties(fov=50.0, size=(width, height))
    cam.look_at_target((0.0, 0.9, 2.4), (0.0, 0.55, 0.0))
    return compiled, cam, EnvironmentProperties()


def unfused(fn, *args):
    """``fn(*args)`` of the JAX package compiled without XLA's fusion pass.
    Fused into loops, XLA's CPU code contracts multiply-adds into FMAs,
    which move grazing hits on thin strands; unfused, every op rounds on
    its own, as the port's torch ops and its kernels (-fmad=false) do."""
    import jax

    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "fusion"})
    return compiled(*args)


def reference_env_vector(env_state):
    """The reference's 16-wide environment vector (pathtracer.py:989-1004)."""
    color = np.asarray(env_state.color, np.float32)
    sky = np.float32(env_state.skylight_intensity)
    gamma = np.float32(env_state.gamma)
    vec = np.zeros(16, np.float32)
    vec[0:3] = np.maximum(np.power(np.maximum(color * sky, 0.0),
                                   np.float32(1.0) / gamma), 0.0)
    vec[3:6] = color * np.float32(env_state.ambient_light_intensity)
    vec[6:9] = np.asarray(env_state.sun_direction, np.float32)
    vec[9] = np.float32(1.0) - np.float32(env_state.light_size)
    return vec


def assert_color_close(a, b, what="colour"):
    """Frame-colour gate: |d| 99th percentile < 2e-3, 99.9th < 5e-2,
    mean < 3e-4."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.quantile(d, 0.99) < 2e-3, (what, float(np.quantile(d, 0.99)))
    assert np.quantile(d, 0.999) < 5e-2, (what, float(np.quantile(d, 0.999)))
    assert d.mean() < 3e-4, (what, float(d.mean()))


def assert_frames_close_but_flips(mine, ref, flip_share=2.5e-3):
    """Frame gate for thin-strand scenes against the reference's render.
    Its camera rays are normalized with XLA's CPU rsqrt, which is not
    correctly rounded, so some directions differ from the port's by an
    ulp; that flips a grazing hit on a strand whose radius is a fifth of a
    pixel, and the pixel then differs wholly. So: pixels whose colour,
    normal or albedo moves by more than 1e-2 (flips) are at most
    ``flip_share`` of the frame, and the colour and AOV gates hold on the
    rest. Fed the same rays, the engines agree at the
    plain gates (tests/test_torch_wavefront.py)."""
    chans = [(np.asarray(getattr(mine, k))[..., :3].astype(np.float64),
              np.asarray(getattr(ref, k))[..., :3].astype(np.float64))
             for k in ("color", "normal", "albedo")]
    flip = np.zeros(chans[0][0].shape[:-1], bool)
    for a, b in chans:
        flip |= np.abs(a - b).max(-1) > 1e-2
    assert flip.mean() <= flip_share, ("flipped pixels", float(flip.mean()))
    keep = ~flip
    assert_color_close(chans[0][0][keep], chans[0][1][keep], "colour")
    for (a, b), k in zip(chans[1:], ("normal", "albedo")):
        assert_aov_close(a[keep], b[keep], k)


def assert_aov_close(a, b, what="aov"):
    """AOV gate: |d| 99.9th percentile < 5e-3."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.quantile(d, 0.999) < 5e-3, (what, float(np.quantile(d, 0.999)))


def assert_count_close(a, b):
    """Live-ray counts within max(2, 0.1%): only flipped terminations
    differ."""
    a, b = float(a), float(b)
    assert abs(a - b) <= max(2.0, 1e-3 * b), (a, b)


def assert_mostly_equal(a, b, what="", frac=0.999):
    """Hit records (act, prim-derived ids, RNG states) equal on >= 99.9%
    of rays: a grazing accept may flip under other rounding."""
    a, b = np.asarray(a), np.asarray(b)
    same = float(np.mean(a == b))
    assert same >= frac, (what, same)
