"""The port's curve math (``ops/curve.py``) and curve bake against the JAX
package's, on the same numpy inputs.

Gates: hit flags exact, t and u within 1e-5; normals, positions and the
Newton refinement within 1e-5 (float32 rounding of the same formulas);
the baked geometry planes exactly (the same numpy bake)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracerfacility_tpu.ops import curve as ref_curve
from raytracerfacility_tpu_torch.ops import curve
from raytracerfacility_tpu_torch.scenes import strands_scene
from tests.torch_parity import reference_strands


def _segments(n, seed=3):
    """Random sphere-swept segments and unit rays aimed near them."""
    rng = np.random.default_rng(seed)
    p0 = rng.standard_normal((n, 3)).astype(np.float32)
    axis = (rng.standard_normal((n, 3)) * 0.6).astype(np.float32)
    r0 = (0.05 + 0.2 * rng.random(n)).astype(np.float32)
    dr = (0.1 * rng.standard_normal(n)).astype(np.float32)
    target = p0 + axis * rng.random((n, 1)).astype(np.float32)
    o = (target + rng.standard_normal((n, 3)) * 2).astype(np.float32)
    d = (target + rng.standard_normal((n, 3)).astype(np.float32) * 0.2) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return p0, axis, r0, dr, o, d


def _both(fn_ref, fn_port, *args):
    ref = fn_ref(*(jnp.asarray(a) for a in args))
    mine = fn_port(*(torch.tensor(a) for a in args))
    return [np.asarray(x) for x in ref], [x.numpy() for x in mine]


def test_intersect_round_cone_matches_reference():
    p0, axis, r0, dr, o, d = _segments(4000)
    tmin = np.full(4000, 1e-3, np.float32)
    tmax = np.full(4000, 100.0, np.float32)
    (rh, rt, ru), (h, t, u) = _both(ref_curve.intersect_round_cone,
                                    curve.intersect_round_cone,
                                    o, d, p0, axis, r0, dr, tmin, tmax)
    assert 1000 < h.sum() < 4000  # hits and misses both occur
    assert (u[h] == 0.0).any() and (u[h] == 1.0).any()  # both end caps
    np.testing.assert_array_equal(h, rh)
    np.testing.assert_allclose(t, rt, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u, ru, rtol=1e-5, atol=1e-5)


def test_linear_curve_normal_matches_reference():
    p0, axis, r0, dr, o, d = _segments(4000)
    tmin = np.full(4000, 1e-3, np.float32)
    tmax = np.full(4000, 100.0, np.float32)
    hit, t, u = (x.numpy() for x in curve.intersect_round_cone(
        *(torch.tensor(a) for a in (o, d, p0, axis, r0, dr, tmin, tmax))))
    x = (o + d * t[:, None])[hit]
    args = (x, p0[hit], axis[hit], r0[hit], dr[hit], u[hit])
    (rn, rp), (n, p) = _both(ref_curve.linear_curve_normal,
                             curve.linear_curve_normal, *args)
    np.testing.assert_allclose(n, rn, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p, rp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("order", [2, 3])
def test_refine_swept_hit_matches_reference(order):
    """Newton steps onto the exact quadratic / cubic canal surface from
    the subdivision hits of rays against a baked strand."""
    rng = np.random.default_rng(order)
    n = 2000
    ctrl = np.cumsum(rng.standard_normal((n, 4, 3)) * 0.3, axis=1).astype(np.float32)
    radii = (0.05 + 0.05 * rng.random((n, 4))).astype(np.float32)
    s0 = rng.random(n).astype(np.float32)
    orders = np.full(n, order, np.int32)
    c, *_ = ref_curve.spline_point(jnp.asarray(ctrl), jnp.asarray(radii),
                                   jnp.asarray(orders), jnp.asarray(s0))
    c = np.asarray(c)
    o = (c + rng.standard_normal((n, 3)) * 2).astype(np.float32)
    d = c + rng.standard_normal((n, 3)).astype(np.float32) * 0.02 - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t0 = (np.linalg.norm(c - o, axis=1) - radii.mean(1)).astype(np.float32)
    ref, mine = _both(
        lambda *a: ref_curve.refine_swept_hit(*a[:6], a[6]),
        lambda *a: curve.refine_swept_hit(*a[:6], a[6]),
        o, d, t0, s0, ctrl, radii, orders)
    np.testing.assert_array_equal(mine[4], ref[4])  # converged flags
    ok = mine[4]
    assert ok.mean() > 0.5
    for k, name in enumerate(("t", "s", "position", "normal")):
        np.testing.assert_allclose(mine[k][ok], ref[k][ok], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", ["linear", "quadratic", "cubic"])
def test_subdivide_strand_segments_matches_reference(mode):
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((40, 8)).astype(np.float32)
    segments = np.arange(0, 36, 4, dtype=np.int32)
    tex = rng.random(40).astype(np.float32)
    ref = ref_curve.subdivide_strand_segments(pts, segments, mode, tex_coords=tex)
    mine = curve.subdivide_strand_segments(pts, segments, mode, tex_coords=tex)
    assert sorted(mine) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)


def test_strands_bake_matches_reference():
    """The port's compile of a reduced config-7 scene (40 strands over the
    ground plane) against the JAX ``build_compiled_scene`` geometry."""
    ref, _, _ = reference_strands(40, 8, 8)
    scene, _, _ = strands_scene(8, 8, n_strands=40)
    mine = scene.build("cpu")
    assert mine.geometry.has_curves and ref.geometry.has_curves
    assert mine.fused is None  # the path engines' tables hold triangles only
    for name in ("v0", "e1", "e2", "kind", "normal", "data", "color",
                 "tex_coord", "instance"):
        np.testing.assert_array_equal(getattr(mine.geometry, name).numpy(),
                                      np.asarray(getattr(ref.geometry, name)),
                                      err_msg=name)
    assert int((mine.geometry.kind == 1).sum()) == 40 * 6
