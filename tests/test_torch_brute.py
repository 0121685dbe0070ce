"""The port's wavefront trace (K3's plain version, ``ops/brute.py``)
against the JAX package's Pallas trace kernel in interpret mode and its
XLA oracle, on the shapes of tests/test_pallas_brute.py, and the packed
table row for row against the reference's ``pack_tri_table``.

Gates: hit and prim exact; t within 1e-6 for triangles, 1e-5 with curves
(the tolerances of tests/test_pallas_brute.py)."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracerfacility_tpu.ops.intersect import trace_closest_bruteforce
from raytracerfacility_tpu.ops.pallas_brute import (
    pack_tri_table as ref_pack,
    trace_any_pallas,
    trace_closest_pallas,
)
from raytracerfacility_tpu_torch.ops import brute
from tests import torch_parity  # noqa: F401  (one torch thread per worker)


def _random_tris(rng, n):
    v0 = (rng.standard_normal((n, 3)) * 2).astype(np.float32)
    e1 = rng.standard_normal((n, 3)).astype(np.float32)
    e2 = rng.standard_normal((n, 3)).astype(np.float32)
    return v0, e1, e2


def _case(kind_mix: str):
    """(v0, e1, e2, kind or None, origin, direction) as numpy arrays:
    1300 random triangles and 700 rays, or 400 triangles plus 300
    sphere-swept segments and 600 unit rays."""
    if kind_mix == "triangles":
        v0, e1, e2 = _random_tris(np.random.default_rng(0), 1300)
        rng = np.random.default_rng(1)
        r = 700
        o = (rng.standard_normal((r, 3)) * 3).astype(np.float32)
        d = rng.standard_normal((r, 3)).astype(np.float32)
        return v0, e1, e2, None, o, d
    rng = np.random.default_rng(7)
    n_tri, n_cur = 400, 300
    v0t, e1t, e2t = _random_tris(np.random.default_rng(2), n_tri)
    p0 = (rng.standard_normal((n_cur, 3)) * 2).astype(np.float32)
    axis = rng.standard_normal((n_cur, 3)).astype(np.float32)
    r0 = (0.05 + 0.15 * rng.random(n_cur)).astype(np.float32)
    r1 = (0.05 + 0.15 * rng.random(n_cur)).astype(np.float32)
    e2c = np.zeros((n_cur, 3), np.float32)
    e2c[:, 0] = r0
    e2c[:, 1] = r1 - r0
    kind = np.concatenate([np.zeros(n_tri, np.int32), np.ones(n_cur, np.int32)])
    r = 600
    o = (rng.standard_normal((r, 3)) * 3).astype(np.float32)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.concatenate([v0t, p0]), np.concatenate([e1t, axis]),
            np.concatenate([e2t, e2c]), kind, o, d)


@pytest.fixture(scope="module", params=["triangles", "curves"])
def case(request):
    v0, e1, e2, kind, o, d = _case(request.param)
    j = [jnp.asarray(x) for x in (v0, e1, e2)]
    jkind = None if kind is None else jnp.asarray(kind)
    ref_tables = ref_pack(*j, kind=jkind)
    t = [torch.tensor(x) for x in (v0, e1, e2)]
    tables = brute.pack_tri_table(*t, None if kind is None else torch.tensor(kind))
    return dict(name=request.param, j=j, jkind=jkind, ref_tables=ref_tables,
                tables=tables, o=o, d=d, n_tri=400 if kind is not None else len(v0))


def test_pack_tri_table_matches_reference(case):
    for mine, ref in zip(case["tables"], case["ref_tables"]):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


def test_trace_closest_matches_pallas_and_oracle(case):
    o, d = case["o"], case["d"]
    r = o.shape[0]
    tmin = np.full(r, 1e-3, np.float32)
    tmax = np.full(r, 100.0, np.float32)
    jargs = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
    pal = trace_closest_pallas(case["ref_tables"], *jargs)
    oracle = trace_closest_bruteforce(*case["j"], *jargs, kind=case["jkind"])
    mine = brute.trace_closest(case["tables"], torch.tensor(o), torch.tensor(d),
                               torch.tensor(tmin), torch.tensor(tmax))
    tol = 1e-6 if case["name"] == "triangles" else 1e-5
    assert int(mine.hit.sum()) > 100  # the scene actually hits
    if case["name"] == "curves":  # ... and the curve rows are hit
        assert int((mine.prim >= case["n_tri"]).sum()) > 20
    for ref in (pal, oracle):
        np.testing.assert_array_equal(mine.hit.numpy(), np.asarray(ref.hit))
        np.testing.assert_array_equal(mine.prim.numpy(), np.asarray(ref.prim))
        np.testing.assert_allclose(mine.t.numpy(), np.asarray(ref.t),
                                   rtol=tol, atol=tol)
    np.testing.assert_allclose(mine.u.numpy(), np.asarray(pal.u), rtol=1e-5,
                               atol=1e-5)


def test_trace_any_matches_pallas(case):
    o, d = case["o"], case["d"]
    r = o.shape[0]
    tmin = np.full(r, 1e-3, np.float32)
    tmax = np.full(r, 100.0, np.float32)
    tmax[::5] = brute.DEAD  # dead lanes never report a hit
    ref = trace_any_pallas(case["ref_tables"], jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tmin), jnp.asarray(tmax))
    mine = brute.trace_any(case["tables"], torch.tensor(o), torch.tensor(d),
                           torch.tensor(tmin), torch.tensor(tmax))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    assert 100 < int(mine.sum()) and not bool(mine[::5].any())
