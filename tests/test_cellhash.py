"""Cell-hash tables vs brute-force NumPy k-NN within the gate radius."""

import numpy as np
import jax.numpy as jnp

from vloam_tpu.ops.cellhash import (
    SENTINEL, append_cell_table, build_cell_table, cell_knn,
)

CELL = 1.0
H = 4096
CAP = 16
K = 5


def brute_knn(q, cand):
    d2 = np.sum((q[:, None, :] - cand[None, :, :]) ** 2, axis=-1)
    idx = np.argsort(d2, axis=1)[:, :K]
    return np.take_along_axis(d2, idx, axis=1)


def make_points(rng, n, lo=-40.0, hi=40.0):
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    return np.concatenate([pts, np.ones((n, 1), np.float32)], -1)


def test_cell_knn_matches_brute_within_gate():
    rng = np.random.default_rng(0)
    cand = make_points(rng, 3000)
    mask = rng.random(3000) < 0.9
    # queries close to candidates so neighbourhoods are non-trivially occupied
    q = cand[rng.integers(0, 3000, 500), :3] + rng.normal(0, 0.3, (500, 3)).astype(np.float32)

    tbl, cnt = build_cell_table(jnp.array(cand), jnp.array(mask), CELL, H, CAP)
    d2, nbr = cell_knn(jnp.array(q), tbl, CELL, K)
    d2 = np.asarray(d2)
    nbr = np.asarray(nbr)

    ref = brute_knn(q.astype(np.float64), cand[mask, :3].astype(np.float64))
    gate = CELL ** 2
    for j in range(K):
        inside = ref[:, j] < gate
        # every true neighbour within the gate radius must be found exactly
        np.testing.assert_allclose(d2[inside, j], ref[inside, j], rtol=1e-4, atol=1e-5)
    # neighbour coordinates actually reproduce the reported distances
    d2_re = np.sum((nbr - q[:, None, :]) ** 2, axis=-1)
    close = d2 < gate
    np.testing.assert_allclose(d2[close], d2_re[close], rtol=1e-4, atol=1e-5)


def test_append_equals_rebuild():
    rng = np.random.default_rng(1)
    a = make_points(rng, 2000)
    b = make_points(rng, 500)
    ma = np.ones(2000, bool)
    mb = rng.random(500) < 0.8

    t1, c1 = build_cell_table(jnp.array(a), jnp.array(ma), CELL, H, CAP)
    t1, c1 = append_cell_table(t1, c1, jnp.array(b), jnp.array(mb), CELL)

    both = np.concatenate([a, b[mb]])
    t2, c2 = build_cell_table(
        jnp.array(both), jnp.ones(len(both), bool), CELL, H, CAP)

    assert int(jnp.sum(c1)) == int(jnp.sum(c2))
    # same per-bucket membership (order within a bucket may differ)
    q = make_points(rng, 300)[:, :3]
    d2a, _ = cell_knn(jnp.array(q), t1, CELL, K)
    d2b, _ = cell_knn(jnp.array(q), t2, CELL, K)
    np.testing.assert_allclose(np.asarray(d2a), np.asarray(d2b), rtol=1e-5, atol=1e-6)


def test_empty_table_reports_far():
    tbl = jnp.full((H, CAP * 4), SENTINEL)
    q = jnp.zeros((8, 3))
    d2, _ = cell_knn(q, tbl, CELL, K)
    assert np.all(np.asarray(d2) > 1e6)
