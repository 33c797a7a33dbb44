"""Plain k-NN path (ops/knn.py) vs NumPy brute force."""

import numpy as np
import jax.numpy as jnp
import pytest

from vloam_tpu.ops.knn import knn, knn_mode, nn1

KS = [1, 5, 8, 16]


def _brute(q, c, mask):
    d2 = ((q[:, None].astype(np.float64) - c[None]) ** 2).sum(-1)
    d2[:, ~mask] = np.inf
    return d2


def _plain_knn(*args, **kw):
    with knn_mode("plain"):
        return tuple(map(np.asarray, knn(*args, **kw)))


def test_knn_small_vs_numpy(rng):
    q = rng.normal(size=(37, 3)).astype(np.float32)
    c = rng.normal(size=(211, 3)).astype(np.float32)
    mask = rng.uniform(size=211) < 0.9
    d, i = _plain_knn(jnp.array(q), jnp.array(c), jnp.array(mask), 5)
    d2 = _brute(q, c, mask)
    ref_i = np.argsort(d2, axis=1)[:, :5]
    ref_d = np.take_along_axis(d2, ref_i, axis=1)
    np.testing.assert_allclose(d, ref_d, rtol=1e-4, atol=1e-5)
    # indices may tie; compare distances only where unique
    np.testing.assert_allclose(
        np.take_along_axis(d2, i, axis=1), ref_d, rtol=1e-4, atol=1e-5
    )


def test_knn_blocked_matches_single(rng):
    q = rng.normal(size=(16, 3)).astype(np.float32) * 5
    c = rng.normal(size=(1024, 3)).astype(np.float32) * 5
    mask = np.ones(1024, bool)
    d1, _ = _plain_knn(jnp.array(q), jnp.array(c), jnp.array(mask), 3, block=2048)
    d2, _ = _plain_knn(jnp.array(q), jnp.array(c), jnp.array(mask), 3, block=256)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-6)


def test_nn1_all_masked(rng):
    q = rng.normal(size=(4, 3)).astype(np.float32)
    c = rng.normal(size=(64, 3)).astype(np.float32)
    with knn_mode("plain"):
        d, i = nn1(jnp.array(q), jnp.array(c), jnp.zeros(64, bool))
    assert (np.asarray(d) > 1e30).all()


@pytest.mark.parametrize("k", KS)
def test_exact_recall(rng, k):
    q = rng.uniform(-30, 30, (64, 3)).astype(np.float32)
    c = rng.uniform(-30, 30, (1500, 3)).astype(np.float32)
    mask = rng.random(1500) < 0.9
    d, i = _plain_knn(jnp.array(q), jnp.array(c), jnp.array(mask), k)
    ref_i = np.argsort(_brute(q, c, mask), axis=1, kind="stable")[:, :k]
    recall = np.mean([len(set(i[r]) & set(ref_i[r])) / k for r in range(len(q))])
    assert recall > 0.999, recall


@pytest.mark.parametrize("k", KS)
def test_masked_sentinel(rng, k):
    """Fewer valid candidates than k: the surplus slots report the sentinel
    and the valid ones are all found."""
    q = rng.normal(size=(8, 3)).astype(np.float32)
    c = rng.normal(size=(128, 3)).astype(np.float32)
    mask = np.zeros(128, bool)
    n_valid = max(k - 1, 0)
    mask[:n_valid] = True
    d, i = _plain_knn(jnp.array(q), jnp.array(c), jnp.array(mask), k)
    assert (d[:, n_valid:] > 1e30).all()
    assert (d[:, :n_valid] < 1e30).all()
    assert all(set(i[r, :n_valid]) == set(range(n_valid)) for r in range(8))


@pytest.mark.parametrize("k", KS)
def test_blocked_equals_single(rng, k):
    """N > block takes the scan with a running merge: same answer as one
    block, including an unaligned tail."""
    q = rng.normal(size=(24, 3)).astype(np.float32) * 5
    c = rng.normal(size=(1000, 3)).astype(np.float32) * 5
    mask = rng.random(1000) < 0.9
    args = (jnp.array(q), jnp.array(c), jnp.array(mask), k)
    d1, i1 = _plain_knn(*args, block=2048)
    d2, i2 = _plain_knn(*args, block=256)
    # the blocks' matmuls round differently: f32 cancellation at |coord|^2
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)
    assert (i1 == i2).mean() > 0.99


@pytest.mark.parametrize("k", KS)
def test_d2_matches_idx(rng, k):
    q = rng.uniform(-60, 60, (48, 3)).astype(np.float32)
    c = rng.uniform(-60, 60, (900, 3)).astype(np.float32)
    mask = rng.random(900) < 0.8
    d, i = _plain_knn(jnp.array(q), jnp.array(c), jnp.array(mask), k)
    d_re = ((c[i] - q[:, None]) ** 2).sum(-1)
    # matmul form: |q|^2 + |c|^2 - 2 q.c cancels ~|coord|^2 * 2^-23
    np.testing.assert_allclose(d, d_re, rtol=1e-4, atol=5e-3)
    assert mask[i].all()
