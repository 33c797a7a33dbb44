"""Fused k-NN kernel (ops/pallas_knn.py) vs a NumPy brute-force oracle.

The kernel runs in the Pallas interpreter here; its contract is exact
k-NN (see the module docstring), so the checks compare distances to float
rounding and neighbour sets exactly.  The compiled kernel is checked against
the plain path on the GPU by chip_smoke.py and tests/test_gpu.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from vloam_tpu.ops import pallas_knn
from vloam_tpu.ops.knn import knn, knn_mode, morton_sort
from vloam_tpu.ops.pallas_knn import BM, BN, knn_fused

K = 5


def brute(q, cand, mask, k=K):
    d2 = np.sum((q[:, None, :].astype(np.float64) - cand[None, :, :]) ** 2, axis=-1)
    d2[:, ~mask] = np.inf
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d2, idx, axis=1), idx


def run(q, cand, mask, k=K, **kw):
    d2, idx = knn_fused(jnp.array(q), jnp.array(cand), jnp.array(mask), k,
                        interpret=True, **kw)
    return np.asarray(d2), np.asarray(idx)


@pytest.mark.parametrize("M,N", [(100, 700), (BM, BN), (33, 129)])
def test_exact_vs_brute(rng, M, N):
    """Aligned and unaligned sizes: exact distances, exact neighbour sets."""
    q = rng.uniform(-20, 20, (M, 3)).astype(np.float32)
    cand = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    mask = rng.random(N) < 0.85
    d2, idx = run(q, cand, mask)
    ref_d2, ref_idx = brute(q, cand, mask)
    np.testing.assert_allclose(d2, ref_d2, rtol=1e-5, atol=1e-6)
    assert (np.sort(idx, 1) == np.sort(ref_idx, 1)).mean() > 0.999


def test_reported_d2_matches_reported_idx(rng):
    M, N = 256, 2048
    q = rng.uniform(-20, 20, (M, 3)).astype(np.float32)
    cand = rng.uniform(-25, 25, (N, 3)).astype(np.float32)
    mask = rng.random(N) < 0.8
    d2, idx = run(q, cand, mask)
    d2_re = np.sum((cand[idx] - q[:, None, :]) ** 2, axis=-1)
    np.testing.assert_allclose(d2, d2_re, rtol=1e-5, atol=1e-6)
    assert mask[idx].all()              # masked candidates never returned
    assert (np.diff(d2, axis=1) >= 0).all()


def test_all_masked_returns_sentinel():
    q = np.zeros((8, 3), np.float32)
    cand = np.ones((512, 3), np.float32)
    d2, _ = run(q, cand, np.zeros(512, bool))
    assert (d2 > 1e30).all() and np.isfinite(d2).all()


def test_query_count_skips_tail(rng):
    q = rng.uniform(-5, 5, (200, 3)).astype(np.float32)
    cand = rng.uniform(-5, 5, (600, 3)).astype(np.float32)
    mask = np.ones(600, bool)
    d2, _ = run(q, cand, mask, query_count=jnp.int32(150))
    ref_d2, _ = brute(q, cand, mask)
    np.testing.assert_allclose(d2[:150], ref_d2[:150], rtol=1e-5, atol=1e-6)
    assert (d2[150:] > 1e30).all()


def test_k_limit_fails_loudly(rng):
    q = rng.normal(size=(8, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="k="):
        run(q, q, np.ones(8, bool), k=pallas_knn.K_MAX + 1)


def test_pruned_matches_within_radius(rng):
    """Morton-sorted clustered layout: pruning keeps every neighbour within
    the radius, and reports the rest beyond it (never wrong-but-small)."""
    M, N, R = 256, 4096, 1.0
    qa = (rng.uniform(0, 1, (M, 1)) * np.array([80, 4, 2])).astype(np.float32)
    qa += rng.normal(0, 1.0, (M, 3)).astype(np.float32)
    ca = (rng.uniform(0, 1, (N, 1)) * np.array([80, 4, 2])).astype(np.float32)
    ca += rng.normal(0, 1.2, (N, 3)).astype(np.float32)
    ma = rng.random(N) < 0.9
    ca_s, ma_s = morton_sort(jnp.array(ca), jnp.array(ma), cell=2.0)
    qa_s, _ = morton_sort(jnp.array(qa), jnp.ones(M, bool), cell=2.0)
    q, c, m = np.asarray(qa_s), np.asarray(ca_s), np.asarray(ma_s)
    d2, idx = run(q, c, m, prune_radius=R)
    ref_d2, _ = brute(q, c, m)
    within = ref_d2 < R * R
    np.testing.assert_allclose(d2[within], ref_d2[within], rtol=1e-5, atol=1e-6)
    assert (d2[~within] >= R * R * 0.999).all()


def test_pruned_isolated_block_gets_sentinel(rng):
    """A query block far from every candidate is pruned against every tile:
    the dedup gate (nn > r_dedup^2) must fire, so no NaN and no small d2."""
    M, N = 2 * BM, 2048
    q = rng.uniform(-5, 5, (M, 3)).astype(np.float32)
    q[BM:] = rng.uniform(395, 405, (BM, 3)).astype(np.float32)
    cand = rng.uniform(-6, 6, (N, 3)).astype(np.float32)
    d2, _ = run(q, cand, np.ones(N, bool), prune_radius=1.0)
    assert not np.isnan(d2).any()
    assert (d2[BM:] > 1e30).all()


def test_kernel_mode_matches_plain_path(rng):
    """knn() under the interpreted kernel agrees with the plain path inside
    the gate radius (the consumers' contract)."""
    q = (rng.uniform(0, 1, (300, 1)) * np.array([40, 6, 2])).astype(np.float32)
    cand = q[rng.integers(0, 300, 3000)] + rng.normal(0, 0.8, (3000, 3)).astype(np.float32)
    mask = rng.random(3000) < 0.95
    args = (jnp.array(q), jnp.array(cand), jnp.array(mask), K)
    with knn_mode("plain"):
        pd, pi = map(np.asarray, knn(*args, prune_radius=1.0))
    with knn_mode("interpret"):
        kd, ki = map(np.asarray, knn(*args, prune_radius=1.0))
    gate = pd < 0.9
    # the plain path's matmul form cancels ~|coord|^2 * 2^-23 per d2 (coords
    # up to ~40 m here); the kernel's difference form does not
    np.testing.assert_allclose(kd[gate], pd[gate], rtol=1e-4, atol=2e-3)
    assert (ki[gate] == pi[gate]).mean() > 0.999


def test_knn_mode_rejects_unknown():
    with pytest.raises(ValueError):
        with knn_mode("gpu"):
            pass
