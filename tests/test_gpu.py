"""The compiled k-NN kernel on the GPU against the plain path.

Marked ``gpu``: skips unless JAX sees a GPU (decided by the ``gpu`` fixture,
never at import).  chip_smoke.py runs the same comparison at production
shapes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vloam_tpu.ops.knn import knn, knn_mode, morton_sort


def _cloud(rng, n):
    xy = rng.uniform(-40, 40, (n, 2))
    z = np.where(rng.random(n) < 0.6, -1.7, rng.uniform(-1.7, 3.0, n))
    return np.concatenate([xy, z[:, None]], 1).astype(np.float32)


def _both(q, c, m, k, r):
    out = {}
    for mode in ("plain", "kernel"):
        with knn_mode(mode):
            d, i = jax.jit(lambda a, b, cm: knn(a, b, cm, k, prune_radius=r))(q, c, m)
        out[mode] = (np.asarray(d), np.asarray(i))
    return out["plain"], out["kernel"]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 5, 16])
def test_kernel_matches_plain_full_search(gpu, rng, k):
    q = jnp.array(_cloud(rng, 1000))
    c = jnp.array(_cloud(rng, 9000))
    m = jnp.array(rng.random(9000) < 0.8)
    (pd, pi), (kd, ki) = _both(q, c, m, k, None)
    # plain matmul form cancels ~4 eps |x|^2; the kernel's difference form not
    np.testing.assert_allclose(kd, pd, rtol=1e-4, atol=2e-3)
    assert (ki == pi).mean() > 0.99


@pytest.mark.gpu
def test_kernel_matches_plain_pruned(gpu, rng):
    c, cm = morton_sort(jnp.array(_cloud(rng, 20000)), jnp.array(rng.random(20000) < 0.7), 4.0)
    q, _ = morton_sort(jnp.array(_cloud(rng, 4000)), jnp.ones(4000, bool), 2.0)
    (pd, pi), (kd, ki) = _both(q, c, cm, 5, 1.0)
    gate = pd < 1.0
    np.testing.assert_allclose(kd[gate], pd[gate], rtol=1e-4, atol=2e-3)
    assert (kd[~gate] >= 0.999).all()
