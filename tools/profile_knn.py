"""Time the fused k-NN kernel against the plain XLA path on the GPU.

Mapping-association shapes (queries x submap candidates), Morton-sorted
clustered points as the mapping step feeds them, radius pruning as the
mapping step asks for it.  Prints each path's time per call, and the
kernel's agreement with the plain path inside the gate radius.

    python tools/profile_knn.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vloam_tpu.ops.knn import knn, knn_mode, morton_sort  # noqa: E402

R = 1.001   # the mapping step's prune radius (neighbor_dist_sq = 1 m^2)


def timeit(fn, n=30):
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def scene(rng, n):
    """Points on a few street-like planes and poles within +-60 m."""
    xy = rng.uniform(-60, 60, (n, 2))
    z = np.where(rng.random(n) < 0.6, -1.7, rng.uniform(-1.7, 3.0, n))
    return np.concatenate([xy, z[:, None]], 1).astype(np.float32)


def main():
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("profile_knn: no GPU found")
    rng = np.random.default_rng(0)
    for m, n, fill in [(4096, 16384, 0.6), (8192, 49152, 0.6)]:
        c, cm = morton_sort(jnp.array(scene(rng, n)), jnp.array(rng.random(n) < fill), 4.0)
        q, _ = morton_sort(jnp.array(scene(rng, m)) + 0.05, jnp.ones(m, bool), 2.0)
        res = {}
        for mode in ("plain", "kernel"):
            with knn_mode(mode):
                f = jax.jit(lambda a, b, d: knn(a, b, d, 5, prune_radius=R))
                res[mode] = (timeit(lambda: f(q, c, cm)), f(q, c, cm))
        (tp, (pd, pi)), (tk, (kd, ki)) = res["plain"], res["kernel"]
        gate = np.asarray(pd) < R * R
        err = float(np.max(np.abs(np.asarray(kd)[gate] - np.asarray(pd)[gate])))
        agree = float(np.mean(np.asarray(ki)[gate] == np.asarray(pi)[gate]))
        print(f"knn {m}x{n}: plain {tp:.3f} ms  kernel {tk:.3f} ms  "
              f"max|d2 diff| {err:.2e}  idx agreement {agree:.4f}")


if __name__ == "__main__":
    main()
