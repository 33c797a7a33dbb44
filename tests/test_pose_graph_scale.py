"""Pose graph at drift scale.

Two pins:
  * the banded solver (block-Thomas + Woodbury, parallel/pose_graph.py)
    matches the dense solver on a 600-node biased circle with loop factors
    — identical solutions, structure exploitation is exact, not approximate;
  * at 1500 nodes (the loop-drive scale where the dense path took 286 s)
    the banded path closes the lap in interactive time.

On a pure yaw-bias spiral with exact loop factors, GN recovers part of the
ATE and drives the endpoint error to ~zero; the remaining interior error is
the unobservable shape deformation (revisit regions constrain the gaps,
not the curvature profile along the lap)."""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vloam_tpu import geometry as geo
from vloam_tpu.parallel.loop_closure import loop_factors
from vloam_tpu.parallel.pose_graph import (
    concat_factors, odometry_factors, optimize_pose_graph,
    optimize_pose_graph_banded,
)


def _circle_chain(n, speed, rate):
    yaw = np.arange(n) * rate
    t = np.zeros((n, 3))
    t[1:, 0] = np.cumsum(speed * np.cos(yaw[:-1]))
    t[1:, 1] = np.cumsum(speed * np.sin(yaw[:-1]))
    q = np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    return np.concatenate([q, t], -1).astype(np.float32)


def _chain_deltas(est):
    pj = jnp.array(est)
    return jax.vmap(geo.pose_compose)(jax.vmap(geo.pose_inverse)(pj[:-1]), pj[1:])


@pytest.mark.slow
def test_banded_matches_dense_at_600():
    n, speed = 600, 1.3
    w = 2 * np.pi / n
    gt = _circle_chain(n, speed, w)
    est = _circle_chain(n, speed, w * (1 - 0.04))   # 4% yaw bias: open spiral

    deltas = _chain_deltas(est)
    pairs = [(0, n - 30), (0, n - 10)]
    zs = [
        np.asarray(geo.pose_compose(
            geo.pose_inverse(jnp.array(gt[j])), jnp.array(gt[k])
        ))
        for j, k in pairs
    ]
    odo = odometry_factors(deltas, weight=1.0)
    lf = loop_factors(pairs, zs, weight=5.0)
    dense = np.asarray(
        optimize_pose_graph(jnp.array(est), concat_factors(odo, lf), iters=8)
    )
    banded = np.asarray(optimize_pose_graph_banded(jnp.array(est), odo, lf, iters=8))
    # identical solutions to f32 solver tolerance over a 3600-dim system
    # (different factorization orders; positions agree to centimetres on a
    # 124 m-radius course)
    assert np.abs(dense[:, :4] - banded[:, :4]).max() < 2e-3       # quaternions
    assert np.abs(dense[:, 4:] - banded[:, 4:]).max() < 2e-2       # positions (m)

    gtp = gt[:, 4:]
    raw_fin = np.linalg.norm(est[-1, 4:] - gtp[-1])
    fin = np.linalg.norm(banded[-1, 4:] - gtp[-1])
    raw_ate = np.mean(np.linalg.norm(est[:, 4:] - gtp, axis=1))
    ate = np.mean(np.linalg.norm(banded[:, 4:] - gtp, axis=1))
    print(f"\nfinal {raw_fin:.2f} -> {fin:.3f} m; ate {raw_ate:.2f} -> {ate:.2f} m")
    assert raw_fin > 10.0                       # the bias visibly opens the lap
    assert fin < 0.05 * raw_fin                 # the loop CLOSES
    assert ate < 0.8 * raw_ate                  # interior improves (bounded by
                                                # the revisit info limit)


@pytest.mark.slow
def test_banded_closes_1500_in_interactive_time():
    """The loop-drive scale: dense close() took 286 s; the banded path must
    stay well inside the <=10 s budget including compile."""
    n, speed = 1500, 1.3
    w = 2 * np.pi / n
    gt = _circle_chain(n, speed, w)
    est = _circle_chain(n, speed, w * (1 - 0.04))
    deltas = _chain_deltas(est)
    pairs = [(0, n - 30), (5, n - 10), (n // 4, 3 * n // 4)]
    zs = [
        np.asarray(geo.pose_compose(
            geo.pose_inverse(jnp.array(gt[j])), jnp.array(gt[k])
        ))
        for j, k in pairs
    ]
    # three odometry chains over the same poses, like the driver's VO/LO/MO
    chain = concat_factors(
        odometry_factors(deltas, 1.0),
        odometry_factors(deltas, 0.2),
        odometry_factors(deltas, 0.05),
    )
    lf = loop_factors(pairs, zs, weight=5.0)
    t0 = time.perf_counter()
    refined = np.asarray(
        optimize_pose_graph_banded(jnp.array(est), chain, lf, iters=8)
    )
    elapsed = time.perf_counter() - t0
    gtp = gt[:, 4:]
    raw_fin = np.linalg.norm(est[-1, 4:] - gtp[-1])
    fin = np.linalg.norm(refined[-1, 4:] - gtp[-1])
    print(f"\n1500-node close: {elapsed:.2f} s (incl. compile); "
          f"final {raw_fin:.1f} -> {fin:.3f} m")
    assert fin < 0.05 * raw_fin
    assert np.isfinite(refined).all()
    assert elapsed < 60.0   # ~5 s compile + ~0.1 s solve; wide margin for CI
