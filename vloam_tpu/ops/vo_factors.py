"""Visual odometry residual blocks — reference: ceres_cost_function.h.

Active residuals (visual_odometry.cpp:400-474): the 3D-2D reprojection
``CostFunctor32`` (:58-100) for matches whose previous-frame pixel has lidar
depth, and the 2D-2D epipolar ``CostFunctor22`` (:151-189) otherwise.  The
3D-3D (``CostFunctor33``, :10-56) and 2D-3D (``CostFunctor23``, :102-149)
forms are dead code in the reference (the branches using them are commented
out at visual_odometry.cpp:374-451) but part of its solver-layer inventory,
so they are provided here too — same conventions, unused by the pipeline.

The pose maps previous-camera coords into current-camera coords
(cam0_curr_T_cam0_last).  The reference parametrises with angle-axis; we
use the engine-wide 7-pose with tangent-space GN — same optimum, and one
shared solver (ops.gauss_newton) for VO/LO/MO.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vloam_tpu import geometry as geo


def reproj_32_residual(pose: jax.Array, X0: jax.Array, xbar1: jax.Array) -> jax.Array:
    """(B, 2): r = [(R X0 + t)_x - (R X0 + t)_z * xbar, ..._y - ..._z * ybar]."""
    Y = geo.pose_apply(pose, X0)
    return jnp.stack(
        [Y[..., 0] - Y[..., 2] * xbar1[..., 0], Y[..., 1] - Y[..., 2] * xbar1[..., 1]],
        axis=-1,
    )


def epipolar_22_residual(pose: jax.Array, xbar0: jax.Array, xbar1: jax.Array) -> jax.Array:
    """(B, 1): r = X1_bar . (t x (R X0_bar)) — the essential-matrix constraint."""
    X0 = jnp.concatenate([xbar0, jnp.ones_like(xbar0[..., :1])], axis=-1)
    X1 = jnp.concatenate([xbar1, jnp.ones_like(xbar1[..., :1])], axis=-1)
    RX0 = geo.quat_rotate(pose[..., :4], X0)
    t = pose[..., 4:7]
    return jnp.sum(X1 * jnp.cross(jnp.broadcast_to(t, RX0.shape), RX0), axis=-1, keepdims=True)


def point_33_residual(pose: jax.Array, X0: jax.Array, X1: jax.Array) -> jax.Array:
    """(B, 3) 3D-3D point residual: r = (R X0 + t) - X1.

    Reference ``CostFunctor33`` (ceres_cost_function.h:10-56) — dead code
    there (visual_odometry.cpp:374-393 commented out) but inventoried.
    """
    return geo.pose_apply(pose, X0) - X1


def inverse_23_residual(pose: jax.Array, xbar0: jax.Array, X1: jax.Array) -> jax.Array:
    """(B, 2) 2D-3D inverse reprojection: Y = R^T (X1 - t); r = [Yx - Yz x0bar, Yy - Yz y0bar].

    Reference ``CostFunctor23`` (ceres_cost_function.h:102-149): the current
    frame's 3D point is pulled back into the previous frame with the inverse
    pose and compared against the previous frame's normalised pixel.
    """
    Y = geo.pose_apply(geo.pose_inverse(pose), X1)
    return jnp.stack(
        [Y[..., 0] - Y[..., 2] * xbar0[..., 0], Y[..., 1] - Y[..., 2] * xbar0[..., 1]],
        axis=-1,
    )


def solve_pose_gn_vo(
    pose0: jax.Array,        # (7,)
    X0: jax.Array,           # (M, 3) unprojected previous-frame points
    xb0: jax.Array,          # (M, 2) previous normalised rays
    xb1: jax.Array,          # (M, 2) current normalised rays
    has_depth: jax.Array,    # (M,) -> 3D-2D residual
    no_depth: jax.Array,     # (M,) -> 2D-2D residual
    iters: int,
    huber_delta: float,
    lm_lambda: float,
) -> jax.Array:
    """The VO GN solve (visual_odometry.cpp:400-482): 3D-2D reprojection
    blocks where the previous pixel has depth, 2D-2D epipolar blocks
    elsewhere, through ops/gauss_newton.solve_pose_gn."""
    from vloam_tpu.ops.gauss_newton import solve_pose_gn

    def residuals(p):
        return (
            (reproj_32_residual(p, X0, xb1), has_depth),
            (epipolar_22_residual(p, xb0, xb1), no_depth),
        )

    return solve_pose_gn(residuals, pose0, iters, huber_delta, lm_lambda)
