"""Lidar residual blocks — the L2 solver layer (reference: lidarFactor.hpp).

All residuals are functions of a 7-vector pose (see vloam_tpu.geometry) and
per-correspondence constant data, vmapped over the correspondence axis by the
callers.  Definitions match the reference exactly:

* edge (point-to-line), 3-dim:  r = (lp - a) x (lp - b) / |a - b|
  (lidarFactor.hpp:41-46), lp = R(q) p + t.
* plane (point-to-plane via unit normal), 1-dim:  r = n . lp + d
  (lidarFactor.hpp:130; the 3-point LO form at :95 reduces to this with
  n = normalize((j-l) x (j-m)), d = -n . j).

The undistortion interpolation factor s is identically 1 for KITTI
(DISTORTION=false, laser_odometry.h:90), so the slerp collapses away in the
default path.  For spinning sensors without per-scan motion compensation,
``OdometryConfig.distortion`` switches LO to the ``*_interp`` forms below,
which reproduce the factors' internal slerp (lidarFactor.hpp:30-44) and
TransformToStart (laser_odometry.cpp:150-173): each point is mapped by the
pose interpolated to its intra-scan time fraction s = rel_time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vloam_tpu import geometry as geo


def edge_residual(pose: jax.Array, p: jax.Array, a: jax.Array, b: jax.Array) -> jax.Array:
    """(B,3) point-to-line residuals.  p,a,b: (B,3)."""
    lp = geo.pose_apply(pose, p)
    nu = jnp.cross(lp - a, lp - b)
    de = jnp.linalg.norm(a - b, axis=-1, keepdims=True)
    return nu / jnp.maximum(de, 1e-10)


def plane_residual(pose: jax.Array, p: jax.Array, n: jax.Array, d: jax.Array) -> jax.Array:
    """(B,1) point-to-plane residuals.  n: (B,3) unit normals, d: (B,)."""
    lp = geo.pose_apply(pose, p)
    return (jnp.sum(n * lp, axis=-1) + d)[..., None]


def plane_from_three_points(j: jax.Array, l: jax.Array, m: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(n, d) from the LO 3-point construction (lidarFactor.hpp:73-74)."""
    n = jnp.cross(j - l, j - m)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-10)
    d = -jnp.sum(n * j, axis=-1)
    return n, d


def pose_apply_interp(pose: jax.Array, p: jax.Array, s: jax.Array) -> jax.Array:
    """Apply the pose interpolated to per-point time fraction s (B,).

    TransformToStart (laser_odometry.cpp:163-167): lp = slerp(I, q; s) p + s t.
    With s = 1 this is ``geo.pose_apply``.
    """
    q_s = geo.quat_slerp_identity(geo.pose_q(pose), s)
    t_s = s[..., None] * geo.pose_t(pose)
    return geo.quat_rotate(q_s, p) + t_s


def transform_to_end(pose: jax.Array, p: jax.Array, s: jax.Array) -> jax.Array:
    """Undistort points to the sweep-END frame (TransformToEnd,
    laser_odometry.cpp:176-193): first to the start via the interpolated
    pose, then through the full inverse delta.

    The reference keeps this call site disabled (laser_odometry.cpp:537
    ``if (0)``) because its KITTI clouds are pre-synced; our distortion mode
    enables it so the stored last clouds are rigid in their anchor frame —
    without it the solve is biased by up to a full frame of motion at the
    sweep start (matching an undistorted scan against a distorted one).
    """
    un = pose_apply_interp(pose, p, s)
    return geo.pose_apply(geo.pose_inverse(pose), un)


def edge_residual_interp(
    pose: jax.Array, p: jax.Array, a: jax.Array, b: jax.Array, s: jax.Array
) -> jax.Array:
    """Distortion-aware point-to-line residual (lidarFactor.hpp:30-46)."""
    lp = pose_apply_interp(pose, p, s)
    nu = jnp.cross(lp - a, lp - b)
    de = jnp.linalg.norm(a - b, axis=-1, keepdims=True)
    return nu / jnp.maximum(de, 1e-10)


def plane_residual_interp(
    pose: jax.Array, p: jax.Array, n: jax.Array, d: jax.Array, s: jax.Array
) -> jax.Array:
    """Distortion-aware point-to-plane residual (lidarFactor.hpp:63-111)."""
    lp = pose_apply_interp(pose, p, s)
    return (jnp.sum(n * lp, axis=-1) + d)[..., None]


def distance_residual(pose: jax.Array, p: jax.Array, closest: jax.Array) -> jax.Array:
    """(B,3) point-to-point residuals: r = (R p + t) - closest.

    Reference ``LidarDistanceFactor`` (lidarFactor.hpp:146-177) — unused by
    the active LO/MO paths there but part of the solver-layer inventory.
    """
    return geo.pose_apply(pose, p) - closest


def solve_pose_gn_lidar(
    pose0: jax.Array,                  # (7,) [qx qy qz qw tx ty tz]
    edge: tuple,                       # (p (Be,3), a (Be,3), b (Be,3), valid (Be,))
    plane: tuple,                      # (p (Bs,3), n (Bs,3), d (Bs,), valid (Bs,))
    iters: int,
    huber_delta: float,
    lm_lambda: float,
) -> jax.Array:
    """GN solve over the two reference lidar factor types (edge + plane
    blocks), as LO and MO run it: ops/gauss_newton.solve_pose_gn with
    jacfwd Jacobians."""
    from vloam_tpu.ops.gauss_newton import solve_pose_gn

    ep, ea, eb, ev = edge
    pp, pn, pd, pv = plane

    def residuals(p):
        return (
            (edge_residual(p, ep, ea, eb), ev),
            (plane_residual(p, pp, pn, pd), pv),
        )

    return solve_pose_gn(residuals, pose0, iters, huber_delta, lm_lambda)
