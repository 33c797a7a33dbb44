"""Batched Gauss-Newton / Levenberg-Marquardt on SE(3) — the Ceres replacement.

The reference's three solvers (VO: visual_odometry.cpp:482, LO:
laser_odometry.cpp:509, MO: laser_mapping.cpp:717) are tiny nonlinear least
squares: 6-7 DoF, 10^3 residuals, Huber(0.1), <=4 Ceres iterations, DENSE_QR.
Each iteration collapses to: one vmapped residual+Jacobian evaluation, one
(6 x NR) x (NR x 6) matmul for J^T J, and a 6x6 dense solve — all fused by XLA
into a handful of kernels.  No factor graphs, no per-residual heap
allocation.

Robustness: Huber weighting per residual *block* (Ceres semantics — the loss
acts on the squared norm of the whole block, see ceres::HuberLoss), applied
as IRLS weights sqrt(rho'(s)).

The normal-equation accumulation optionally psums over a named mesh axis —
this is the hook the distributed mapping backend uses: residual blocks live
on different devices, J^T J / J^T r are 36 + 6 floats, so the collective is
tiny.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from vloam_tpu import geometry as geo


def huber_block_weight(sq_norm: jax.Array, delta: float) -> jax.Array:
    """sqrt(rho'(s)) for Huber: 1 inside, sqrt(delta/||r||) outside."""
    r = jnp.sqrt(jnp.maximum(sq_norm, 1e-20))
    return jnp.where(r <= delta, 1.0, jnp.sqrt(delta / r))


def normal_equations(
    r: jax.Array,        # (NR,) flattened scalar residuals
    J: jax.Array,        # (NR, D)
    w: jax.Array,        # (NR,) weights (0 for padding)
    axis_name: str | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Weighted J^T J and J^T r, optionally psum-reduced over a mesh axis."""
    Jw = J * w[:, None]
    rw = r * w
    jtj = Jw.T @ Jw                       # (D, D)
    jtr = Jw.T @ rw                       # (D,)
    if axis_name is not None:
        jtj = jax.lax.psum(jtj, axis_name)
        jtr = jax.lax.psum(jtr, axis_name)
    return jtj, jtr


def lm_step(jtj: jax.Array, jtr: jax.Array, lm_lambda: float) -> jax.Array:
    """Solve (J^T J + lambda diag(J^T J)) dx = -J^T r."""
    from vloam_tpu.ops.linalg3 import solve_spd_small

    d = jnp.diagonal(jtj)
    damped = jtj + jnp.diag(lm_lambda * d + 1e-10)
    return solve_spd_small(damped, -jtr)


def pose_plus(pose: jax.Array, delta: jax.Array) -> jax.Array:
    """Local update: q <- exp(dtheta) (x) q,  t <- t + dt.  delta = [dtheta, dt]."""
    dq = geo.angle_axis_to_quat(delta[:3])
    q = geo.quat_normalize(geo.quat_mul(dq, geo.pose_q(pose)))
    return geo.pose_from_qt(q, geo.pose_t(pose) + delta[3:])


def solve_pose_gn(
    residual_fn: Callable[[jax.Array], tuple],
    pose0: jax.Array,
    iters: int,
    huber_delta: float,
    lm_lambda: float,
    axis_name: str | None = None,
) -> jax.Array:
    """Iterate GN on a 7-vector pose with 6-DoF tangent updates.

    ``residual_fn(pose)`` returns a tuple of residual groups
    ``((res (B, Rdim), valid (B,)), ...)`` — e.g. an edge group (Rdim=3) and a
    plane group (Rdim=1).  The Jacobian w.r.t. the local 6-DoF delta is taken
    with jacfwd through ``pose_plus`` (6 JVPs total, batched by XLA); normal
    equations accumulate over all groups and optionally psum over a mesh axis.
    """

    def gn_iter(_, pose):
        def local(delta):
            groups = residual_fn(pose_plus(pose, delta))
            rs = tuple(r for r, _ in groups)
            return rs, groups

        Js, groups = jax.jacfwd(local, has_aux=True)(jnp.zeros(6, pose0.dtype))
        jtj = jnp.zeros((6, 6), pose0.dtype)
        jtr = jnp.zeros((6,), pose0.dtype)
        for J, (r, valid) in zip(Js, groups):
            # r: (B, Rdim), J: (B, Rdim, 6)
            sq = jnp.sum(r * r, axis=-1)
            w_blk = huber_block_weight(sq, huber_delta) * valid.astype(r.dtype)
            w = jnp.repeat(w_blk, r.shape[-1])
            a, b = normal_equations(r.reshape(-1), J.reshape(-1, 6), w, axis_name=None)
            jtj = jtj + a
            jtr = jtr + b
        if axis_name is not None:
            jtj = jax.lax.psum(jtj, axis_name)
            jtr = jax.lax.psum(jtr, axis_name)
        delta = lm_step(jtj, jtr, lm_lambda)
        return pose_plus(pose, delta)

    # Fully unrolled: the GN iteration is ~30 tiny ops, so the while-loop's
    # per-iteration condition/state overhead is a measurable slice of the
    # 6-26 iterations each frame runs; unrolling also lets XLA fuse across
    # iteration boundaries.
    with jax.named_scope("gauss_newton"):
        return jax.lax.fori_loop(0, iters, gn_iter, pose0, unroll=True)
