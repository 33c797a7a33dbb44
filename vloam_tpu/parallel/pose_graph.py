"""Pose-graph optimisation — the backend the reference lacks.

The reference chains frame-to-frame/-to-map solves and never revisits past
poses (SURVEY.md §2: no BA, no loop closures).  This module adds a batched
Gauss-Newton pose-graph solver over a window of keyframe poses with
relative-pose factors (odometry links, mapping links, loop closures):

  r_ij = [ log_q( zq_ij^-1 (x) (q_i^-1 (x) q_j) ),  R_i^T (t_j - t_i) - zt_ij ]

All factor residuals/Jacobians evaluate in one vmap.  Two solvers share
that evaluation:

* ``optimize_pose_graph`` — arbitrary graphs: scatter-add the (6W, 6W)
  block system and solve densely.  O(W^3); fine for sliding windows of
  tens of poses.  With ``axis_name`` the factor set shards across a device
  mesh and JtJ/Jtr psum across it — the distributed-BA reduction pattern
  (the Schur trick is unnecessary landmark-free: the pose system *is* the
  reduced system).
* ``optimize_pose_graph_banded`` — the full-trajectory case (a chain plus
  a handful of loop factors): JtJ is block-tridiagonal plus low-rank, so
  a block-Thomas (block-LDL^T) forward/backward ``lax.scan`` solves the
  chain part in O(W * 6^3) and the loop factors enter by the Woodbury
  identity against 6L extra right-hand sides.  A 1500-pose lap closes in
  well under a second where the dense path needed minutes (the two paths
  agree to solver tolerance; tests/test_pose_graph_scale.py pins that).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vloam_tpu import geometry as geo


class PoseGraphFactors(NamedTuple):
    i: jax.Array        # (F,) int32 source pose index
    j: jax.Array        # (F,) int32 target pose index
    z: jax.Array        # (F, 7) measured i_T_j (maps j-frame points into i-frame)
    weight: jax.Array   # (F,) scalar information weight
    valid: jax.Array    # (F,) bool


def relative_pose_residual(pose_i: jax.Array, pose_j: jax.Array, z: jax.Array) -> jax.Array:
    """(6,) residual of one factor."""
    rel = geo.pose_compose(geo.pose_inverse(pose_i), pose_j)
    dq = geo.quat_mul(geo.quat_conj(z[:4]), rel[:4])
    r_rot = geo.quat_to_angle_axis(dq)
    r_t = rel[4:] - z[4:]
    return jnp.concatenate([r_rot, r_t])


def _plus(p: jax.Array, d: jax.Array) -> jax.Array:
    """Left-multiplicative local update: d = (omega, dt) applied to pose p."""
    dq = geo.angle_axis_to_quat(d[:3])
    return geo.pose_from_qt(
        geo.quat_normalize(geo.quat_mul(dq, p[:4])), p[4:] + d[3:]
    )


def _eval_factors(
    poses: jax.Array, factors: PoseGraphFactors, huber_delta: float
) -> tuple[jax.Array, jax.Array]:
    """Huber-weighted residuals + Jacobians for every factor, one vmap.

    Returns (Jf (F, 6, 12), rf (F, 6)); columns 0:6 of Jf differentiate the
    local update of pose i, columns 6:12 of pose j.  Invalid factors weigh 0.
    """
    def one_factor(i, j, z, wgt, valid):
        pi = poses[i]
        pj = poses[j]

        def local(d):
            r = relative_pose_residual(_plus(pi, d[:6]), _plus(pj, d[6:]), z)
            return r, r

        Jf, r = jax.jacfwd(local, has_aux=True)(jnp.zeros(12, poses.dtype))
        sq = jnp.sum(r * r)
        w = jnp.where(sq > huber_delta**2, huber_delta / jnp.sqrt(sq + 1e-12), 1.0)
        w = w * wgt * valid.astype(poses.dtype)
        return Jf * w, r * w   # (6, 12), (6,)

    return jax.vmap(one_factor)(
        factors.i, factors.j, factors.z, factors.weight, factors.valid
    )


def optimize_pose_graph(
    poses: jax.Array,            # (W, 7)
    factors: PoseGraphFactors,
    iters: int = 5,
    lm_lambda: float = 1e-5,
    huber_delta: float = 0.5,
    axis_name: str | None = None,
) -> jax.Array:
    """GN/LM over the window; pose 0 is gauge-fixed with a strong prior."""
    W = poses.shape[0]
    D = 6 * W

    def gn_iter(_, poses):
        Jf, rf = _eval_factors(poses, factors, huber_delta)  # (F, 6, 12), (F, 6)

        Ji = Jf[:, :, :6]
        Jj = Jf[:, :, 6:]
        jtj_ii = jnp.einsum("fri,frj->fij", Ji, Ji)
        jtj_ij = jnp.einsum("fri,frj->fij", Ji, Jj)
        jtj_jj = jnp.einsum("fri,frj->fij", Jj, Jj)
        jtr_i = jnp.einsum("fri,fr->fi", Ji, rf)
        jtr_j = jnp.einsum("fri,fr->fi", Jj, rf)

        JtJ = jnp.zeros((W, W, 6, 6), poses.dtype)
        JtJ = JtJ.at[factors.i, factors.i].add(jtj_ii)
        JtJ = JtJ.at[factors.i, factors.j].add(jtj_ij)
        JtJ = JtJ.at[factors.j, factors.i].add(jnp.swapaxes(jtj_ij, -1, -2))
        JtJ = JtJ.at[factors.j, factors.j].add(jtj_jj)
        Jtr = jnp.zeros((W, 6), poses.dtype)
        Jtr = Jtr.at[factors.i].add(jtr_i)
        Jtr = Jtr.at[factors.j].add(jtr_j)

        if axis_name is not None:
            JtJ = jax.lax.psum(JtJ, axis_name)
            Jtr = jax.lax.psum(Jtr, axis_name)

        A = JtJ.transpose(0, 2, 1, 3).reshape(D, D)
        b = Jtr.reshape(D)
        # gauge prior on pose 0
        A = A + jnp.diag(
            jnp.concatenate([jnp.full(6, 1e6), jnp.zeros(D - 6)]).astype(poses.dtype)
        )
        A = A + jnp.diag(lm_lambda * jnp.diagonal(A) + 1e-8)
        delta = jnp.linalg.solve(A, -b).reshape(W, 6)
        return jax.vmap(_plus)(poses, delta)

    return jax.lax.fori_loop(0, iters, gn_iter, poses)


def _block_thomas_solve(diag: jax.Array, upper: jax.Array, rhs: jax.Array) -> jax.Array:
    """Solve the SPD block-tridiagonal system T x = rhs for multiple RHS.

    diag (W, 6, 6) are the diagonal blocks, upper (W-1, 6, 6) the (w, w+1)
    blocks, rhs (W, 6, R).  Block-LDL^T: a forward Schur recursion
    S_w = D_w - U_{w-1}^T S_{w-1}^{-1} U_{w-1} with substitution, then a
    backward substitution — two lax.scans of 6x6 algebra, O(W * 6^3)
    regardless of R's contribution O(W * 6^2 * R).
    """
    W = diag.shape[0]
    R = rhs.shape[-1]
    eye = jnp.eye(6, dtype=diag.dtype)
    zeros66 = jnp.zeros((1, 6, 6), diag.dtype)
    up_prev = jnp.concatenate([zeros66, upper])    # U_{w-1} aligned to w
    up_next = jnp.concatenate([upper, zeros66])    # U_w aligned to w

    def fwd(carry, inp):
        Sinv_prev, y_prev = carry
        D, Uprev, b = inp
        S = D - Uprev.T @ Sinv_prev @ Uprev
        Sinv = jnp.linalg.solve(S, eye)
        y = Sinv @ (b - Uprev.T @ y_prev)
        return (Sinv, y), (Sinv, y)

    init = (jnp.zeros((6, 6), diag.dtype), jnp.zeros((6, R), diag.dtype))
    _, (Sinv, y) = jax.lax.scan(fwd, init, (diag, up_prev, rhs))

    def bwd(x_next, inp):
        Sinv_w, y_w, U_w = inp
        x = y_w - Sinv_w @ (U_w @ x_next)
        return x, x

    _, xs = jax.lax.scan(
        bwd, jnp.zeros((6, R), diag.dtype), (Sinv, y, up_next), reverse=True
    )
    return xs


def optimize_pose_graph_banded(
    poses: jax.Array,                       # (W, 7)
    chain_factors: PoseGraphFactors,        # contract: j == i + 1 elementwise
    loop: PoseGraphFactors | None = None,   # few factors, arbitrary (i, j)
    iters: int = 5,
    lm_lambda: float = 1e-5,
    huber_delta: float = 0.5,
) -> jax.Array:
    """GN over a chain-plus-loops graph, exploiting the sparsity structure.

    ``chain_factors`` MUST connect consecutive poses (j == i + 1; multiple
    chains over the same poses are fine — e.g. the VO/LO/MO odometry
    chains).  Their JtJ is block-tridiagonal and solves by block-Thomas in
    O(W * 6^3).  ``loop`` factors (L of them) add JtJ_loop = U U^T with U a
    (6W, 6L) tall sparse matrix, folded in by the Woodbury identity:

      (T + U U^T)^-1 b = T^-1 b - T^-1 U (I + U^T T^-1 U)^-1 U^T T^-1 b

    i.e. one multi-RHS block-Thomas solve with 6L extra columns plus a
    (6L, 6L) dense solve.  The solution matches ``optimize_pose_graph`` on
    the same factor set (same Huber weights, gauge prior on pose 0, and LM
    damping computed from the FULL system diagonal including the loop
    blocks).  Intended as the whole-trajectory epilogue solver; for the
    sharded distributed path use ``optimize_pose_graph`` with axis_name.
    """
    W = poses.shape[0]
    if loop is not None and loop.i.shape[0] == 0:
        loop = None

    def gn_iter(_, poses):
        dtype = poses.dtype
        Jf, rf = _eval_factors(poses, chain_factors, huber_delta)
        Ji = Jf[:, :, :6]
        Jj = Jf[:, :, 6:]
        ci, cj = chain_factors.i, chain_factors.j
        diag = jnp.zeros((W, 6, 6), dtype)
        diag = diag.at[ci].add(jnp.einsum("fri,frj->fij", Ji, Ji))
        diag = diag.at[cj].add(jnp.einsum("fri,frj->fij", Jj, Jj))
        upper = jnp.zeros((W - 1, 6, 6), dtype)
        upper = upper.at[ci].add(jnp.einsum("fri,frj->fij", Ji, Jj))
        b = jnp.zeros((W, 6), dtype)
        b = b.at[ci].add(jnp.einsum("fri,fr->fi", Ji, rf))
        b = b.at[cj].add(jnp.einsum("fri,fr->fi", Jj, rf))

        if loop is not None:
            Jl, rl = _eval_factors(poses, loop, huber_delta)
            Li = Jl[:, :, :6]       # (L, 6, 6)
            Lj = Jl[:, :, 6:]
            b = b.at[loop.i].add(jnp.einsum("lri,lr->li", Li, rl))
            b = b.at[loop.j].add(jnp.einsum("lri,lr->li", Lj, rl))

        # gauge prior on pose 0, then LM damping from the FULL diagonal
        # (chain + gauge + loop blocks) — exactly the dense solver's damping
        diag = diag.at[0].add(1e6 * jnp.eye(6, dtype=dtype))
        full_diag = jnp.diagonal(diag, axis1=1, axis2=2)    # (W, 6)
        if loop is not None:
            full_diag = full_diag.at[loop.i].add(jnp.sum(Li * Li, axis=1))
            full_diag = full_diag.at[loop.j].add(jnp.sum(Lj * Lj, axis=1))
        diag = diag + jax.vmap(jnp.diag)(lm_lambda * full_diag + 1e-8)

        if loop is None:
            delta = _block_thomas_solve(diag, upper, (-b)[..., None])[..., 0]
            return jax.vmap(_plus)(poses, delta)

        L = loop.i.shape[0]
        # dense form of the sparse U: U[p, a, 6l+r] = J_l[r, a] at p = i_l, j_l
        r6 = jnp.arange(6)
        cols = (jnp.arange(L) * 6)[:, None, None] + r6[None, None, :]   # (L,1,6)
        rows = r6[None, :, None]
        U = jnp.zeros((W, 6, 6 * L), dtype)
        U = U.at[loop.i[:, None, None], rows, cols].add(jnp.swapaxes(Li, 1, 2))
        U = U.at[loop.j[:, None, None], rows, cols].add(jnp.swapaxes(Lj, 1, 2))

        rhs = jnp.concatenate([(-b)[..., None], U], axis=-1)
        X = _block_thomas_solve(diag, upper, rhs)
        x0 = X[..., 0]      # T^-1 (-b)           (W, 6)
        Z = X[..., 1:]      # T^-1 U              (W, 6, 6L)

        def Ut(Y):
            """U^T @ Y for Y of shape (W, 6) or (W, 6, K)."""
            out = (
                jnp.einsum("lra,la...->lr...", Li, Y[loop.i])
                + jnp.einsum("lra,la...->lr...", Lj, Y[loop.j])
            )
            return out.reshape((6 * L,) + Y.shape[2:])

        M = jnp.eye(6 * L, dtype=dtype) + Ut(Z)
        w = jnp.linalg.solve(M, Ut(x0))
        delta = x0 - jnp.einsum("wak,k->wa", Z, w)
        return jax.vmap(_plus)(poses, delta)

    return jax.lax.fori_loop(0, iters, gn_iter, poses)


def odometry_factors(deltas: jax.Array, weight: float = 1.0) -> PoseGraphFactors:
    """Chain factors from frame-to-frame deltas: z_k = k_T_{k+1}."""
    F = deltas.shape[0]
    return PoseGraphFactors(
        i=jnp.arange(F, dtype=jnp.int32),
        j=jnp.arange(1, F + 1, dtype=jnp.int32),
        z=deltas,
        weight=jnp.full((F,), weight, jnp.float32),
        valid=jnp.ones((F,), bool),
    )


def concat_factors(*fs: PoseGraphFactors) -> PoseGraphFactors:
    return PoseGraphFactors(*[jnp.concatenate(parts) for parts in zip(*fs)])
