"""Essential-matrix RANSAC + relative-pose recovery, batched.

Parity target: ``VisualOdometry::solveRANSAC`` (reference
visual_odometry.cpp:234-299), which calls OpenCV ``findEssentialMat``
(RANSAC, prob 0.999, 1 px threshold) followed by ``recoverPose``.

Batched formulation: instead of OpenCV's sequential hypothesise-and-test
loop, ALL hypotheses are solved simultaneously —

  * one batched 8-point problem: (H, 8, 9) design matrices, batched 9x9
    eigendecomposition for the null vectors, batched 3x3 SVD to project
    onto the essential manifold;
  * one (H, N) Sampson-distance matrix pass to score every hypothesis
    against every correspondence in one elementwise pass;
  * a batched cheirality vote over the 4 (R, t) decompositions of the
    winning E.

Everything is fixed-shape and jit-once; masked correspondences are given
zero sampling weight and excluded from scoring.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vloam_tpu import geometry as geo


def _normalize(uv: jax.Array, K_inv: jax.Array) -> jax.Array:
    """Pixel coords -> normalized camera coords (x, y) with z=1."""
    uv1 = jnp.concatenate([uv, jnp.ones_like(uv[..., :1])], axis=-1)
    X = uv1 @ K_inv.T
    return X[..., :2] / jnp.maximum(X[..., 2:3], 1e-9)


def eight_point(x0: jax.Array, x1: jax.Array) -> jax.Array:
    """Batched 8-point essential matrix.

    x0, x1: (H, 8, 2) normalized coords in the two views.  Returns (H, 3, 3)
    essential matrices satisfying x1h^T E x0h = 0, projected onto the
    essential manifold (singular values 1, 1, 0).
    """
    a0, b0 = x0[..., 0], x0[..., 1]
    a1, b1 = x1[..., 0], x1[..., 1]
    one = jnp.ones_like(a0)
    # row of A per correspondence: [x1*x0, x1*y0, x1, y1*x0, y1*y0, y1, x0, y0, 1]
    A = jnp.stack(
        [a1 * a0, a1 * b0, a1, b1 * a0, b1 * b0, b1, a0, b0, one], axis=-1
    )  # (H, 8, 9)
    # Null vector of A = eigenvector of A^T A with smallest eigenvalue.
    AtA = jnp.einsum("hni,hnj->hij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)           # ascending eigenvalues
    e = vecs[..., 0]                          # (H, 9)
    E = e.reshape(*e.shape[:-1], 3, 3)
    # Project to essential manifold: singular values -> (1, 1, 0).
    U, _, Vt = jnp.linalg.svd(E)
    S = jnp.array([1.0, 1.0, 0.0], E.dtype)
    return (U * S[None, None, :]) @ Vt


def sampson_error(E: jax.Array, x0: jax.Array, x1: jax.Array) -> jax.Array:
    """Squared Sampson distance.  E: (H, 3, 3); x0, x1: (N, 2) -> (H, N)."""
    x0h = jnp.concatenate([x0, jnp.ones_like(x0[:, :1])], axis=-1)  # (N, 3)
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[:, :1])], axis=-1)
    Ex0 = jnp.einsum("hij,nj->hni", E, x0h)        # (H, N, 3)
    Etx1 = jnp.einsum("hji,nj->hni", E, x1h)       # E^T x1
    num = jnp.einsum("ni,hni->hn", x1h, Ex0) ** 2  # (x1^T E x0)^2
    den = (
        Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    )
    return num / jnp.maximum(den, 1e-12)


def find_essential_ransac(
    uv0: jax.Array,            # (N, 2) pixel coords, previous frame
    uv1: jax.Array,            # (N, 2) pixel coords, current frame
    mask: jax.Array,           # (N,) valid-match mask
    K: jax.Array,              # (3, 3) intrinsics
    n_hypotheses: int = 256,
    thresh_px: float = 1.0,
    seed: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """RANSAC essential matrix.  Returns (E (3,3), inlier mask (N,)).

    All ``n_hypotheses`` minimal samples are drawn and solved in one batch;
    the inlier count decides the winner (cv::findEssentialMat semantics,
    reference visual_odometry.cpp:254).
    """
    x0 = _normalize(uv0, jnp.linalg.inv(K))
    x1 = _normalize(uv1, jnp.linalg.inv(K))

    # Weighted sampling of valid matches: Gumbel-top-8 per hypothesis keeps
    # everything fixed-shape (no rejection loop).
    key = jax.random.PRNGKey(seed)
    g = jax.random.gumbel(key, (n_hypotheses, uv0.shape[0]))
    g = jnp.where(mask[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, 8)               # (H, 8) distinct valid indices

    E = eight_point(jnp.take(x0, idx, axis=0), jnp.take(x1, idx, axis=0))

    # Threshold in normalized coords: px / focal length.
    f = 0.5 * (K[0, 0] + K[1, 1])
    thresh = (thresh_px / f) ** 2
    err = sampson_error(E, x0, x1)             # (H, N)
    inl = (err < thresh) & mask[None, :]
    best = jnp.argmax(jnp.sum(inl, axis=1))
    return E[best], inl[best]


def _triangulate_depth(R: jax.Array, t: jax.Array, x0h: jax.Array, x1h: jax.Array):
    """Depth of each point in both cameras for candidate (R, t).

    x1 x (d0 R x0 + t) = 0  =>  d0 = (x1 x t) . (x1 x R x0) / |x1 x R x0|^2
    (x0h/x1h are (N, 3) homogeneous rays).  Returns (d0, z1).
    """
    Rx0 = x0h @ R.T
    c1 = jnp.cross(x1h, jnp.broadcast_to(t, x1h.shape))
    c2 = jnp.cross(x1h, Rx0)
    d0 = -jnp.sum(c1 * c2, axis=-1) / jnp.maximum(jnp.sum(c2 * c2, axis=-1), 1e-12)
    z1 = d0 * Rx0[:, 2] + t[2]
    return d0, z1


def recover_pose(
    E: jax.Array, x0: jax.Array, x1: jax.Array, mask: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Disambiguate the 4 (R, t) decompositions of E by cheirality vote.

    x0, x1: (N, 2) *normalized* coords.  Returns (pose (7,) = curr_T_last
    with unit-norm translation, n_good) — cv::recoverPose semantics
    (reference visual_odometry.cpp:258).
    """
    U, _, Vt = jnp.linalg.svd(E)
    # Keep rotations proper.
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    tvec = U[:, 2]
    cands_R = jnp.stack([R1, R1, R2, R2])          # (4, 3, 3)
    cands_t = jnp.stack([tvec, -tvec, tvec, -tvec])

    x0h = jnp.concatenate([x0, jnp.ones_like(x0[:, :1])], axis=-1)
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[:, :1])], axis=-1)
    d0, z1 = jax.vmap(_triangulate_depth, in_axes=(0, 0, None, None))(
        cands_R, cands_t, x0h, x1h
    )                                              # (4, N) each
    good = (d0 > 0) & (z1 > 0) & mask[None, :]
    votes = jnp.sum(good, axis=1)
    k = jnp.argmax(votes)
    q = geo.matrix_to_quat(cands_R[k])
    return geo.pose_from_qt(q, cands_t[k]), votes[k]


def solve_ransac_pose(
    uv0: jax.Array,
    uv1: jax.Array,
    mask: jax.Array,
    K: jax.Array,
    n_hypotheses: int = 256,
    thresh_px: float = 1.0,
    seed: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Full solveRANSAC parity: E by RANSAC, then (R, unit t) by cheirality.

    Returns (pose (7,), n_inliers).  Like the reference (which only logs the
    result), the translation scale is unobservable from 2D-2D matches.
    """
    E, inl = find_essential_ransac(uv0, uv1, mask, K, n_hypotheses, thresh_px, seed)
    x0 = _normalize(uv0, jnp.linalg.inv(K))
    x1 = _normalize(uv1, jnp.linalg.inv(K))
    pose, _ = recover_pose(E, x0, x1, inl)
    return pose, jnp.sum(inl)
