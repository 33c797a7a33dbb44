"""Closed-form batched 3x3 symmetric linear algebra.

jnp.linalg.eigh on big batches of tiny matrices lowers to a loop-heavy
solver call; the analytic trigonometric eigensolver
is a few dozen vectorised flops per matrix and fuses into the surrounding
kernel.  Used by the mapping line/plane fits (reference: Eigen
SelfAdjointEigenSolver at laser_mapping.cpp:583 and colPivHouseholderQr at
laser_mapping.cpp:655).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def eigh3x3_sym(a, b, c, d, e, f):
    """Component-form eigendecomposition of symmetric 3x3 batches.

    Matrix layout (matching ``eigh3x3``):  [[a, d, f], [d, b, e], [f, e, c]],
    each component an arbitrary-shape batch array.

    Returns ((e1, e2, e3) ascending, ((v1x, v1y, v1z), (v2x, ...), (v3x, ...))).

    Structure-of-arrays on purpose: (..., 3)/(..., 3, 3) shapes put a
    length-3 axis innermost; componentwise, every op is a full-width (...,)
    elementwise vector op.
    """
    tr = a + b + c
    q = tr / 3.0
    p1 = d * d + f * f + e * e
    aq, bq, cq = a - q, b - q, c - q
    p2 = aq * aq + bq * bq + cq * cq + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))

    # B = (A - q I) / p ; r = det(B)/2 in [-1, 1] (componentwise determinant)
    inv_p = 1.0 / p
    a_, b_, c_ = aq * inv_p, bq * inv_p, cq * inv_p
    d_, e_, f_ = d * inv_p, e * inv_p, f * inv_p
    det = a_ * (b_ * c_ - e_ * e_) - d_ * (d_ * c_ - e_ * f_) + f_ * (d_ * e_ - b_ * f_)
    r = jnp.clip(det / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0

    e3 = q + 2.0 * p * jnp.cos(phi)                       # largest
    e1 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest
    e2 = tr - e1 - e3

    # Degenerate (isotropic) guard
    iso = p2 < 1e-20
    e1 = jnp.where(iso, a, e1)
    e2 = jnp.where(iso, b, e2)
    e3 = jnp.where(iso, c, e3)

    one = jnp.ones_like(a)
    zero = jnp.zeros_like(a)

    def eigvec(lam):
        # rows of (A - lam I); the eigenvector is the largest cross product
        # of two rows.  All three crosses computed componentwise.
        r0x, r0y, r0z = a - lam, d, f
        r1x, r1y, r1z = d, b - lam, e
        r2x, r2y, r2z = f, e, c - lam

        def cross(x1, y1, z1, x2, y2, z2):
            return y1 * z2 - z1 * y2, z1 * x2 - x1 * z2, x1 * y2 - y1 * x2

        c01 = cross(r0x, r0y, r0z, r1x, r1y, r1z)
        c02 = cross(r0x, r0y, r0z, r2x, r2y, r2z)
        c12 = cross(r1x, r1y, r1z, r2x, r2y, r2z)
        n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2]
        n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2]
        n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2]
        pick01 = n01 >= n02
        bx = jnp.where(pick01, c01[0], c02[0])
        by = jnp.where(pick01, c01[1], c02[1])
        bz = jnp.where(pick01, c01[2], c02[2])
        bn = jnp.maximum(n01, n02)
        pickb = bn >= n12
        bx = jnp.where(pickb, bx, c12[0])
        by = jnp.where(pickb, by, c12[1])
        bz = jnp.where(pickb, bz, c12[2])
        bn = jnp.maximum(bn, n12)
        inv = 1.0 / jnp.sqrt(jnp.maximum(bn, 1e-30))
        ok = bn >= 1e-24
        # isotropic fallback: any axis
        return (
            jnp.where(ok, bx * inv, one),
            jnp.where(ok, by * inv, zero),
            jnp.where(ok, bz * inv, zero),
        )

    v1 = eigvec(e1)
    v3 = eigvec(e3)
    v2x = v3[1] * v1[2] - v3[2] * v1[1]
    v2y = v3[2] * v1[0] - v3[0] * v1[2]
    v2z = v3[0] * v1[1] - v3[1] * v1[0]
    n2 = jnp.maximum(jnp.sqrt(v2x * v2x + v2y * v2y + v2z * v2z), 1e-30)
    v2 = (v2x / n2, v2y / n2, v2z / n2)
    return (e1, e2, e3), (v1, v2, v3)


def eigh3x3(A: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Eigendecomposition of symmetric (..., 3, 3) matrices.

    Returns (eigvals (..., 3) ascending, eigvecs (..., 3, 3) with columns as
    eigenvectors), matching Eigen's SelfAdjointEigenSolver convention.
    Analytic method: Deledalle et al. closed form + cross-product vectors,
    evaluated in component form (see eigh3x3_sym) and re-packed.
    """
    (e1, e2, e3), (v1, v2, v3) = eigh3x3_sym(
        A[..., 0, 0], A[..., 1, 1], A[..., 2, 2],
        A[..., 0, 1], A[..., 1, 2], A[..., 0, 2],
    )
    vals = jnp.stack([e1, e2, e3], axis=-1)
    vecs = jnp.stack(
        [jnp.stack(v, axis=-1) for v in (v1, v2, v3)], axis=-1
    )  # (..., 3 components, 3 columns)
    return vals, vecs


def solve_spd_small(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A x = b for a small SPD matrix (e.g. the 6x6 GN normal matrix)
    with an unrolled Cholesky — pure scalar jnp ops that XLA fuses into the
    surrounding kernel, where jnp.linalg.solve would be a separate LU solver
    call per tiny system."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-12))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def solve3x3_sym(a, b, c, d, e, f, bx, by, bz):
    """Cramer's-rule solve for symmetric [[a,d,f],[d,b,e],[f,e,c]] x = rhs,
    all inputs component batch arrays.  Returns (x0, x1, x2).

    Structure-of-arrays for the same reason as
    ``eigh3x3_sym`` (the mapping plane fit calls this on (M,) batches)."""
    m00 = b * c - e * e
    m01 = d * c - e * f
    m02 = d * e - b * f
    det = a * m00 - d * m01 + f * m02
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    det0 = bx * m00 - d * (by * c - e * bz) + f * (by * e - b * bz)
    det1 = a * (by * c - e * bz) - bx * m01 + f * (d * bz - by * f)
    det2 = a * (b * bz - e * by) - d * (d * bz - by * f) + bx * m02
    inv = 1.0 / det
    return det0 * inv, det1 * inv, det2 * inv


def solve3x3(A: jax.Array, b: jax.Array) -> jax.Array:
    """Cramer's-rule solve for (..., 3, 3) @ x = (..., 3)."""
    det = jnp.linalg.det(A)
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)

    def rep(i):
        return jnp.linalg.det(A.at[..., :, i].set(b))

    x = jnp.stack([rep(0), rep(1), rep(2)], axis=-1)
    return x / det[..., None]
