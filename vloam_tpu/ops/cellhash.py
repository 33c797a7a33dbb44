"""Hashed cell-list nearest-neighbour tables — the radius-bounded kd-tree.

The mapping correspondences only ever *use* neighbours closer than 1 m:
every consumer gates on ``pointSearchSqDis[4] < 1.0`` (reference
laser_mapping.cpp:557,642) and the insert-dedup radius is 0.2/0.4 m, so
~99.9% of the candidate distances the brute-force k-NN in ops/knn.py
evaluates are provably irrelevant.

STATUS — NOT wired into the mapping hot path, and not measured on the GPU:
the brute-force k-NN (with box pruning on the kernel path) serves the
production sizes.  The op is retained (and unit-tested vs a NumPy oracle)
for regimes where brute force is genuinely infeasible — host-side queries
against very large maps, or N >~ 10^6 candidates where O(M*N) loses to
O(M*cap*27).

The method is the classic cell list, laid out for fixed shapes:
candidates are scattered into an open-hashed table of spatial cells
(edge = the 1 m gate radius), and each query examines only the 27 buckets
of its 3x3x3 cell neighbourhood.  All points within the gate radius lie in
that neighbourhood, so the result equals brute force for every neighbour
that can affect the fits; points beyond the gate may be missed, but they
are discarded by the gate anyway.

Hash collisions are benign by construction:
  * two *far* cells sharing a bucket only add candidates that the distance
    test rejects;
  * two of a query's 27 *neighbour* cells hashing to the same bucket would
    double-count its points, so duplicate bucket ids are masked per query;
  * bucket-capacity overflow drops points (same policy as cube capacity).

Empty slots hold a far-away sentinel coordinate instead of a validity mask,
so the query path needs no mask gather at all.

Layout note: tables are stored 2-D as (table_size, cap*4), so a bucket is
one contiguous row gather; the kernel reshapes the gathered rows back to
(..., cap, 4) for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vloam_tpu.ops.knn import _min_k

_INF = jnp.float32(3.4e38)
SENTINEL = jnp.float32(1e6)     # empty-slot coordinate; d2 ~ 3e12 << _INF
_P1, _P2, _P3 = 73856093, 19349663, 83492791   # standard spatial-hash primes


def cell_hash(cell: jax.Array, table_size: int) -> jax.Array:
    """(..., 3) int32 cell coords -> bucket id in [0, table_size).

    table_size must be a power of two (masked, not modded)."""
    assert table_size & (table_size - 1) == 0
    h = cell[..., 0] * _P1 ^ cell[..., 1] * _P2 ^ cell[..., 2] * _P3
    return h & (table_size - 1)


def _bucket_ranks(h_sorted: jax.Array) -> jax.Array:
    """Rank of each element within its (sorted-key) run."""
    n = h_sorted.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool), h_sorted[1:] != h_sorted[:-1]])
    return idx - jax.lax.cummax(jnp.where(is_start, idx, 0))


def empty_cell_table(table_size: int, cap: int) -> jax.Array:
    """(table_size, cap*4) table with every slot at the sentinel."""
    return jnp.full((table_size, cap * 4), SENTINEL, jnp.float32)


def build_cell_table(
    pts: jax.Array,          # (N, 4) xyzw candidates
    mask: jax.Array,         # (N,) bool
    cell_size: float,
    table_size: int,
    cap: int,
) -> tuple[jax.Array, jax.Array]:
    """Scatter points into (table_size, cap*4) buckets; returns (tbl, cnt)."""
    cells = jnp.floor(pts[:, :3] / cell_size).astype(jnp.int32)
    h = jnp.where(mask, cell_hash(cells, table_size), table_size)
    order = jnp.argsort(h)
    h_s = jnp.take(h, order)
    pts_s = jnp.take(pts, order, axis=0)
    rank = _bucket_ranks(h_s)
    ok = (h_s < table_size) & (rank < cap)
    dest = jnp.where(ok, h_s * cap + rank, table_size * cap)
    tbl = jnp.full((table_size * cap + 1, 4), SENTINEL, jnp.float32).at[dest].set(
        jnp.where(ok[:, None], pts_s, SENTINEL), mode="drop", unique_indices=True
    )[:-1]
    cnt = jax.ops.segment_sum(
        ok.astype(jnp.int32), jnp.minimum(h_s, table_size),
        num_segments=table_size + 1, indices_are_sorted=True,
    )[:table_size]
    return tbl.reshape(table_size, cap * 4), cnt


def append_cell_table(
    tbl: jax.Array,          # (table_size, cap*4)
    cnt: jax.Array,          # (table_size,) int32
    pts: jax.Array,          # (N, 4)
    mask: jax.Array,         # (N,) bool
    cell_size: float,
) -> tuple[jax.Array, jax.Array]:
    """Append masked points to their buckets (overflow drops)."""
    table_size = tbl.shape[0]
    cap = tbl.shape[1] // 4
    cells = jnp.floor(pts[:, :3] / cell_size).astype(jnp.int32)
    h = jnp.where(mask, cell_hash(cells, table_size), table_size)
    order = jnp.argsort(h)
    h_s = jnp.take(h, order)
    pts_s = jnp.take(pts, order, axis=0)
    rank = _bucket_ranks(h_s)
    row = jnp.take(cnt, jnp.minimum(h_s, table_size - 1)) + rank
    ok = (h_s < table_size) & (row < cap)
    dest = jnp.where(ok, h_s * cap + row, table_size * cap)
    flat = tbl.reshape(-1, 4)
    flat = jnp.concatenate([flat, jnp.zeros((1, 4), flat.dtype)]).at[dest].set(
        jnp.where(ok[:, None], pts_s, SENTINEL), mode="drop", unique_indices=True
    )[:-1]
    added = jax.ops.segment_sum(
        ok.astype(jnp.int32), jnp.minimum(h_s, table_size),
        num_segments=table_size + 1, indices_are_sorted=True,
    )[:table_size]
    return flat.reshape(table_size, cap * 4), cnt + added


# 3x3x3 neighbourhood offsets, static
_OFFSETS = jnp.stack(
    jnp.meshgrid(*([jnp.arange(-1, 2)] * 3), indexing="ij"), axis=-1
).reshape(-1, 3).astype(jnp.int32)                        # (27, 3)


def cell_knn(
    query: jax.Array,        # (M, 3)
    tbl: jax.Array,          # (table_size, cap*4)
    cell_size: float,
    k: int,
) -> tuple[jax.Array, jax.Array]:
    """k nearest within the 3x3x3 cell neighbourhood.

    Returns (d2 (M, k), nbr (M, k, 3)).  Neighbours farther than cell_size
    may be reported with their true distance or missed entirely (d2 = huge);
    callers must gate at d2 < cell_size**2 — exactly what the mapping fits
    already do (laser_mapping.cpp:557,642)."""
    table_size = tbl.shape[0]
    cap = tbl.shape[1] // 4
    m = query.shape[0]
    cq = jnp.floor(query / cell_size).astype(jnp.int32)    # (M, 3)
    hs = cell_hash(cq[:, None, :] + _OFFSETS[None], table_size)   # (M, 27)

    # Mask buckets already visited by an earlier neighbour offset (hash
    # collision among the 27) so no candidate is double-counted.
    dup = jnp.any(
        (hs[:, :, None] == hs[:, None, :])
        & (jnp.arange(27)[None, :] > jnp.arange(27)[:, None])[None], axis=1,
    )                                                       # (M, 27)

    cand = jnp.take(tbl, hs.reshape(-1), axis=0).reshape(m, 27, cap, 4)  # 2-D gather
    diff = cand[..., :3] - query[:, None, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)                      # (M, 27, cap)
    d2 = jnp.where(dup[:, :, None], _INF, d2).reshape(m, 27 * cap)
    d2k, idx = _min_k(d2, k)
    nbr = jnp.take_along_axis(
        cand.reshape(m, 27 * cap, 3 + 1)[..., :3], idx[..., None], axis=1
    )
    return d2k, nbr
