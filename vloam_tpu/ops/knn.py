"""Brute-force nearest-neighbour search — the kd-tree replacement.

The reference builds 4 PCL KdTreeFLANN trees per frame (2 in LaserOdometry,
2 in LaserMapping) and queries them point-by-point.  At these sizes (10^3
queries x 10^4..10^5 candidates) a brute-force distance sweep is the better
fit for an accelerator.  Two implementations with one exact contract:

  * the plain path (any backend): a blocked distance matrix
    ||q||^2 + ||c||^2 - 2 q.c^T and a row-wise ``lax.top_k``, with a running
    merge over candidate blocks wider than ``block``;
  * on the GPU, the fused Pallas kernel in ops/pallas_knn.py, which never
    writes the distance matrix to device memory.

``_mode`` is the one place that chooses between them.  Masked
candidates get distance 3.4e38.  All shapes static.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp

_INF = jnp.float32(3.4e38)  # large finite sentinel (inf-safe for top_k)

_MODES = ("plain", "kernel", "interpret")
_MODE: str | None = None      # None: decide by backend (see _mode)


@contextlib.contextmanager
def knn_mode(mode: str):
    """Force one implementation for everything traced inside the block:
    "plain", "kernel" (the fused GPU kernel) or "interpret" (the same kernel
    in the Pallas interpreter, for CPU tests).  Used to time the kernel
    against the plain path in one process."""
    global _MODE
    if mode not in _MODES:
        raise ValueError(f"knn_mode: {mode!r} not in {_MODES}")
    prev, _MODE = _MODE, mode
    try:
        yield
    finally:
        _MODE = prev


def _mode() -> str:
    """The fused k-NN kernel runs on the GPU; other backends take the plain
    path.  ``knn_mode`` takes precedence."""
    if _MODE is not None:
        return _MODE
    return "kernel" if jax.default_backend() == "gpu" else "plain"


def _knn_scope(fn):
    """Run ``fn`` under the "knn" named scope (the trace reduction in
    tools/profile_trace.py reads it)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.named_scope("knn"):
            return fn(*args, **kwargs)

    return wrapped


def _fused(query, cand, cand_mask, k, query_count, prune_radius):
    from vloam_tpu.ops.pallas_knn import knn_fused

    return knn_fused(query, cand, cand_mask, k, query_count=query_count,
                     prune_radius=prune_radius, interpret=_mode() == "interpret")


def pairwise_sqdist(query: jax.Array, cand: jax.Array) -> jax.Array:
    """(M,3) x (N,3) -> (M,N) squared distances via one matmul.

    The cross term MUST run at full f32 precision: bf16 operands lose
    ~|coord|^2 * 2^-8 per product (TF32 ~|coord|^2 * 2^-11) — square metres
    at KITTI coordinate scales, which silently corrupts every neighbour
    ranking (67 m^2 max error, 0.81 recall@5 at +-60 m coords with bf16)."""
    q2 = jnp.sum(query * query, axis=-1, keepdims=True)
    c2 = jnp.sum(cand * cand, axis=-1)[None, :]
    cross = jnp.matmul(query, cand.T, precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(q2 + c2 - 2.0 * cross, 0.0)


def _min_k(d2: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Row-wise smallest-k, exact."""
    neg, idx = jax.lax.top_k(-d2, k)
    return -neg, idx


@_knn_scope
def knn(
    query: jax.Array,       # (M, 3)
    cand: jax.Array,        # (N, 3)
    cand_mask: jax.Array,   # (N,) bool
    k: int,
    block: int = 32768,
    query_count: jax.Array | None = None,
    prune_radius: float | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Exact k nearest candidates per query: returns (sqdist (M,k), idx (M,k)).

    Invalid candidates never win (distance _INF).  The plain path uses one
    matmul + top-k if N <= block, else a lax.scan with a running merge.

    ``query_count`` (dynamic valid-prefix length of ``query``) and
    ``prune_radius`` let the kernel skip work; neighbours beyond the radius
    and queries past the count may then come back as _INF.  Consumers must
    gate at d2 < prune_radius^2, which makes both paths agree.
    """
    if _mode() != "plain":
        return _fused(query, cand, cand_mask, k, query_count, prune_radius)

    m = query.shape[0]
    n = cand.shape[0]
    if n <= block:
        d2 = pairwise_sqdist(query, cand)
        d2 = jnp.where(cand_mask[None, :], d2, _INF)
        return _min_k(d2, k)

    if n % block != 0:
        pad = block - n % block
        cand = jnp.concatenate([cand, jnp.zeros((pad, 3), cand.dtype)])
        cand_mask = jnp.concatenate([cand_mask, jnp.zeros((pad,), bool)])
        n += pad
    n_blocks = n // block
    cand_b = cand.reshape(n_blocks, block, 3)
    mask_b = cand_mask.reshape(n_blocks, block)

    def step(carry, inp):
        best_d, best_i = carry
        cb, mb, b = inp
        d2 = pairwise_sqdist(query, cb)
        d2 = jnp.where(mb[None, :], d2, _INF)
        bd, bi = _min_k(d2, k)
        cat_d = jnp.concatenate([best_d, bd], axis=1)
        cat_i = jnp.concatenate([best_i, b * block + bi], axis=1)
        neg, pos = jax.lax.top_k(-cat_d, k)     # 2k wide: cheap either way
        return (-neg, jnp.take_along_axis(cat_i, pos, axis=1)), None

    init = (jnp.full((m, k), _INF), jnp.zeros((m, k), jnp.int32))
    (best_d, best_i), _ = jax.lax.scan(
        step, init, (cand_b, mask_b, jnp.arange(n_blocks, dtype=jnp.int32))
    )
    return best_d, best_i


@_knn_scope
def nn1(
    query: jax.Array, cand: jax.Array, cand_mask: jax.Array, block: int = 32768,
) -> tuple[jax.Array, jax.Array]:
    """Single nearest neighbour: (sqdist (M,), idx (M,)).

    k=1 needs no top-k machinery: the plain path is a fused min/argmin
    reduction over the (blocked) distance matrix.
    """
    if _mode() != "plain":
        d2, idx = _fused(query, cand, cand_mask, 1, None, None)
        return d2[:, 0], idx[:, 0]
    m, n = query.shape[0], cand.shape[0]
    if n <= block:
        d2 = pairwise_sqdist(query, cand)
        d2 = jnp.where(cand_mask[None, :], d2, _INF)
        idx = jnp.argmin(d2, axis=-1).astype(jnp.int32)
        return jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0], idx

    if n % block != 0:
        pad = block - n % block
        cand = jnp.concatenate([cand, jnp.zeros((pad, 3), cand.dtype)])
        cand_mask = jnp.concatenate([cand_mask, jnp.zeros((pad,), bool)])
        n += pad
    cand_b = cand.reshape(n // block, block, 3)
    mask_b = cand_mask.reshape(n // block, block)

    def step(carry, inp):
        best_d, best_i = carry
        cb, mb, b = inp
        d2 = jnp.where(mb[None, :], pairwise_sqdist(query, cb), _INF)
        i = jnp.argmin(d2, axis=-1).astype(jnp.int32)
        d = jnp.take_along_axis(d2, i[:, None], axis=1)[:, 0]
        better = d < best_d
        return (jnp.where(better, d, best_d),
                jnp.where(better, b * block + i, best_i)), None

    init = (jnp.full((m,), _INF), jnp.zeros((m,), jnp.int32))
    (d, i), _ = jax.lax.scan(
        step, init, (cand_b, mask_b, jnp.arange(n // block, dtype=jnp.int32))
    )
    return d, i


def compact_rows(
    pts: jax.Array,      # (C, cap, D) per-group point buffers (valid prefix per group)
    counts: jax.Array,   # (C,) valid prefix lengths
    out_cap: int,
) -> tuple[jax.Array, jax.Array]:
    """Concatenate per-group prefixes into one dense (out_cap, D) buffer.

    Pure scatter (no sort): destination row = exclusive-cumsum offset + rank.
    Used to strip the ~95% padding out of gathered submap windows before the
    distance matmuls.
    """
    C, cap, D = pts.shape
    offs = jnp.cumsum(counts) - counts                      # exclusive
    col = jnp.arange(cap, dtype=jnp.int32)[None, :]
    dest = offs[:, None] + col
    ok = (col < counts[:, None]) & (dest < out_cap)
    dest = jnp.where(ok, dest, out_cap)
    out = jnp.zeros((out_cap + 1, D), pts.dtype).at[dest.reshape(-1)].set(
        jnp.where(ok.reshape(-1)[:, None], pts.reshape(-1, D), 0.0),
        mode="drop", unique_indices=True,
    )[:out_cap]
    total = jnp.minimum(jnp.sum(counts), out_cap)
    return out, jnp.arange(out_cap) < total


def _part1by2(v: jax.Array) -> jax.Array:
    """Spread the low 10 bits of v so they occupy every third bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_keys(pts: jax.Array, cell: float, origin: jax.Array | float = 0.0) -> jax.Array:
    """(N, 3) -> (N,) int32 Morton (Z-order) keys at ``cell`` resolution.

    Coordinates are binned relative to ``origin`` with a +512-cell offset so
    ±512*cell around the origin maps into the 10-bit/axis key space (clipped
    beyond — distant outliers collapse onto the boundary cells, which only
    costs pruning efficiency, never correctness)."""
    g = jnp.clip(
        jnp.floor((pts[:, :3] - origin) / cell).astype(jnp.int32) + 512, 0, 1023
    )
    return _part1by2(g[:, 0]) | (_part1by2(g[:, 1]) << 1) | (_part1by2(g[:, 2]) << 2)


def morton_sort(
    pts: jax.Array, mask: jax.Array, cell: float, origin: jax.Array | float = 0.0
) -> tuple[jax.Array, jax.Array]:
    """Sort a prefix-compacted point buffer into Morton order.

    Consecutive rows become spatially adjacent, which is what makes the
    AABB tile pruning in ops/pallas_knn effective (a query block or
    candidate tile covers a compact region instead of a full ring sweep).  Invalid rows sort to the
    tail, so a prefix mask stays a prefix mask.  Row order is irrelevant to
    every consumer of the feature stacks and submap caches (fits, GN
    residuals, scatter inserts are order-free)."""
    key = jnp.where(mask, morton_keys(pts, cell, origin), jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(key)
    return jnp.take(pts, order, axis=0), jnp.take(mask, order)


def masked_argmin(
    d2: jax.Array, valid: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Argmin along last axis under a mask; returns (min, argmin)."""
    d2m = jnp.where(valid, d2, _INF)
    idx = jnp.argmin(d2m, axis=-1)
    return jnp.take_along_axis(d2m, idx[..., None], axis=-1)[..., 0], idx
