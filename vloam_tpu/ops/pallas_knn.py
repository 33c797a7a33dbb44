"""Fused brute-force k-NN kernel for the GPU (Pallas, Triton route).

The plain formulation in ops/knn.py writes the (M, N) squared-distance
matrix to device memory and reads it back for a top-k: for the mapping surf
association (8192 stacked queries against a 49152-row submap) that is
gigabytes of traffic per frame for ~9 flops per pair.  This kernel keeps
every distance tile in registers and reduces it on the spot.

Layout: the grid runs over (query block, candidate split).  Each program
loads its BM queries once, then walks its share of the candidate tiles that
survive pruning (tile ids computed in XLA beforehand, ``_tile_lists``) in a
loop inside the block, so nothing is carried between programs.  The splits
of one query block are merged by a (M, SPLITS * KP) top-k in XLA.

Per tile:
  * d2 in difference form, (qx-cx)^2 + (qy-cy)^2 + (qz-cz)^2, on the CUDA
    cores in f32.  No matmul: TF32 or bf16 cross terms corrupt neighbour
    rankings at metric coordinate scales (see ops/knn.pairwise_sqdist).
  * entries not below the row's current k-th best are dropped, then up to k
    rounds of masked row-min move the tile's winners into the carried best
    list (replace-the-worst).  The rounds stop as soon as no row of the
    block has an entry left below its k-th best, so once the best lists are
    full most tiles cost one compare pass.

Contract: EXACT k-NN over the valid candidates (no index-packing
approximation): the k smallest difference-form d2, ascending, with their
indices.  Rows with fewer than k valid candidates (or whose neighbours all
lie beyond ``prune_radius``) report d2 = 3.4e38, the plain path's sentinel.
With ``prune_radius`` r, a (query block, candidate tile) pair is skipped
when their axis-aligned boxes are farther apart than r, so neighbours
beyond r may be reported as 3.4e38; every neighbour within r is still
found.  Consumers that gate at d2 < r^2 see the unpruned result.  Pruning
pays when queries and candidates are Morton-sorted (ops/knn.morton_sort).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BM = 32          # queries per program
BN = 128         # candidates per tile
SPLITS = 4       # candidate splits per query block (grid axis 1)
K_MAX = 16       # largest k the carried best list supports
_BIG = 3.4e38    # empty-slot distance (matches ops/knn._INF)


def _kp(k: int) -> int:
    """Best-list width: the next power of two >= k (at least 2)."""
    return max(2, 1 << (k - 1).bit_length())


def _kernel(q_ref, c_ref, tiles_ref, cnt_ref, d_ref, i_ref, *, k: int):
    i, s = pl.program_id(0), pl.program_id(1)
    kp = d_ref.shape[-1]
    qx, qy, qz = q_ref[0, :], q_ref[1, :], q_ref[2, :]            # (BM,)
    lane = jax.lax.broadcasted_iota(jnp.int32, (BM, kp), 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (BM, BN), 1)
    # Slots >= k hold -1: never the row maximum, so never replaced, and the
    # row maximum over the list is the k-th best distance.
    best_d = jnp.where(lane < k, jnp.float32(_BIG), jnp.float32(-1.0))
    best_i = jnp.zeros((BM, kp), jnp.int32)
    n_live = cnt_ref[i]
    n_mine = jnp.maximum(n_live - s + SPLITS - 1, 0) // SPLITS

    def tile(u, carry):
        best_d, best_i = carry
        j = tiles_ref[i, s + u * SPLITS]
        sl = pl.ds(j * BN, BN)
        cx, cy, cz = c_ref[0, sl], c_ref[1, sl], c_ref[2, sl]     # (BN,)
        dx = qx[:, None] - cx[None, :]
        dy = qy[:, None] - cy[None, :]
        dz = qz[:, None] - cz[None, :]
        d2 = dx * dx + dy * dy + dz * dz                           # (BM, BN)
        worst = jnp.max(best_d, axis=1)
        d2 = jnp.where(d2 < worst[:, None], d2, jnp.inf)
        mn = jnp.min(d2, axis=1)

        def more(c):
            r, _, mn, bd, _ = c
            return (r < k) & (jnp.min(mn - jnp.max(bd, axis=1)) < 0.0)

        def take(c):
            r, d2, mn, bd, bi = c
            at = jnp.min(jnp.where(d2 == mn[:, None], col, BN), axis=1)   # (BM,)
            wmax = jnp.max(bd, axis=1)
            pos = jnp.min(jnp.where(bd == wmax[:, None], lane, kp), axis=1)
            hit = (lane == pos[:, None]) & (mn < wmax)[:, None]
            bd = jnp.where(hit, mn[:, None], bd)
            bi = jnp.where(hit, (j * BN + at)[:, None], bi)
            d2 = jnp.where(col == at[:, None], jnp.inf, d2)
            return r + 1, d2, jnp.min(d2, axis=1), bd, bi

        _, _, _, best_d, best_i = jax.lax.while_loop(
            more, take, (jnp.int32(0), d2, mn, best_d, best_i))
        return best_d, best_i

    best_d, best_i = jax.lax.fori_loop(0, n_mine, tile, (best_d, best_i))
    d_ref[...] = best_d
    i_ref[...] = best_i


@functools.partial(jax.jit, static_argnames=("k", "interpret"))
def _knn_call(qt, ct, tiles, cnt, k: int, interpret: bool = False):
    """qt: (4, M_pad) query rows x/y/z/0; ct: (4, N_pad) candidate rows with
    +inf coordinates for masked entries; tiles: (M_pad // BM, n_tiles) live
    tile ids first; cnt: (M_pad // BM,) live tile count per query block.
    Returns per-split best lists (SPLITS, M_pad, KP) of d2 and indices."""
    m_pad = qt.shape[1]
    kp = _kp(k)
    nb = m_pad // BM
    return pl.pallas_call(
        functools.partial(_kernel, k=k),
        grid=(nb, SPLITS),
        in_specs=[
            pl.BlockSpec((4, BM), lambda i, s: (0, i)),
            pl.BlockSpec(ct.shape, lambda i, s: (0, 0)),
            pl.BlockSpec(tiles.shape, lambda i, s: (0, 0)),
            pl.BlockSpec(cnt.shape, lambda i, s: (0,)),
        ],
        out_specs=[
            pl.BlockSpec((None, BM, kp), lambda i, s: (s, i, 0)),
            pl.BlockSpec((None, BM, kp), lambda i, s: (s, i, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((SPLITS, m_pad, kp), jnp.float32),
            jax.ShapeDtypeStruct((SPLITS, m_pad, kp), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="knn_fused",
    )(qt, ct, tiles, cnt)


def _box_dist2(qlo, qhi, clo, chi):
    """Squared distance between axis-aligned boxes (blocks x tiles)."""
    gap = jnp.maximum(
        0.0, jnp.maximum(qlo[:, None] - chi[None], clo[None] - qhi[:, None])
    )
    return jnp.sum(gap * gap, axis=-1)


def _block_aabb(x, valid, tile):
    """(n, 3) + (n,) bool -> per-block (lo, hi); empty blocks get +inf/-inf,
    so their box distance is +inf and they never survive pruning."""
    xb = x.reshape(-1, tile, 3)
    vb = valid.reshape(-1, tile, 1)
    lo = jnp.min(jnp.where(vb, xb, jnp.inf), axis=1)
    hi = jnp.max(jnp.where(vb, xb, -jnp.inf), axis=1)
    return lo, hi


def _tile_lists(q, q_valid, c, c_valid, prune_radius):
    """Per query block: the ids of the candidate tiles it must visit, live
    ones first, and how many are live.  A tile is live when both it and the
    block hold a valid point and (with ``prune_radius``) their boxes are
    within the radius."""
    qlo, qhi = _block_aabb(q, q_valid, BM)
    clo, chi = _block_aabb(c, c_valid, BN)
    live = jnp.any(q_valid.reshape(-1, BM), axis=1)[:, None] & \
        jnp.any(c_valid.reshape(-1, BN), axis=1)[None, :]
    if prune_radius is not None:
        live = live & (_box_dist2(qlo, qhi, clo, chi) <= jnp.float32(prune_radius) ** 2)
    order = jnp.argsort(~live, axis=1, stable=True).astype(jnp.int32)
    return order, jnp.sum(live, axis=1, dtype=jnp.int32)


def _pad_rows(x: jax.Array, n: int, value) -> jax.Array:
    if x.shape[0] == n:
        return x
    return jnp.concatenate(
        [x, jnp.full((n - x.shape[0],) + x.shape[1:], value, x.dtype)])


def knn_fused(
    query: jax.Array,       # (M, 3)
    cand: jax.Array,        # (N, 3)
    cand_mask: jax.Array,   # (N,) bool
    k: int,
    query_count: jax.Array | None = None,   # () valid-prefix length of query
    prune_radius: float | None = None,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Exact k nearest valid candidates per query: (d2 (M, k), idx (M, k)),
    d2 ascending.  See the module docstring for the contract.

    ``query_count``: queries at or past it are skipped (d2 = 3.4e38).
    ``interpret``: run the kernel in the Pallas interpreter (CPU tests).
    Raises ValueError for k outside [1, K_MAX]."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"knn_fused supports 1 <= k <= {K_MAX}, got k={k}")
    m, n = query.shape[0], cand.shape[0]
    m_pad = -(-m // BM) * BM
    n_pad = -(-n // BN) * BN
    q_valid = jnp.arange(m_pad) < (m if query_count is None else query_count)
    q = _pad_rows(query.astype(jnp.float32), m_pad, 0.0)
    c_valid = _pad_rows(cand_mask, n_pad, False)
    c = _pad_rows(cand.astype(jnp.float32), n_pad, 0.0)
    tiles, cnt = _tile_lists(q, q_valid, c, c_valid, prune_radius)

    qt = jnp.zeros((4, m_pad), jnp.float32).at[:3].set(q.T)
    ct = jnp.zeros((4, n_pad), jnp.float32).at[:3].set(
        jnp.where(c_valid[:, None], c, jnp.inf).T)
    d, i = _knn_call(qt, ct, tiles, cnt, k, interpret)       # (SPLITS, M_pad, KP)
    kp = d.shape[-1]
    lane = jnp.arange(SPLITS * kp) % kp
    d = jnp.moveaxis(d, 0, 1).reshape(m_pad, SPLITS * kp)
    i = jnp.moveaxis(i, 0, 1).reshape(m_pad, SPLITS * kp)
    d = jnp.where(lane[None, :] < k, d, jnp.float32(_BIG))    # drop the -1 pad slots
    neg, pos = jax.lax.top_k(-d[:m], k)
    idx = jnp.take_along_axis(i[:m], pos, axis=1)
    d2 = jnp.where(q_valid[:m, None], -neg, jnp.float32(_BIG))
    return d2, jnp.minimum(idx, n - 1).astype(jnp.int32)
