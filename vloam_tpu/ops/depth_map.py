"""Lidar-to-camera depth association — reference: point_cloud_util.cpp.

Pipeline: project the velodyne cloud through cam_T_velo, R_rect, P_rect
(:183-219), average hits into a 5 px bucket grid (:256-324), and answer
per-keypoint depth queries with an inverse-distance-weighted 3-NN over the
5x5 bucket neighbourhood, requiring >= 10 occupied neighbours (:381-487).

Formulation: projection is one (N, 4) x (4, 3) matmul; bucketing is a
segment mean (exact mean — the reference's incremental form at :292-299
divides by the pre-increment count, i.e. forgets a bucket's first hit once
a second arrives); queries are vmapped gathers over a static 5x5
neighbourhood.

Measured parity vs the sequential oracle (tests/test_vo_oracle_parity.py):
query semantics are exact (<= 1e-5 m on identical buckets, 100% valid/
invalid decision agreement); the full-path depth gap vs the reference's
forgetful bucket mean is ~0.07 m mean / 0.34 m p95, concentrated at depth
discontinuities, and flips zero 3D-2D/2D-2D branch decisions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vloam_tpu.config import VisualConfig


class DepthBuckets(NamedTuple):
    u: jax.Array       # (BW, BH) mean pixel x per bucket
    v: jax.Array       # (BW, BH) mean pixel y
    z: jax.Array       # (BW, BH) mean depth
    count: jax.Array   # (BW, BH) hits


def bucket_shape(cfg: VisualConfig) -> tuple[int, int]:
    g = cfg.downsample_grid
    return (-(-cfg.img_width // g), -(-cfg.img_height // g))


def project_cloud(
    points: jax.Array,        # (N, 3) velodyne-frame
    mask: jax.Array,          # (N,)
    proj: jax.Array,          # (3, 4) = P_rect0 @ rect0_T_cam @ cam_T_velo
    cfg: VisualConfig,
) -> tuple[jax.Array, jax.Array]:
    """Velodyne cloud -> image-plane (u, v, depth) with validity mask."""
    ph = jnp.concatenate([points, jnp.ones_like(points[:, :1])], axis=1)
    uvz = ph @ proj.T                                       # (N, 3)
    z = uvz[:, 2]
    ok = mask & (z > cfg.min_projection_depth)
    uv = uvz[:, :2] / jnp.maximum(z[:, None], 1e-6)
    return jnp.concatenate([uv, z[:, None]], axis=1), ok


def build_buckets(
    uvz: jax.Array, mask: jax.Array, cfg: VisualConfig
) -> DepthBuckets:
    """Average projected points into the (W/g, H/g) bucket grid."""
    bw, bh = bucket_shape(cfg)
    g = cfg.downsample_grid
    ix = (uvz[:, 0] / g).astype(jnp.int32)
    iy = (uvz[:, 1] / g).astype(jnp.int32)
    ok = mask & (ix >= 0) & (ix < bw) & (iy >= 0) & (iy < bh) & (uvz[:, 0] >= 0) & (uvz[:, 1] >= 0)
    flat = jnp.where(ok, ix * bh + iy, bw * bh)
    nb = bw * bh
    sums = jnp.zeros((nb + 1, 3), jnp.float32).at[flat].add(jnp.where(ok[:, None], uvz, 0.0))[:nb]
    cnt = jnp.zeros((nb + 1,), jnp.float32).at[flat].add(ok.astype(jnp.float32))[:nb]
    means = sums / jnp.maximum(cnt[:, None], 1.0)
    return DepthBuckets(
        u=means[:, 0].reshape(bw, bh),
        v=means[:, 1].reshape(bw, bh),
        z=means[:, 2].reshape(bw, bh),
        count=cnt.reshape(bw, bh),
    )


def query_depth(
    buckets: DepthBuckets, pts: jax.Array, cfg: VisualConfig
) -> jax.Array:
    """Per-keypoint depth (or -1) — semantics of queryDepth
    (point_cloud_util.cpp:381-487): 5x5 bucket neighbourhood, >= 10 occupied
    buckets required, inverse-distance-weighted 3-NN depth."""
    bw, bh = buckets.u.shape
    g = cfg.downsample_grid
    rr = cfg.query_radius
    side = 2 * rr + 1
    dx = jnp.arange(-rr, rr + 1)
    oy, ox = jnp.meshgrid(dx, dx, indexing="ij")
    offs = jnp.stack([ox.reshape(-1), oy.reshape(-1)], axis=-1)   # (25, 2) (dx, dy)

    # One plane-interleaved gather instead of four: fetching (u, v, z,
    # count) 4-vectors per neighbour quarters the number of gathered rows.
    planes = jnp.stack([buckets.u, buckets.v, buckets.z, buckets.count], axis=-1)

    def one(pt):
        ix = (pt[0] / g).astype(jnp.int32)
        iy = (pt[1] / g).astype(jnp.int32)
        nx = ix + offs[:, 0]
        ny = iy + offs[:, 1]
        inside = (nx >= 0) & (nx < bw) & (ny >= 0) & (ny < bh)
        nxc = jnp.clip(nx, 0, bw - 1)
        nyc = jnp.clip(ny, 0, bh - 1)
        vals = planes[nxc, nyc]                    # (25, 4)
        bu, bv, bz, cnt = vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3]
        occ = inside & (cnt > 0)
        dist = jnp.sqrt((pt[0] - bu) ** 2 + (pt[1] - bv) ** 2)
        dist = jnp.where(occ, dist, jnp.float32(3.4e38))
        neg, idx = jax.lax.top_k(-dist, cfg.depth_knn)
        d3 = -neg
        z3 = jnp.take(bz, idx)
        # weighted 3-NN: z = sum_i z_i * prod_{j != i} d_j / (eps + sum_i prod_{j != i} d_j)
        d0, d1, d2 = d3[0], d3[1], d3[2]
        num = z3[0] * d1 * d2 + z3[1] * d0 * d2 + z3[2] * d0 * d1
        den = 1e-4 + d1 * d2 + d0 * d2 + d0 * d1
        z = num / den
        enough = jnp.sum(occ) >= cfg.min_depth_neighbors
        if cfg.depth_spread_gate > 0:
            # drop queries straddling a depth discontinuity
            enough = enough & (jnp.max(z3) - jnp.min(z3) <= cfg.depth_spread_gate)
        return jnp.where(enough, z, -1.0)

    return jax.vmap(one)(pts)
