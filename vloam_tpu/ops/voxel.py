"""Fixed-shape voxel-grid downsampling (PCL VoxelGrid equivalent).

The reference leans on ``pcl::VoxelGrid`` in four places: per-ring less-flat
reduction (scan_registration.cpp:496-504), per-frame corner/surf stack
reduction (laser_mapping.cpp:491-500) and per-cube map re-filtering
(laser_mapping.cpp:793-808).  PCL's semantics: partition space into cubic
leaves, replace all points in a leaf with their centroid (all channels
averaged, including intensity).

Formulation: no hash maps, no dynamic sizes.  We quantise to integer
voxel coordinates, pack them into one int32 key (bounded grids — the inputs
are sensor-frame clouds or single 50 m cubes), sort once, and reduce
segments with ``segment_sum``.  Output is a fixed-capacity buffer + mask.
An optional secondary key keeps groups separate (used for "per-ring"
downsampling, which PCL gets by being called once per ring).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INT_MAX = jnp.iinfo(jnp.int32).max


def voxel_downsample(
    points: jax.Array,      # (N, D) — first 3 channels are xyz; the rest averaged along for the ride
    mask: jax.Array,        # (N,) bool
    leaf: float,
    cap: int,
    group_key: jax.Array | None = None,  # (N,) int32 — points in different groups never merge
    max_grid: int = 1024,   # per-axis voxel-grid bound; (max coord span)/leaf must fit
    presorted: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Returns (out_points (cap, D), out_mask (cap,)).

    Centroid semantics match pcl::VoxelGrid.  If the number of occupied
    voxels exceeds ``cap`` the surplus voxels (highest keys) are dropped.

    ``presorted=True`` skips the sort and merges consecutive same-voxel runs
    instead — for scan-ordered lidar points (azimuth sweeps) this is PCL
    semantics except that a voxel revisited later in the sweep keeps a second
    centroid (rare, and harmless for feature clouds: slightly denser output).
    """
    n = points.shape[0]
    xyz = points[..., :3]

    # Quantise relative to the masked minimum so the int grid is small.
    big = jnp.float32(1e30)
    p_min = jnp.min(jnp.where(mask[:, None], xyz, big), axis=0)
    ijk = jnp.floor((xyz - p_min) / leaf).astype(jnp.int32)
    ijk = jnp.clip(ijk, 0, max_grid - 1)
    key = (ijk[:, 0] + max_grid * ijk[:, 1] + max_grid * max_grid * ijk[:, 2]).astype(jnp.int32)
    key = jnp.where(mask, key, INT_MAX)

    if presorted:
        # run-length merge in given order; invalid rows form their own runs
        # but are masked out of the output by msk_s
        key_s = key
        grp_s = jnp.zeros_like(key) if group_key is None else group_key
        order = None
    elif group_key is None:
        # single stable pass
        order = jnp.argsort(key, stable=True)
        key_s = jnp.take(key, order)
        grp_s = jnp.zeros_like(key_s)
    else:
        group_key = jnp.where(mask, group_key, INT_MAX)
        # Sort by (group, voxel) — two stable passes.
        order = jnp.argsort(key, stable=True)
        order = jnp.take(order, jnp.argsort(jnp.take(group_key, order), stable=True))
        key_s = jnp.take(key, order)
        grp_s = jnp.take(group_key, order)
    if order is None:
        pts_s, msk_s = points, mask
    else:
        pts_s = jnp.take(points, order, axis=0)
        msk_s = jnp.take(mask, order)

    new_seg = jnp.concatenate(
        [jnp.ones((1,), bool), (key_s[1:] != key_s[:-1]) | (grp_s[1:] != grp_s[:-1])]
    )
    new_seg = new_seg & msk_s
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1          # (N,) — -1..S-1
    # Invalid rows KEEP the running id (their contribution is zeroed below),
    # clamped at 0 for any leading invalid prefix.  They must NOT be dumped
    # into a scrap segment: that made seg_id non-monotone wherever invalid
    # rows interleave valid runs (ring-grid padding), and segment_sum below
    # declares indices_are_sorted=True — a backend that exploits the hint
    # then silently misreduces, zeroing most less-flat centroids (CPU
    # ignores the hint, which hid such a bug from the unit suite once).
    seg_id = jnp.maximum(seg_id, 0)

    # seg_id is monotone non-decreasing by construction, so the
    # sorted-indices hint is true.  Counts ride as an extra ones-column in
    # the SAME scatter: one (N, D+1) pass instead of a (N, D) + (N,) pair.
    aug = jnp.concatenate([pts_s, jnp.ones_like(pts_s[:, :1])], axis=1)
    sums5 = jax.ops.segment_sum(
        jnp.where(msk_s[:, None], aug, 0.0), seg_id, num_segments=n, indices_are_sorted=True
    )
    sums, cnts = sums5[:, :-1], sums5[:, -1]
    total = jnp.sum(new_seg.astype(jnp.int32))

    means = sums / jnp.maximum(cnts, 1.0)[:, None]
    if cap > n:
        means = jnp.pad(means, ((0, cap - n), (0, 0)))
    out = means[:cap]
    out_mask = jnp.arange(cap) < jnp.minimum(total, cap)
    return jnp.where(out_mask[:, None], out, 0.0), out_mask
