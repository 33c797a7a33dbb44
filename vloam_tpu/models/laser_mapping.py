"""Scan-to-map lidar odometry (MO) — reference: laser_mapping.cpp:212-814.

The reference keeps a 21x21x11 grid of unbounded point-cloud cubes and
physically shuffles 4851 shared_ptrs through six while-loops whenever the
robot nears a grid border (laser_mapping.cpp:252-444).  The re-design here
makes recentering free: cube slots are addressed **block-cyclically**
(slot = world_cube_coord mod grid_dims) and each slot remembers which world
cube it currently stores.  Moving on simply lets new world cubes lazily
evict stale slots — no data movement, no pointer shuffles, and the cube
arrays are flat fixed-shape tensors that shard across a device mesh along
the slot axis (see vloam_tpu.parallel).

Per frame: voxel-downsample the input features (laser_mapping.cpp:491-500),
gather the 5x5x3-cube submap by masked slot lookup (:448-485), associate
with brute-force 5-NN (ops/knn.py) + closed-form 3x3 eigen/solve line & plane fits
(:545-699), run batched GN (2 outer x 4 inner, Huber 0.1, :526,712), update
the wmap_wodom correction (:147-151), then scatter the registered features
into their cubes and re-voxel-filter the submap window (:741-808).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vloam_tpu import geometry as geo
from vloam_tpu.config import VloamConfig
from vloam_tpu.ops import lidar_factors
from vloam_tpu.ops.knn import knn, morton_sort
from vloam_tpu.ops.lidar_factors import solve_pose_gn_lidar
from vloam_tpu.ops.linalg3 import eigh3x3_sym, solve3x3_sym
from vloam_tpu.ops.voxel import voxel_downsample


class MapState(NamedTuple):
    # Corner and surf cubes live in ONE buffer: rows [0, corner_cap) of each
    # slot are its corner points, rows [corner_cap, corner_cap + surf_cap)
    # its surf points, so the per-frame insert does ONE sort + ONE scatter +
    # ONE count pass for both feature types instead of two of each.
    cube_pts: jax.Array      # (n_cubes, corner_cap + surf_cap, 4)
    corner_cnt: jax.Array    # (n_cubes,) int32
    surf_cnt: jax.Array      # (n_cubes,)
    cube_coord: jax.Array    # (n_cubes, 3) int32 — world cube coord stored in each slot
    pose_map: jax.Array      # (7,) world_T_curr after mapping
    wmap_wodom: jax.Array    # (7,) map-world_T_odom-world correction
    initialized: jax.Array   # () bool
    # Compacted-submap cache (single-device insert_dedup path): the gathered
    # 75-cube window only changes by this frame's inserts until the robot
    # crosses a cube boundary, so it is rebuilt from the cube arrays only
    # when sub_center changes and incrementally appended otherwise.
    sub_c: jax.Array         # (submap_corner_cap, 4)
    sub_c_n: jax.Array       # () int32 valid prefix
    sub_s: jax.Array         # (submap_surf_cap, 4)
    sub_s_n: jax.Array       # () int32
    sub_center: jax.Array    # (3,) int32 cube coord the cache was built around


def n_cubes(cfg: VloamConfig) -> int:
    mc = cfg.mapping
    return mc.grid_w * mc.grid_h * mc.grid_d


def init_map_state(cfg: VloamConfig, n_shards: int = 1, sharded: bool | None = None) -> MapState:
    """``n_shards > 1`` pads the slot axis to a multiple of the shard count so
    the cube arrays partition evenly across a mesh axis (pad slots hold the
    never-matching sentinel coord and are never addressed).  The submap-cache
    arrays also scale with the shard count — each shard caches its own
    compacted window slice (parallel/mapping_shard.py), so sub_c/sub_s grow
    to (n_shards * cap, 4) and the scalar valid-prefix counts become
    (n_shards,) vectors, all partitioned on the same mesh axis.  Pass
    ``sharded=True`` to force the vector cache layout at n_shards=1 (a
    1-device mesh running the sharded twin, e.g. the scaling bench anchor)."""
    mc = cfg.mapping
    nc = n_cubes(cfg)
    nc = -(-nc // n_shards) * n_shards
    if sharded is None:
        sharded = n_shards > 1
    if sharded:
        sub_c = jnp.zeros((n_shards * mc.submap_corner_cap, 4), jnp.float32)
        sub_c_n = jnp.zeros((n_shards,), jnp.int32)
        sub_s = jnp.zeros((n_shards * mc.submap_surf_cap, 4), jnp.float32)
        sub_s_n = jnp.zeros((n_shards,), jnp.int32)
    else:
        sub_c = jnp.zeros((mc.submap_corner_cap, 4), jnp.float32)
        sub_c_n = jnp.array(0, jnp.int32)
        sub_s = jnp.zeros((mc.submap_surf_cap, 4), jnp.float32)
        sub_s_n = jnp.array(0, jnp.int32)
    return MapState(
        cube_pts=jnp.zeros((nc, mc.corner_cube_cap + mc.surf_cube_cap, 4), jnp.float32),
        corner_cnt=jnp.zeros((nc,), jnp.int32),
        surf_cnt=jnp.zeros((nc,), jnp.int32),
        cube_coord=jnp.full((nc, 3), jnp.iinfo(jnp.int32).min, jnp.int32),
        pose_map=geo.pose_identity(),
        wmap_wodom=geo.pose_identity(),
        initialized=jnp.array(False),
        sub_c=sub_c, sub_c_n=sub_c_n, sub_s=sub_s, sub_s_n=sub_s_n,
        sub_center=jnp.full((3,), jnp.iinfo(jnp.int32).min, jnp.int32),
    )


def cube_coord_of(points: jax.Array, cube_size: float) -> jax.Array:
    """World point -> integer cube coordinate (laser_mapping.cpp:747-756
    including the negative-rounding correction — this is plain floor)."""
    return jnp.floor((points + cube_size / 2.0) / cube_size).astype(jnp.int32)


def coord_to_slot(coord: jax.Array, cfg: VloamConfig) -> jax.Array:
    """Block-cyclic slot index for a world cube coordinate."""
    mc = cfg.mapping
    dims = jnp.array([mc.grid_w, mc.grid_h, mc.grid_d], jnp.int32)
    m = jnp.remainder(coord, dims)  # python-style mod: result in [0, dims)
    return m[..., 0] + mc.grid_w * m[..., 1] + mc.grid_w * mc.grid_h * m[..., 2]


def _submap_coords(center_coord: jax.Array, cfg: VloamConfig) -> jax.Array:
    """(75, 3) world cube coords of the 5x5x3 neighbourhood."""
    mc = cfg.mapping
    dx = jnp.arange(-mc.submap_rx, mc.submap_rx + 1)
    dy = jnp.arange(-mc.submap_rx, mc.submap_rx + 1)
    dz = jnp.arange(-mc.submap_rz, mc.submap_rz + 1)
    off = jnp.stack(jnp.meshgrid(dx, dy, dz, indexing="ij"), axis=-1).reshape(-1, 3)
    return center_coord[None, :] + off.astype(jnp.int32)


def _gather_submap(state: MapState, coords: jax.Array, cfg: VloamConfig):
    """Gather the neighbourhood cubes' points, compacted into dense buffers.

    Cube buffers are mostly padding (capacity >> typical occupancy after
    re-voxelisation); compacting before the NN matmuls shrinks the candidate
    axis ~5-20x (laser_mapping.cpp:479-485 concatenates the same way)."""
    from vloam_tpu.ops.knn import compact_rows

    mc = cfg.mapping
    slots = coord_to_slot(coords, cfg)                      # (75,)
    fresh = jnp.all(jnp.take(state.cube_coord, slots, axis=0) == coords, axis=-1)  # (75,)

    sub = jnp.take(state.cube_pts, slots, axis=0)           # (75, capT, 4)
    c_counts = jnp.where(fresh, jnp.take(state.corner_cnt, slots), 0)
    s_counts = jnp.where(fresh, jnp.take(state.surf_cnt, slots), 0)
    c_pts, c_mask = compact_rows(sub[:, :mc.corner_cube_cap], c_counts, mc.submap_corner_cap)
    s_pts, s_mask = compact_rows(sub[:, mc.corner_cube_cap:], s_counts, mc.submap_surf_cap)
    return (c_pts, c_mask), (s_pts, s_mask), slots, fresh


def fit_corner_lines(stack, stack_mask, nbr, d2, cfg):
    """PCA line fit from gathered 5-NN neighbours (laser_mapping.cpp:557-604).
    nbr: (M, 5, 3) neighbour xyz; d2: (M, 5) their squared distances.

    Covariance components and the eigensolve run in structure-of-arrays form
    ((M,) vectors per component) rather than as (M, 3, 3) matrices."""
    mc = cfg.mapping
    x, y, z = nbr[..., 0], nbr[..., 1], nbr[..., 2]          # (M, 5) each
    cx, cy, cz = jnp.mean(x, axis=1), jnp.mean(y, axis=1), jnp.mean(z, axis=1)
    zx, zy, zz = x - cx[:, None], y - cy[:, None], z - cz[:, None]
    a = jnp.sum(zx * zx, axis=1)
    b = jnp.sum(zy * zy, axis=1)
    c = jnp.sum(zz * zz, axis=1)
    dd = jnp.sum(zx * zy, axis=1)
    ee = jnp.sum(zy * zz, axis=1)
    ff = jnp.sum(zx * zz, axis=1)
    (_, e2, e3), (_, _, v3) = eigh3x3_sym(a, b, c, dd, ee, ff)
    is_line = e3 > mc.eigen_ratio * e2
    valid = stack_mask & (d2[:, -1] < mc.neighbor_dist_sq) & is_line
    span = mc.line_span
    pa = jnp.stack([cx + span * v3[0], cy + span * v3[1], cz + span * v3[2]], axis=-1)
    pb = jnp.stack([cx - span * v3[0], cy - span * v3[1], cz - span * v3[2]], axis=-1)
    return stack[:, :3], pa, pb, valid


def fit_surf_planes(stack, stack_mask, nbr, d2, cfg):
    """Least-squares plane fit A n = -1 from 5-NN (laser_mapping.cpp:637-681).

    Component form throughout (see fit_corner_lines): normal-equation
    components and the Cramer solve are (M,) vector ops."""
    mc = cfg.mapping
    x, y, z = nbr[..., 0], nbr[..., 1], nbr[..., 2]          # (M, 5) each
    a = jnp.sum(x * x, axis=1)
    b = jnp.sum(y * y, axis=1)
    c = jnp.sum(z * z, axis=1)
    dd = jnp.sum(x * y, axis=1)
    ee = jnp.sum(y * z, axis=1)
    ff = jnp.sum(x * z, axis=1)
    bx, by, bz = -jnp.sum(x, axis=1), -jnp.sum(y, axis=1), -jnp.sum(z, axis=1)
    nx, ny, nz = solve3x3_sym(a, b, c, dd, ee, ff, bx, by, bz)
    inv_len = 1.0 / jnp.maximum(jnp.sqrt(nx * nx + ny * ny + nz * nz), 1e-10)
    d = inv_len                                              # negative_OA_dot_norm
    nx, ny, nz = nx * inv_len, ny * inv_len, nz * inv_len
    fit = jnp.abs(x * nx[:, None] + y * ny[:, None] + z * nz[:, None] + d[:, None])
    plane_ok = jnp.all(fit <= mc.plane_fit_tol, axis=-1)
    valid = stack_mask & (d2[:, -1] < mc.neighbor_dist_sq) & plane_ok
    n_unit = jnp.stack([nx, ny, nz], axis=-1)
    return stack[:, :3], n_unit, d, valid


def _corner_correspondences(pose, stack, stack_mask, cand, cand_mask, cfg):
    """5-NN + PCA line fit -> virtual edge endpoints (laser_mapping.cpp:545-604).

    Also returns the 1-NN squared distance (d2[:, 0]) so the insert-dedup
    gate can reuse it instead of paying another full distance pass."""
    q = geo.pose_apply(pose, stack[:, :3])
    d2, idx = knn(q, cand[:, :3], cand_mask, cfg.mapping.n_neighbors)
    nbr = jnp.take(cand[:, :3], idx, axis=0)                # (M, 5, 3)
    return fit_corner_lines(stack, stack_mask, nbr, d2, cfg) + (d2[:, 0],)


def _surf_correspondences(pose, stack, stack_mask, cand, cand_mask, cfg):
    """5-NN + least-squares plane fit A n = -1 (laser_mapping.cpp:626-699)."""
    q = geo.pose_apply(pose, stack[:, :3])
    d2, idx = knn(q, cand[:, :3], cand_mask, cfg.mapping.n_neighbors)
    nbr = jnp.take(cand[:, :3], idx, axis=0)                # (M, 5, 3)
    return fit_surf_planes(stack, stack_mask, nbr, d2, cfg) + (d2[:, 0],)


def _scatter_insert_pair(
    corner_w, c_mask, surf_w, s_mask,
    cube_pts, corner_cnt, surf_cnt, cube_coord, cfg, slot_offset=0,
):
    """Append BOTH feature types' world-frame points into their cube slots
    (block-cyclic) with one sort, one point scatter, and one count pass.

    Stale slots (holding an evicted world cube) are reset before appending.
    ``slot_offset`` shifts global slot ids into this shard's local range
    (points outside [0, nc) are dropped — they belong to another shard).
    Returns (cube_pts, corner_cnt, surf_cnt, cube_coord, accepted_corner,
    accepted_surf).
    """
    mc = cfg.mapping
    nc = cube_pts.shape[0]
    capc, capT = mc.corner_cube_cap, mc.corner_cube_cap + mc.surf_cube_cap
    n_c, n_s = corner_w.shape[0], surf_w.shape[0]
    n = n_c + n_s

    pts = jnp.concatenate([corner_w, surf_w])
    mask = jnp.concatenate([c_mask, s_mask])
    is_surf = jnp.arange(n, dtype=jnp.int32) >= n_c
    coord = cube_coord_of(pts[:, :3], mc.cube_size)
    slot = coord_to_slot(coord, cfg) - slot_offset
    mask = mask & (slot >= 0) & (slot < nc)
    slot = jnp.where(mask, slot, nc)                         # invalid -> scrap slot

    # Reset stale slots touched by this insertion (single pass, both types).
    stored = jnp.take(cube_coord, jnp.minimum(slot, nc - 1), axis=0)
    stale = jnp.any(stored != coord, axis=-1) & mask
    touched = jnp.zeros((nc + 1,), bool).at[slot].set(mask, mode="drop")[:nc]
    stale_slot = jnp.zeros((nc + 1,), bool).at[slot].set(stale, mode="drop")[:nc]
    corner_cnt = jnp.where(stale_slot, 0, corner_cnt)
    surf_cnt = jnp.where(stale_slot, 0, surf_cnt)
    new_coord = jnp.full((nc + 1, 3), jnp.iinfo(jnp.int32).min, jnp.int32).at[slot].set(
        coord, mode="drop"
    )[:nc]
    cube_coord = jnp.where(touched[:, None], new_coord, cube_coord)

    # Rank within (slot, type) segments via ONE stable sort of the combined
    # key; rejects (key = 2 nc) sort to the tail.
    key = jnp.where(mask, slot * 2 + is_surf, 2 * nc)
    order = jnp.argsort(key, stable=True)
    key_s = jnp.take(key, order)
    pts_s = jnp.take(pts, order, axis=0)
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool), key_s[1:] != key_s[:-1]])
    seg_start = jax.lax.cummax(jnp.where(is_start, idx, 0))
    rank = idx - seg_start

    slot_s = jnp.minimum(key_s >> 1, nc - 1)
    surf_s = key_s & 1
    base = jnp.where(surf_s == 1, capc + jnp.take(surf_cnt, slot_s), jnp.take(corner_cnt, slot_s))
    dest_row = base + rank
    ok = (key_s < 2 * nc) & (dest_row < jnp.where(surf_s == 1, capT, capc))
    # Rejected points scatter to distinct out-of-bounds rows (mode="drop"
    # discards them); scattering straight into the state buffer — instead of
    # a scrap-row concatenate — avoids two full copies of the ~half-GB cube
    # array and lets XLA update a donated buffer in place.
    flat = jnp.where(ok, slot_s * capT + dest_row, nc * capT + idx)
    pts_flat = cube_pts.reshape(-1, 4).at[flat].set(
        pts_s, mode="drop", unique_indices=True
    )
    added = jax.ops.segment_sum(
        ok.astype(jnp.int32), jnp.minimum(key_s, 2 * nc), num_segments=2 * nc + 1,
        indices_are_sorted=True,
    )[:2 * nc].reshape(nc, 2)
    accepted = jnp.zeros((n,), bool).at[order].set(ok)     # per-INPUT-point landed flag
    return (
        pts_flat.reshape(nc, capT, 4),
        corner_cnt + added[:, 0], surf_cnt + added[:, 1],
        cube_coord, accepted[:n_c], accepted[n_c:],
    )


def _refilter_cubes(cube_pts, corner_cnt, surf_cnt, slots, cfg):
    """Re-voxel-downsample the submap-window cubes (laser_mapping.cpp:793-808),
    both feature types in one gather + one scatter-back.

    Out-of-range slot ids (another shard's cubes, in the distributed path)
    are gathered clipped and dropped on scatter-back."""
    mc = cfg.mapping
    nc = cube_pts.shape[0]
    capc, caps = mc.corner_cube_cap, mc.surf_cube_cap
    slots_c = jnp.clip(slots, 0, nc - 1)
    sub = jnp.take(cube_pts, slots_c, axis=0)                # (75, capT, 4)

    def part(off, cap, cnt, leaf):
        p = sub[:, off:off + cap]
        m = jnp.arange(cap)[None, :] < jnp.take(cnt, slots_c)[:, None]
        newp, newm = jax.vmap(lambda pp, mm: voxel_downsample(pp, mm, leaf, cap, max_grid=256))(p, m)
        return jnp.where(newm[..., None], newp, 0.0), jnp.sum(newm, axis=1).astype(jnp.int32)

    newc, ncnt = part(0, capc, corner_cnt, mc.line_resolution)
    news, scnt = part(capc, caps, surf_cnt, mc.plane_resolution)
    # scatter back (slots unique inside the window; duplicates impossible mod-grid
    # because the window is smaller than the grid in every axis)
    cube_pts = cube_pts.at[slots].set(jnp.concatenate([newc, news], axis=1), mode="drop")
    corner_cnt = corner_cnt.at[slots].set(ncnt, mode="drop")
    surf_cnt = surf_cnt.at[slots].set(scnt, mode="drop")
    return cube_pts, corner_cnt, surf_cnt


def _prune_radius(cfg: VloamConfig) -> float:
    """Radius-clamped association: pruning is exact only if every consumer
    gates correspondences at d2 <= r^2.  The fits gate at neighbor_dist_sq
    AND the insert-dedup gate at (insert_dedup_factor * resolution)^2 both
    read these distances, so the radius covers the max of the two."""
    mc = cfg.mapping
    r_dedup = mc.insert_dedup_factor * max(mc.line_resolution, mc.plane_resolution)
    return max(float(mc.neighbor_dist_sq) ** 0.5, r_dedup) * 1.001


def mapping_step(
    state: MapState,
    corner_in: jax.Array, corner_in_mask: jax.Array,   # LO less-sharp cloud (xyzw)
    surf_in: jax.Array, surf_in_mask: jax.Array,       # LO less-flat cloud (xyzw)
    pose_wodom: jax.Array,                             # LO world pose (7,)
    cfg: VloamConfig,
) -> tuple[MapState, jax.Array]:
    """One mapping frame.  Returns (new_state, world pose after mapping)."""
    mc = cfg.mapping

    # Initial guess: wmap_wodom o wodom_curr (laser_mapping.cpp:204-208).
    pose0 = geo.pose_compose(state.wmap_wodom, pose_wodom)

    # Downsample input features (laser_mapping.cpp:491-500).
    # inputs are ring/azimuth-ordered feature clouds -> run-merge, no sort
    corner_stack, cs_mask = voxel_downsample(
        corner_in, corner_in_mask, mc.line_resolution, mc.corner_stack_cap,
        max_grid=1024, presorted=True,
    )
    surf_stack, ss_mask = voxel_downsample(
        surf_in, surf_in_mask, mc.plane_resolution, mc.surf_stack_cap,
        max_grid=512, presorted=True,
    )
    # Morton-sort the stacks: ring/azimuth order sweeps the whole 360° scan,
    # so a query block would span the scene and defeat the box pruning of
    # the k-NN kernel.  Sorting by local coords keeps world blocks equally
    # compact (rigid transform), and the order is irrelevant to fits / GN /
    # inserts (only f32 summation order shifts, sub-mm).
    corner_stack, cs_mask = morton_sort(corner_stack, cs_mask, cell=2.0)
    surf_stack, ss_mask = morton_sort(surf_stack, ss_mask, cell=2.0)

    center = cube_coord_of(geo.pose_t(pose0)[None, :], mc.cube_size)[0]
    coords = _submap_coords(center, cfg)

    if mc.insert_dedup:
        # Compacted-submap cache: the gathered window only changes by this
        # frame's inserts until the robot crosses a cube boundary (~50 m), so
        # the expensive gather+compact runs ~once per 50 frames (lax.cond)
        # and inserts are appended to the cache below.
        def rebuild(_):
            (cp, cm), (sp, sm), _, _ = _gather_submap(state, coords, cfg)
            # Morton-sort the rebuilt cache (world coords, around the window
            # centre) so candidate tiles are compact for box pruning; the
            # per-frame appended tail is naturally local (points near the
            # current pose) and needs no re-sort.
            org = (center.astype(jnp.float32) * mc.cube_size)[None, :]
            cp, cm = morton_sort(cp, cm, cell=4.0, origin=org)
            sp, sm = morton_sort(sp, sm, cell=4.0, origin=org)
            return cp, jnp.sum(cm).astype(jnp.int32), sp, jnp.sum(sm).astype(jnp.int32)

        def cached(_):
            return state.sub_c, state.sub_c_n, state.sub_s, state.sub_s_n

        need_rebuild = jnp.any(center != state.sub_center)
        c_pts, c_n, s_pts, s_n = jax.lax.cond(need_rebuild, rebuild, cached, None)
        c_mask = jnp.arange(c_pts.shape[0]) < c_n
        s_mask = jnp.arange(s_pts.shape[0]) < s_n
        slots = None
    else:
        (c_pts, c_mask), (s_pts, s_mask), slots, fresh = _gather_submap(state, coords, cfg)
        c_n = jnp.sum(c_mask).astype(jnp.int32)
        s_n = jnp.sum(s_mask).astype(jnp.int32)

    enough = (c_n > mc.min_map_corner) & (s_n > mc.min_map_surf)

    inf = jnp.float32(3.4e38)
    # Valid-prefix lengths of the stacks: the k-NN kernel skips query
    # blocks past them.
    cs_n = jnp.sum(cs_mask, dtype=jnp.int32)
    ss_n = jnp.sum(ss_mask, dtype=jnp.int32)
    r_prune = _prune_radius(cfg)

    def optimize(pose):
        for _ in range(mc.outer_iters):
            # two 5-NN problems: corner stack vs corner submap, surf stack
            # vs surf submap
            qc = geo.pose_apply(pose, corner_stack[:, :3])
            qs = geo.pose_apply(pose, surf_stack[:, :3])
            d2c, idxc = knn(qc, c_pts[:, :3], c_mask, mc.n_neighbors,
                            query_count=cs_n, prune_radius=r_prune)
            d2s, idxs = knn(qs, s_pts[:, :3], s_mask, mc.n_neighbors,
                            query_count=ss_n, prune_radius=r_prune)
            nbr_c = jnp.take(c_pts[:, :3], idxc, axis=0)
            p_e, a_e, b_e, v_e = fit_corner_lines(corner_stack, cs_mask, nbr_c, d2c, cfg)
            nn_c = d2c[:, 0]
            nbr_s = jnp.take(s_pts[:, :3], idxs, axis=0)
            p_s, n_s, d_s, v_s = fit_surf_planes(surf_stack, ss_mask, nbr_s, d2s, cfg)
            nn_s = d2s[:, 0]

            pose = solve_pose_gn_lidar(
                pose, (p_e, a_e, b_e, v_e), (p_s, n_s, d_s, v_s),
                mc.inner_iters, mc.huber_delta, mc.lm_lambda,
            )
        return pose, nn_c, nn_s

    pose_w, nn_c, nn_s = jax.lax.cond(
        enough,
        optimize,
        lambda p: (p, jnp.full(corner_stack.shape[:1], inf), jnp.full(surf_stack.shape[:1], inf)),
        pose0,
    )

    # transformUpdate (laser_mapping.cpp:147-151).
    wmap_wodom = geo.pose_compose(pose_w, geo.pose_inverse(pose_wodom))

    # Insert registered features into cubes (laser_mapping.cpp:741-788).
    corner_w = corner_stack.at[:, :3].set(geo.pose_apply(pose_w, corner_stack[:, :3]))
    surf_w = surf_stack.at[:, :3].set(geo.pose_apply(pose_w, surf_stack[:, :3]))
    ins_c_mask, ins_s_mask = cs_mask, ss_mask
    if mc.insert_dedup:
        # Density gate replacing the per-frame window re-voxelisation
        # (laser_mapping.cpp:793-808): a registered point enters the map only
        # if no existing map point lies within half a voxel of it.  The 1-NN
        # distances are reused from the final association pass — they are
        # evaluated one GN solve before pose_w, a sub-cm pose difference that
        # is negligible against the 0.2-0.4 m gate radius, and reusing them
        # saves a full (M, N) distance pass per feature type.
        ins_c_mask = cs_mask & (nn_c > (mc.insert_dedup_factor * mc.line_resolution) ** 2)
        ins_s_mask = ss_mask & (nn_s > (mc.insert_dedup_factor * mc.plane_resolution) ** 2)
    cube_arr, c_cnt, s_cnt, cube_coord, acc_c, acc_s = _scatter_insert_pair(
        corner_w, ins_c_mask, surf_w, ins_s_mask,
        state.cube_pts, state.corner_cnt, state.surf_cnt, state.cube_coord, cfg,
    )

    if mc.insert_dedup:
        # Append this frame's accepted in-window points to the submap cache so
        # it stays exactly the set a fresh gather would produce.
        radii = jnp.array([mc.submap_rx, mc.submap_rx, mc.submap_rz], jnp.int32)

        def in_window(pts_w):
            cc = cube_coord_of(pts_w[:, :3], mc.cube_size)
            return jnp.all(jnp.abs(cc - center[None, :]) <= radii[None, :], axis=-1)

        def append(buf, n, pts_w, m):
            cap = buf.shape[0]
            rank = jnp.cumsum(m.astype(jnp.int32)) - m.astype(jnp.int32)
            # distinct out-of-bounds rows for rejects (dropped by mode="drop")
            dest = jnp.where(m & (n + rank < cap), n + rank,
                             cap + jnp.arange(m.shape[0], dtype=jnp.int32))
            buf = buf.at[dest].set(pts_w, mode="drop", unique_indices=True)
            return buf, jnp.minimum(n + jnp.sum(m, dtype=jnp.int32), cap)

        sub_c, sub_c_n = append(c_pts, c_n, corner_w, acc_c & in_window(corner_w))
        sub_s, sub_s_n = append(s_pts, s_n, surf_w, acc_s & in_window(surf_w))
        sub_center = center
    else:
        # Reference-exact path: re-voxelise the submap window each frame.
        cube_arr, c_cnt, s_cnt = _refilter_cubes(cube_arr, c_cnt, s_cnt, slots, cfg)
        sub_c, sub_c_n, sub_s, sub_s_n = state.sub_c, state.sub_c_n, state.sub_s, state.sub_s_n
        sub_center = state.sub_center

    return MapState(
        cube_pts=cube_arr, corner_cnt=c_cnt, surf_cnt=s_cnt,
        cube_coord=cube_coord, pose_map=pose_w, wmap_wodom=wmap_wodom,
        initialized=jnp.array(True),
        sub_c=sub_c, sub_c_n=sub_c_n, sub_s=sub_s, sub_s_n=sub_s_n,
        sub_center=sub_center,
    ), pose_w
