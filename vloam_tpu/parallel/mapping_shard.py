"""Distributed scan-to-map registration: cube grid sharded over a mesh axis.

This is the capability the reference never had (single process, single
thread — SURVEY.md §2 "parallelism: none"): the 21x21x11 cube map and its
submap NN searches partition across devices.

Design:
  * Cube slot arrays shard along axis 0 ("map" axis).  Block-cyclic slot
    addressing already spreads any 5x5x3 submap window across shards almost
    uniformly (window slot ids are mod-grid, so consecutive cubes land on
    different shards) — every device does useful NN work every frame.
  * Per frame, each shard runs 5-NN for ALL query points against ITS OWN
    window cubes with the same k-NN as the single-device path (ops/knn.py:
    Morton-sorted queries and candidates, radius pruning on the kernel
    path), then the per-shard top-5 merge across shards.
  * The merge is a butterfly (recursive-doubling) all-reduce of the running
    top-k: log2(S) ppermute steps, each exchanging a fixed (M, k, 4) packet
    of neighbour xyz + d2.  Per-device traffic is O(M k log S) — NOT the
    O(M k S) of a flat all_gather — so the collective cost grows
    logarithmically with shard count while NN compute and map capacity
    scale linearly.  (Non-power-of-two meshes fall back to the flat
    all_gather merge; tools/bench_scaling.py reports measured per-S payload
    bytes for both schemes.)
  * The line/plane fits and the GN solve are replicated (6-DoF normal
    equations over a few thousand residuals); cube insertion + the compacted-submap cache are
    shard-local (each shard keeps the points whose slot it owns, and caches
    the compacted window slice it will search next frame, rebuilding only
    when the robot crosses a cube boundary — exactly the single-device
    cache policy of models/laser_mapping.py, per shard).

The single-device ``mapping_step`` in models/laser_mapping.py remains the
reference implementation; ``sharded_mapping_step`` is its SPMD twin run
under ``shard_map`` (``dryrun_multichip`` in __graft_entry__.py validates
compile + execution on a virtual mesh; tests/test_parallel_mapping.py and
tests/test_vloam_sharded.py pin pose equivalence with the single path).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from vloam_tpu import geometry as geo
from vloam_tpu.config import VloamConfig
from vloam_tpu.models.laser_mapping import (
    MapState,
    _prune_radius,
    _refilter_cubes,
    _scatter_insert_pair,
    _submap_coords,
    coord_to_slot,
    cube_coord_of,
    fit_corner_lines,
    fit_surf_planes,
)
from vloam_tpu.ops.knn import compact_rows, knn, morton_sort
from vloam_tpu.ops.lidar_factors import solve_pose_gn_lidar
from vloam_tpu.ops.voxel import voxel_downsample

_INF = jnp.float32(3.4e38)


def _local_window(state: MapState, coords, cfg, axis: str):
    """Gather this shard's portion of the submap window.

    Returns ((corner pts, mask), (surf pts, mask), local_slots) where
    local_slots holds nc_local (out of range -> dropped) for non-owned cubes.
    """
    nc_local = state.cube_pts.shape[0]        # inside shard_map: the local block
    dev = jax.lax.axis_index(axis)
    offset = dev * nc_local
    slots = coord_to_slot(coords, cfg) - offset            # (75,)
    own = (slots >= 0) & (slots < nc_local)
    slots_c = jnp.clip(slots, 0, nc_local - 1)
    fresh = jnp.all(jnp.take(state.cube_coord, slots_c, axis=0) == coords, axis=-1) & own

    mc = cfg.mapping
    sub = jnp.take(state.cube_pts, slots_c, axis=0)        # (75, capT, 4)
    c_counts = jnp.where(fresh, jnp.take(state.corner_cnt, slots_c), 0)
    s_counts = jnp.where(fresh, jnp.take(state.surf_cnt, slots_c), 0)
    # local shard holds ~1/S of the window points; same dense caps are safe
    c = compact_rows(sub[:, :mc.corner_cube_cap], c_counts, mc.submap_corner_cap)
    s = compact_rows(sub[:, mc.corner_cube_cap:], s_counts, mc.submap_surf_cap)
    return c, s, jnp.where(own, slots, nc_local)


def _merge_topk(packed, k, axis: str):
    """All-reduce the per-shard k-NN candidates to the global top-k.

    ``packed``: (M, k, 4) local neighbour [x y z d2] rows, d2 ascending-ish
    (only set membership matters).  Power-of-two meshes use an XOR butterfly:
    log2(S) ppermute rounds, each merging the partner's (M, k, 4) packet via
    top_k over 2k — per-step payload independent of S.  Other mesh sizes use
    the flat all_gather merge (payload O(S)).  Returns (nbr (M,k,3), d2 (M,k)).
    """
    S = jax.lax.axis_size(axis)
    m = packed.shape[0]
    if S > 1 and (S & (S - 1)) == 0:
        step = 1
        while step < S:
            perm = [(i, i ^ step) for i in range(S)]
            other = jax.lax.ppermute(packed, axis, perm)
            both = jnp.concatenate([packed, other], axis=1)          # (M, 2k, 4)
            _, sel = jax.lax.top_k(-both[..., 3], k)
            packed = jnp.take_along_axis(both, sel[..., None], axis=1)
            step *= 2
    elif S > 1:
        allp = jax.lax.all_gather(packed, axis)                      # (S, M, k, 4)
        allp = jnp.moveaxis(allp, 0, 1).reshape(m, S * k, 4)
        _, sel = jax.lax.top_k(-allp[..., 3], k)
        packed = jnp.take_along_axis(allp, sel[..., None], axis=1)
    return packed[..., :3], packed[..., 3]


def merge_payload_bytes(S: int, m: int, k: int) -> int:
    """Per-device collective bytes RECEIVED per _merge_topk call, for the
    scheme actually used at shard count S (butterfly vs flat gather)."""
    if S <= 1:
        return 0
    pkt = m * k * 4 * 4
    if (S & (S - 1)) == 0:
        return pkt * S.bit_length() - pkt        # log2(S) rounds x packet
    return pkt * S                               # all_gather of S packets


def sharded_mapping_step(
    state: MapState,
    corner_in, corner_in_mask,
    surf_in, surf_in_mask,
    pose_wodom,
    cfg: VloamConfig,
    axis: str = "map",
    ablate_merge: bool = False,
):
    """SPMD twin of mapping_step; call inside shard_map with MapState cube
    arrays AND submap-cache arrays partitioned on axis 0, poses replicated.

    Mirrors models/laser_mapping.mapping_step stage for stage (semantics:
    laser_mapping.cpp:212-814); the only structural additions are the
    shard-local window slice and the butterfly top-k merge.

    ``ablate_merge=True`` replaces the cross-shard top-k merge with the
    shard-local candidates — numerically WRONG (each shard associates only
    against its own cubes) but byte-identical compute otherwise, so
    (normal - ablated) step time isolates the collective's wall-clock share
    (tools/bench_scaling.py --ablate-merge)."""
    mc = cfg.mapping
    pose0 = geo.pose_compose(state.wmap_wodom, pose_wodom)

    # inputs are ring/azimuth-ordered feature clouds -> run-merge, no sort
    corner_stack, cs_mask = voxel_downsample(
        corner_in, corner_in_mask, mc.line_resolution, mc.corner_stack_cap,
        max_grid=1024, presorted=True,
    )
    surf_stack, ss_mask = voxel_downsample(
        surf_in, surf_in_mask, mc.plane_resolution, mc.surf_stack_cap,
        max_grid=512, presorted=True,
    )
    # Morton-sort the query stacks so the k-NN box pruning sees compact
    # blocks (see laser_mapping.mapping_step).
    corner_stack, cs_mask = morton_sort(corner_stack, cs_mask, cell=2.0)
    surf_stack, ss_mask = morton_sort(surf_stack, ss_mask, cell=2.0)

    center = cube_coord_of(geo.pose_t(pose0)[None, :], mc.cube_size)[0]
    coords = _submap_coords(center, cfg)

    if mc.insert_dedup:
        # Per-shard compacted-window cache: rebuilt only when the robot
        # crosses a cube boundary (~50 m), appended shard-locally otherwise.
        def rebuild(_):
            (cp, cm), (sp, sm), _ = _local_window(state, coords, cfg, axis)
            org = (center.astype(jnp.float32) * mc.cube_size)[None, :]
            cp, cm = morton_sort(cp, cm, cell=4.0, origin=org)
            sp, sm = morton_sort(sp, sm, cell=4.0, origin=org)
            return cp, jnp.sum(cm).astype(jnp.int32), sp, jnp.sum(sm).astype(jnp.int32)

        def cached(_):
            return state.sub_c, state.sub_c_n[0], state.sub_s, state.sub_s_n[0]

        need_rebuild = jnp.any(center != state.sub_center)
        c_pts, c_n, s_pts, s_n = jax.lax.cond(need_rebuild, rebuild, cached, None)
        c_mask = jnp.arange(c_pts.shape[0]) < c_n
        s_mask = jnp.arange(s_pts.shape[0]) < s_n
        local_slots = None
    else:
        (c_pts, c_mask), (s_pts, s_mask), local_slots = _local_window(state, coords, cfg, axis)
        c_n = jnp.sum(c_mask).astype(jnp.int32)
        s_n = jnp.sum(s_mask).astype(jnp.int32)

    n_corner = jax.lax.psum(c_n, axis)
    n_surf = jax.lax.psum(s_n, axis)
    enough = (n_corner > mc.min_map_corner) & (n_surf > mc.min_map_surf)

    cs_n = jnp.sum(cs_mask, dtype=jnp.int32)
    ss_n = jnp.sum(ss_mask, dtype=jnp.int32)
    k = mc.n_neighbors
    r_prune = _prune_radius(cfg)

    def optimize(pose):
        for _ in range(mc.outer_iters):
            qc = geo.pose_apply(pose, corner_stack[:, :3])
            qs = geo.pose_apply(pose, surf_stack[:, :3])
            d2c_l, idxc = knn(qc, c_pts[:, :3], c_mask, k,
                              query_count=cs_n, prune_radius=r_prune)
            d2s_l, idxs = knn(qs, s_pts[:, :3], s_mask, k,
                              query_count=ss_n, prune_radius=r_prune)
            nbr_c_l = jnp.take(c_pts[:, :3], idxc, axis=0)           # (M, k, 3)
            nbr_s_l = jnp.take(s_pts[:, :3], idxs, axis=0)
            if ablate_merge:
                nbr_c, d2c = nbr_c_l, d2c_l
                nbr_s, d2s = nbr_s_l, d2s_l
            else:
                nbr_c, d2c = _merge_topk(
                    jnp.concatenate([nbr_c_l, d2c_l[..., None]], axis=-1), k, axis)
                nbr_s, d2s = _merge_topk(
                    jnp.concatenate([nbr_s_l, d2s_l[..., None]], axis=-1), k, axis)
            p_e, a_e, b_e, v_e = fit_corner_lines(corner_stack, cs_mask, nbr_c, d2c, cfg)
            p_s, n_s, d_s, v_s = fit_surf_planes(surf_stack, ss_mask, nbr_s, d2s, cfg)

            # Fits + GN are replicated after the merge.
            pose = solve_pose_gn_lidar(
                pose, (p_e, a_e, b_e, v_e), (p_s, n_s, d_s, v_s),
                mc.inner_iters, mc.huber_delta, mc.lm_lambda,
            )
        return pose, d2c[:, 0], d2s[:, 0]

    pose_w, nn_c, nn_s = jax.lax.cond(
        enough,
        optimize,
        lambda p: (p, jnp.full(corner_stack.shape[:1], _INF),
                   jnp.full(surf_stack.shape[:1], _INF)),
        pose0,
    )
    wmap_wodom = geo.pose_compose(pose_w, geo.pose_inverse(pose_wodom))

    # Shard-local insertion; dedup gates reuse the final association pass's
    # merged global 1-NN distances (same reuse as the single-device path).
    nc_local = state.cube_pts.shape[0]
    offset = jax.lax.axis_index(axis) * nc_local
    corner_w = corner_stack.at[:, :3].set(geo.pose_apply(pose_w, corner_stack[:, :3]))
    surf_w = surf_stack.at[:, :3].set(geo.pose_apply(pose_w, surf_stack[:, :3]))
    ins_c_mask, ins_s_mask = cs_mask, ss_mask
    if mc.insert_dedup:
        ins_c_mask = cs_mask & (nn_c > (mc.insert_dedup_factor * mc.line_resolution) ** 2)
        ins_s_mask = ss_mask & (nn_s > (mc.insert_dedup_factor * mc.plane_resolution) ** 2)
    cube_arr, c_cnt, s_cnt, cube_coord, acc_c, acc_s = _scatter_insert_pair(
        corner_w, ins_c_mask, surf_w, ins_s_mask,
        state.cube_pts, state.corner_cnt, state.surf_cnt, state.cube_coord,
        cfg, slot_offset=offset,
    )

    if mc.insert_dedup:
        # Append this frame's points that landed on THIS shard (acc_* is the
        # per-input-point landed flag, already offset-filtered) to the local
        # cache so it stays exactly what a fresh local gather would produce.
        radii = jnp.array([mc.submap_rx, mc.submap_rx, mc.submap_rz], jnp.int32)

        def in_window(pts_w):
            cc = cube_coord_of(pts_w[:, :3], mc.cube_size)
            return jnp.all(jnp.abs(cc - center[None, :]) <= radii[None, :], axis=-1)

        def append(buf, n, pts_w, m):
            cap = buf.shape[0]
            rank = jnp.cumsum(m.astype(jnp.int32)) - m.astype(jnp.int32)
            dest = jnp.where(m & (n + rank < cap), n + rank,
                             cap + jnp.arange(m.shape[0], dtype=jnp.int32))
            buf = buf.at[dest].set(pts_w, mode="drop", unique_indices=True)
            return buf, jnp.minimum(n + jnp.sum(m, dtype=jnp.int32), cap)

        sub_c, sub_c_n = append(c_pts, c_n, corner_w, acc_c & in_window(corner_w))
        sub_s, sub_s_n = append(s_pts, s_n, surf_w, acc_s & in_window(surf_w))
        sub_c_n, sub_s_n = sub_c_n[None], sub_s_n[None]
        sub_center = center
    else:
        cube_arr, c_cnt, s_cnt = _refilter_cubes(cube_arr, c_cnt, s_cnt, local_slots, cfg)
        sub_c, sub_c_n = state.sub_c, state.sub_c_n
        sub_s, sub_s_n = state.sub_s, state.sub_s_n
        sub_center = state.sub_center

    return MapState(
        cube_pts=cube_arr, corner_cnt=c_cnt, surf_cnt=s_cnt,
        cube_coord=cube_coord, pose_map=pose_w, wmap_wodom=wmap_wodom,
        initialized=jnp.array(True),
        sub_c=sub_c, sub_c_n=sub_c_n,
        sub_s=sub_s, sub_s_n=sub_s_n, sub_center=sub_center,
    ), pose_w


MAP_SHARDED_FIELDS = (
    "cube_pts", "corner_cnt", "surf_cnt", "cube_coord",
    "sub_c", "sub_c_n", "sub_s", "sub_s_n",
)


def map_state_specs(axis: str = "map") -> MapState:
    """PartitionSpec pytree for a sharded MapState: cube-slot arrays and the
    per-shard submap cache on ``axis``, poses/flags replicated."""
    sh, rep = P(axis), P()
    return MapState(
        cube_pts=sh, corner_cnt=sh, surf_cnt=sh, cube_coord=sh,
        pose_map=rep, wmap_wodom=rep, initialized=rep,
        sub_c=sh, sub_c_n=sh, sub_s=sh, sub_s_n=sh, sub_center=rep,
    )


def make_sharded_step(cfg: VloamConfig, mesh: Mesh, axis: str = "map",
                      ablate_merge: bool = False):
    """jit-compiled shard_map wrapper: (MapState, corner, cmask, surf, smask,
    pose) -> (MapState, pose_w) with cube + cache arrays partitioned over
    ``axis`` (state from ``init_map_state(cfg, n_shards=S)``).
    ``ablate_merge`` builds the collective-free twin for isolation timing
    (see sharded_mapping_step)."""
    rep = P()
    state_specs = map_state_specs(axis)

    @jax.jit
    def step(state, corner_in, cmask, surf_in, smask, pose_wodom):
        f = jax.shard_map(
            lambda st, ci, cm, si, sm, pw: sharded_mapping_step(
                st, ci, cm, si, sm, pw, cfg, axis, ablate_merge=ablate_merge),
            mesh=mesh,
            in_specs=(state_specs, rep, rep, rep, rep, rep),
            out_specs=(state_specs, rep),
            check_vma=False,
        )
        return f(state, corner_in, cmask, surf_in, smask, pose_wodom)

    return step
