"""Scan-to-scan lidar odometry (LO) — reference: laser_odometry.cpp:199-584.

Re-design: the per-point kd-tree queries + ring-window scans of the
reference become brute-force k-NN sweeps (ops/knn.py) plus masked argmins —
the ring constraint (NEARBY_SCAN, laser_odometry.h:94-95) is just another
mask on the candidate axis.  Correspondences are re-built twice (the outer
iterations at laser_odometry.cpp:224) and each association feeds a batched
Gauss-Newton solve (4 inner iterations, Huber 0.1 — the Ceres settings at
laser_odometry.cpp:229-234,500-509).  Everything is fixed-shape and jits
once; the frame loop threads a small pytree of last-frame feature clouds.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vloam_tpu import geometry as geo
from vloam_tpu.config import VloamConfig
from vloam_tpu.ops import lidar_factors
from vloam_tpu.ops.knn import knn, masked_argmin
from vloam_tpu.ops.lidar_factors import solve_pose_gn_lidar
from vloam_tpu.ops.scan_registration import ScanFeatures

_INF = jnp.float32(3.4e38)


class LoState(NamedTuple):
    last_corner: jax.Array        # (N_c, 4) xyzw — prev frame's less-sharp cloud
    last_corner_mask: jax.Array   # (N_c,)
    last_surf: jax.Array          # (N_s, 4) — prev frame's less-flat cloud
    last_surf_mask: jax.Array
    pose_wodom: jax.Array         # (7,) accumulated odometry-world pose
    last_delta: jax.Array         # (7,) previous frame-to-frame solution (warm start)
    initialized: jax.Array        # () bool


def init_lo_state(cfg: VloamConfig) -> LoState:
    sc = cfg.scan
    n_c = sc.n_scans * sc.n_sectors * sc.max_less_sharp
    n_s = sc.less_flat_cap
    return LoState(
        last_corner=jnp.zeros((n_c, 4), jnp.float32),
        last_corner_mask=jnp.zeros((n_c,), bool),
        last_surf=jnp.zeros((n_s, 4), jnp.float32),
        last_surf_mask=jnp.zeros((n_s,), bool),
        pose_wodom=geo.pose_identity(),
        last_delta=geo.pose_identity(),
        initialized=jnp.array(False),
    )


def _ring_picks(d2, idx, cand, cfg):
    """Resolve the ring-constrained picks from a k-NN list.

    The reference's kd-tree passes (laser_odometry.cpp:282-459) want, per
    query: the global nearest j, the nearest same-ring-as-j candidate != j,
    and the nearest nearby-other-ring (|Δring| <= NEARBY_SCAN) candidate.
    On a scan-structured cloud those are essentially always within the
    global ``assoc_k``-NN (same-ring/adjacent-ring neighbours are the
    closest points by construction), so one fused k-NN pass + a masked
    min over the k list replaces three full argmin sweeps over (M, N).
    Misses only lose a correspondence (valid gates reject), never corrupt.

    Returns (d2_1, j1, d2_same, j_same, d2_other, j_other).
    """
    oc = cfg.odom
    ring_c = jnp.floor(cand[:, 3]).astype(jnp.int32)
    ring_n = jnp.take(ring_c, idx)                           # (M, k)
    ring1 = ring_n[:, 0]

    d2_1, j1 = d2[:, 0], idx[:, 0]
    same = (ring_n == ring1[:, None]).at[:, 0].set(False)
    dring = jnp.abs(ring_n - ring1[:, None]).astype(jnp.float32)
    other = (ring_n != ring1[:, None]) & (dring <= oc.nearby_scan)

    d2_s, c_s = masked_argmin(d2, same)
    d2_o, c_o = masked_argmin(d2, other)
    j_s = jnp.take_along_axis(idx, c_s[:, None], axis=1)[:, 0]
    j_o = jnp.take_along_axis(idx, c_o[:, None], axis=1)[:, 0]
    return d2_1, j1, d2_s, j_s, d2_o, j_o


def _edge_correspondences(d2, idx, sharp, sharp_mask, cand, cfg):
    """Point-to-line data: for each sharp point, closest cand + nearest
    cand on a different-but-nearby ring (laser_odometry.cpp:282-356)."""
    oc = cfg.odom
    d2_1, j1, _, _, d2_2, j2 = _ring_picks(d2, idx, cand, cfg)
    valid = sharp_mask & (d2_1 < oc.distance_sq_threshold) & (d2_2 < oc.distance_sq_threshold)
    a = jnp.take(cand[:, :3], j1, axis=0)
    b = jnp.take(cand[:, :3], j2, axis=0)
    return sharp[:, :3], a, b, valid


def _plane_correspondences(d2, idx, flat, flat_mask, cand, cfg):
    """Point-to-plane data: closest cand j, nearest same-ring cand l (!= j),
    nearest nearby-other-ring cand m (laser_odometry.cpp:387-459)."""
    oc = cfg.odom
    d2_1, j1, d2_2, j2, d2_3, j3 = _ring_picks(d2, idx, cand, cfg)
    thr = oc.distance_sq_threshold
    valid = flat_mask & (d2_1 < thr) & (d2_2 < thr) & (d2_3 < thr)
    pj = jnp.take(cand[:, :3], j1, axis=0)
    pl = jnp.take(cand[:, :3], j2, axis=0)
    pm = jnp.take(cand[:, :3], j3, axis=0)
    nrm, d = lidar_factors.plane_from_three_points(pj, pl, pm)
    # Degenerate normals (colinear triples) are rejected by zeroing validity.
    ok_n = jnp.linalg.norm(jnp.cross(pj - pl, pj - pm), axis=-1) > 1e-10
    return flat[:, :3], nrm, d, valid & ok_n


def solve_f2f(
    feats: ScanFeatures,
    cand_corner: jax.Array, cand_corner_mask: jax.Array,
    cand_surf: jax.Array, cand_surf_mask: jax.Array,
    pose0: jax.Array,
    cfg: VloamConfig,
) -> tuple[jax.Array, jax.Array]:
    """Register ``feats`` against arbitrary candidate clouds: the LO solve
    body (association + GN, laser_odometry.cpp:224-516) factored out so
    loop-closure registration (parallel/loop_closure.py) can align ANY two
    keyframe scans, not just consecutive frames.

    Returns (pose cand_T_feats, counts (2,) int32 edge/plane correspondences).
    """
    oc = cfg.odom

    if oc.distortion:
        sp = cfg.scan.scan_period
        s_e = jnp.clip((feats.sharp[:, 3] - jnp.floor(feats.sharp[:, 3])) / sp, 0.0, 1.0)
        s_s = jnp.clip((feats.flat[:, 3] - jnp.floor(feats.flat[:, 3])) / sp, 0.0, 1.0)

    pose = pose0
    for _ in range(oc.outer_iters):
        # two association problems: sharp vs less-sharp, flat vs less-flat
        if oc.distortion:
            # TransformToStart with the per-point slerp fraction
            # (laser_odometry.cpp:285,390).
            q_e = lidar_factors.pose_apply_interp(pose, feats.sharp[:, :3], s_e)
            q_s = lidar_factors.pose_apply_interp(pose, feats.flat[:, :3], s_s)
        else:
            q_e = geo.pose_apply(pose, feats.sharp[:, :3])
            q_s = geo.pose_apply(pose, feats.flat[:, :3])
        d2e, idxe = knn(q_e, cand_corner[:, :3], cand_corner_mask, oc.assoc_k)
        d2s, idxs = knn(q_s, cand_surf[:, :3], cand_surf_mask, oc.assoc_k_surf)
        p_e, a_e, b_e, v_e = _edge_correspondences(
            d2e, idxe, feats.sharp, feats.sharp_mask, cand_corner, cfg
        )
        p_s, n_s, d_s, v_s = _plane_correspondences(
            d2s, idxs, feats.flat, feats.flat_mask, cand_surf, cfg
        )

        if oc.distortion:
            # Per-point slerp inside the residuals (the factors' s parameter,
            # lidarFactor.hpp:30-44).
            from vloam_tpu.ops.gauss_newton import solve_pose_gn

            def residuals(pp, p_e=p_e, a_e=a_e, b_e=b_e, v_e=v_e,
                          p_s=p_s, n_s=n_s, d_s=d_s, v_s=v_s):
                r_e = lidar_factors.edge_residual_interp(pp, p_e, a_e, b_e, s_e)
                r_s = lidar_factors.plane_residual_interp(pp, p_s, n_s, d_s, s_s)
                return ((r_e, v_e), (r_s, v_s))

            pose = solve_pose_gn(
                residuals, pose, oc.inner_iters, oc.huber_delta, oc.lm_lambda
            )
        else:
            pose = solve_pose_gn_lidar(
                pose, (p_e, a_e, b_e, v_e), (p_s, n_s, d_s, v_s),
                oc.inner_iters, oc.huber_delta, oc.lm_lambda,
            )
    counts = jnp.stack(
        [jnp.sum(v_e, dtype=jnp.int32), jnp.sum(v_s, dtype=jnp.int32)]
    )
    return pose, counts


def lo_step(
    state: LoState, feats: ScanFeatures, cfg: VloamConfig, vo_prior: jax.Array | None = None
) -> tuple[LoState, jax.Array, jax.Array, jax.Array]:
    """One LO frame.  Returns (new_state, f2f pose last_T_curr, world pose,
    corr_counts (2,) int32 = final-iteration edge/plane correspondences —
    the reference's degradation signal, laser_odometry.cpp:489-496).

    ``vo_prior`` (a 7-pose, velodyne frame, last_T_curr) seeds the solve when
    the VO/LO coupling is on (laser_odometry.cpp:237-250); otherwise the
    previous solution warm-starts it (Ceres reuses para_q/para_t across
    frames).
    """
    oc = cfg.odom

    pose0 = state.last_delta if vo_prior is None else vo_prior

    def solve(pose_init):
        return solve_f2f(
            feats, state.last_corner, state.last_corner_mask,
            state.last_surf, state.last_surf_mask, pose_init, cfg,
        )

    delta, corr_counts = jax.lax.cond(
        state.initialized,
        solve,
        lambda p: (geo.pose_identity(), jnp.zeros((2,), jnp.int32)),
        pose0,
    )

    pose_w = geo.pose_compose(state.pose_wodom, delta)
    pose_w = jnp.where(state.initialized, pose_w, state.pose_wodom)

    if oc.distortion:
        # Store the next frame's match targets rigid in their sweep-end
        # anchor (TransformToEnd; see lidar_factors.transform_to_end).  The
        # w channel keeps ring + time; consumers floor() it for the ring id.
        sp = cfg.scan.scan_period
        ls_s = jnp.clip(
            (feats.less_sharp[:, 3] - jnp.floor(feats.less_sharp[:, 3])) / sp, 0.0, 1.0
        )
        lf_s = jnp.clip(
            (feats.less_flat[:, 3] - jnp.floor(feats.less_flat[:, 3])) / sp, 0.0, 1.0
        )
        store_corner = feats.less_sharp.at[:, :3].set(
            lidar_factors.transform_to_end(delta, feats.less_sharp[:, :3], ls_s)
        )
        store_surf = feats.less_flat.at[:, :3].set(
            lidar_factors.transform_to_end(delta, feats.less_flat[:, :3], lf_s)
        )
    else:
        store_corner, store_surf = feats.less_sharp, feats.less_flat

    new_state = LoState(
        last_corner=store_corner,
        last_corner_mask=feats.less_sharp_mask,
        last_surf=store_surf,
        last_surf_mask=feats.less_flat_mask,
        pose_wodom=pose_w,
        last_delta=jnp.where(state.initialized, delta, state.last_delta),
        initialized=jnp.array(True),
    )
    return new_state, delta, pose_w, corr_counts
