"""Depth-enhanced monocular visual odometry (DEMO-style) — reference:
visual_odometry.cpp + image_util.cpp + point_cloud_util.cpp.

Per frame: Shi-Tomasi corners on the current image; pyramidal LK tracks the
previous frame's corners into the current frame; the previous frame's lidar
depth buckets answer per-feature depth queries; matches with depth become
3D-2D reprojection residuals, the rest 2D-2D epipolar residuals; one batched
GN solve (Huber 0.1) yields cam0_curr_T_cam0_last
(visual_odometry.cpp:304-509).

The double-buffered OpenCV pipeline of the reference becomes a VoState
pytree threaded through a jit-once step.  Keypoints are detected on the
*previous* frame and tracked forward; the reference instead detects on the
CURRENT frame and feeds those corners as the start positions of prev->curr
LK (visual_odometry.cpp:120,146-148).  Measured head-to-head on the
synthetic camera world (tests/test_klt_direction.py): detect-on-prev wins
on every axis — track survival 0.66 vs 0.60, depth-hit 0.64 vs 0.62,
rotation error 2.0e-4 vs 2.9e-4, translation error 0.19 vs 0.21 — because
corners detected on the frame where LK starts initialize on their own
intensity peaks.  The shipped formulation is kept deliberately.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vloam_tpu import geometry as geo
from vloam_tpu.config import VloamConfig
from vloam_tpu.ops import image_ops, vo_factors
from vloam_tpu.ops.depth_map import DepthBuckets, build_buckets, bucket_shape, project_cloud, query_depth
from vloam_tpu.ops.gauss_newton import solve_pose_gn


class VoState(NamedTuple):
    prev_img: jax.Array         # (H, W)
    prev_pts: jax.Array         # (max_features, 2) corners detected on prev frame
    prev_pts_mask: jax.Array    # (max_features,)
    prev_desc: jax.Array        # (max_features, 8) uint32 ORB descriptors
    prev_desc_mask: jax.Array   # (max_features,)
    prev_buckets: DepthBuckets  # lidar depth map of prev frame
    count: jax.Array            # () int32 frame counter


def _desc_buffer_spec(vc) -> tuple[int, jnp.dtype]:
    """Descriptor buffer (width, dtype) per family: ORB/BRIEF = 256-bit,
    BRISK/FREAK/AKAZE = 512-bit binary; SIFT = 128-d float."""
    t = vc.descriptor_type
    if t in ("orb", "brief"):
        return 8, jnp.uint32
    if t in ("brisk", "freak", "akaze"):
        return 16, jnp.uint32
    if t == "sift":
        return 128, jnp.float32
    raise ValueError(f"unknown descriptor_type {t!r}")


def init_vo_state(cfg: VloamConfig) -> VoState:
    vc = cfg.visual
    bw, bh = bucket_shape(vc)
    dw, ddt = _desc_buffer_spec(vc)
    # four DISTINCT zero buffers: the state is donated in the hot jits, and
    # donation rejects pytrees whose leaves alias the same buffer
    z0, z1, z2, z3 = (jnp.zeros((bw, bh), jnp.float32) for _ in range(4))
    return VoState(
        prev_img=jnp.zeros((vc.img_height, vc.img_width), jnp.float32),
        prev_pts=jnp.zeros((vc.max_features, 2), jnp.float32),
        prev_pts_mask=jnp.zeros((vc.max_features,), bool),
        prev_desc=jnp.zeros((vc.max_features, dw), ddt),
        prev_desc_mask=jnp.zeros((vc.max_features,), bool),
        prev_buckets=DepthBuckets(z0, z1, z2, z3),
        count=jnp.array(0, jnp.int32),
    )


def _unproject(K_inv: jax.Array, uv: jax.Array, depth: jax.Array) -> jax.Array:
    """K^-1 [u d, v d, d] — the rectified-camera 3D point (visual_odometry.cpp:403-415)."""
    uvd = jnp.stack([uv[..., 0] * depth, uv[..., 1] * depth, depth], axis=-1)
    return uvd @ K_inv.T


def _ray(K_inv: jax.Array, uv: jax.Array) -> jax.Array:
    """Normalised image ray (xbar, ybar) = (K^-1 [u v 1]) / z."""
    uv1 = jnp.concatenate([uv, jnp.ones_like(uv[..., :1])], axis=-1)
    X = uv1 @ K_inv.T
    return X[..., :2] / jnp.maximum(X[..., 2:3], 1e-9)


def vo_step(
    state: VoState,
    img: jax.Array,            # (H, W) float32 current frame
    cloud: jax.Array,          # (N, 3) velodyne points (current frame)
    cloud_mask: jax.Array,
    proj: jax.Array,           # (3, 4) P_rect0 @ rect0_T_cam @ cam_T_velo
    K: jax.Array,              # (3, 3) = P_rect0[:, :3]
    cfg: VloamConfig,
    lo_prior: jax.Array | None = None,   # (7,) cam0_curr_T_cam0_prev seed
    pre_buckets: DepthBuckets | None = None,  # host-built depth buckets (data/gridding.py)
) -> tuple[VoState, jax.Array]:
    """One VO frame.  Returns (new_state, cam0_curr_T_cam0_last pose).

    ``pre_buckets``: the lidar->camera depth-bucket grid for the CURRENT
    cloud, pre-built by the host data layer (the projection matrix is a
    per-sequence constant, so this is frame data, not model state); the
    device then skips the 131k-point projection + bucket scatter."""
    vc = cfg.visual

    # --- frontend -----------------------------------------------------------
    if vc.clahe:
        from vloam_tpu.ops.clahe import clahe as _clahe

        img = _clahe(img, vc.clahe_clip)
    if vc.detector_type in ("shitomasi", "fast"):
        # hot path: single-scale corner detectors, inline
        pts, pts_mask, resp = image_ops.detect_corners(img, vc)
        kp_oct = jnp.zeros((vc.max_features,), jnp.int32)
        kp_ang = jnp.zeros((vc.max_features,), jnp.float32)
    else:
        # scale-space families (BRISK/ORB/AKAZE/SIFT) via the ImageUtil facade
        from vloam_tpu import image_util as iu

        kp = iu.det_keypoints(img, vc.detector_type, vc)
        pts, pts_mask, resp = kp.pts, kp.mask, kp.response
        kp_oct, kp_ang = kp.octave, kp.angle
    if vc.keypoint_nms:
        pts_mask = image_ops.bucket_nms(pts, pts_mask, resp, vc)

    # --- depth association (prev frame's buckets at prev pixel) -------------
    depth0 = query_depth(state.prev_buckets, state.prev_pts, vc)

    if vc.optical_flow_match:
        # Seed KLT with the motion-prior flow: project each prev feature's 3D
        # point (bucket depth, or a nominal mid-range depth) through the prior.
        pose_pred = geo.pose_identity() if lo_prior is None else lo_prior
        d_nom = jnp.where(depth0 > 0, depth0, 15.0)
        X0_pred = _unproject(jnp.linalg.inv(K), state.prev_pts, d_nom)
        X1_pred = geo.pose_apply(pose_pred, X0_pred)
        uv_pred = X1_pred @ K.T
        uv_pred = uv_pred[:, :2] / jnp.maximum(uv_pred[:, 2:3], 1e-3)
        init_flow = jnp.clip(uv_pred - state.prev_pts, -120.0, 120.0)

        # With a real LO prior (frame >= 2) the seeded flow lands inside the
        # level-0 patch slack, so the coarse pyramid levels are skipped at
        # runtime (lax.cond) — they only run on the first tracked frame.
        skip_coarse = None if lo_prior is None else (state.count >= 2)
        track = image_ops.lk_track_fb if vc.klt_fb_check else image_ops.lk_track
        curr_pts, track_ok = track(
            state.prev_img, img, state.prev_pts, state.prev_pts_mask, vc, init_flow,
            skip_coarse=skip_coarse,
        )
        desc = state.prev_desc          # unused in this mode
        desc_mask = state.prev_desc_mask
    else:
        # Descriptor mode (the reference default): describe current corners,
        # match against the previous frame's descriptors (image_util.cpp:
        # 280-438).  Full DescriptorType x MatcherType x SelectType dispatch
        # via the ImageUtil facade; ORB/BRIEF short-circuit the hot path.
        if vc.descriptor_type in ("orb", "brief") and vc.matcher_type == "bf":
            from vloam_tpu.ops import orb

            desc, desc_mask = orb.orb_descriptors(
                img, pts, pts_mask, vc, rotate=(vc.descriptor_type == "orb")
            )
            midx, mvalid = orb.match_descriptors(
                state.prev_desc, state.prev_desc_mask, desc, desc_mask,
                ratio=vc.match_ratio, select=vc.match_select,
            )
        else:
            from vloam_tpu import image_util as iu

            kp_full = iu.Keypoints(pts, pts_mask, resp, kp_oct, kp_ang)
            desc, desc_mask = iu.desc_keypoints(img, kp_full, vc.descriptor_type, vc)
            midx, mvalid = iu.match(
                state.prev_desc, state.prev_desc_mask, desc, desc_mask,
                matcher_type=vc.matcher_type, select=vc.match_select,
                ratio=vc.match_ratio,
            )
        curr_pts = jnp.take(pts, midx, axis=0)
        track_ok = mvalid
    track_ok = track_ok & (state.count > 0)

    # outlier gate on pixel displacement (visual_odometry.cpp:363-368)
    if vc.remove_vo_outlier > 0:
        disp2 = jnp.sum((curr_pts - state.prev_pts) ** 2, axis=-1)
        track_ok = track_ok & (disp2 <= vc.remove_vo_outlier ** 2)

    # --- residuals ----------------------------------------------------------
    K_inv = jnp.linalg.inv(K)
    has_depth = track_ok & (depth0 > 0)
    no_depth = track_ok & (depth0 <= 0)

    X0 = _unproject(K_inv, state.prev_pts, jnp.maximum(depth0, 1e-3))
    xb0 = _ray(K_inv, state.prev_pts)
    xb1 = _ray(K_inv, curr_pts)

    pose0 = geo.pose_identity() if (lo_prior is None or vc.reset_vo_to_identity) else lo_prior

    from vloam_tpu.ops.vo_factors import solve_pose_gn_vo

    solved = solve_pose_gn_vo(
        pose0, X0, xb0, xb1, has_depth, no_depth,
        vc.max_iters, vc.huber_delta, vc.lm_lambda,
    )
    enough = jnp.sum(track_ok) >= 10
    pose = jnp.where((state.count > 0) & enough, solved, pose0)

    # --- roll state ---------------------------------------------------------
    if pre_buckets is None:
        uvz, ok = project_cloud(cloud, cloud_mask, proj, vc)
        buckets = build_buckets(uvz, ok, vc)
    else:
        buckets = pre_buckets
    new_state = VoState(
        prev_img=img,
        prev_pts=pts,
        prev_pts_mask=pts_mask,
        prev_desc=desc,
        prev_desc_mask=desc_mask,
        prev_buckets=buckets,
        count=state.count + 1,
    )
    return new_state, pose


def solve_nls_2d_only(
    prev_pts: jax.Array,       # (M, 2) pixel coords, previous frame
    curr_pts: jax.Array,       # (M, 2) tracked positions, current frame
    match_mask: jax.Array,     # (M,) valid-match mask
    K: jax.Array,
    cfg: VloamConfig,
    pose0: jax.Array | None = None,
) -> jax.Array:
    """Epipolar-only GN solve — ``VisualOdometry::solveNls2dOnly``.

    The reference declares this solver (visual_odometry.h:61) as the
    depth-free variant of solveNlsAll; every match contributes only the
    2D-2D epipolar residual (ceres_cost_function.h:151-189).  Translation
    scale is unobservable; the returned pose carries the seed's scale (or
    unit scale from identity).
    """
    vc = cfg.visual
    K_inv = jnp.linalg.inv(K)
    xb0 = _ray(K_inv, prev_pts)
    xb1 = _ray(K_inv, curr_pts)
    p0 = geo.pose_identity() if pose0 is None else pose0

    def residuals(p):
        return ((vo_factors.epipolar_22_residual(p, xb0, xb1), match_mask),)

    return solve_pose_gn(residuals, p0, vc.max_iters, vc.huber_delta, vc.lm_lambda)


def solve_ransac(
    prev_pts: jax.Array,
    curr_pts: jax.Array,
    match_mask: jax.Array,
    K: jax.Array,
    n_hypotheses: int = 256,
    thresh_px: float = 1.0,
    seed: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Essential-matrix RANSAC pose — ``VisualOdometry::solveRANSAC``
    (visual_odometry.cpp:234-299).  Returns (pose (7,), n_inliers); the
    translation is unit-norm, as with cv::recoverPose.
    """
    from vloam_tpu.ops.epipolar import solve_ransac_pose

    return solve_ransac_pose(
        prev_pts, curr_pts, match_mask, K, n_hypotheses, thresh_px, seed
    )
