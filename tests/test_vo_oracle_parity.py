"""VO-half reference-semantics parity: ops/depth_map + solve_pose_gn_vo vs
the sequential NumPy oracle (testing/vo_oracle.py).

Quantifies the documented approximations of the fixed-shape formulation against
the reference's exact sequential semantics (point_cloud_util.cpp:183-487,
visual_odometry.cpp:339-482):

  * bucket means: exact segment mean vs the reference's forgetful
    incremental average (first hit forgotten when a bucket has >= 2 hits),
  * depth queries: vmapped static 5x5 gather vs sequential neighbour
    collection + sort,
  * residual assembly: masked fixed-shape branches vs per-match branching,
  * the GN/LM solve vs scipy's Huber trust-region (the Ceres analogue).

Pinned numbers: depth decision agreement, co-valid |dz|, 3D-2D/2D-2D
branch-count gaps, and the oracle-vs-engine pose delta on exact-match
synthetic camera+lidar frames.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from vloam_tpu import geometry as geo
from vloam_tpu.config import VisualConfig, kitti_hdl64
from vloam_tpu.data import synthetic
from vloam_tpu.ops.depth_map import build_buckets, project_cloud, query_depth
from vloam_tpu.ops.vo_factors import solve_pose_gn_vo
from vloam_tpu.testing.vo_oracle import PointCloudUtilOracle, solve_nls_all

H, W = 376, 1248
K = np.array([[718.856, 0.0, 624.0], [0.0, 718.856, 188.0], [0.0, 0.0, 1.0]])
CAM_T_VELO = np.eye(4)
CAM_T_VELO[:3, :3] = synthetic.CAM_R_WORLD
P34 = np.zeros((3, 4))
P34[:, :3] = K


def _make_frames():
    """Two synthetic frames: lidar cloud @ frame 0, exact feature matches."""
    scene = synthetic.default_scene()
    poses = synthetic.straight_trajectory(2, speed=0.9, yaw_rate=0.02)
    (R0, t0), (R1, t1) = poses
    cloud0 = synthetic.simulate_scan(R0, t0, scene, n_azimuth=900, noise=0.0, seed=0)

    rng = np.random.default_rng(5)
    # features across the image, weighted toward the lidar-covered lower half
    uv0 = np.concatenate([
        np.stack([rng.uniform(30, W - 30, 500), rng.uniform(190, H - 30, 500)], -1),
        np.stack([rng.uniform(30, W - 30, 200), rng.uniform(30, 185, 200)], -1),
    ])
    R_wc0 = R0 @ synthetic.CAM_R_WORLD.T
    R_wc1 = R1 @ synthetic.CAM_R_WORLD.T
    pc0, hit = synthetic.raycast_camera(R_wc0, t0, scene, K, uv0)
    world = (pc0[hit] @ R_wc0.T) + t0
    prev_pts = uv0[hit]
    pc1 = (world - t1) @ R_wc1                     # camera-frame @ frame 1
    uv1 = pc1 @ K.T
    curr_pts = uv1[:, :2] / uv1[:, 2:3]
    ok = (pc1[:, 2] > 0.5) & (curr_pts[:, 0] > 5) & (curr_pts[:, 0] < W - 5) \
        & (curr_pts[:, 1] > 5) & (curr_pts[:, 1] < H - 5)
    prev_pts, curr_pts = prev_pts[ok], curr_pts[ok]

    # ground-truth cam0_curr_T_cam0_last: X1 = R X0 + t
    R_gt = R_wc1.T @ R_wc0
    t_gt = R_wc1.T @ (t0 - t1)
    return cloud0, prev_pts, curr_pts, R_gt, t_gt


@pytest.mark.slow
def test_vo_oracle_parity():
    cfg = kitti_hdl64().replace(
        visual=VisualConfig(img_height=H, img_width=W, depth_spread_gate=0.0),
    )
    vc = cfg.visual
    cloud0, prev_pts, curr_pts, R_gt, t_gt = _make_frames()
    m = len(prev_pts)
    assert m > 400

    # ---- oracle side ------------------------------------------------------
    util = PointCloudUtilOracle(W, H, grid=vc.downsample_grid)
    util.project(cloud0, CAM_T_VELO, np.eye(4), P34)
    util.downsample()
    status = np.ones(m, bool)
    ang_or, t_or, c32, c22, d_or = solve_nls_all(
        prev_pts, curr_pts, status, util, K, vc.remove_vo_outlier)

    # ---- engine side (same matches; int-truncated query coords
    # to isolate depth/assembly semantics from coordinate rounding) --------
    proj = jnp.array(P34 @ CAM_T_VELO, jnp.float32)
    uvz, okp = project_cloud(jnp.array(cloud0), jnp.ones(len(cloud0), bool), proj, vc)
    buckets = build_buckets(uvz, okp, vc)
    q_pts = jnp.array(np.trunc(prev_pts), jnp.float32)
    d_jax = np.asarray(query_depth(buckets, q_pts, vc))

    # 1) per-feature depth agreement ---------------------------------------
    val_or, val_jax = d_or > 0, d_jax > 0
    agree = float(np.mean(val_or == val_jax))
    both = val_or & val_jax
    dz = np.abs(d_or[both] - d_jax[both])
    print(f"depth decision agreement {agree:.4f}; co-valid {both.sum()}; "
          f"mean|dz| {dz.mean():.4f} m; p95 {np.percentile(dz, 95):.4f} m")
    assert agree >= 0.97
    # vs the reference's forgetful incremental bucket mean (it discards the
    # first hit whenever a bucket has >= 2 — the exact segment mean deviates
    # most at depth discontinuities); bounded but not tight:
    assert dz.mean() < 0.15
    assert np.percentile(dz, 95) < 0.6

    # attribution: inject the exact-mean buckets into the oracle and
    # re-query sequentially — any remaining gap is QUERY semantics (5x5
    # neighbourhood, >= 10 gate, sort + weighted 3-NN), which must be exact.
    util2 = PointCloudUtilOracle(W, H, grid=vc.downsample_grid)
    util2.bucket_x = np.asarray(buckets.u)
    util2.bucket_y = np.asarray(buckets.v)
    util2.bucket_depth = np.asarray(buckets.z)
    util2.bucket_count = np.asarray(buckets.count).astype(np.int32)
    d_or2 = np.array([util2.query_depth(x, y) for x, y in np.trunc(prev_pts)])
    both2 = (d_or2 > 0) & val_jax
    dz2 = np.abs(d_or2[both2] - d_jax[both2])
    print(f"exact-mean-bucket query gap: mean {dz2.mean():.6f} m; "
          f"max {dz2.max():.6f} m; decisions equal "
          f"{float(np.mean((d_or2 > 0) == val_jax)):.4f}")
    assert float(np.mean((d_or2 > 0) == val_jax)) >= 0.995
    assert dz2.mean() < 1e-3
    assert np.percentile(dz2, 99) < 1e-2

    # 2) branch counts ------------------------------------------------------
    disp2 = np.sum((np.trunc(curr_pts) - np.trunc(prev_pts)) ** 2, axis=-1)
    gate = disp2 <= vc.remove_vo_outlier ** 2
    n32_jax = int(np.sum(gate & val_jax))
    n22_jax = int(np.sum(gate & ~val_jax))
    print(f"branch counts: oracle 32/22 = {c32}/{c22}, engine = {n32_jax}/{n22_jax}")
    assert abs(n32_jax - c32) <= max(5, m // 50)
    assert abs(n22_jax - c22) <= max(5, m // 50)

    # 3) pose delta ---------------------------------------------------------
    K_inv = np.linalg.inv(K)

    def unproj(uv, d):
        return (np.concatenate([uv * d[:, None], d[:, None]], 1) @ K_inv.T)

    def ray(uv):
        r = np.concatenate([uv, np.ones((len(uv), 1))], 1) @ K_inv.T
        return r[:, :2] / r[:, 2:3]

    tp, tc = np.trunc(prev_pts), np.trunc(curr_pts)
    has_d = jnp.array(gate & val_jax)
    no_d = jnp.array(gate & ~val_jax)
    X0 = jnp.array(unproj(tp, np.where(val_jax, d_jax, 1.0)), jnp.float32)
    pose = solve_pose_gn_vo(
        geo.pose_identity(), X0,
        jnp.array(ray(tp), jnp.float32), jnp.array(ray(tc), jnp.float32),
        has_d, no_d, vc.max_iters, vc.huber_delta, vc.lm_lambda,
    )
    pose = np.asarray(pose)
    t_eng, q_eng = pose[4:], pose[:4]

    theta = np.linalg.norm(ang_or)
    q_or = np.concatenate([np.sin(theta / 2) * ang_or / max(theta, 1e-12),
                           [np.cos(theta / 2)]])
    dq = abs(float(np.dot(q_or, q_eng)))
    rot_gap_deg = np.degrees(2 * np.arccos(min(dq, 1.0)))
    t_gap = np.linalg.norm(t_or - t_eng)
    err_or = np.linalg.norm(t_or - t_gt)
    err_eng = np.linalg.norm(t_eng - t_gt)
    print(f"pose delta: |dt| {t_gap*1e3:.2f} mm, rot {rot_gap_deg*60:.2f} arcmin; "
          f"|t_or - gt| {err_or*1e3:.2f} mm, |t_eng - gt| {err_eng*1e3:.2f} mm")
    assert t_gap < 0.01            # oracle vs engine solver agree to < 1 cm
    assert rot_gap_deg < 0.05
    assert err_eng < 0.03          # and both track the exact ground truth
    assert err_or < 0.03


@pytest.mark.slow
def test_outlier_gate_parity():
    """Corrupted matches must be dropped by BOTH assemblies (the
    remove_VO_outlier gate, visual_odometry.cpp:363-368)."""
    cfg = kitti_hdl64().replace(
        visual=VisualConfig(img_height=H, img_width=W, depth_spread_gate=0.0),
    )
    vc = cfg.visual
    cloud0, prev_pts, curr_pts, _, _ = _make_frames()
    rng = np.random.default_rng(6)
    bad = rng.choice(len(prev_pts), 40, replace=False)
    curr_pts = curr_pts.copy()
    curr_pts[bad] += rng.uniform(150, 400, (40, 2)) * np.sign(rng.normal(size=(40, 2)))

    util = PointCloudUtilOracle(W, H, grid=vc.downsample_grid)
    util.project(cloud0, CAM_T_VELO, np.eye(4), P34)
    util.downsample()
    from vloam_tpu.testing.vo_oracle import assemble_residual_blocks

    blocks, _, c32, c22 = assemble_residual_blocks(
        prev_pts, curr_pts, np.ones(len(prev_pts), bool), util, K, vc.remove_vo_outlier)
    assert c32 + c22 <= len(prev_pts) - 35   # most corrupted matches gated

    disp2 = np.sum((np.trunc(curr_pts) - np.trunc(prev_pts)) ** 2, axis=-1)
    gate = disp2 <= vc.remove_vo_outlier ** 2
    # the engine's gate (models/visual_odometry.py:181-183) drops the same set
    assert int(np.sum(~gate)) >= 35
    assert abs((c32 + c22) - int(np.sum(gate))) <= 5
