"""Quantified parity: fixed-shape reformulations vs the NumPy oracle.

The oracle (vloam_tpu/testing/oracle.py) transliterates the reference's
sequential selection/association semantics exactly.  These tests measure the
two documented approximations on synthetic HDL-64 frames and pin the numbers:

  (a) feature selection: greedy masked-argmax rounds with candidate
      pre-reduction (ops/scan_registration.py) vs the sequential
      sort-and-pick loop — measured as per-class set Jaccard;
  (b) association: ring-constrained picks resolved from the fused top-8 NN
      list (models/lidar_odometry._ring_picks) vs the kd-tree + directional
      index scans — measured as pick recall;
  (c) end-to-end: LO pose delta of the production step vs an oracle-
      associated solve — measured as translation/rotation gap.

Thresholds are set ~10-15%% under the measured agreement so regressions trip
without flaking on scene randomness.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vloam_tpu import geometry as geo
from vloam_tpu.config import ScanConfig, kitti_hdl64
from vloam_tpu.data import synthetic
from vloam_tpu.models.lidar_odometry import _ring_picks, init_lo_state, lo_step
from vloam_tpu.ops.gauss_newton import solve_pose_gn
from vloam_tpu.ops import lidar_factors
from vloam_tpu.ops.knn import knn
from vloam_tpu.ops.scan_registration import extract_features
from vloam_tpu.testing import oracle

CFG = kitti_hdl64().replace(
    scan=ScanConfig(ring_cap=1024, max_points=65536, less_flat_cap=16384)
)


def _frames(n, n_azimuth=700, speed=1.0, yaw_rate=0.02):
    scene = synthetic.default_scene()
    poses = synthetic.straight_trajectory(n, speed=speed, yaw_rate=yaw_rate)
    return [
        (
            synthetic.simulate_scan(R, t, scene, n_azimuth=n_azimuth, noise=0.004, seed=i),
            (R, t),
        )
        for i, (R, t) in enumerate(poses)
    ]


def _pt_set(arr, decimals=4):
    return {tuple(np.round(np.asarray(p[:3], np.float64), decimals)) for p in arr}


def _jaccard(a, b):
    return len(a & b) / max(len(a | b), 1)


@pytest.fixture(scope="module")
def extract_jit():
    return jax.jit(lambda p, m: extract_features(p, m, CFG.scan))


@pytest.mark.slow
def test_feature_selection_jaccard_vs_oracle(extract_jit):
    """Approximation (a): per-class selected-set overlap over 8 frames."""
    js, jf, jl = [], [], []
    for pts, _ in _frames(8):
        ofe = oracle.oracle_scan_registration(pts, 64)
        p, m = synthetic.pad_cloud(pts, CFG.scan.max_points)
        fe = extract_jit(jnp.array(p), jnp.array(m))

        mine_sharp = _pt_set(np.asarray(fe.sharp)[np.asarray(fe.sharp_mask)])
        mine_flat = _pt_set(np.asarray(fe.flat)[np.asarray(fe.flat_mask)])
        mine_ls = _pt_set(np.asarray(fe.less_sharp)[np.asarray(fe.less_sharp_mask)])
        js.append(_jaccard(mine_sharp, _pt_set(ofe.sharp)))
        jf.append(_jaccard(mine_flat, _pt_set(ofe.flat)))
        jl.append(_jaccard(mine_ls, _pt_set(ofe.less_sharp)))

    js, jf, jl = map(np.mean, (js, jf, jl))
    print(f"\nJaccard sharp={js:.3f} flat={jf:.3f} less_sharp={jl:.3f}")
    # measured on this scene: sharp 0.890, flat 0.953, less_sharp 0.967
    assert js > 0.80, js
    assert jf > 0.85, jf
    assert jl > 0.90, jl


@pytest.mark.slow
def test_ring_pick_recall_vs_oracle():
    """Approximation (b): top-8 shortcut recall vs exact directional scans.

    Both sides see the SAME clouds (oracle features of consecutive frames)
    and the same pose, isolating the association approximation.
    """
    frames = _frames(4)
    edge_hits = edge_total = 0
    plane_hits = plane_total = 0
    edge_found = plane_found = 0
    for k in range(1, len(frames)):
        prev, (Rp, tp) = frames[k - 1]
        curr, (R, t) = frames[k]
        o_prev = oracle.oracle_scan_registration(prev, 64)
        o_curr = oracle.oracle_scan_registration(curr, 64)

        # true delta as the association pose (post-warm-start conditions)
        q = geo.matrix_to_quat(jnp.array(Rp.T @ R, jnp.float32))
        tt = jnp.array(Rp.T @ (t - tp), jnp.float32)
        pose = geo.pose_from_qt(q, tt)
        qn, tn = np.asarray(q, np.float64), np.asarray(tt, np.float64)

        # ---- edges ----
        cand = jnp.array(o_prev.less_sharp, jnp.float32)
        cmask = jnp.ones((cand.shape[0],), bool)
        qpts = geo.pose_apply(pose, jnp.array(o_curr.sharp[:, :3], jnp.float32))
        d2, idx = knn(qpts, cand[:, :3], cmask, CFG.odom.assoc_k)
        _, j1, _, _, d2_2, j2 = _ring_picks(np.asarray(d2), np.asarray(idx), cand, CFG)
        j1, j2 = np.asarray(j1), np.asarray(j2)
        v2 = np.asarray(d2_2) < CFG.odom.distance_sq_threshold
        mine = {qi: (int(j1[qi]), int(j2[qi])) for qi in range(len(j1)) if v2[qi]}
        for qi, cl, m2 in oracle.oracle_edge_association(
            o_curr.sharp, o_prev.less_sharp, qn, tn
        ):
            edge_total += 1
            if qi in mine:
                edge_found += 1
                if mine[qi] == (cl, m2):
                    edge_hits += 1

        # ---- planes ----
        cand = jnp.array(o_prev.less_flat, jnp.float32)
        cmask = jnp.ones((cand.shape[0],), bool)
        qpts = geo.pose_apply(pose, jnp.array(o_curr.flat[:, :3], jnp.float32))
        d2, idx = knn(qpts, cand[:, :3], cmask, CFG.odom.assoc_k_surf)
        _, j1, d2_2, j2, d2_3, j3 = _ring_picks(np.asarray(d2), np.asarray(idx), cand, CFG)
        thr = CFG.odom.distance_sq_threshold
        v = (np.asarray(d2_2) < thr) & (np.asarray(d2_3) < thr)
        j1, j2, j3 = map(np.asarray, (j1, j2, j3))
        minep = {
            qi: (int(j1[qi]), int(j2[qi]), int(j3[qi])) for qi in range(len(j1)) if v[qi]
        }
        for qi, cj, cl, cm in oracle.oracle_plane_association(
            o_curr.flat, o_prev.less_flat, qn, tn
        ):
            plane_total += 1
            if qi in minep:
                plane_found += 1
                if minep[qi] == (cj, cl, cm):
                    plane_hits += 1

    er = edge_hits / max(edge_total, 1)
    ef = edge_found / max(edge_total, 1)
    pr = plane_hits / max(plane_total, 1)
    pf = plane_found / max(plane_total, 1)
    print(
        f"\nedge recall={er:.3f} (found {ef:.3f}, n={edge_total}) "
        f"plane recall={pr:.3f} (found {pf:.3f}, n={plane_total})"
    )
    # "found" = a correspondence exists where the oracle has one (may pick a
    # different, near-equidistant pair); "recall" = the exact oracle pick.
    # Measured: edge found 0.995 / recall 0.993 @ k=8; plane found 0.954 /
    # recall 0.952 @ k=16 (0.84 @ k=8, 0.996 @ k=32 — the config comment
    # records the fps ladder behind the assoc_k_surf=16 default).
    assert ef > 0.97, (ef, edge_total)
    assert pf > 0.92, (pf, plane_total)
    assert er > 0.96, (er, edge_total)
    assert pr > 0.92, (pr, plane_total)


@pytest.mark.slow
def test_lo_pose_delta_vs_oracle_association():
    """Approximation (c): production lo_step vs a solve driven by the
    oracle's exact associations, on identical consecutive frames."""
    frames = _frames(3)
    state = init_lo_state(CFG)
    step = jax.jit(lambda s, p, m: lo_step(s, extract_features(p, m, CFG.scan), CFG)[:2])
    deltas_mine = []
    for pts, _ in frames:
        p, m = synthetic.pad_cloud(pts, CFG.scan.max_points)
        state, delta = step(state, jnp.array(p), jnp.array(m))
        deltas_mine.append(np.asarray(delta))

    gaps_t, gaps_r = [], []
    for k in range(1, len(frames)):
        o_prev = oracle.oracle_scan_registration(frames[k - 1][0], 64)
        o_curr = oracle.oracle_scan_registration(frames[k][0], 64)
        pose = geo.pose_identity()
        for _ in range(CFG.odom.outer_iters):
            qn = np.asarray(geo.pose_q(pose), np.float64)
            tn = np.asarray(geo.pose_t(pose), np.float64)
            ea = oracle.oracle_edge_association(o_curr.sharp, o_prev.less_sharp, qn, tn)
            pa = oracle.oracle_plane_association(o_curr.flat, o_prev.less_flat, qn, tn)
            p_e = jnp.array([o_curr.sharp[i, :3] for i, _, _ in ea], jnp.float32).reshape(-1, 3)
            a_e = jnp.array([o_prev.less_sharp[c, :3] for _, c, _ in ea], jnp.float32).reshape(-1, 3)
            b_e = jnp.array([o_prev.less_sharp[m2, :3] for _, _, m2 in ea], jnp.float32).reshape(-1, 3)
            p_s = jnp.array([o_curr.flat[i, :3] for i, _, _, _ in pa], jnp.float32).reshape(-1, 3)
            pj = jnp.array([o_prev.less_flat[j, :3] for _, j, _, _ in pa], jnp.float32).reshape(-1, 3)
            pl = jnp.array([o_prev.less_flat[l, :3] for _, _, l, _ in pa], jnp.float32).reshape(-1, 3)
            pm = jnp.array([o_prev.less_flat[m3, :3] for _, _, _, m3 in pa], jnp.float32).reshape(-1, 3)
            n_s, d_s = lidar_factors.plane_from_three_points(pj, pl, pm)

            def residuals(pp):
                r_e = lidar_factors.edge_residual(pp, p_e, a_e, b_e)
                r_s = lidar_factors.plane_residual(pp, p_s, n_s, d_s)
                ve = jnp.ones((p_e.shape[0],), bool)
                vs = jnp.ones((p_s.shape[0],), bool)
                return ((r_e, ve), (r_s, vs))

            pose = solve_pose_gn(
                residuals, pose, CFG.odom.inner_iters, CFG.odom.huber_delta,
                CFG.odom.lm_lambda,
            )
        d_oracle = np.asarray(pose)
        d_mine = deltas_mine[k]
        gaps_t.append(np.linalg.norm(d_mine[4:] - d_oracle[4:]))
        qd = geo.quat_mul(geo.quat_conj(jnp.array(d_oracle[:4])), jnp.array(d_mine[:4]))
        gaps_r.append(2 * np.arccos(min(abs(float(qd[3])), 1.0)))

    print(f"\nLO delta gap: t={[f'{g:.4f}' for g in gaps_t]} m, r={[f'{g:.5f}' for g in gaps_r]} rad")
    assert max(gaps_t) < 0.03, gaps_t       # <= 3 cm on ~1 m/frame motion
    assert max(gaps_r) < 0.005, gaps_r      # <= 0.3 deg
