"""Quantify the mapping-stage approximation: insert-dedup vs reference-exact.

The MO stage has one documented deviation from the reference with accuracy
impact: map density control.  The reference appends every registered point
and re-voxel-filters the touched cubes each frame
(/root/reference/src/lidar_odometry_mapping/src/laser_mapping.cpp:741-808);
our default gates insertions on nearest-map-point distance instead
(MappingConfig.insert_dedup=True — the fast path), with
``insert_dedup=False`` restoring the reference-exact insert + re-voxelise.

This test runs the SAME synthetic drive through both policies and pins the
MO world-pose gap — converting "should be equivalent" into a committed
number, like tests/test_oracle_parity.py does for selection/association.

The 5-NN association itself needs no policy oracle here: both k-NN paths
are exact brute force (== the reference's kd-tree result); the GPU kernel's
contract is pinned by test_pallas_knn.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vloam_tpu.config import MappingConfig, ScanConfig, kitti_hdl64
from vloam_tpu.data import synthetic
from vloam_tpu.models.laser_mapping import init_map_state, mapping_step
from vloam_tpu.models.lidar_odometry import init_lo_state, lo_step
from vloam_tpu.ops.scan_registration import extract_features

MAP_KW = dict(
    grid_w=7, grid_h=7, grid_d=3,
    corner_cube_cap=1024, surf_cube_cap=2048,
    corner_stack_cap=2048, surf_stack_cap=4096,
)


@pytest.mark.slow
def test_insert_dedup_pose_gap_vs_reference_exact_revoxelize():
    base = kitti_hdl64().replace(
        scan=ScanConfig(ring_cap=1024, max_points=65536, less_flat_cap=16384)
    )
    scene = synthetic.default_scene()
    poses = synthetic.straight_trajectory(8, speed=0.9, yaw_rate=0.01)

    # shared front half: identical features + LO poses for both policies
    cfg0 = base.replace(mapping=MappingConfig(**MAP_KW))
    lo = init_lo_state(cfg0)
    frames = []
    for i, (R, t) in enumerate(poses):
        pts = synthetic.simulate_scan(R, t, scene, n_azimuth=700, noise=0.005, seed=i)
        p, m = synthetic.pad_cloud(pts, cfg0.scan.max_points)
        feats = extract_features(jnp.array(p), jnp.array(m), cfg0.scan)
        lo, _, wodom, _ = lo_step(lo, feats, cfg0)
        frames.append((feats, wodom))

    def run(dedup):
        cfg = base.replace(mapping=MappingConfig(**MAP_KW, insert_dedup=dedup))
        mp = init_map_state(cfg)
        out = []
        for feats, wodom in frames:
            mp, pose_w = mapping_step(
                mp, feats.less_sharp, feats.less_sharp_mask,
                feats.less_flat, feats.less_flat_mask, wodom, cfg,
            )
            out.append(np.asarray(pose_w))
        return np.stack(out), mp

    poses_fast, mp_fast = run(True)
    poses_ref, mp_ref = run(False)

    gt = np.stack([t for _, t in poses])
    err_fast = np.linalg.norm(poses_fast[:, 4:] - gt, axis=1)
    err_ref = np.linalg.norm(poses_ref[:, 4:] - gt, axis=1)
    gap_t = np.linalg.norm(poses_fast[:, 4:] - poses_ref[:, 4:], axis=1)
    n_fast = int(mp_fast.corner_cnt.sum() + mp_fast.surf_cnt.sum())
    n_ref = int(mp_ref.corner_cnt.sum() + mp_ref.surf_cnt.sum())
    path_len = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    print(
        f"\nMO vs gt: fast={[f'{g:.3f}' for g in err_fast]} m, "
        f"ref={[f'{g:.3f}' for g in err_ref]} m; policy gap "
        f"{gap_t[-1]:.3f} m over {path_len:.1f} m; map pts fast={n_fast} ref={n_ref}"
    )
    # Measured: the policies diverge by ~1.5% of path (different map content
    # -> different fits -> different drift), but BOTH track ground truth at
    # the same error level; the fast path must not be meaningfully worse.
    assert np.mean(err_fast) < 1.5 * np.mean(err_ref) + 0.01, (
        np.mean(err_fast), np.mean(err_ref)
    )
    assert np.max(err_fast) / max(path_len, 1e-9) < 0.03, err_fast
    # density: dedup gates at insert_dedup_factor*resolution (finer than the
    # re-voxelise leaf), so the fast path keeps MORE points — bounded by 2x.
    assert n_ref < n_fast < 2 * n_ref, (n_fast, n_ref)
