"""Checkpoint/resume roundtrip of the full pipeline state."""

import numpy as np
import jax
import pytest

from vloam_tpu.config import MappingConfig, ScanConfig, kitti_hdl64
from vloam_tpu.models.vloam import init_vloam_state
from vloam_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

CFG = kitti_hdl64().replace(
    scan=ScanConfig(ring_cap=128, max_points=4096, less_flat_cap=4096),
    mapping=MappingConfig(grid_w=5, grid_h=5, grid_d=3, corner_cube_cap=128,
                          surf_cube_cap=256, corner_stack_cap=256, surf_stack_cap=512),
)


def test_checkpoint_roundtrip(tmp_path, rng):
    state = init_vloam_state(CFG)
    # mutate a few leaves so the roundtrip is non-trivial
    state = state._replace(
        world_VOT_base=state.world_VOT_base.at[4].set(3.25),
        count=state.count + 17,
        mp=state.mp._replace(corner_cnt=state.mp.corner_cnt.at[3].set(9)),
    )
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state, 17)

    fresh = init_vloam_state(CFG)
    restored, frame = load_checkpoint(path, fresh)
    assert frame == 17
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_driver_resume_equals_uninterrupted(tmp_path):
    """End-to-end lossless resume: a run interrupted after a
    mid-run checkpoint, resumed, must produce byte-identical trajectory
    files AND identical refined output to an uninterrupted run — including
    the f64 host chains, loop-closure keyframes, and world history that
    live outside the device pytree."""
    from vloam_tpu.data import synthetic
    from vloam_tpu.models import frame_graph as fg
    from vloam_tpu.runtime.driver import VloamDriver

    n = 10
    scene = synthetic.default_scene()
    poses = synthetic.straight_trajectory(n, speed=0.8, yaw_rate=0.004)
    clouds = [
        synthetic.simulate_scan(R, t, scene, n_azimuth=300, noise=0.005, seed=i)
        for i, (R, t) in enumerate(poses)
    ]
    ext = fg.kitti_default_extrinsics()
    kw = dict(refine=True, loop_closure=True, keyframe_every=3)

    # --- uninterrupted reference run -----------------------------------
    out_a = str(tmp_path / "a")
    da = VloamDriver(CFG, ext, out_dir=out_a, **kw)
    for c in clouds:
        da.process(None, c)
    ref_a = da.refine_trajectory()
    da.close()

    # --- interrupted run: checkpoint at 6, "crash" at 8 ----------------
    out_b = str(tmp_path / "b")
    ck = str(tmp_path / "ck")
    db = VloamDriver(CFG, ext, out_dir=out_b, checkpoint_dir=ck,
                     checkpoint_every=6, **kw)
    for c in clouds[:8]:
        db.process(None, c)
    del db                                   # no close(): simulated crash

    # --- resume and finish ---------------------------------------------
    dc = VloamDriver(CFG, ext, out_dir=out_b, **kw)
    start = dc.restore_checkpoint(str(tmp_path / "ck" / "ckpt_000006"))
    assert start == 6
    assert sorted(dc._keyframes) == [0, 3]   # keyframes survive the resume
    assert len(dc._world_hist) == 6
    for c in clouds[6:]:
        dc.process(None, c)
    ref_c = dc.refine_trajectory()
    dc.close()

    for name in ("VO1.txt", "LO1.txt", "MO1.txt", "MO1_refined.txt"):
        with open(f"{out_a}/{name}") as fa, open(f"{out_b}/{name}") as fb:
            assert fa.read() == fb.read(), f"{name} differs after resume"
    np.testing.assert_array_equal(ref_a, ref_c)


def test_checkpoint_roundtrip_sharded_map(tmp_path):
    """Distributed-job resume: snapshot a cube-SHARDED map state, restore,
    re-place on the mesh, and verify the continued sharded step agrees with
    an uninterrupted run (resumable multi-chip mapping jobs)."""
    import jax.numpy as jnp

    from vloam_tpu.data import synthetic
    from vloam_tpu.models.laser_mapping import init_map_state
    from vloam_tpu.models.lidar_odometry import init_lo_state, lo_step
    from vloam_tpu.ops.scan_registration import extract_features
    from vloam_tpu.parallel.mapping_shard import make_sharded_step
    from vloam_tpu.parallel.mesh import map_mesh, shard_map_state

    n_dev = len(jax.devices())
    mesh = map_mesh(n_dev)
    step = make_sharded_step(CFG, mesh)

    scene = synthetic.default_scene()
    lo = init_lo_state(CFG)
    frames = []
    for i, (R, t) in enumerate(synthetic.straight_trajectory(3, speed=0.8)):
        pts = synthetic.simulate_scan(R, t, scene, n_azimuth=300, noise=0.005, seed=i)
        p, m = synthetic.pad_cloud(pts, CFG.scan.max_points)
        feats = extract_features(jnp.array(p), jnp.array(m), CFG.scan)
        lo, _, wodom, _ = lo_step(lo, feats, CFG)
        frames.append((feats, wodom))

    def feed(mp, fr):
        feats, wodom = fr
        return step(mp, feats.less_sharp, feats.less_sharp_mask,
                    feats.less_flat, feats.less_flat_mask, wodom)

    mp = shard_map_state(init_map_state(CFG, n_shards=n_dev), mesh)
    mp, _ = feed(mp, frames[0])
    mp, _ = feed(mp, frames[1])
    path = str(tmp_path / "ckpt_sharded")
    save_checkpoint(path, mp, 2)                     # gathers to host
    mp_cont, pose_cont = feed(mp, frames[2])         # uninterrupted

    template = init_map_state(CFG, n_shards=n_dev)
    restored, frame = load_checkpoint(path, template)
    assert frame == 2
    mp_res = shard_map_state(restored, mesh)         # re-place on the mesh
    assert mp_res.cube_pts.sharding.is_fully_replicated is False
    _, pose_res = feed(mp_res, frames[2])
    np.testing.assert_allclose(np.asarray(pose_res), np.asarray(pose_cont), atol=1e-6)


def test_checkpoint_rejects_mismatched_template(tmp_path):
    state = init_vloam_state(CFG)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state, 3)
    other = init_vloam_state(CFG.replace(
        mapping=MappingConfig(grid_w=5, grid_h=5, grid_d=3, corner_cube_cap=64,
                              surf_cube_cap=256, corner_stack_cap=256,
                              surf_stack_cap=512)))
    with pytest.raises(ValueError, match="leaf"):
        load_checkpoint(path, other)
