"""Worker process for the multi-host CPU rehearsal — see launch_multihost.py.

Each process owns a slice of a global CPU mesh (jax.distributed over
loopback), runs the sharded mapping step over the GLOBAL mesh — collectives
cross the process boundary, as they would cross the network between hosts
— and checks pose agreement against a process-local single-device run
of the same frames (SURVEY §5.8 / BASELINE "≥2 hosts" north star).

Invoked as:
  python tools/multihost_worker.py <coordinator> <num_procs> <proc_id> <out.json>
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOCAL_DEVICES = 4


def main() -> None:
    coordinator, num_procs, proc_id, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()

    import jax

    from vloam_tpu.parallel.mesh import init_distributed

    init_distributed(
        coordinator_address=coordinator, num_processes=num_procs, process_id=proc_id
    )

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vloam_tpu.config import MappingConfig, ScanConfig, kitti_hdl64
    from vloam_tpu.data import synthetic
    from vloam_tpu.models.laser_mapping import init_map_state, mapping_step
    from vloam_tpu.models.lidar_odometry import init_lo_state, lo_step
    from vloam_tpu.ops.scan_registration import extract_features
    from vloam_tpu.parallel.mapping_shard import make_sharded_step
    from vloam_tpu.parallel.mesh import map_mesh

    n_global = num_procs * LOCAL_DEVICES
    assert len(jax.devices()) == n_global, (len(jax.devices()), n_global)

    cfg = kitti_hdl64().replace(
        scan=ScanConfig(ring_cap=512, max_points=32768, less_flat_cap=8192),
        mapping=MappingConfig(
            grid_w=7, grid_h=7, grid_d=3,
            corner_cube_cap=512, surf_cube_cap=1024,
            corner_stack_cap=1024, surf_stack_cap=2048,
        ),
    )
    mesh = map_mesh(n_global)
    rep = NamedSharding(mesh, P())

    # identical frame stream on every process (same seeds)
    scene = synthetic.default_scene()
    poses = synthetic.straight_trajectory(3, speed=0.8, yaw_rate=0.01)
    lo = init_lo_state(cfg)
    frames = []
    for i, (R, t) in enumerate(poses):
        pts = synthetic.simulate_scan(R, t, scene, n_azimuth=500, noise=0.005, seed=i)
        p, m = synthetic.pad_cloud(pts, cfg.scan.max_points)
        feats = extract_features(jnp.array(p), jnp.array(m), cfg.scan)
        lo, _, wodom, _ = lo_step(lo, feats, cfg)
        frames.append((feats, wodom))

    # single-process reference (local devices only)
    mp_ref = init_map_state(cfg)
    ref_poses = []
    for feats, wodom in frames:
        mp_ref, pose_ref = mapping_step(
            mp_ref, feats.less_sharp, feats.less_sharp_mask,
            feats.less_flat, feats.less_flat_mask, wodom, cfg,
        )
        ref_poses.append(np.asarray(pose_ref))

    # global sharded run: state materialized ON the global mesh by jit
    step = make_sharded_step(cfg, mesh)
    from vloam_tpu.parallel.mapping_shard import map_state_specs

    shardings = jax.tree.map(
        lambda sp: NamedSharding(mesh, sp), map_state_specs("map")
    )
    mp = jax.jit(
        lambda: init_map_state(cfg, n_shards=n_global), out_shardings=shardings
    )()

    def to_global(x):
        return multihost_utils.host_local_array_to_global_array(np.asarray(x), mesh, P())

    gaps = []
    for (feats, wodom), pose_ref in zip(frames, ref_poses):
        mp, pose_w = step(
            mp, to_global(feats.less_sharp), to_global(feats.less_sharp_mask),
            to_global(feats.less_flat), to_global(feats.less_flat_mask),
            to_global(wodom),
        )
        pose_local = np.asarray(pose_w.addressable_data(0))
        gaps.append(float(np.max(np.abs(pose_local - pose_ref))))

    # ---- FULL coupled step (VO + scan-reg + LO + sharded mapping) over the
    # same global mesh: the flagship multi-chip program of
    # parallel/vloam_shard.py, exercised across the process boundary.
    from vloam_tpu.models import frame_graph as fg
    from vloam_tpu.models.vloam import init_vloam_state, vloam_step
    from vloam_tpu.parallel.vloam_shard import make_sharded_vloam_step, state_partition_specs

    ext = fg.kitti_default_extrinsics()
    full_cfg = cfg.replace(
        scan=ScanConfig(ring_cap=128, max_points=8192, less_flat_cap=8192)
    )
    full_step = make_sharded_vloam_step(full_cfg, ext, mesh)
    specs = state_partition_specs(init_vloam_state(full_cfg))
    state_shardings = jax.tree.map(lambda sp: NamedSharding(mesh, sp), specs)
    vstate = jax.jit(
        lambda: init_vloam_state(full_cfg, n_map_shards=n_global),
        out_shardings=state_shardings,
    )()
    rng = np.random.default_rng(7)
    n = full_cfg.scan.max_points
    az = rng.uniform(-np.pi, np.pi, n)
    el = np.radians(rng.uniform(-24.0, 1.9, n))
    r = rng.uniform(5.5, 60.0, n)
    pts = np.stack(
        [r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], -1
    ).astype(np.float32)
    img = rng.uniform(0, 255, (full_cfg.visual.img_height, full_cfg.visual.img_width)).astype(
        np.float32
    )
    # process-local single-device reference over the SAME frames: the full
    # coupled step's cross-process agreement is a comparison, not just an
    # executes-without-NaN assertion (round-3 weak #7).
    ref_vstate = init_vloam_state(full_cfg)
    ref_step = jax.jit(lambda s, i, c, m: vloam_step(s, i, c, m, ext, full_cfg))
    full_gaps = []
    for _ in range(2):
        vstate, out = full_step(
            vstate, to_global(img), to_global(pts), to_global(np.ones((n,), bool))
        )
        ref_vstate, ref_out = ref_step(
            ref_vstate, jnp.array(img), jnp.array(pts), jnp.ones((n,), bool)
        )
        mo = np.asarray(out.mo_pose.addressable_data(0))
        full_gaps.append(float(np.max(np.abs(mo - np.asarray(ref_out.mo_pose)))))
    full_ok = bool(np.isfinite(full_gaps).all()) and max(full_gaps) < 1e-2

    multihost_utils.sync_global_devices("vloam_multihost_done")
    if proc_id == 0:
        # Pose agreement tolerance: the shard-merge reorders float reductions
        # and flips keep/drop decisions for points exactly on the dedup-gate
        # voxel boundary, so the maps (and hence later-frame poses) drift
        # apart by a few mm over frames — same phenomenon and order as the
        # single-process virtual-mesh test (test_parallel_mapping, atol 5e-3).
        result = {
            "ok": bool(max(gaps) < 1e-2) and full_ok,
            "num_processes": num_procs,
            "local_devices": LOCAL_DEVICES,
            "global_devices": n_global,
            "frames": len(frames),
            "max_pose_gap_vs_single_process": max(gaps),
            "per_frame_gap": gaps,
            "full_coupled_step_ok": full_ok,
            "full_coupled_max_pose_gap_vs_single_device": max(full_gaps),
        }
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps(result))
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
