"""Per-stage timing of the vloam pipeline on the current accelerator."""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time
import numpy as np
import jax
import jax.numpy as jnp

from vloam_tpu.config import kitti_hdl64
from vloam_tpu.data import synthetic
from vloam_tpu.models import frame_graph as fg
from vloam_tpu.models.vloam import init_vloam_state, vloam_step
from vloam_tpu.models.visual_odometry import vo_step
from vloam_tpu.models.lidar_odometry import lo_step
from vloam_tpu.models.laser_mapping import mapping_step
from vloam_tpu.ops.scan_registration import extract_features

cfg = kitti_hdl64()
ext = fg.kitti_default_extrinsics()
vc = cfg.visual

boxes = synthetic.default_scene()
poses = synthetic.straight_trajectory(6, speed=0.8, yaw_rate=0.005)
K = np.asarray(ext.P_rect0)[:, :3].astype(np.float64)
rng = np.random.default_rng(11)
uv0 = np.stack([rng.uniform(20, vc.img_width - 20, 1400), rng.uniform(20, vc.img_height - 20, 1400)], -1)
R_wc0 = poses[0][0] @ synthetic.CAM_R_WORLD.T
pc0, hit = synthetic.raycast_camera(R_wc0, poses[0][1], boxes, K, uv0)
blob_world = (pc0[hit] @ R_wc0.T) + poses[0][1]

frames = []
for i, (R, t) in enumerate(poses):
    cloud = synthetic.simulate_scan(R, t, boxes, n_azimuth=1800, noise=0.005, seed=i)
    R_wc = R @ synthetic.CAM_R_WORLD.T
    img = synthetic.render_blob_image((blob_world - t) @ R_wc, K, vc.img_height, vc.img_width)
    pts, mask = synthetic.pad_cloud(cloud, cfg.scan.max_points)
    frames.append((jnp.array(img), jnp.array(pts), jnp.array(mask)))

step = jax.jit(lambda s, i, c, m: vloam_step(s, i, c, m, ext, cfg))
state = init_vloam_state(cfg)
for f in frames[:2]:
    state, out = step(state, *f)
out.mo_pose.block_until_ready()

# stage jits
proj = ext.P_rect0 @ ext.R_rect0 @ ext.cam_T_velo
Kj = ext.P_rect0[:, :3]

vo_j = jax.jit(lambda vs, img, c, m, prior: vo_step(vs, img, c, m, proj, Kj, cfg, lo_prior=prior))
feat_j = jax.jit(lambda c, m: extract_features(c, m, cfg.scan))
lo_j = jax.jit(lambda ls, feats: lo_step(ls, feats, cfg, vo_prior=None)[:3])
map_j = jax.jit(lambda mp, ls_, lsm, lf, lfm, w: mapping_step(mp, ls_, lsm, lf, lfm, w, cfg))

img, cloud, mask = frames[3]
feats = feat_j(cloud, mask)
ls, ld, wl = lo_j(state.lo, feats)
mp, wm = map_j(state.mp, feats.less_sharp, feats.less_sharp_mask, feats.less_flat, feats.less_flat_mask, wl)
vs, d = vo_j(state.vo, img, cloud, mask, state.cam0_curr_LOT_cam0_prev)
jax.block_until_ready((feats, ls, mp, vs))

def timeit(name, fn, n=20):
    small = lambda r: min(jax.tree.leaves(r), key=lambda a: a.size)
    r = fn(); np.asarray(small(r))
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn()
    np.asarray(small(r))  # force a (tiny) host fetch
    dt = (time.perf_counter() - t0) / n * 1000
    print(f"{name:24s} {dt:8.2f} ms")
    return dt

tot = 0
tot += timeit("vo_step", lambda: vo_j(state.vo, img, cloud, mask, state.cam0_curr_LOT_cam0_prev))
tot += timeit("extract_features", lambda: feat_j(cloud, mask))
tot += timeit("lo_step", lambda: lo_j(state.lo, feats))
tot += timeit("mapping_step", lambda: map_j(state.mp, feats.less_sharp, feats.less_sharp_mask, feats.less_flat, feats.less_flat_mask, wl))
print(f"{'SUM':24s} {tot:8.2f} ms  ({1000/tot:.1f} fps)")
timeit("full vloam_step", lambda: step(state, img, cloud, mask)[1].mo_pose, n=20)
