"""Sub-profile inside vo_step on the current accelerator."""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time
import numpy as np
import jax
import jax.numpy as jnp

from vloam_tpu.config import kitti_hdl64
from vloam_tpu.data import synthetic
from vloam_tpu.models import frame_graph as fg
from vloam_tpu.ops import image_ops
from vloam_tpu.ops.depth_map import build_buckets, project_cloud, query_depth
from vloam_tpu.ops.gauss_newton import solve_pose_gn
from vloam_tpu.ops import vo_factors
from vloam_tpu import geometry as geo

cfg = kitti_hdl64()
ext = fg.kitti_default_extrinsics()
vc = cfg.visual

rng = np.random.default_rng(0)
img0 = jnp.array(rng.uniform(0, 255, (vc.img_height, vc.img_width)).astype(np.float32))
img1 = jnp.array(rng.uniform(0, 255, (vc.img_height, vc.img_width)).astype(np.float32))
n = cfg.scan.max_points
cloud = jnp.array(rng.normal(0, 20, (n, 3)).astype(np.float32))
cmask = jnp.ones((n,), bool)
proj = ext.P_rect0 @ ext.R_rect0 @ ext.cam_T_velo
K = ext.P_rect0[:, :3]

det_j = jax.jit(lambda im: image_ops.detect_corners(im, vc))
pts, pmask, resp = det_j(img0)
qd_j = jax.jit(lambda b, p: query_depth(b, p, vc))
proj_j = jax.jit(lambda c, m: project_cloud(c, m, proj, vc))
uvz, ok = proj_j(cloud, cmask)
bk_j = jax.jit(lambda u, o: build_buckets(u, o, vc))
buckets = bk_j(uvz, ok)
flow0 = jnp.zeros_like(pts)
lk_j = jax.jit(lambda a, b, p, m, f: image_ops.lk_track_fb(a, b, p, m, vc, f))
cp, tok = lk_j(img0, img1, pts, pmask, flow0)
lk1_j = jax.jit(lambda a, b, p, m, f: image_ops.lk_track(a, b, p, m, vc, f))
_ = lk1_j(img0, img1, pts, pmask, flow0)

K_inv = jnp.linalg.inv(K)
d = jnp.abs(jnp.array(rng.normal(10, 3, (vc.max_features,)).astype(np.float32)))
X0 = jnp.stack([pts[:, 0] * d, pts[:, 1] * d, d], -1) @ K_inv.T
xb0 = pts / 500.0
xb1 = cp / 500.0
hd = pmask
nd = ~pmask

def residuals(p):
    return (
        (vo_factors.reproj_32_residual(p, X0, xb1), hd),
        (vo_factors.epipolar_22_residual(p, xb0, xb1), nd),
    )
gn_j = jax.jit(lambda p0: solve_pose_gn(residuals, p0, vc.max_iters, vc.huber_delta, vc.lm_lambda))
_ = gn_j(geo.pose_identity())

def timeit(name, fn, n_=30):
    small = lambda r: min(jax.tree.leaves(r), key=lambda a: a.size)
    r = fn(); np.asarray(small(r))
    t0 = time.perf_counter()
    for _ in range(n_):
        r = fn()
    np.asarray(small(r))  # force a (tiny) host fetch
    print(f"{name:24s} {(time.perf_counter()-t0)/n_*1000:8.2f} ms")

timeit("detect_corners", lambda: det_j(img0))
timeit("query_depth", lambda: qd_j(buckets, pts))
timeit("lk_track_fb", lambda: lk_j(img0, img1, pts, pmask, flow0))
timeit("lk_track (fwd only)", lambda: lk1_j(img0, img1, pts, pmask, flow0))
timeit("project_cloud", lambda: proj_j(cloud, cmask))
timeit("build_buckets", lambda: bk_j(uvz, ok))
timeit("solve_pose_gn", lambda: gn_j(geo.pose_identity()))
