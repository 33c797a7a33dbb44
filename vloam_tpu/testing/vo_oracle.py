"""Reference-semantics oracle for the VO half — exact NumPy transliteration.

Like testing/oracle.py (scan registration / LO association), this module
re-implements the reference's SEQUENTIAL algorithms loops-and-all so the
fixed-shape reformulations in ops/depth_map.py and models/visual_odometry.py can be
measured against the original semantics:

  * ``PointCloudUtilOracle`` — projection (point_cloud_util.cpp:183-219),
    5-px bucket downsampling with the reference's exact incremental
    averaging (:256-324 — note it divides by the PRE-increment count, so a
    bucket's final value is the mean of its 2nd..nth hits, forgetting the
    first whenever n >= 2), and ``query_depth`` (:381-487): 5x5-bucket
    neighbourhood, >= 10 occupied neighbours else -1, inverse-distance-
    weighted 3-NN with the 1e-4 epsilon.
  * ``solve_nls_all`` — the residual assembly + outlier gate of
    visual_odometry.cpp:339-482 (int-truncated pixel coords, squared-
    displacement gate, depth0>0 -> CostFunctor32 3D-2D else CostFunctor22
    2D-2D, ceres_cost_function.h:58-100,151-189) solved over (angle-axis,
    t) with Huber(0.1) via scipy's trust-region least squares (the Ceres
    analogue).

This is a parity MEASUREMENT INSTRUMENT: deliberately slow, sequential,
and outside the hot path.  Do not vectorise it — its value is exactness.
"""

from __future__ import annotations

import numpy as np


class PointCloudUtilOracle:
    """Sequential twin of vloam::PointCloudUtil (projection + buckets + query)."""

    def __init__(self, img_width: int, img_height: int, grid: int = 5):
        self.img_width = img_width
        self.img_height = img_height
        self.grid = grid
        self.new_width = int(np.ceil(img_width / grid))
        self.new_height = int(np.ceil(img_height / grid))
        self.bucket_x = np.zeros((self.new_width, self.new_height), np.float32)
        self.bucket_y = np.zeros((self.new_width, self.new_height), np.float32)
        self.bucket_depth = np.zeros((self.new_width, self.new_height), np.float32)
        self.bucket_count = np.zeros((self.new_width, self.new_height), np.int32)

    def project(self, cloud_velo: np.ndarray, cam_T_velo: np.ndarray,
                rect0_T_cam: np.ndarray, P_rect0: np.ndarray) -> np.ndarray:
        """point_cloud_util.cpp:183-219: X~ . camT^T . rectT^T . P^T, keep
        z > 0.1, normalise to (u, v, depth)."""
        n = len(cloud_velo)
        tilde = np.ones((n, 4), np.float32)
        tilde[:, :3] = cloud_velo.astype(np.float32)
        p3d = tilde @ cam_T_velo.T.astype(np.float32) \
                    @ rect0_T_cam.T.astype(np.float32) @ P_rect0.T.astype(np.float32)
        front = p3d[p3d[:, 2] > 0.1].copy()
        front[:, 0] /= front[:, 2]
        front[:, 1] /= front[:, 2]
        self.point_cloud_2d = front
        return front

    def downsample(self) -> int:
        """point_cloud_util.cpp:256-324 — EXACT incremental averaging: the
        update divides by the pre-increment count, so the first hit is
        forgotten as soon as a second arrives."""
        g = float(self.grid)
        count = 0
        for u, v, z in self.point_cloud_2d:
            ix = int(u / g)
            iy = int(v / g)
            if 0 <= ix < self.new_width and 0 <= iy < self.new_height:
                c = self.bucket_count[ix, iy]
                if c == 0:
                    self.bucket_x[ix, iy] = u
                    self.bucket_y[ix, iy] = v
                    self.bucket_depth[ix, iy] = z
                    count += 1
                else:
                    self.bucket_x[ix, iy] += (u - self.bucket_x[ix, iy]) / c
                    self.bucket_y[ix, iy] += (v - self.bucket_y[ix, iy]) / c
                    self.bucket_depth[ix, iy] += (z - self.bucket_depth[ix, iy]) / c
                self.bucket_count[ix, iy] += 1
        return count

    def query_depth(self, x: float, y: float, searching_radius: int = 2) -> float:
        """point_cloud_util.cpp:381-487."""
        ix = int(x / self.grid)
        iy = int(y / self.grid)
        neighbors = []
        for ix_ in range(ix - searching_radius, ix + searching_radius + 1):
            for iy_ in range(iy - searching_radius, iy + searching_radius + 1):
                if (0 <= ix_ < self.new_width and 0 <= iy_ < self.new_height
                        and self.bucket_count[ix_, iy_] > 0):
                    bx = self.bucket_x[ix_, iy_]
                    by = self.bucket_y[ix_, iy_]
                    bz = self.bucket_depth[ix_, iy_]
                    d = np.sqrt((x - bx) ** 2 + (y - by) ** 2)
                    neighbors.append((bx, by, bz, d))
        if len(neighbors) < 10:
            return -1.0
        neighbors.sort(key=lambda n: n[3])
        n0, n1, n2 = neighbors[0], neighbors[1], neighbors[2]
        z = (n0[2] * n1[3] * n2[3] + n1[2] * n0[3] * n2[3] + n2[2] * n0[3] * n1[3]) / (
            1e-4 + n1[3] * n2[3] + n0[3] * n2[3] + n0[3] * n1[3])
        assert z > 0
        return float(z)


def _angle_axis_rotate(angles: np.ndarray, X: np.ndarray) -> np.ndarray:
    """ceres::AngleAxisRotatePoint (Rodrigues)."""
    theta = np.linalg.norm(angles)
    if theta < 1e-12:
        return X + np.cross(angles, X)
    k = angles / theta
    return (X * np.cos(theta) + np.cross(k, X) * np.sin(theta)
            + k * np.dot(k, X) * (1.0 - np.cos(theta)))


def assemble_residual_blocks(
    prev_pts: np.ndarray,      # (M, 2) float pixel coords, previous frame
    curr_pts: np.ndarray,      # (M, 2) tracked/matched positions, current frame
    status: np.ndarray,        # (M,) bool valid-match flags
    util_prev: PointCloudUtilOracle,
    K: np.ndarray,             # (3, 3) P_rect0[:, :3]
    remove_vo_outlier: float = 100.0,
):
    """visual_odometry.cpp:339-475 — per match: int-truncate coords, gate on
    squared displacement, query prev depth, branch 3D-2D vs 2D-2D.

    Returns (blocks, depth0s, counter32, counter22); blocks is a list of
    ("32", X0, xb1) / ("22", xb0, xb1) tuples in reference order."""
    K_inv = np.linalg.inv(K.astype(np.float64))
    blocks = []
    depth0s = np.full(len(prev_pts), np.nan)
    counter32 = counter22 = 0
    for j in range(len(prev_pts)):
        if not status[j]:
            continue
        prev_x, prev_y = int(prev_pts[j, 0]), int(prev_pts[j, 1])
        curr_x, curr_y = int(curr_pts[j, 0]), int(curr_pts[j, 1])
        if remove_vo_outlier > 0:
            if (prev_x - curr_x) ** 2 + (prev_y - curr_y) ** 2 > remove_vo_outlier ** 2:
                continue
        depth0 = util_prev.query_depth(prev_x, prev_y)
        depth0s[j] = depth0
        if depth0 > 0:
            X0 = K_inv @ np.array([prev_x * depth0, prev_y * depth0, depth0])
            ray1 = K_inv @ np.array([curr_x, curr_y, 1.0])
            blocks.append(("32", X0, ray1[:2] / ray1[2]))
            counter32 += 1
        else:
            ray0 = K_inv @ np.array([prev_x, prev_y, 1.0])
            ray1 = K_inv @ np.array([curr_x, curr_y, 1.0])
            blocks.append(("22", ray0[:2] / ray0[2], ray1[:2] / ray1[2]))
            counter22 += 1
    return blocks, depth0s, counter32, counter22


def _residual_vector(params: np.ndarray, blocks) -> np.ndarray:
    angles, t = params[:3], params[3:]
    out = []
    for kind, a, b in blocks:
        if kind == "32":
            RX = _angle_axis_rotate(angles, a) + t
            out.append(RX[0] - RX[2] * b[0])
            out.append(RX[1] - RX[2] * b[1])
        else:
            X0 = np.array([a[0], a[1], 1.0])
            X1 = np.array([b[0], b[1], 1.0])
            RX0 = _angle_axis_rotate(angles, X0)
            out.append(np.dot(X1, np.cross(t, RX0)))
    return np.asarray(out)


def solve_nls_all(
    prev_pts, curr_pts, status, util_prev, K,
    remove_vo_outlier: float = 100.0,
    seed_angles=None, seed_t=None,
    huber_delta: float = 0.1,
):
    """The full solveNlsAll oracle: assembly + Huber(0.1) least squares over
    (angle-axis, t).  Returns (angles (3,), t (3,), counter32, counter22,
    depth0s (M,))."""
    from scipy.optimize import least_squares

    blocks, depth0s, c32, c22 = assemble_residual_blocks(
        prev_pts, curr_pts, status, util_prev, K, remove_vo_outlier)
    x0 = np.zeros(6)
    if seed_angles is not None:
        x0[:3] = seed_angles
    if seed_t is not None:
        x0[3:] = seed_t
    res = least_squares(
        _residual_vector, x0, args=(blocks,),
        loss="huber", f_scale=huber_delta, max_nfev=400,
    )
    return res.x[:3], res.x[3:], c32, c22, depth0s
