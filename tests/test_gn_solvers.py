"""The GN solves the pipeline runs (lidar_factors.solve_pose_gn_lidar for LO
and MO, vo_factors.solve_pose_gn_vo for VO) on problems with a known pose."""

import numpy as np
import jax.numpy as jnp
import pytest

from vloam_tpu import geometry as geo
from vloam_tpu.ops.lidar_factors import solve_pose_gn_lidar
from vloam_tpu.ops.vo_factors import solve_pose_gn_vo

HUBER, LM = 0.1, 1e-4


def _lidar_problem(rng, be=1024, bs=2048, noise=0.002):
    """Points on lines/planes observed from a perturbed pose; the true pose
    is the known inverse perturbation."""
    aa = rng.normal(0, 0.02, 3)
    t_true = rng.normal(0, 0.3, 3)
    pose_true = geo.pose_from_qt(
        geo.angle_axis_to_quat(jnp.array(aa, jnp.float32)), jnp.array(t_true, jnp.float32))
    inv = geo.pose_inverse(pose_true)
    a = rng.uniform(-20, 20, (be, 3)).astype(np.float32)
    u = rng.normal(0, 1, (be, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    s = rng.uniform(-0.5, 0.5, (be, 1)).astype(np.float32)
    pts_w = a + s * u + rng.normal(0, noise, (be, 3)).astype(np.float32)
    ep = geo.pose_apply(inv, jnp.array(pts_w))
    edge = (ep, jnp.array(a + 0.1 * u), jnp.array(a - 0.1 * u), jnp.array(rng.random(be) < 0.9))
    n = rng.normal(0, 1, (bs, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.uniform(-5, 5, bs).astype(np.float32)
    q0 = rng.uniform(-20, 20, (bs, 3)).astype(np.float32)
    pw = q0 - (np.sum(n * q0, -1) + d)[:, None] * n
    pw += rng.normal(0, noise, (bs, 3)).astype(np.float32)
    plane = (geo.pose_apply(inv, jnp.array(pw)), jnp.array(n), jnp.array(d),
             jnp.array(rng.random(bs) < 0.9))
    return pose_true, edge, plane


def _vo_problem(rng, m=512, noise=0.0002):
    """Two views of random 3D points under a known motion; 60 % of matches
    carry depth (3D-2D), the rest are epipolar-only (2D-2D)."""
    aa = rng.normal(0, 0.02, 3)
    t_true = np.array([0.1, -0.05, 0.8]) + rng.normal(0, 0.05, 3)
    pose_true = geo.pose_from_qt(
        geo.angle_axis_to_quat(jnp.array(aa, jnp.float32)), jnp.array(t_true, jnp.float32))
    X0 = np.stack([rng.uniform(-10, 10, m), rng.uniform(-3, 3, m),
                   rng.uniform(5, 40, m)], -1).astype(np.float32)
    X1 = np.asarray(geo.pose_apply(pose_true, jnp.array(X0)))
    xb0 = (X0[:, :2] / X0[:, 2:3] + rng.normal(0, noise, (m, 2))).astype(np.float32)
    xb1 = (X1[:, :2] / X1[:, 2:3] + rng.normal(0, noise, (m, 2))).astype(np.float32)
    hd = rng.random(m) < 0.6
    return pose_true, (jnp.array(X0), jnp.array(xb0), jnp.array(xb1),
                       jnp.array(hd), jnp.array(~hd))


def _solve(kind, pose0, data, iters):
    if kind == "lidar":
        edge, plane = data
        return np.asarray(solve_pose_gn_lidar(pose0, edge, plane, iters, HUBER, LM))
    return np.asarray(solve_pose_gn_vo(pose0, *data, iters, HUBER, LM))


def _problem(kind, rng, **kw):
    if kind == "lidar":
        pose_true, edge, plane = _lidar_problem(rng, **kw)
        return pose_true, (edge, plane)
    return _vo_problem(rng, **kw)


def _assert_pose_close(p, ref, atol_t, qtol):
    np.testing.assert_allclose(p[4:], np.asarray(ref)[4:], atol=atol_t)
    assert abs(float(np.sum(p[:4] * np.asarray(ref)[:4]))) > 1.0 - qtol


@pytest.mark.parametrize("kind", ["lidar", "vo"])
def test_converges_to_truth(rng, kind):
    pose_true, data = _problem(kind, rng)
    p = _solve(kind, geo.pose_identity(), data, 10)
    _assert_pose_close(p, pose_true, atol_t=0.03, qtol=1e-4)


@pytest.mark.parametrize("kind", ["lidar", "vo"])
def test_all_invalid_keeps_pose(rng, kind):
    """Zero valid residuals: the damped solve of a ~zero system must not
    produce NaNs and leaves the pose (nearly) unchanged."""
    _, data = _problem(kind, rng)
    if kind == "lidar":
        edge, plane = data
        data = (edge[:3] + (jnp.zeros_like(edge[3]),), plane[:3] + (jnp.zeros_like(plane[3]),))
    else:
        data = data[:3] + (jnp.zeros_like(data[3]), jnp.zeros_like(data[4]))
    pose0 = geo.pose_from_qt(geo.angle_axis_to_quat(jnp.array([0.01, 0.02, -0.01])),
                             jnp.array([1.0, -2.0, 0.5]))
    out = _solve(kind, pose0, data, 4)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(pose0), atol=1e-3)


@pytest.mark.parametrize("kind", ["lidar", "vo"])
def test_unaligned_sizes(rng, kind):
    """Residual counts that are not powers of two solve the same problem."""
    kw = dict(be=769, bs=1537) if kind == "lidar" else dict(m=333)
    pose_true, data = _problem(kind, rng, **kw)
    p = _solve(kind, geo.pose_identity(), data, 10)
    _assert_pose_close(p, pose_true, atol_t=0.03, qtol=1e-4)
