"""voxel_downsample vs a NumPy brute-force oracle."""

import numpy as np
import jax.numpy as jnp

from vloam_tpu.ops.voxel import voxel_downsample


def oracle_voxel(pts, mask, leaf, groups=None):
    pts = pts[mask]
    g = (groups[mask] if groups is not None else np.zeros(len(pts), np.int32))
    pmin = pts[:, :3].min(axis=0)
    keys = {}
    for p, gi in zip(pts, g):
        ijk = tuple(np.floor((p[:3] - pmin) / leaf).astype(int)) + (int(gi),)
        keys.setdefault(ijk, []).append(p)
    return sorted(np.mean(np.stack(v), axis=0).tolist() for v in keys.values())


def test_voxel_matches_oracle(rng):
    pts = rng.uniform(-5, 5, size=(500, 4)).astype(np.float32)
    mask = rng.uniform(size=500) < 0.8
    out, omask = voxel_downsample(jnp.array(pts), jnp.array(mask), 0.7, 512)
    got = sorted(np.asarray(out)[np.asarray(omask)].tolist())
    want = oracle_voxel(pts, mask, 0.7)
    assert len(got) == len(want)
    np.testing.assert_allclose(np.array(got), np.array(want), atol=1e-4)


def test_voxel_groups_do_not_merge(rng):
    # identical xyz, two groups -> two output points
    pts = np.tile(np.array([[1.0, 1.0, 1.0, 0.0]], np.float32), (10, 1))
    pts[5:, 3] = 7.0  # different feature channel to check averaging per group
    grp = np.array([0] * 5 + [1] * 5, np.int32)
    out, omask = voxel_downsample(jnp.array(pts), jnp.ones(10, bool), 0.5, 8, group_key=jnp.array(grp))
    got = np.asarray(out)[np.asarray(omask)]
    assert got.shape[0] == 2
    assert sorted(got[:, 3].tolist()) == [0.0, 7.0]


def test_voxel_cap_truncates(rng):
    pts = rng.uniform(-50, 50, size=(256, 3)).astype(np.float32)  # all distinct voxels
    out, omask = voxel_downsample(jnp.array(pts), jnp.ones(256, bool), 0.1, 64)
    assert int(np.asarray(omask).sum()) == 64


def test_voxel_empty():
    pts = np.zeros((16, 3), np.float32)
    out, omask = voxel_downsample(jnp.array(pts), jnp.zeros(16, bool), 0.5, 8)
    assert not np.asarray(omask).any()


def test_voxel_presorted_interleaved_invalid(rng):
    """Invalid rows interleaved BETWEEN valid runs (the ring-grid padding
    layout of the less-flat reduction).  Regression: the old implementation
    dumped invalid rows into a scrap segment, breaking the monotone-index
    contract that segment_sum(indices_are_sorted=True) relies on — a
    backend that exploits the hint then silently zeroes most centroids (the
    unit suite runs on CPU, which ignores the hint and hid it).  This pins
    the monotone formulation on every backend."""
    import jax.numpy as jnp

    from vloam_tpu.ops.voxel import voxel_downsample

    R, C = 8, 64
    pts = np.zeros((R * C, 4), np.float32)
    mask = np.zeros((R * C,), bool)
    expect = []
    for r in range(8):
        n_valid = 10 + 3 * r
        base = r * C
        # one spatial cluster per ring, well separated; all points of the
        # ring land in ONE voxel at leaf=4 -> the centroid is their mean
        cluster = np.array([10.0 * r, -5.0 * r, 1.0]) + rng.uniform(0, 0.5, (n_valid, 3))
        pts[base:base + n_valid, :3] = cluster
        mask[base:base + n_valid] = True          # trailing C-n_valid rows invalid
        expect.append(cluster.mean(axis=0))
    ring_id = np.repeat(np.arange(R, dtype=np.int32), C)
    out, om = voxel_downsample(
        jnp.array(pts), jnp.array(mask), 4.0, 64,
        group_key=jnp.array(ring_id), presorted=True,
    )
    got = np.asarray(out)[np.asarray(om)]
    assert got.shape[0] == R, got.shape
    np.testing.assert_allclose(
        np.sort(got[:, :3], axis=0), np.sort(np.stack(expect), axis=0), atol=1e-5
    )
    # no valid output row may be the zero artifact
    assert (np.linalg.norm(got[:, :3], axis=1) > 1e-6).sum() >= R - 1
