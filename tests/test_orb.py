"""ORB descriptors + Hamming matching + CLAHE + descriptor-mode VO."""

import numpy as np
import dataclasses
import jax.numpy as jnp
import pytest

from vloam_tpu.config import VisualConfig, kitti_hdl64
from vloam_tpu.data import synthetic
from vloam_tpu.ops import image_ops, orb
from vloam_tpu.ops.clahe import clahe

VC = VisualConfig(img_height=376, img_width=1248)


@pytest.fixture(scope="module")
def blob_pair():
    rng = np.random.default_rng(3)
    pts = np.stack(
        [rng.uniform(40, VC.img_width - 40, 400), rng.uniform(40, VC.img_height - 40, 400), np.ones(400)],
        axis=-1,
    )
    amp_seed = 5
    img0 = synthetic.render_blob_image(pts, np.eye(3), VC.img_height, VC.img_width, seed=amp_seed)
    shift = np.array([6.0, -3.0])
    pts1 = pts.copy()
    pts1[:, :2] += shift
    img1 = synthetic.render_blob_image(pts1, np.eye(3), VC.img_height, VC.img_width, seed=amp_seed)
    return img0, img1, shift


def test_popcount():
    x = jnp.array([0, 1, 3, 0xFFFFFFFF, 0x80000000], jnp.uint32)
    np.testing.assert_array_equal(np.asarray(orb._popcount32(x)), [0, 1, 2, 32, 1])


def test_descriptor_self_match(blob_pair):
    img0, _, _ = blob_pair
    kp, mask, _ = image_ops.detect_corners(jnp.array(img0), VC)
    d, dm = orb.orb_descriptors(jnp.array(img0), kp, mask, VC)
    # matching a frame against itself must be (near-)identity
    idx, valid = orb.match_descriptors(d, dm, d, dm)
    v = np.asarray(valid)
    assert v.sum() > 0.8 * int(np.asarray(dm).sum())
    np.testing.assert_array_equal(np.asarray(idx)[v], np.arange(len(v))[v])


def test_descriptor_match_across_shift(blob_pair):
    img0, img1, shift = blob_pair
    kp0, m0, _ = image_ops.detect_corners(jnp.array(img0), VC)
    kp1, m1, _ = image_ops.detect_corners(jnp.array(img1), VC)
    d0, dm0 = orb.orb_descriptors(jnp.array(img0), kp0, m0, VC)
    d1, dm1 = orb.orb_descriptors(jnp.array(img1), kp1, m1, VC)
    idx, valid = orb.match_descriptors(d0, dm0, d1, dm1)
    v = np.asarray(valid)
    assert v.sum() > 100
    flow = np.asarray(jnp.take(kp1, idx, axis=0) - kp0)[v]
    good = np.abs(flow - shift).max(axis=1) < 1.5
    assert good.mean() > 0.8          # most ratio-test survivors are correct
    np.testing.assert_allclose(np.median(flow[good], axis=0), shift, atol=0.7)


def test_clahe_enhances_contrast():
    rng = np.random.default_rng(0)
    # low-contrast image: values in [100, 120]
    img = rng.uniform(100, 120, (376, 1248)).astype(np.float32)
    out = np.asarray(clahe(jnp.array(img)))
    assert out.std() > 2.0 * img.std()
    assert out.min() >= 0.0 and out.max() <= 255.0


def test_vo_descriptor_mode_runs(blob_pair):
    img0, img1, shift = blob_pair
    cfg = kitti_hdl64()
    cfg = cfg.replace(visual=dataclasses.replace(cfg.visual, optical_flow_match=False))
    from vloam_tpu.models.visual_odometry import init_vo_state, vo_step

    K = synthetic.kitti_like_intrinsics(cfg.visual.img_width, cfg.visual.img_height)
    proj = np.zeros((3, 4), np.float32)
    proj[:, :3] = K
    state = init_vo_state(cfg)
    cloud = jnp.zeros((1024, 3))
    for img in [img0, img1]:
        state, pose = vo_step(
            state, jnp.array(img), cloud, jnp.zeros(1024, bool),
            jnp.array(proj), jnp.array(K, jnp.float32), cfg,
        )
    assert np.isfinite(np.asarray(pose)).all()


def test_brief_descriptor_and_nn_crosscheck(blob_pair):
    """Plain BRIEF + NN/cross-check matching (reference DescriptorType::BRIEF
    + SelectType::NN, image_util.cpp:300-305,356-360) track a pure shift."""
    img0, img1, shift = blob_pair
    kp0, m0, _ = image_ops.detect_corners(jnp.array(img0), VC)
    kp1, m1, _ = image_ops.detect_corners(jnp.array(img1), VC)
    d0, dm0 = orb.orb_descriptors(jnp.array(img0), kp0, m0, VC, rotate=False)
    d1, dm1 = orb.orb_descriptors(jnp.array(img1), kp1, m1, VC, rotate=False)
    idx, ok = orb.match_descriptors(d0, dm0, d1, dm1, select="nn")
    ok = np.asarray(ok)
    assert ok.sum() > 50
    dxy = np.asarray(kp1)[np.asarray(idx)[ok]] - np.asarray(kp0)[ok]
    med = np.median(dxy, axis=0)
    np.testing.assert_allclose(med, shift, atol=0.5)
    # cross-check keeps only mutual matches: every matched train index unique
    tr = np.asarray(idx)[ok]
    assert len(np.unique(tr)) == len(tr)


def test_fast_detector_finds_blobs(blob_pair):
    img0, _, _ = blob_pair
    cfg = dataclasses.replace(VC, detector_type="fast", fast_threshold=10.0)
    kp, mask, resp = image_ops.detect_corners(jnp.array(img0), cfg)
    assert int(np.asarray(mask).sum()) > 100
    # FAST corners should land near high-gradient blob regions: their local
    # Shi-Tomasi response must be far above the image median
    st = np.asarray(image_ops.shi_tomasi_response(jnp.array(img0)))
    kpi = np.asarray(kp[np.asarray(mask)]).astype(int)
    vals = st[kpi[:, 1], kpi[:, 0]]
    assert np.median(vals) > 10 * np.median(np.abs(st))


def test_bits_match_numpy_taps():
    """Descriptor bits are the angle bin's tap comparisons s1 < s2."""
    rng = np.random.default_rng(7)
    flat = rng.uniform(0, 255, (64, orb.PATCH * orb.PATCH)).astype(np.float32)
    abin = rng.integers(0, orb.N_ANGLES, 64).astype(np.int32)
    bits = np.asarray(orb._descriptor_bits(jnp.array(flat), jnp.array(abin)))
    b1, b2 = np.asarray(orb._BANK1)[abin], np.asarray(orb._BANK2)[abin]
    ref = np.take_along_axis(flat, b1, 1) < np.take_along_axis(flat, b2, 1)
    np.testing.assert_array_equal(bits, ref)
