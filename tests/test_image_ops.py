"""Image frontend: Shi-Tomasi detection + pyramidal KLT vs known motion."""

import numpy as np
import jax.numpy as jnp
import pytest

from vloam_tpu.config import VisualConfig
from vloam_tpu.data import synthetic
from vloam_tpu.ops import image_ops

VC = VisualConfig(img_height=376, img_width=1248)


@pytest.fixture(scope="module")
def blob_pair():
    rng = np.random.default_rng(0)
    pts = np.stack(
        [rng.uniform(30, VC.img_width - 30, 400), rng.uniform(30, VC.img_height - 30, 400), np.ones(400)],
        axis=-1,
    )
    img0 = synthetic.render_blob_image(pts, np.eye(3), VC.img_height, VC.img_width)
    shift = np.array([3.4, -2.2])
    pts1 = pts.copy()
    pts1[:, :2] += shift
    img1 = synthetic.render_blob_image(pts1, np.eye(3), VC.img_height, VC.img_width)
    return img0, img1, pts, shift


def test_detect_corners_on_blobs(blob_pair):
    img0, _, pts, _ = blob_pair
    kp, mask, resp = image_ops.detect_corners(jnp.array(img0), VC)
    kp, mask = np.asarray(kp), np.asarray(mask)
    assert mask.sum() > 200
    # most detected corners should be within 2 px of a blob center
    d = np.sqrt(((kp[mask][:, None] - pts[None, :, :2]) ** 2).sum(-1)).min(1)
    assert np.median(d) < 2.0


def test_bucket_nms_caps(blob_pair):
    img0, _, _, _ = blob_pair
    kp, mask, resp = image_ops.detect_corners(jnp.array(img0), VC)
    nms_mask = image_ops.bucket_nms(kp, mask, resp, VC)
    assert int(nms_mask.sum()) <= VC.nms_max_total
    assert int(nms_mask.sum()) > 0
    assert not np.any(np.asarray(nms_mask) & ~np.asarray(mask))


def test_klt_pure_shift(blob_pair):
    img0, img1, _, shift = blob_pair
    kp, mask, _ = image_ops.detect_corners(jnp.array(img0), VC)
    curr, ok = image_ops.lk_track(jnp.array(img0), jnp.array(img1), kp, mask, VC)
    flow = np.asarray(curr - kp)[np.asarray(ok)]
    assert len(flow) > 150
    np.testing.assert_allclose(np.median(flow, axis=0), shift, atol=0.05)


def test_klt_fb_check_drops_bad_tracks(blob_pair):
    img0, img1, _, shift = blob_pair
    kp, mask, _ = image_ops.detect_corners(jnp.array(img0), VC)
    # corrupt: track into an UNRELATED image -> fb check should nuke almost everything
    rng = np.random.default_rng(9)
    noise_img = rng.uniform(0, 255, img0.shape).astype(np.float32)
    _, ok_bad = image_ops.lk_track_fb(jnp.array(img0), jnp.array(noise_img), kp, mask, VC)
    _, ok_good = image_ops.lk_track_fb(jnp.array(img0), jnp.array(img1), kp, mask, VC)
    assert int(ok_bad.sum()) < 0.2 * int(ok_good.sum())


def test_pyramid_shapes():
    img = jnp.zeros((376, 1248))
    pyr = image_ops.gaussian_pyramid(img, 2)
    assert [p.shape for p in pyr] == [(376, 1248), (188, 624), (94, 312)]


def test_slice_patches_edge_corners_match_numpy(rng):
    """Patch gathers at the corners of a KITTI-sized 376x1241 image (the
    extreme legal corners, where a window touches the image border) are
    exact windows."""
    from vloam_tpu.ops.image_ops import _slice_patches

    H, W, P = 376, 1241, 32
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    corners = np.array([[0, 0], [W - P, 0], [0, H - P], [W - P, H - P],
                        [W // 2, H // 2], [1, H - P - 1]], np.int32)
    out = np.asarray(_slice_patches(jnp.array(img), jnp.array(corners), P))
    for k, (x, y) in enumerate(corners):
        np.testing.assert_array_equal(out[k], img[y:y + P, x:x + P])


def test_slice_patches_multi_matches_numpy(rng):
    """The stacked (C, H, W) gather returns (N, C, P, P) exact windows."""
    from vloam_tpu.ops.image_ops import _slice_patches_multi

    C, H, W, P = 3, 96, 200, 16
    imgs = rng.uniform(0, 255, (C, H, W)).astype(np.float32)
    corners = np.stack([rng.integers(0, W - P + 1, 20), rng.integers(0, H - P + 1, 20)],
                       -1).astype(np.int32)
    out = np.asarray(_slice_patches_multi(jnp.array(imgs), jnp.array(corners), P))
    for k, (x, y) in enumerate(corners):
        np.testing.assert_array_equal(out[k], imgs[:, y:y + P, x:x + P])
