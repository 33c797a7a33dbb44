"""ImageUtil facade — the reference's 2D feature frontend as one dispatch
surface (src/visual_odometry/include/visual_odometry/image_util.h:16-101).

Maps the reference's enums onto the engine's fixed-shape ops:

  DetectorType    {ShiTomasi, BRISK, FAST, ORB, AKAZE, SIFT}
                  -> det_keypoints(detector_type=...)
  DescriptorType  {BRISK, ORB, BRIEF, AKAZE, FREAK, SIFT}
                  -> desc_keypoints(descriptor_type=...)
  MatcherType     {BF, FLANN} x SelectType {NN, KNN}
                  -> match(matcher_type=..., select=...)
  calculateOpticalFlow (image_util.cpp:503-570)
                  -> ops.image_ops.lk_track / lk_track_fb
  keyPointsNMS (image_util.cpp:202-261)
                  -> ops.image_ops.bucket_nms

Keypoints are carried as a uniform fixed-shape pytree (pts, mask, response,
octave, angle) regardless of detector family; single-scale detectors
(ShiTomasi / FAST) report octave 0.  The "ORB" detector is FAST with the
Shi-Tomasi (Harris-style) cornerness re-ranking cv::ORB applies
(HARRIS_SCORE default).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vloam_tpu.config import VisualConfig
from vloam_tpu.ops import akaze as _akaze
from vloam_tpu.ops import brisk as _brisk
from vloam_tpu.ops import image_ops as _io
from vloam_tpu.ops import orb as _orb
from vloam_tpu.ops import sift as _sift

DETECTOR_TYPES = ("shitomasi", "brisk", "fast", "orb", "akaze", "sift")
DESCRIPTOR_TYPES = ("brisk", "orb", "brief", "akaze", "freak", "sift")
MATCHER_TYPES = ("bf", "flann")
SELECT_TYPES = ("nn", "knn")


class Keypoints(NamedTuple):
    pts: jax.Array        # (N, 2) full-res xy
    mask: jax.Array       # (N,)
    response: jax.Array   # (N,)
    octave: jax.Array     # (N,) int32 (0 for single-scale detectors)
    angle: jax.Array      # (N,) radians (0 until a descriptor orients them)


def _single_scale(pts, mask, resp) -> Keypoints:
    n = pts.shape[0]
    return Keypoints(
        pts, mask, resp, jnp.zeros((n,), jnp.int32), jnp.zeros((n,), jnp.float32)
    )


def det_keypoints(
    img: jax.Array, detector_type: str, cfg: VisualConfig
) -> Keypoints:
    """detKeypoints (image_util.cpp:8-192): corner/blob detection with a
    fixed ``cfg.max_corners`` budget."""
    t = detector_type.lower()
    if t in ("shitomasi", "fast"):
        import dataclasses

        c = dataclasses.replace(cfg, detector_type=t)
        pts, mask, resp = _io.detect_corners(img, c)
        return _single_scale(pts, mask, resp)
    if t == "orb":
        # cv::ORB: FAST corners, Harris-score re-ranked.  detect_corners
        # already budgets by response; re-score survivors by Shi-Tomasi.
        import dataclasses

        c = dataclasses.replace(cfg, detector_type="fast")
        pts, mask, _ = _io.detect_corners(img, c)
        st = _io.shi_tomasi_response(img, cfg.block_size)
        xi = jnp.clip(pts[:, 0].astype(jnp.int32), 0, img.shape[1] - 1)
        yi = jnp.clip(pts[:, 1].astype(jnp.int32), 0, img.shape[0] - 1)
        resp = jnp.where(mask, st[yi, xi], 0.0)
        return _single_scale(pts, mask, resp)
    if t == "brisk":
        kp = _brisk.brisk_detect(img, cfg.max_corners, cfg.fast_threshold)
        n = kp.pts.shape[0]
        return Keypoints(kp.pts, kp.mask, kp.response, kp.octave,
                         jnp.zeros((n,), jnp.float32))
    if t == "akaze":
        kp = _akaze.detect(img, cfg.max_corners)
        return Keypoints(kp.pts, kp.mask, kp.response, kp.octave, kp.angle)
    if t == "sift":
        kp = _sift.detect(img, cfg.max_corners)
        return Keypoints(kp.pts, kp.mask, kp.response, kp.octave, kp.angle)
    raise ValueError(f"unknown detector_type {detector_type!r} ({DETECTOR_TYPES})")


def key_points_nms(kp: Keypoints, cfg: VisualConfig) -> Keypoints:
    """keyPointsNMS (image_util.cpp:202-261): bucketed per-cell cap."""
    return kp._replace(mask=_io.bucket_nms(kp.pts, kp.mask, kp.response, cfg))


def desc_keypoints(
    img: jax.Array, kp: Keypoints, descriptor_type: str, cfg: VisualConfig
) -> tuple[jax.Array, jax.Array]:
    """descKeypoints (image_util.cpp:280-339).  Returns (descriptors, valid).

    Binary families return (N, 8|16) uint32; SIFT returns (N, 128) float32.
    """
    t = descriptor_type.lower()
    if t in ("orb", "brief"):
        return _orb.orb_descriptors(img, kp.pts, kp.mask, cfg, rotate=(t == "orb"))
    if t in ("brisk", "freak"):
        sk = _brisk.ScaleKeypoints(kp.pts, kp.mask, kp.response, kp.octave)
        fn = _brisk.brisk_descriptors if t == "brisk" else _brisk.freak_descriptors
        return fn(img, sk)
    if t == "akaze":
        ak = _akaze.AkazeKeypoints(kp.pts, kp.mask, kp.response, kp.octave, kp.angle)
        desc, valid, _ = _akaze.describe(img, ak)
        return desc, valid
    if t == "sift":
        octs = _sift.gaussian_octaves(img)
        sk = _sift.SiftKeypoints(
            kp.pts, kp.mask, kp.response, kp.octave,
            jnp.ones_like(kp.octave), kp.angle,
        )
        sk = _sift.orient(octs, sk)
        return _sift.describe(octs, sk)
    raise ValueError(f"unknown descriptor_type {descriptor_type!r} ({DESCRIPTOR_TYPES})")


def match(
    desc0: jax.Array, mask0: jax.Array,
    desc1: jax.Array, mask1: jax.Array,
    matcher_type: str = "bf",
    select: str = "knn",
    ratio: float = 0.8,
) -> tuple[jax.Array, jax.Array]:
    """matchDescriptors (image_util.cpp:347-438): BF = exact distance
    matrix; FLANN = approximate prefilter + exact re-rank.  Dtype picks the
    metric (uint32 words -> Hamming, float -> L2)."""
    binary = jnp.issubdtype(desc0.dtype, jnp.unsignedinteger)
    if matcher_type == "bf":
        if binary:
            return _orb.match_descriptors(desc0, mask0, desc1, mask1, ratio, select)
        return _sift.match_float_descriptors(desc0, mask0, desc1, mask1, ratio, select)
    if matcher_type == "flann":
        if binary:
            return _orb.match_descriptors_approx(desc0, mask0, desc1, mask1, ratio)
        return _sift.match_float_descriptors_approx(desc0, mask0, desc1, mask1, ratio)
    raise ValueError(f"unknown matcher_type {matcher_type!r} ({MATCHER_TYPES})")


def calculate_optical_flow(
    prev_img: jax.Array, img: jax.Array, kp: Keypoints, cfg: VisualConfig
):
    """calculateOpticalFlow (image_util.cpp:503-570): pyramidal LK; returns
    (tracked pts, status)."""
    track = _io.lk_track_fb if cfg.klt_fb_check else _io.lk_track
    return track(prev_img, img, kp.pts, kp.mask, cfg, None)
