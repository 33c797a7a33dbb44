"""Rotated-BRIEF descriptors + Hamming matching — the reference's default
frontend (image_util.cpp: descriptor_type=ORB :280-339, BF/KNN matching with
0.8 ratio test :347-438; selected by optical_flow_match=false).

Formulation:
  * orientation = intensity centroid over a 31x31 patch (the ORB moment
    test), patches sliced once per keypoint;
  * descriptor = 256 smoothed-point comparisons on a fixed random pattern
    rotated by the orientation, sampled with the same interpolation-matmul
    machinery as the KLT windows, packed into 8 uint32 lanes;
  * matching = one XOR + popcount distance matrix (N0, N1, 8 words) on the
    device, 2-NN + Lowe ratio entirely vectorised.

The sampling pattern is a seeded Gaussian BRIEF pattern (self-contained;
OpenCV's learned bit_pattern_31 is an external artifact, and the ratio-test
matcher dominates matching quality at these feature counts).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from vloam_tpu.config import VisualConfig
from vloam_tpu.ops.image_ops import _sep_conv, _slice_patches

PATCH = 32          # descriptor patch (covers the 31x31 ORB window)
N_BITS = 256


def _pattern() -> np.ndarray:
    """(256, 4) sampling pairs (x1, y1, x2, y2), Gaussian around the centre
    (sigma = patch/5, the classic BRIEF-II choice), clipped to +-13 so any
    rotation stays inside the 31x31 window."""
    rng = np.random.default_rng(1234)
    p = rng.normal(scale=PATCH / 5.0, size=(N_BITS, 4))
    return np.clip(p, -13.0, 13.0).astype(np.float32)


_PAT = _pattern()

N_ANGLES = 30       # ORB's 12-degree orientation quantisation (Rublee et al.
                    # 2011 §4.1: a lookup table of 30 pre-rotated patterns)


def _pattern_bank() -> tuple[np.ndarray, np.ndarray]:
    """(N_ANGLES, 256) integer tap indices into the flattened 32x32 patch for
    each pattern endpoint, one row per quantised orientation.  Nearest-tap
    sampling, matching the ORB paper's precomputed rotated patterns."""
    half = PATCH // 2
    banks = []
    for ends in ((_PAT[:, 0], _PAT[:, 1]), (_PAT[:, 2], _PAT[:, 3])):
        px, py = ends
        rows = []
        for a in range(N_ANGLES):
            th = 2.0 * np.pi * a / N_ANGLES
            c, s = np.cos(th), np.sin(th)
            x = c * px - s * py + (half - 0.5)
            y = s * px + c * py + (half - 0.5)
            xi = np.clip(np.round(x), 0, PATCH - 1).astype(np.int32)
            yi = np.clip(np.round(y), 0, PATCH - 1).astype(np.int32)
            rows.append(yi * PATCH + xi)
        banks.append(np.stack(rows))
    return banks[0], banks[1]


_BANK1, _BANK2 = _pattern_bank()


def orb_descriptors(
    img: jax.Array,          # (H, W) float32
    pts: jax.Array,          # (N, 2)
    mask: jax.Array,         # (N,)
    cfg: VisualConfig,
    rotate: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Returns (descriptors (N, 8) uint32, valid (N,)).

    ``rotate=True`` gives ORB (rotation-steered BRIEF via the intensity
    centroid); ``rotate=False`` gives plain BRIEF (the reference's
    DescriptorType::BRIEF alternative, image_util.cpp:300-305).
    Keypoints whose 32x32 patch leaves the image are invalidated (OpenCV
    drops border keypoints the same way)."""
    H, W = img.shape
    # BRIEF samples a smoothed image (ORB: 7x7 box-ish blur)
    g = jnp.array([1.0, 2.0, 3.0, 2.0, 1.0], jnp.float32)
    g = g / jnp.sum(g)
    smooth = _sep_conv(img, g, g)

    half = PATCH // 2
    corner = jnp.round(pts).astype(jnp.int32) - half
    inside = (
        (corner[:, 0] >= 0) & (corner[:, 0] <= W - PATCH)
        & (corner[:, 1] >= 0) & (corner[:, 1] <= H - PATCH)
    )
    corner = jnp.stack(
        [jnp.clip(corner[:, 0], 0, W - PATCH), jnp.clip(corner[:, 1], 0, H - PATCH)], axis=-1
    )
    patches = _slice_patches(smooth, corner, PATCH)          # (N, 32, 32)

    # orientation: intensity centroid moments over the patch, quantised to
    # the ORB paper's 30 pre-rotated patterns (Rublee et al. 2011 §4.1)
    if rotate:
        ax = jnp.arange(PATCH, dtype=jnp.float32) - (half - 0.5)
        m10 = jnp.einsum("nyx,x->n", patches, ax)
        m01 = jnp.einsum("nyx,y->n", patches, ax)
        theta = jnp.arctan2(m01, m10)                        # (-pi, pi]
        abin = jnp.mod(
            jnp.round(theta * (N_ANGLES / (2.0 * jnp.pi))).astype(jnp.int32), N_ANGLES
        )
    else:
        abin = jnp.zeros((pts.shape[0],), jnp.int32)

    flat = patches.reshape(patches.shape[0], -1)             # (N, 1024)
    bits = _descriptor_bits(flat, abin)
    words = bits.reshape(-1, 8, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    desc = jnp.sum(jnp.where(words, weights, jnp.uint32(0)), axis=-1, dtype=jnp.uint32)
    return desc, mask & inside


def _descriptor_bits(flat: jax.Array, abin: jax.Array) -> jax.Array:
    """Pattern comparisons for pre-sliced flattened patches: (N, 256) bits,
    by a per-keypoint tap lookup of its angle bin's pattern."""
    idx1 = jnp.take(jnp.asarray(_BANK1), abin, axis=0)       # (N, 256)
    idx2 = jnp.take(jnp.asarray(_BANK2), abin, axis=0)
    return jnp.take_along_axis(flat, idx1, axis=1) < jnp.take_along_axis(flat, idx2, axis=1)


def _popcount32(x: jax.Array) -> jax.Array:
    """Vectorised 32-bit population count (Hacker's Delight 5-2)."""
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> 24


def match_descriptors(
    desc0: jax.Array, mask0: jax.Array,     # query (prev frame)
    desc1: jax.Array, mask1: jax.Array,     # train (curr frame)
    ratio: float = 0.8,
    select: str = "knn",
) -> tuple[jax.Array, jax.Array]:
    """Brute-force Hamming matching (image_util.cpp:347-438).

    ``select="knn"`` is the reference's active path: 2-NN + Lowe 0.8 ratio
    (SelectType::KNN, :407-430).  ``select="nn"`` is SelectType::NN with
    cross-checking (cv::BFMatcher(crossCheck=true), :356-360): keep a match
    only when it is mutually nearest.

    Returns (match_idx (N0,) into desc1, valid (N0,)).
    """
    x = desc0[:, None, :] ^ desc1[None, :, :]                # (N0, N1, 8)
    d = jnp.sum(_popcount32(x), axis=-1).astype(jnp.float32)
    d = jnp.where(mask1[None, :], d, 1e9)
    if select == "nn":
        d = jnp.where(mask0[:, None], d, 1e9)
        fwd = jnp.argmin(d, axis=1)                          # (N0,)
        bwd = jnp.argmin(d, axis=0)                          # (N1,)
        best = jnp.take_along_axis(d, fwd[:, None], axis=1)[:, 0]
        mutual = jnp.take(bwd, fwd) == jnp.arange(desc0.shape[0])
        return fwd, mask0 & mutual & (best < 256.0)
    neg, idx = jax.lax.top_k(-d, 2)
    best, second = -neg[:, 0], -neg[:, 1]
    valid = mask0 & (best < ratio * second) & (best < 256.0)
    return idx[:, 0], valid


def match_descriptors_approx(
    desc0: jax.Array, mask0: jax.Array,
    desc1: jax.Array, mask1: jax.Array,
    ratio: float = 0.8,
    n_probe_words: int = 2,
    rerank: int = 8,
    seed: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """FLANN-equivalent approximate Hamming matcher (MatcherType::FLANN;
    OpenCV FLANN uses LSH tables for binary descriptors,
    image_util.cpp:366-378).

    Fixed-shape analogue: Hamming distance on a seeded subset of
    ``n_probe_words`` 32-bit words prefilters ``rerank`` candidates per
    query (bit-sampling LSH), exact full-width Hamming re-ranks only those.
    All fixed-shape; useful when descriptor width dominates (512-bit BRISK/
    FREAK/AKAZE at large N)."""
    W = desc0.shape[1]
    probe = np.random.default_rng(seed).permutation(W)[:n_probe_words]
    p = jnp.asarray(np.sort(probe))
    x = jnp.take(desc0, p, 1)[:, None, :] ^ jnp.take(desc1, p, 1)[None, :, :]
    d_pre = jnp.sum(_popcount32(x), axis=-1).astype(jnp.float32)
    d_pre = jnp.where(mask1[None, :], d_pre, 1e9)
    _, cand = jax.lax.top_k(-d_pre, rerank)                  # (N0, rerank)
    c1 = jnp.take(desc1, cand, axis=0)                       # (N0, rerank, W)
    d = jnp.sum(_popcount32(desc0[:, None, :] ^ c1), axis=-1).astype(jnp.float32)
    d = jnp.where(jnp.take(mask1, cand), d, 1e9)
    neg, order = jax.lax.top_k(-d, 2)
    best, second = -neg[:, 0], -neg[:, 1]
    idx = jnp.take_along_axis(cand, order[:, :1], axis=1)[:, 0]
    max_ok = float(W * 32)
    valid = mask0 & (best < ratio * second) & (best < max_ok)
    return idx, valid
