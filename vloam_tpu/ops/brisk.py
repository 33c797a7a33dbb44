"""BRISK + FREAK — pattern-sampling binary features.

Parity targets: ``DetectorType::BRISK`` (image_util.cpp:88-92 via
cv::BRISK::create), ``DescriptorType::BRISK`` (:296-299), and
``DescriptorType::FREAK`` (:311-315 via cv::xfeatures2d::FREAK) — all OpenCV
factory calls in the reference.

Formulation:
  * detector: the BRISK/AGAST scale-space corner search becomes the FAST-9/16
    response (image_ops.fast_response — 16 static rolls, one fused pass) on a
    static 4-octave pyramid with per-octave ``approx_max_k`` budgets;
  * descriptors: both BRISK's concentric pattern (60 points, 4 rings) and
    FREAK's retinal pattern (43 overlapping fields) reduce to the same
    machinery — slice one patch per keypoint at its octave, pre-blur the
    octave at 3 smoothing levels (coarse stand-in for per-point Gaussian
    radii), resample all pattern points with ONE bf16 matmul against a
    bank of pre-rotated bilinear taps (2pi/30 rotation bins — see
    _sample_pattern), compare fixed pair lists, pack bits into uint32 lanes;
  * orientation: BRISK's long-pair gradient estimate / FREAK's symmetric-pair
    gradient, both one masked einsum over the sampled intensities.

Pair lists are derived from the published pattern geometries (short/long
distance thresholds for BRISK; a seeded coarse-to-fine selection for FREAK,
standing in for OpenCV's offline-trained pair table).  Descriptors are 512
bits = 16 uint32 words; orb.match_descriptors handles matching.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from vloam_tpu.ops.image_ops import _sep_conv, _slice_patches_multi, fast_response

N_OCTAVES = 4
PATCH = 32
BLUR_SIGMAS = (0.8, 1.8, 3.2)     # pattern-point smoothing levels
N_BITS = 512


class ScaleKeypoints(NamedTuple):
    pts: jax.Array        # (N, 2) full-res xy
    mask: jax.Array       # (N,)
    response: jax.Array   # (N,)
    octave: jax.Array     # (N,) int32


# --------------------------------------------------------------------------
# Detector: multi-scale FAST (the BRISK/AGAST search, simplified to
# per-octave spatial non-max + budgeted top-k; no sub-scale interpolation)
# --------------------------------------------------------------------------

def brisk_detect(
    img: jax.Array, max_keypoints: int = 1024, threshold: float = 20.0
) -> ScaleKeypoints:
    per_oct = max_keypoints // N_OCTAVES
    g5 = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]
    pts, msk, rsp, ocs = [], [], [], []
    level = img
    for o in range(N_OCTAVES):
        resp = fast_response(level, threshold)
        H, W = resp.shape
        # 3x3 spatial non-max
        mx = jnp.full_like(resp, -jnp.inf)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                mx = jnp.maximum(mx, jnp.roll(resp, (dy, dx), (0, 1)))
        yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        b = PATCH // 2 + 1
        keep = (
            (resp > 0) & (resp >= mx)
            & (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
        )
        score = jnp.where(keep, resp, 0.0).reshape(1, -1)
        top, idx = jax.lax.approx_max_k(score, per_oct, recall_target=0.95)
        top, idx = top[0], idx[0]
        x = (idx % W).astype(jnp.float32)
        y = (idx // W).astype(jnp.float32)
        sf = float(2 ** o)
        pts.append(jnp.stack([(x + 0.5) * sf - 0.5, (y + 0.5) * sf - 0.5], -1))
        msk.append(top > 0.0)
        rsp.append(top)
        ocs.append(jnp.full((per_oct,), o, jnp.int32))
        level = _sep_conv(level, g5, g5)[::2, ::2]
    return ScaleKeypoints(
        jnp.concatenate(pts), jnp.concatenate(msk),
        jnp.concatenate(rsp), jnp.concatenate(ocs),
    )


# --------------------------------------------------------------------------
# Shared pattern-sampling machinery
# --------------------------------------------------------------------------

def _brisk_pattern() -> tuple[np.ndarray, np.ndarray]:
    """(60, 2) point offsets + (60,) blur-level ids (BRISK paper geometry:
    rings of [1, 10, 14, 15, 20] points at radii [0, 2.9, 4.9, 7.4, 10.8],
    smoothing growing with ring radius)."""
    counts = [1, 10, 14, 15, 20]
    radii = [0.0, 2.9, 4.9, 7.4, 10.8]
    blur = [0, 0, 1, 1, 2]
    xy, lv = [], []
    for ring, (n, r, b) in enumerate(zip(counts, radii, blur)):
        for k in range(n):
            a = 2 * math.pi * k / n + (math.pi / n if ring % 2 else 0.0)
            xy.append((r * math.cos(a), r * math.sin(a)))
            lv.append(b)
    return np.array(xy, np.float32), np.array(lv, np.int32)


def _freak_pattern() -> tuple[np.ndarray, np.ndarray]:
    """(43, 2) retinal pattern: 7 rings of 6 + centre, radii shrinking
    exponentially toward the fovea, smoothing proportional to radius."""
    xy, lv = [(0.0, 0.0)], [0]
    for ring in range(7):
        r = 13.0 * (0.72 ** ring)
        b = 2 if r > 8 else (1 if r > 3.5 else 0)
        for k in range(6):
            a = 2 * math.pi * k / 6 + (math.pi / 6 if ring % 2 else 0.0)
            xy.append((r * math.cos(a), r * math.sin(a)))
            lv.append(b)
    return np.array(xy, np.float32), np.array(lv, np.int32)


def _pairs_by_distance(xy: np.ndarray, short_max: float, long_min: float):
    """(all short pairs -> descriptor bits, all long pairs -> orientation)."""
    n = xy.shape[0]
    ii, jj = np.triu_indices(n, 1)
    d = np.linalg.norm(xy[ii] - xy[jj], axis=1)
    short = np.stack([ii, jj], 1)[d < short_max]
    long = np.stack([ii, jj], 1)[d > long_min]
    # fixed 512 bits: shortest-first, truncate or tile
    order = np.argsort(d[d < short_max])
    short = short[order]
    reps = -(-N_BITS // max(len(short), 1))
    short = np.tile(short, (reps, 1))[:N_BITS]
    return short.astype(np.int32), long.astype(np.int32)


_BRISK_XY, _BRISK_LV = _brisk_pattern()
_BRISK_SHORT, _BRISK_LONG = _pairs_by_distance(_BRISK_XY, 9.75, 13.67)
_FREAK_XY, _FREAK_LV = _freak_pattern()


def _freak_pairs() -> tuple[np.ndarray, np.ndarray]:
    """512 seeded coarse-to-fine pairs (stand-in for OpenCV's trained table)
    + 42 symmetric orientation pairs (opposite points of each ring)."""
    n = _FREAK_XY.shape[0]
    ii, jj = np.triu_indices(n, 1)
    pairs = np.stack([ii, jj], 1)
    r = np.linalg.norm(_FREAK_XY, axis=1)
    coarse = r[ii] + r[jj]                     # prefer coarse first (FREAK order)
    order = np.argsort(-coarse, kind="stable")
    rng = np.random.default_rng(77)
    keep = order[rng.permutation(len(order))[: N_BITS]]
    desc_pairs = pairs[np.sort(keep)]
    # orientation pairs: opposite points within each ring (k, k+3 of 6)
    opairs = []
    for ring in range(7):
        base = 1 + 6 * ring
        for k in range(3):
            opairs.append((base + k, base + k + 3))
    return desc_pairs.astype(np.int32), np.array(opairs, np.int32)


_FREAK_DESC_PAIRS, _FREAK_ORI_PAIRS = _freak_pairs()


N_ROT = 30                # pre-rotated pattern grids (ORB's 2pi/30 binning)
_BANK_CACHE: dict = {}


def _pattern_tap_bank(
    pat_xy: np.ndarray, pat_lv: np.ndarray, n_rot: int
) -> tuple[np.ndarray, np.ndarray]:
    """Bilinear tap tables for n_rot pre-rotated copies of the pattern.

    Returns (idx (n_rot*K, 4) int32 into the blur-level-major (3*P*P) patch
    stack, w (n_rot*K, 4) float32).  The trace expands these into a dense
    sampling matrix (small constants in the program; the dense matrix would
    blow the remote-compile payload)."""
    key = (pat_xy.tobytes(), pat_lv.tobytes(), n_rot)
    if key in _BANK_CACHE:
        return _BANK_CACHE[key]
    idx_all, w_all = [], []
    for b in range(n_rot):
        th = b * 2.0 * np.pi / n_rot
        c, s = np.cos(th), np.sin(th)
        px = (c * pat_xy[:, 0] - s * pat_xy[:, 1]) + (PATCH - 1) / 2.0
        py = (s * pat_xy[:, 0] + c * pat_xy[:, 1]) + (PATCH - 1) / 2.0
        x0 = np.clip(np.floor(px), 0, PATCH - 2).astype(np.int64)
        y0 = np.clip(np.floor(py), 0, PATCH - 2).astype(np.int64)
        fx = np.clip(px - x0, 0.0, 1.0)
        fy = np.clip(py - y0, 0.0, 1.0)
        base = pat_lv.astype(np.int64) * (PATCH * PATCH) + y0 * PATCH + x0
        idx_all.append(np.stack([base, base + 1, base + PATCH, base + PATCH + 1], -1))
        w_all.append(
            np.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], -1)
        )
    bank = (
        np.concatenate(idx_all).astype(np.int32),
        np.concatenate(w_all).astype(np.float32),
    )
    _BANK_CACHE[key] = bank
    return bank


def _sample_pattern(
    img: jax.Array,
    kp: ScaleKeypoints,
    pat_xy: np.ndarray,       # (K, 2)
    pat_lv: np.ndarray,       # (K,) blur level id
    abin: jax.Array | None,   # (N,) int32 rotation bin, or None for upright
) -> tuple[jax.Array, jax.Array]:
    """Sample all pattern points for all keypoints: (N, K) intensities +
    validity.  Patches are sliced at each keypoint's own octave, from the
    blur stack matching each pattern point's smoothing level.

    Sampling is ONE bf16 matmul of the (N, 3*P*P) patch stacks against a
    bank of N_ROT pre-rotated bilinear-weight rows + a one-hot bin select,
    in place of per-keypoint continuous-angle gathers (rotation therefore
    quantizes to 2pi/30, the ORB trade).

    Precision: the matmul casts patch intensities (0-255) and bilinear
    weights to bf16 (~8-bit mantissa) with f32 accumulation, adding ~±0.5
    grey-level error to each sampled intensity on top of the rotation
    snap.  Descriptor bits from near-tie comparisons (|Ia - Ib| < ~1 grey
    level) can flip vs an f32 sampling path; matching is Hamming-distance
    ranking, so a handful of unstable bits out of 512 does not change
    nearest-neighbour assignment in practice."""
    N = kp.pts.shape[0]
    K = pat_xy.shape[0]
    n_rot = 1 if abin is None else N_ROT
    idx_t, w_t = _pattern_tap_bank(pat_xy, pat_lv, n_rot)

    pix = jnp.arange(3 * PATCH * PATCH, dtype=jnp.int32)
    S = jnp.zeros((idx_t.shape[0], 3 * PATCH * PATCH), jnp.float32)
    for t in range(4):
        S = S + (jnp.asarray(idx_t[:, t])[:, None] == pix[None, :]) * jnp.asarray(
            w_t[:, t]
        )[:, None]

    out = jnp.zeros((N, K), jnp.float32)
    valid = jnp.zeros((N,), bool)
    level = img
    g5 = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]
    for o in range(N_OCTAVES):
        H, W = level.shape
        if H < PATCH or W < PATCH:
            # octave smaller than the sampling patch (tiny images): its
            # keypoints stay invalid (detection's border mask already
            # rejects them; KITTI-sized images never hit this)
            break
        blurs = []
        for sig in BLUR_SIGMAS:
            r = max(int(math.ceil(2.5 * sig)), 1)
            x = np.arange(-r, r + 1)
            k1 = np.exp(-0.5 * (x / sig) ** 2)
            k1 = list((k1 / k1.sum()).astype(np.float32))
            blurs.append(_sep_conv(level, k1, k1))
        stack = jnp.stack(blurs)                       # (3, H, W)

        xy = (kp.pts + 0.5) / (2.0 ** o) - 0.5
        corner = jnp.round(xy).astype(jnp.int32) - PATCH // 2
        inside = (
            (corner[:, 0] >= 0) & (corner[:, 0] <= W - PATCH)
            & (corner[:, 1] >= 0) & (corner[:, 1] <= H - PATCH)
        )
        corner = jnp.stack(
            [jnp.clip(corner[:, 0], 0, W - PATCH), jnp.clip(corner[:, 1], 0, H - PATCH)], -1
        )
        patches_all = _slice_patches_multi(stack, corner, PATCH)  # (N, 3, P, P)
        flat3 = patches_all.reshape(N, 3 * PATCH * PATCH)
        sampled = jax.lax.dot_general(
            flat3.astype(jnp.bfloat16), S.astype(jnp.bfloat16),
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )                                               # (N, n_rot*K)
        if abin is None:
            v = sampled
        else:
            onehot = (
                jnp.arange(N_ROT, dtype=jnp.int32)[None, :] == abin[:, None]
            ).astype(jnp.float32)
            v = jnp.einsum("nb,nbk->nk", onehot, sampled.reshape(N, N_ROT, K))
        sel = kp.octave == o
        out = jnp.where(sel[:, None], v, out)
        valid = jnp.where(sel, inside, valid)
        level = _sep_conv(level, g5, g5)[::2, ::2]
    return out, valid & kp.mask


def _pack_bits(bits: jax.Array) -> jax.Array:
    """(N, 512) bool -> (N, 16) uint32."""
    words = bits.reshape(bits.shape[0], -1, 32)
    w = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(jnp.where(words, w, jnp.uint32(0)), axis=-1, dtype=jnp.uint32)


def brisk_descriptors(
    img: jax.Array, kp: ScaleKeypoints
) -> tuple[jax.Array, jax.Array]:
    """(N, 16) uint32 BRISK descriptors + validity.

    Two sampling passes: upright for the long-pair orientation estimate
    (the paper's local-gradient sum), then rotated for the 512 short-pair
    comparisons."""
    vals, valid = _sample_pattern(img, kp, _BRISK_XY, _BRISK_LV, None)
    li, lj = jnp.asarray(_BRISK_LONG[:, 0]), jnp.asarray(_BRISK_LONG[:, 1])
    pat = jnp.asarray(_BRISK_XY)
    dxy = jnp.take(pat, lj, 0) - jnp.take(pat, li, 0)            # (L, 2)
    dI = jnp.take(vals, lj, 1) - jnp.take(vals, li, 1)           # (N, L)
    g = jnp.einsum("nl,lk->nk", dI / jnp.maximum(jnp.sum(dxy ** 2, -1), 1e-9), dxy)
    angle = jnp.arctan2(g[:, 1], g[:, 0])
    abin = jnp.mod(jnp.round(angle * (N_ROT / (2.0 * jnp.pi))).astype(jnp.int32), N_ROT)

    vals_r, valid_r = _sample_pattern(img, kp, _BRISK_XY, _BRISK_LV, abin)
    si, sj = jnp.asarray(_BRISK_SHORT[:, 0]), jnp.asarray(_BRISK_SHORT[:, 1])
    bits = jnp.take(vals_r, si, 1) < jnp.take(vals_r, sj, 1)
    return _pack_bits(bits), valid & valid_r


def freak_descriptors(
    img: jax.Array, kp: ScaleKeypoints
) -> tuple[jax.Array, jax.Array]:
    """(N, 16) uint32 FREAK descriptors + validity (retinal pattern,
    symmetric-pair orientation, coarse-to-fine comparisons)."""
    vals, valid = _sample_pattern(img, kp, _FREAK_XY, _FREAK_LV, None)
    oi, oj = jnp.asarray(_FREAK_ORI_PAIRS[:, 0]), jnp.asarray(_FREAK_ORI_PAIRS[:, 1])
    pat = jnp.asarray(_FREAK_XY)
    dxy = jnp.take(pat, oi, 0) - jnp.take(pat, oj, 0)
    dxy = dxy / jnp.maximum(jnp.linalg.norm(dxy, axis=-1, keepdims=True), 1e-9)
    dI = jnp.take(vals, oi, 1) - jnp.take(vals, oj, 1)
    g = jnp.einsum("nl,lk->nk", dI, dxy)
    angle = jnp.arctan2(g[:, 1], g[:, 0])
    abin = jnp.mod(jnp.round(angle * (N_ROT / (2.0 * jnp.pi))).astype(jnp.int32), N_ROT)

    vals_r, valid_r = _sample_pattern(img, kp, _FREAK_XY, _FREAK_LV, abin)
    di, dj = jnp.asarray(_FREAK_DESC_PAIRS[:, 0]), jnp.asarray(_FREAK_DESC_PAIRS[:, 1])
    bits = jnp.take(vals_r, di, 1) < jnp.take(vals_r, dj, 1)
    return _pack_bits(bits), valid & valid_r
