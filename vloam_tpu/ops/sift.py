"""SIFT — DoG scale-space detector + 128-d gradient-histogram descriptor.

Parity target: the reference's ``DetectorType::SIFT`` / ``DescriptorType::SIFT``
alternatives (image_util.cpp:104-108,316-320 via cv::SIFT::create) and the
FLANN float matcher (image_util.cpp:366-378).

Formulation — everything fixed-shape, batched over keypoints:
  * the Gaussian/DoG pyramid is a stack of separable convolutions per octave
    (static octave count, so XLA sees a fixed op graph);
  * scale-space extrema = two shifted-min/max passes over (levels, H, W)
    versus the 26-neighbourhood, scored by |DoG| with a Hessian edge gate;
  * per-octave ``approx_max_k`` keeps a fixed keypoint budget, merged across
    octaves with octave-id bookkeeping;
  * orientation + descriptor sample a rotated 16x16 gradient grid with the
    36-bin pre-rotated sampling bank (one bf16 matmul + one-hot select;
    exactly lossless because the orientation is already a 36-bin histogram
    peak) and soft-bin into the classic 4x4x8 histogram as one einsum.

Simplifications vs OpenCV (documented, not silent): no 2x initial
upsampling, no subpixel (quadratic) extremum refinement, single dominant
orientation per keypoint.  These trade <1 px localisation for a jit-once
fixed-shape graph; the ratio-test matcher dominates end-to-end match quality
at VO feature counts.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from vloam_tpu.ops.image_ops import _sep_conv, _slice_patches

N_OCTAVES = 4
S = 3                      # intra-octave scales; 5 DoG levels, 3 searchable
SIGMA0 = 1.6
EDGE_R = 10.0              # Hessian edge-ratio gate (Lowe's r=10)
PATCH = 24                 # descriptor support patch (octave pixels)
DESC_GRID = 16             # sample grid for the 4x4x8 histogram


class SiftKeypoints(NamedTuple):
    pts: jax.Array          # (N, 2) full-resolution xy
    mask: jax.Array         # (N,)
    response: jax.Array     # (N,) |DoG|
    octave: jax.Array       # (N,) int32
    level: jax.Array        # (N,) int32 DoG level within octave (1..S)
    angle: jax.Array        # (N,) radians (0 until oriented)


def _gauss_kernel(sigma: float) -> list[float]:
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return list((k / k.sum()).astype(np.float32))


def gaussian_octaves(img: jax.Array) -> list[jax.Array]:
    """[(S+3, H_o, W_o)] per octave: incremental Gaussian blurs."""
    octaves = []
    base = img
    # incremental sigmas: level k has total sigma SIGMA0 * 2^(k/S)
    inc = [
        SIGMA0 * (2.0 ** ((k + 1) / S)) * math.sqrt(1.0 - 2.0 ** (-2.0 / S))
        for k in range(S + 2)
    ]
    for _ in range(N_OCTAVES):
        levels = [_sep_conv(base, _gauss_kernel(SIGMA0), _gauss_kernel(SIGMA0))]
        for k in range(S + 2):
            g = _gauss_kernel(inc[k])
            levels.append(_sep_conv(levels[-1], g, g))
        octaves.append(jnp.stack(levels))
        base = levels[S][::2, ::2]       # the 2x-sigma level seeds the next octave
    return octaves


def _extrema_scores(dog: jax.Array, contrast_thresh: float) -> jax.Array:
    """dog: (L, H, W).  Scores |dog| at 26-neighbourhood extrema of the
    middle levels, 0 elsewhere.  Returns (L-2, H, W)."""
    def shift_minmax(x):
        # neighbourhood min/max EXCLUDING the centre pixel
        mn = jnp.full_like(x, jnp.inf)
        mx = jnp.full_like(x, -jnp.inf)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                r = jnp.roll(x, (dy, dx), axis=(1, 2))
                mn = jnp.minimum(mn, r)
                mx = jnp.maximum(mx, r)
        return mn, mx

    mn, mx = shift_minmax(dog)
    c = dog[1:-1]
    # extremum vs the 8 spatial neighbours at own level, and the 9 cells
    # (8 neighbours + centre) of the levels above and below
    is_max = (
        (c > mx[1:-1]) & (c >= mx[:-2]) & (c >= mx[2:])
        & (c > dog[:-2]) & (c > dog[2:])
    )
    is_min = (
        (c < mn[1:-1]) & (c <= mn[:-2]) & (c <= mn[2:])
        & (c < dog[:-2]) & (c < dog[2:])
    )
    # Hessian edge gate on the centre level
    dxx = jnp.roll(c, -1, 2) + jnp.roll(c, 1, 2) - 2 * c
    dyy = jnp.roll(c, -1, 1) + jnp.roll(c, 1, 1) - 2 * c
    dxy = 0.25 * (
        jnp.roll(c, (-1, -1), (1, 2)) + jnp.roll(c, (1, 1), (1, 2))
        - jnp.roll(c, (-1, 1), (1, 2)) - jnp.roll(c, (1, -1), (1, 2))
    )
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    edge_ok = (det > 0) & (tr * tr / jnp.maximum(det, 1e-12) < (EDGE_R + 1) ** 2 / EDGE_R)
    strong = jnp.abs(c) > contrast_thresh
    return jnp.where((is_max | is_min) & edge_ok & strong, jnp.abs(c), 0.0)


def detect(
    img: jax.Array,
    max_keypoints: int = 1024,
    contrast_thresh: float = 1.0,   # on [0, 255] images ~ Lowe's 0.04*255/S
) -> SiftKeypoints:
    """DoG keypoints with a fixed total budget (per-octave approx top-k)."""
    octs = gaussian_octaves(img)
    per_oct = max_keypoints // N_OCTAVES
    pts, msk, rsp, ocs, lvs = [], [], [], [], []
    for o, g in enumerate(octs):
        dog = g[1:] - g[:-1]                       # (S+2, H, W)
        sc = _extrema_scores(dog, contrast_thresh) # (S, H, W)
        L, H, W = sc.shape
        # exclude borders (descriptor support)
        yy = jax.lax.broadcasted_iota(jnp.int32, (L, H, W), 1)
        xx = jax.lax.broadcasted_iota(jnp.int32, (L, H, W), 2)
        b = PATCH // 2 + 1
        sc = jnp.where((yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b), sc, 0.0)
        flat = sc.reshape(1, -1)
        top, idx = jax.lax.approx_max_k(flat, per_oct, recall_target=0.95)
        top, idx = top[0], idx[0]
        lvl = idx // (H * W)
        rem = idx % (H * W)
        x = (rem % W).astype(jnp.float32)
        y = (rem // W).astype(jnp.float32)
        scale_f = float(2 ** o)
        pts.append(jnp.stack([(x + 0.5) * scale_f - 0.5, (y + 0.5) * scale_f - 0.5], -1))
        msk.append(top > 0.0)
        rsp.append(top)
        ocs.append(jnp.full((per_oct,), o, jnp.int32))
        lvs.append(lvl.astype(jnp.int32) + 1)
    kp = SiftKeypoints(
        pts=jnp.concatenate(pts),
        mask=jnp.concatenate(msk),
        response=jnp.concatenate(rsp),
        octave=jnp.concatenate(ocs),
        level=jnp.concatenate(lvs),
        angle=jnp.zeros((per_oct * N_OCTAVES,), jnp.float32),
    )
    return kp


def _patch_grads(patch: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Central-difference gradients of (N, P, P) patches."""
    gx = 0.5 * (jnp.roll(patch, -1, 2) - jnp.roll(patch, 1, 2))
    gy = 0.5 * (jnp.roll(patch, -1, 1) - jnp.roll(patch, 1, 1))
    return gx, gy


def _gather_patches_multi_octave(octs, kp: SiftKeypoints):
    """(N, PATCH, PATCH) patches, each sliced from its keypoint's octave's
    Gaussian level.  Static loop over octaves; keypoints select their own."""
    N = kp.pts.shape[0]
    out = jnp.zeros((N, PATCH, PATCH), jnp.float32)
    for o, g in enumerate(octs):
        H, W = g.shape[1:]
        xy = (kp.pts + 0.5) / (2.0 ** o) - 0.5
        corner = jnp.round(xy).astype(jnp.int32) - PATCH // 2
        corner = jnp.stack(
            [jnp.clip(corner[:, 0], 0, W - PATCH), jnp.clip(corner[:, 1], 0, H - PATCH)], -1
        )
        # middle Gaussian level approximates each keypoint's own level: the
        # descriptor is normalised, so the residual blur difference washes out
        img_o = g[S // 2 + 1]
        p = _slice_patches(img_o, corner, PATCH)
        out = jnp.where((kp.octave == o)[:, None, None], p, out)
    return out


def orient(octs, kp: SiftKeypoints) -> SiftKeypoints:
    """Dominant gradient orientation (36-bin histogram, Gaussian weighted)."""
    patches = _gather_patches_multi_octave(octs, kp)
    gx, gy = _patch_grads(patches)
    mag = jnp.sqrt(gx * gx + gy * gy)
    ang = jnp.arctan2(gy, gx)                       # [-pi, pi]
    ax = jnp.arange(PATCH, dtype=jnp.float32) - (PATCH - 1) / 2.0
    w = jnp.exp(-(ax[None, :] ** 2 + ax[:, None] ** 2) / (2 * (0.5 * PATCH / 3) ** 2))
    bins = jnp.floor((ang / (2 * jnp.pi) + 0.5) * 36).astype(jnp.int32) % 36
    onehot = jax.nn.one_hot(bins, 36, dtype=jnp.float32)       # (N, P, P, 36)
    hist = jnp.einsum("npqb,npq,pq->nb", onehot, mag, w)
    peak = jnp.argmax(hist, axis=-1)
    angle = (peak.astype(jnp.float32) + 0.5) / 36.0 * 2 * jnp.pi - jnp.pi
    return kp._replace(angle=angle)


def _sift_rot_bank() -> tuple[np.ndarray, np.ndarray]:
    """Bilinear tap tables of the 36 pre-rotated DESC_GRID^2 sample grids.

    SIFT's orientation is ALREADY the peak of a 36-bin histogram (see
    orientation()), so snapping the sampling rotation to those same 36 bin
    centres is exactly lossless — unlike the 2pi/30 quantization trade the
    ORB/AKAZE/BRISK banks make."""
    global _SIFT_BANK
    if _SIFT_BANK is not None:
        return _SIFT_BANK
    u = (np.arange(DESC_GRID, dtype=np.float64) + 0.5) / DESC_GRID - 0.5
    gu, gv = np.meshgrid(u, u, indexing="xy")
    gu, gv = gu.reshape(-1), gv.reshape(-1)
    span = PATCH * 0.8
    idx_all, w_all = [], []
    for b in range(36):
        th = (b + 0.5) / 36.0 * 2.0 * np.pi - np.pi   # the orientation() centres
        c, s = np.cos(th), np.sin(th)
        px = (c * gu - s * gv) * span + (PATCH - 1) / 2.0
        py = (s * gu + c * gv) * span + (PATCH - 1) / 2.0
        x0 = np.clip(np.floor(px), 0, PATCH - 2).astype(np.int64)
        y0 = np.clip(np.floor(py), 0, PATCH - 2).astype(np.int64)
        fx = np.clip(px - x0, 0.0, 1.0)
        fy = np.clip(py - y0, 0.0, 1.0)
        base = y0 * PATCH + x0
        idx_all.append(np.stack([base, base + 1, base + PATCH, base + PATCH + 1], -1))
        w_all.append(
            np.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], -1)
        )
    _SIFT_BANK = (
        np.concatenate(idx_all).astype(np.int32),
        np.concatenate(w_all).astype(np.float32),
    )
    return _SIFT_BANK


_SIFT_BANK = None


def describe(octs, kp: SiftKeypoints) -> tuple[jax.Array, jax.Array]:
    """128-d descriptors: rotated 16x16 gradient samples soft-binned 4x4x8."""
    patches = _gather_patches_multi_octave(octs, kp)
    gx, gy = _patch_grads(patches)
    N = kp.pts.shape[0]

    # rotated sample grid: ONE bf16 matmul against the 36-bin sampling
    # bank + a one-hot bin select instead of per-keypoint bilinear gathers
    u = (jnp.arange(DESC_GRID, dtype=jnp.float32) + 0.5) / DESC_GRID - 0.5
    gu, gv = jnp.meshgrid(u, u, indexing="xy")          # (G, G)
    c, s = jnp.cos(kp.angle), jnp.sin(kp.angle)
    abin = jnp.mod(
        jnp.round((kp.angle + jnp.pi) / (2.0 * jnp.pi) * 36.0 - 0.5).astype(jnp.int32), 36
    )

    idx_t, w_t = _sift_rot_bank()
    pix = jnp.arange(PATCH * PATCH, dtype=jnp.int32)
    S = jnp.zeros((idx_t.shape[0], PATCH * PATCH), jnp.float32)
    for t in range(4):
        S = S + (jnp.asarray(idx_t[:, t])[:, None] == pix[None, :]) * jnp.asarray(
            w_t[:, t]
        )[:, None]
    feats2 = jnp.stack([gx, gy], axis=0).reshape(2 * N, PATCH * PATCH)
    all_bins = jax.lax.dot_general(
        feats2.astype(jnp.bfloat16), S.astype(jnp.bfloat16),
        (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).reshape(2, N, 36, DESC_GRID * DESC_GRID)
    onehot = (jnp.arange(36, dtype=jnp.int32)[None, :] == abin[:, None]).astype(
        jnp.float32
    )
    s2 = jnp.einsum("nb,cnbs->cns", onehot, all_bins)
    sgx = s2[0].reshape(N, DESC_GRID, DESC_GRID)
    sgy = s2[1].reshape(N, DESC_GRID, DESC_GRID)
    # rotate gradients into the keypoint frame
    rgx = c[:, None, None] * sgx + s[:, None, None] * sgy
    rgy = -s[:, None, None] * sgx + c[:, None, None] * sgy
    mag = jnp.sqrt(rgx * rgx + rgy * rgy)
    ang = jnp.arctan2(rgy, rgx)

    # Gaussian spatial weight over the normalized grid
    w = jnp.exp(-(gu ** 2 + gv ** 2) / (2 * 0.25))
    mag = mag * w[None]

    # soft binning: spatial tent into 4x4 cells, orientation tent into 8 bins
    cell = (jnp.arange(DESC_GRID, dtype=jnp.float32) + 0.5) / DESC_GRID * 4.0 - 0.5
    def tent(pos, centers):
        return jnp.maximum(0.0, 1.0 - jnp.abs(pos[:, None] - centers[None, :]))
    centers = jnp.arange(4, dtype=jnp.float32)
    wx = tent(cell, centers)                            # (G, 4)
    wy = tent(cell, centers)
    ob = (ang / (2 * jnp.pi) + 0.5) * 8.0 - 0.5         # (N, G, G)
    k = jnp.arange(8, dtype=jnp.float32)
    d = jnp.abs(ob[..., None] - k[None, None, None, :])
    wo = jnp.maximum(0.0, 1.0 - jnp.minimum(d, 8.0 - d))  # circular tent (N,G,G,8)
    # rows of the grid are y (axis 1 of meshgrid 'xy': gv varies along axis 0)
    desc = jnp.einsum("nyxo,yr,xc,nyx->nrco", wo, wy, wx, mag)
    desc = desc.reshape(N, 128)
    # normalise, clip, renormalise (Lowe's illumination robustness)
    desc = desc / jnp.maximum(jnp.linalg.norm(desc, axis=1, keepdims=True), 1e-9)
    desc = jnp.minimum(desc, 0.2)
    desc = desc / jnp.maximum(jnp.linalg.norm(desc, axis=1, keepdims=True), 1e-9)
    return desc, kp.mask


def sift_features(
    img: jax.Array, max_keypoints: int = 1024, contrast_thresh: float = 1.0
) -> tuple[SiftKeypoints, jax.Array]:
    """Detect + orient + describe in one call.  Returns (keypoints, (N, 128))."""
    octs = gaussian_octaves(img)
    kp = detect(img, max_keypoints, contrast_thresh)
    kp = orient(octs, kp)
    desc, _ = describe(octs, kp)
    return kp, desc


def match_float_descriptors(
    desc0: jax.Array, mask0: jax.Array,
    desc1: jax.Array, mask1: jax.Array,
    ratio: float = 0.8,
    select: str = "knn",
) -> tuple[jax.Array, jax.Array]:
    """L2 matching for float descriptors (SIFT) as one matmul.

    |a-b|^2 = |a|^2 + |b|^2 - 2 a.b — one (N0, N1) matmul.  ``select`` as in
    orb.match_descriptors: "knn" = 2-NN + Lowe ratio, "nn" = mutual NN.
    """
    d2 = (
        jnp.sum(desc0 ** 2, 1)[:, None] + jnp.sum(desc1 ** 2, 1)[None, :]
        - 2.0 * desc0 @ desc1.T
    )
    d2 = jnp.where(mask1[None, :], d2, 1e9)
    if select == "nn":
        d2 = jnp.where(mask0[:, None], d2, 1e9)
        fwd = jnp.argmin(d2, axis=1)
        bwd = jnp.argmin(d2, axis=0)
        best = jnp.take_along_axis(d2, fwd[:, None], axis=1)[:, 0]
        mutual = jnp.take(bwd, fwd) == jnp.arange(desc0.shape[0])
        return fwd, mask0 & mutual & (best < 1e8)
    neg, idx = jax.lax.top_k(-d2, 2)
    best, second = -neg[:, 0], -neg[:, 1]
    valid = mask0 & (best < ratio * ratio * second) & (best < 1e8)
    return idx[:, 0], valid


def match_float_descriptors_approx(
    desc0: jax.Array, mask0: jax.Array,
    desc1: jax.Array, mask1: jax.Array,
    ratio: float = 0.8,
    proj_dim: int = 32,
    rerank: int = 8,
    seed: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """FLANN-equivalent approximate float matcher (MatcherType::FLANN,
    image_util.cpp:366-378).

    OpenCV FLANN builds randomized kd-trees; the fixed-shape analogue is a
    random-projection prefilter: distances in a ``proj_dim``-dim sketch
    (one small matmul) select ``rerank`` candidates per query, exact L2
    re-ranks only those.  O(N^2 * proj_dim) + O(N * rerank * D) instead of
    O(N^2 * D), all fixed-shape.
    """
    key = jax.random.PRNGKey(seed)
    P = jax.random.normal(key, (desc0.shape[1], proj_dim)) / math.sqrt(proj_dim)
    s0, s1 = desc0 @ P, desc1 @ P
    d2s = (
        jnp.sum(s0 ** 2, 1)[:, None] + jnp.sum(s1 ** 2, 1)[None, :] - 2.0 * s0 @ s1.T
    )
    d2s = jnp.where(mask1[None, :], d2s, 1e9)
    _, cand = jax.lax.top_k(-d2s, rerank)               # (N0, rerank)
    c1 = jnp.take(desc1, cand, axis=0)                  # (N0, rerank, D)
    d2 = jnp.sum((desc0[:, None, :] - c1) ** 2, axis=-1)
    d2 = jnp.where(jnp.take(mask1, cand), d2, 1e9)
    neg, order = jax.lax.top_k(-d2, 2)
    best, second = -neg[:, 0], -neg[:, 1]
    idx = jnp.take_along_axis(cand, order[:, :1], axis=1)[:, 0]
    valid = mask0 & (best < ratio * ratio * second) & (best < 1e8)
    return idx, valid
