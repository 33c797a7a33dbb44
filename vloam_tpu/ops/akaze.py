"""AKAZE — nonlinear-diffusion scale space + M-LDB binary descriptor.

Parity target: ``DetectorType::AKAZE`` / ``DescriptorType::AKAZE``
(image_util.cpp:98-102,306-310 via cv::AKAZE::create).

Formulation:
  * the nonlinear (Perona-Malik g2) scale space is evolved with a FIXED
    number of explicit diffusion steps per sublevel — each step is two
    separable-shift gradient passes and one divergence pass, pure elementwise
    stencils, so the whole evolution is a static fused op chain (AKAZE's
    adaptive FED step schedules would make shapes/trip-counts dynamic);
  * the contrast factor k is a robust scale of the smoothed gradient
    magnitude (1.5x mean over interior pixels — stand-in for KAZE's
    70th-percentile histogram, which needs a data-dependent sort);
  * detector: scale-normalised determinant-of-Hessian extrema per sublevel
    (spatial 8-neighbourhood + adjacent sublevels), per-octave approx top-k
    budgets like ops/sift.py;
  * descriptor: M-LDB — grids of 2x2 / 3x3 / 4x4 cells over a rotated patch;
    per cell the MEANS of (intensity, dx, dy); all cell-pair comparisons per
    channel = 3*(6+36+120) = 486 bits, zero-padded to 512 = 16 uint32 words.
    Orientation is the Gaussian-weighted gradient sum over the patch.

orb.match_descriptors handles matching (Hamming, 2-NN ratio or mutual-NN).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from vloam_tpu.ops.image_ops import _sep_conv, _slice_patches

N_OCTAVES = 4
N_SUB = 3                 # sublevels per octave
FED_STEPS = 6             # explicit diffusion steps per sublevel
TAU = 0.24                # explicit step size (stability bound 0.25)
PATCH = 32
GRID = 24                 # rotated sample grid for cell means (lcm-friendly)
N_ROT = 30                # pre-rotated sampling grids (ORB's 2pi/30 binning)


def _rot_bank_build() -> tuple[np.ndarray, np.ndarray]:
    """Bilinear tap tables of the N_ROT pre-rotated GRIDxGRID sample grids.

    Returns (idx (N_ROT*GRID^2, 4) int32 flat patch indices,
             w (N_ROT*GRID^2, 4) float32 bilinear weights) — the compact form
    the trace expands into the dense sampling matrix."""
    u = (np.arange(GRID, dtype=np.float64) + 0.5) / GRID - 0.5
    gu, gv = np.meshgrid(u, u, indexing="xy")
    gu, gv = gu.reshape(-1), gv.reshape(-1)
    span = PATCH * 0.75
    idx_all, w_all = [], []
    for b in range(N_ROT):
        th = b * 2.0 * np.pi / N_ROT
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
    return (
        np.concatenate(idx_all).astype(np.int32),
        np.concatenate(w_all).astype(np.float32),
    )


_ROT_BANK: tuple[np.ndarray, np.ndarray] | None = None


def _rot_bank() -> tuple[np.ndarray, np.ndarray]:
    global _ROT_BANK
    if _ROT_BANK is None:
        _ROT_BANK = _rot_bank_build()
    return _ROT_BANK


class AkazeKeypoints(NamedTuple):
    pts: jax.Array        # (N, 2) full-res xy
    mask: jax.Array
    response: jax.Array
    octave: jax.Array     # (N,) int32
    angle: jax.Array      # (N,) radians


def _grad(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    gx = 0.5 * (jnp.roll(x, -1, 1) - jnp.roll(x, 1, 1))
    gy = 0.5 * (jnp.roll(x, -1, 0) - jnp.roll(x, 1, 0))
    return gx, gy


def _diffuse(x: jax.Array, k2: jax.Array, steps: int) -> jax.Array:
    """Explicit Perona-Malik g2 diffusion: x += tau * div(g grad x)."""
    for _ in range(steps):
        gx, gy = _grad(x)
        g = 1.0 / (1.0 + (gx * gx + gy * gy) / k2)
        fx, fy = g * gx, g * gy
        div = (
            0.5 * (jnp.roll(fx, -1, 1) - jnp.roll(fx, 1, 1))
            + 0.5 * (jnp.roll(fy, -1, 0) - jnp.roll(fy, 1, 0))
        )
        x = x + TAU * div
    return x


def nonlinear_scale_space(img: jax.Array) -> list[jax.Array]:
    """[(N_SUB, H_o, W_o)] per octave of diffused images."""
    g5 = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]
    base = _sep_conv(img, g5, g5)
    # contrast factor from the smoothed gradient (fixed-shape percentile
    # stand-in: 1.5x mean magnitude)
    gx, gy = _grad(base)
    mag = jnp.sqrt(gx * gx + gy * gy)
    k = 1.5 * jnp.mean(mag) + 1e-6
    k2 = k * k
    octaves = []
    x = base
    for _ in range(N_OCTAVES):
        subs = []
        for _ in range(N_SUB):
            x = _diffuse(x, k2, FED_STEPS)
            subs.append(x)
        octaves.append(jnp.stack(subs))
        x = x[::2, ::2]
    return octaves


def _hessian_response(x: jax.Array) -> jax.Array:
    dxx = jnp.roll(x, -1, 1) + jnp.roll(x, 1, 1) - 2 * x
    dyy = jnp.roll(x, -1, 0) + jnp.roll(x, 1, 0) - 2 * x
    dxy = 0.25 * (
        jnp.roll(x, (-1, -1), (0, 1)) + jnp.roll(x, (1, 1), (0, 1))
        - jnp.roll(x, (-1, 1), (0, 1)) - jnp.roll(x, (1, -1), (0, 1))
    )
    return dxx * dyy - dxy * dxy


def detect(
    img: jax.Array, max_keypoints: int = 1024, threshold: float = 1e-3
) -> AkazeKeypoints:
    octs = nonlinear_scale_space(img)
    per_oct = max_keypoints // N_OCTAVES
    pts, msk, rsp, ocs = [], [], [], []
    for o, subs in enumerate(octs):
        resp = jax.vmap(_hessian_response)(subs)       # (N_SUB, H, W)
        # scale normalisation (sigma^4 for det-of-Hessian; sigma ~ 2^o)
        resp = resp * float((2 ** o) ** 4)
        L, H, W = resp.shape
        mx = jnp.full_like(resp, -jnp.inf)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                mx = jnp.maximum(mx, jnp.roll(resp, (dy, dx), (1, 2)))
        is_peak = (resp > mx) & (resp > threshold)
        # adjacent sublevels (centre pixels)
        up = jnp.concatenate([resp[1:], jnp.full_like(resp[:1], -jnp.inf)])
        dn = jnp.concatenate([jnp.full_like(resp[:1], -jnp.inf), resp[:-1]])
        is_peak = is_peak & (resp > up) & (resp > dn)
        yy = jax.lax.broadcasted_iota(jnp.int32, (L, H, W), 1)
        xx = jax.lax.broadcasted_iota(jnp.int32, (L, H, W), 2)
        b = PATCH // 2 + 1
        is_peak = is_peak & (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
        score = jnp.where(is_peak, resp, 0.0).reshape(1, -1)
        top, idx = jax.lax.approx_max_k(score, per_oct, recall_target=0.95)
        top, idx = top[0], idx[0]
        rem = idx % (H * W)
        x = (rem % W).astype(jnp.float32)
        y = (rem // W).astype(jnp.float32)
        sf = float(2 ** o)
        pts.append(jnp.stack([(x + 0.5) * sf - 0.5, (y + 0.5) * sf - 0.5], -1))
        msk.append(top > 0.0)
        rsp.append(top)
        ocs.append(jnp.full((per_oct,), o, jnp.int32))
    n = per_oct * N_OCTAVES
    return AkazeKeypoints(
        jnp.concatenate(pts), jnp.concatenate(msk), jnp.concatenate(rsp),
        jnp.concatenate(ocs), jnp.zeros((n,), jnp.float32),
    )


def _ldb_pairs() -> np.ndarray:
    """(162, 2) cell-index pairs across the stacked 2x2|3x3|4x4 grids
    (cells 0-3, 4-12, 13-28): all within-grid pairs."""
    pairs = []
    off = 0
    for g in (2, 3, 4):
        n = g * g
        for i in range(n):
            for j in range(i + 1, n):
                pairs.append((off + i, off + j))
        off += n
    return np.array(pairs, np.int32)


_PAIRS = _ldb_pairs()


def describe(
    img: jax.Array, kp: AkazeKeypoints
) -> tuple[jax.Array, jax.Array, AkazeKeypoints]:
    """(N, 16) uint32 M-LDB descriptors + validity + oriented keypoints."""
    octs = nonlinear_scale_space(img)
    N = kp.pts.shape[0]

    # --- patches at each keypoint's octave (finest sublevel) ---------------
    patches = jnp.zeros((N, PATCH, PATCH), jnp.float32)
    valid = jnp.zeros((N,), bool)
    for o, subs in enumerate(octs):
        H, W = subs.shape[1:]
        if H < PATCH or W < PATCH:
            break
        xy = (kp.pts + 0.5) / (2.0 ** o) - 0.5
        corner = jnp.round(xy).astype(jnp.int32) - PATCH // 2
        inside = (
            (corner[:, 0] >= 0) & (corner[:, 0] <= W - PATCH)
            & (corner[:, 1] >= 0) & (corner[:, 1] <= H - PATCH)
        )
        corner = jnp.stack(
            [jnp.clip(corner[:, 0], 0, W - PATCH), jnp.clip(corner[:, 1], 0, H - PATCH)], -1
        )
        p = _slice_patches(subs[0], corner, PATCH)
        sel = kp.octave == o
        patches = jnp.where(sel[:, None, None], p, patches)
        valid = jnp.where(sel, inside, valid)
    valid = valid & kp.mask

    gx = 0.5 * (jnp.roll(patches, -1, 2) - jnp.roll(patches, 1, 2))
    gy = 0.5 * (jnp.roll(patches, -1, 1) - jnp.roll(patches, 1, 1))

    # --- orientation: Gaussian-weighted gradient sum ------------------------
    ax = jnp.arange(PATCH, dtype=jnp.float32) - (PATCH - 1) / 2.0
    w = jnp.exp(-(ax[None, :] ** 2 + ax[:, None] ** 2) / (2 * (PATCH / 5.0) ** 2))
    sx = jnp.einsum("nyx,yx->n", gx, w)
    sy = jnp.einsum("nyx,yx->n", gy, w)
    angle = jnp.arctan2(sy, sx)
    # ORB-style rotation quantization (12-degree bins): per-keypoint
    # continuous-angle bilinear sampling would gather ~7M elements/frame;
    # with the angle snapped to N_ROT pre-rotated sample grids the whole
    # rotated (I, dx, dy) resampling becomes ONE bf16 matmul against a
    # device-built sampling bank + a one-hot bin select.
    abin = jnp.mod(
        jnp.round(angle * (N_ROT / (2.0 * jnp.pi))).astype(jnp.int32), N_ROT
    )
    angle_q = abin.astype(jnp.float32) * (2.0 * jnp.pi / N_ROT)
    kp = kp._replace(angle=angle_q)

    # sampling bank: (N_ROT * GRID^2, PATCH^2) bilinear weights, built in
    # trace from the small tap tables (embedding the dense 70 MB matrix as a
    # literal would blow the remote-compile payload limit)
    idx_t, w_t = _rot_bank()                                  # (R*G2, 4) each
    pix = jnp.arange(PATCH * PATCH, dtype=jnp.int32)
    S = jnp.zeros((idx_t.shape[0], PATCH * PATCH), jnp.float32)
    for t in range(4):
        S = S + (jnp.asarray(idx_t[:, t])[:, None] == pix[None, :]) * jnp.asarray(
            w_t[:, t]
        )[:, None]

    feats3 = jnp.stack([patches, gx, gy], axis=0).reshape(3 * N, PATCH * PATCH)
    all_bins = jax.lax.dot_general(
        feats3.astype(jnp.bfloat16), S.astype(jnp.bfloat16),
        (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).reshape(3, N, N_ROT, GRID * GRID)
    onehot = (jnp.arange(N_ROT, dtype=jnp.int32)[None, :] == abin[:, None]).astype(
        jnp.float32
    )
    s3 = jnp.einsum("nb,cnbs->cns", onehot, all_bins)         # (3, N, G2)
    si = s3[0].reshape(N, GRID, GRID)
    sgx = s3[1].reshape(N, GRID, GRID)
    sgy = s3[2].reshape(N, GRID, GRID)
    c, s = jnp.cos(angle_q), jnp.sin(angle_q)
    # rotate gradients into the keypoint frame
    rgx = c[:, None, None] * sgx + s[:, None, None] * sgy
    rgy = -s[:, None, None] * sgx + c[:, None, None] * sgy

    # --- cell means for 2x2 / 3x3 / 4x4 grids -------------------------------
    def cell_means(f, g):
        m = f.reshape(N, g, GRID // g, g, GRID // g).mean(axis=(2, 4))
        return m.reshape(N, g * g)

    feats = []
    for ch in (si, rgx, rgy):
        feats.append(jnp.concatenate(
            [cell_means(ch, 2), cell_means(ch, 3), cell_means(ch, 4)], axis=1
        ))                                             # (N, 29) each
    ii = jnp.asarray(_PAIRS[:, 0])
    jj = jnp.asarray(_PAIRS[:, 1])
    bits = jnp.concatenate(
        [jnp.take(f, ii, 1) > jnp.take(f, jj, 1) for f in feats], axis=1
    )                                                  # (N, 486)
    bits = jnp.pad(bits, ((0, 0), (0, 512 - bits.shape[1])))
    words = bits.reshape(N, 16, 32)
    wgt = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    desc = jnp.sum(jnp.where(words, wgt, jnp.uint32(0)), axis=-1, dtype=jnp.uint32)
    return desc, valid, kp


def akaze_features(
    img: jax.Array, max_keypoints: int = 1024, threshold: float = 1e-3
) -> tuple[AkazeKeypoints, jax.Array, jax.Array]:
    """Detect + describe.  Returns (keypoints, (N, 16) uint32, valid)."""
    kp = detect(img, max_keypoints, threshold)
    desc, valid, kp = describe(img, kp)
    return kp, desc, valid
