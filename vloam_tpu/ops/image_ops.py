"""2D feature frontend — reference: image_util.cpp (Shi-Tomasi + pyramidal LK).

Formulation:
  * Shi-Tomasi response is the min eigenvalue of the 5x5 structure tensor —
    separable box/Sobel convolutions that XLA fuses into elementwise passes
    (reference: cv::goodFeaturesToTrack, image_util.cpp:16-58).
  * Corner selection = local-max suppression (the minDistance=7.5 greedy of
    OpenCV becomes a 7x7 window max) + quality gate + global top-k into a
    fixed (max_corners,) buffer.
  * Bucketed NMS replicates the reference's own keyPointsNMS
    (image_util.cpp:202-261): 100x100 px buckets, top responses per bucket.
  * Pyramidal Lucas-Kanade: 15x15 window, 3 levels, 10 iterations — a
    vmapped gather/solve loop (reference: cv::calcOpticalFlowPyrLK with
    winSize 15x15, maxLevel 2, 10 iters/0.03 eps, image_util.cpp:526,562).

All images are (H, W) float32 in [0, 255].  Keypoints are (N, 2) float32
``(x, y)`` pixel coords with a validity mask — fixed shapes throughout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vloam_tpu.config import VisualConfig


def _conv1d_shift(img: jax.Array, k: jax.Array, axis: int) -> jax.Array:
    """1D SAME convolution along ``axis`` as a shift-and-add.

    A single-channel (1,1,H,W) conv_general_dilated gives a convolution
    library nothing to parallelise over channels; k-1 padded slices + fused
    multiply-adds run as ONE elementwise pass over the image instead.
    """
    r = len(k) // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, r)
    padded = jnp.pad(img, pad)
    n = img.shape[axis]
    out = None
    for i, ki in enumerate(k):
        sl = jax.lax.slice_in_dim(padded, i, i + n, axis=axis)
        term = ki * sl
        out = term if out is None else out + term
    return out


def _sep_conv(img: jax.Array, kx, ky) -> jax.Array:
    """Separable 2D convolution (SAME padding) via two shift-and-add passes.

    ``kx``/``ky`` must be static Python sequences of floats (the taps are
    baked into the fused elementwise program).
    """
    out = _conv1d_shift(img, list(ky), 0)
    return _conv1d_shift(out, list(kx), 1)


def sobel_gradients(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    smooth = [0.25, 0.5, 0.25]
    diff = [-0.5, 0.0, 0.5]
    ix = _sep_conv(img, diff, smooth)
    iy = _sep_conv(img, smooth, diff)
    return ix, iy


def shi_tomasi_response(img: jax.Array, block_size: int = 5) -> jax.Array:
    """Min-eigenvalue corner response with a block_size box window."""
    ix, iy = sobel_gradients(img)
    box = [1.0 / block_size] * block_size
    sxx = _sep_conv(ix * ix, box, box)
    syy = _sep_conv(iy * iy, box, box)
    sxy = _sep_conv(ix * iy, box, box)
    tr = sxx + syy
    det_part = jnp.sqrt(jnp.maximum((sxx - syy) ** 2 + 4.0 * sxy * sxy, 0.0))
    return 0.5 * (tr - det_part)


def fast_response(img: jax.Array, threshold: float = 20.0) -> jax.Array:
    """FAST-9/16 corner response (reference alternative DetectorType::FAST,
    image_util.cpp:83-87 via cv::FastFeatureDetector).

    A pixel is a corner when >= 9 contiguous pixels on the radius-3 Bresenham
    circle are all brighter than center+t or all darker than center-t; the
    response is the summed threshold excess over the circle (the standard
    non-max-suppression score).  Formulated as 16 static rolls + a circular
    9-window AND — one fused elementwise pass, no gathers.
    """
    # radius-3 Bresenham circle offsets (dy, dx), OpenCV ordering
    offs = [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
            (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)]
    circ = [jnp.roll(img, (-dy, -dx), axis=(0, 1)) for (dy, dx) in offs]
    brighter = [c > img + threshold for c in circ]
    darker = [c < img - threshold for c in circ]

    def arc9(flags):
        hit = jnp.zeros_like(flags[0])
        for s in range(16):
            run = flags[s]
            for k in range(1, 9):
                run = run & flags[(s + k) % 16]
            hit = hit | run
        return hit

    is_corner = arc9(brighter) | arc9(darker)
    excess = sum(jnp.maximum(jnp.abs(c - img) - threshold, 0.0) for c in circ)
    return jnp.where(is_corner, excess, 0.0)


def detect_corners(
    img: jax.Array, cfg: VisualConfig
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Corner detection -> fixed-size (max_corners, 2) xy + mask + response.

    ``cfg.detector_type`` selects the response: "shitomasi" (the reference's
    default goodFeaturesToTrack) or "fast" (FAST-9/16).  Selection (local-max
    suppression at minDistance, quality gate, global top-k) is shared.
    """
    if cfg.detector_type == "shitomasi":
        resp = shi_tomasi_response(img, cfg.block_size)
        quality_gate = True
    elif cfg.detector_type == "fast":
        resp = fast_response(img, cfg.fast_threshold)
        quality_gate = False            # FAST thresholds absolutely, not vs max
    else:
        raise ValueError(
            f"unsupported detector_type={cfg.detector_type!r} (shitomasi|fast)"
        )
    H, W = resp.shape

    # local-max suppression over a (2r+1)^2 window, r from minDistance;
    # separable shift-max (two fused elementwise passes) instead of reduce_window
    r = max(int(cfg.min_distance // 2), 1)

    def _shift_max(x, axis):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        p = jnp.pad(x, pad, constant_values=-jnp.inf)
        n = x.shape[axis]
        out = x
        for i in range(2 * r + 1):
            out = jnp.maximum(out, jax.lax.slice_in_dim(p, i, i + n, axis=axis))
        return out

    local_max = _shift_max(_shift_max(resp, 0), 1)
    if quality_gate:
        is_peak = (resp >= local_max) & (resp >= cfg.quality_level * jnp.max(resp))
    else:
        is_peak = (resp >= local_max) & (resp > 0.0)

    # keep a safety border (gradients/window invalid at edges)
    b = cfg.block_size
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    is_peak = is_peak & (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)

    neg_big = jnp.float32(-3.4e38)
    score = jnp.where(is_peak, resp, neg_big).reshape(-1)
    top, idx = jax.lax.approx_max_k(score[None, :], cfg.max_corners, recall_target=0.95)
    top, idx = top[0], idx[0]
    pts = jnp.stack([(idx % W).astype(jnp.float32), (idx // W).astype(jnp.float32)], axis=-1)
    mask = top > neg_big
    return pts, mask, top


def bucket_nms(
    pts: jax.Array, mask: jax.Array, resp: jax.Array, cfg: VisualConfig
) -> jax.Array:
    """Reference keyPointsNMS (image_util.cpp:202-261): cap keypoints per
    100x100 bucket at max_total/(n_buckets).  Returns an updated mask."""
    bx = (pts[:, 0] / cfg.nms_bucket_width).astype(jnp.int32)
    by = (pts[:, 1] / cfg.nms_bucket_height).astype(jnp.int32)
    nbx = -(-cfg.img_width // cfg.nms_bucket_width)
    nby = -(-cfg.img_height // cfg.nms_bucket_height)
    cap = max(cfg.nms_max_total // (nbx * nby), 1)
    bucket = bx * nby + by
    bucket = jnp.where(mask, bucket, nbx * nby)
    # rank within bucket by response: sort by (bucket, -resp)
    order = jnp.argsort(-jnp.where(mask, resp, -jnp.inf), stable=True)
    order = jnp.take(order, jnp.argsort(jnp.take(bucket, order), stable=True))
    b_s = jnp.take(bucket, order)
    idx = jnp.arange(pts.shape[0], dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool), b_s[1:] != b_s[:-1]])
    start = jax.lax.cummax(jnp.where(is_start, idx, 0))
    rank = idx - start
    keep_sorted = rank < cap
    keep = jnp.zeros_like(mask).at[order].set(keep_sorted)
    return mask & keep


def gaussian_pyramid(img: jax.Array, levels: int) -> list[jax.Array]:
    """[level0 (full res), ..., levelN] with 5-tap Gaussian + 2x decimation."""
    g = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]
    pyr = [img]
    for _ in range(levels):
        blurred = _sep_conv(pyr[-1], g, g)
        pyr.append(blurred[::2, ::2])
    return pyr


def _bilinear(img: jax.Array, xy: jax.Array) -> jax.Array:
    """Sample img (H, W) at xy (..., 2) float coords with clamping."""
    H, W = img.shape
    x = jnp.clip(xy[..., 0], 0.0, W - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (
        i00 * (1 - fx) * (1 - fy)
        + i01 * fx * (1 - fy)
        + i10 * (1 - fx) * fy
        + i11 * fx * fy
    )


def _tent_weights(x: jax.Array, P: int) -> jax.Array:
    """Bilinear (tent) interpolation weights onto an integer grid of size P.

    x: (..., w) float coords in patch space -> (..., w, P) weights with two
    non-zeros per row.  Sampling then becomes a dense matmul — this keeps
    the KLT inner loop in batched matmuls instead of per-pixel gathers.
    """
    xc = jnp.clip(x, 0.0, P - 1.000001)
    grid = jnp.arange(P, dtype=jnp.float32)
    return jnp.maximum(0.0, 1.0 - jnp.abs(xc[..., None] - grid))


def _sample_windows(patch: jax.Array, wy: jax.Array, wx: jax.Array) -> jax.Array:
    """(N,P,P) patches x (N,w,P) row/col weights -> (N,w,w) windows via two
    batched matmuls.

    Inputs run in bf16 with f32 accumulation (tensor-core rate rather than
    the engine-wide "highest" f32 default): the rounding (2^-8 relative on
    0..255 intensities and 0..1 tent weights, ~0.5 grey level) is below
    sensor noise — KLT flow shift < 0.01 px, unlike the k-NN distance
    matmuls where bf16 is catastrophic (ops/knn.pairwise_sqdist)."""
    tmp = jnp.einsum(
        "nwp,npq->nwq",
        wy.astype(jnp.bfloat16),
        patch.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    return jnp.einsum(
        "nwq,nvq->nwv",
        tmp.astype(jnp.bfloat16),
        wx.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )


def _slice_patches(img: jax.Array, corner: jax.Array, P: int) -> jax.Array:
    """vmapped dynamic_slice: (H,W) image + (N,2) int corners -> (N,P,P)."""
    def one(c):
        return jax.lax.dynamic_slice(img, (c[1], c[0]), (P, P))

    with jax.named_scope("patch_gather"):
        return jax.vmap(one)(corner)


def _slice_patches_multi(imgs: jax.Array, corner: jax.Array, P: int) -> jax.Array:
    """(C,H,W) stacked images + (N,2) corners -> (N,C,P,P) in ONE gather."""
    C = imgs.shape[0]

    def one(c):
        return jax.lax.dynamic_slice(imgs, (0, c[1], c[0]), (C, P, P))

    with jax.named_scope("patch_gather"):
        return jax.vmap(one)(corner)


def _patch_sobel(patch: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Same separable smooth/diff taps as sobel_gradients, applied to a
    (N, P, P) patch stack — pure shift-adds, no extra device-memory traffic.
    Patch-edge pixels see wrapped taps, but the tracking window stays
    >= klt_patch_slack px inside the patch, so they are never sampled."""
    def conv(x, k, axis):
        return k[0] * jnp.roll(x, 1, axis) + k[1] * x + k[2] * jnp.roll(x, -1, axis)

    smooth = (0.25, 0.5, 0.25)
    diff = (-0.5, 0.0, 0.5)
    gx = conv(conv(patch, diff, 2), smooth, 1)
    gy = conv(conv(patch, smooth, 2), diff, 1)
    return gx, gy


def _window_hessian(Ix: jax.Array, Iy: jax.Array, w: int, cfg: VisualConfig):
    """Inverse of the 2x2 structure tensor per feature + validity gate."""
    gxx = jnp.sum(Ix * Ix, axis=(1, 2))
    gxy = jnp.sum(Ix * Iy, axis=(1, 2))
    gyy = jnp.sum(Iy * Iy, axis=(1, 2))
    det = gxx * gyy - gxy * gxy
    min_eig = 0.5 * (gxx + gyy - jnp.sqrt((gxx - gyy) ** 2 + 4 * gxy ** 2)) / (w * w)
    ok_g = (det > 1e-6) & (min_eig > cfg.klt_min_eig * 255.0 ** 2 * 0.0001)
    safe_det = jnp.where(det > 1e-6, det, 1.0)
    return gyy / safe_det, -gxy / safe_det, gxx / safe_det, ok_g


def _gn_iterations(
    patch: jax.Array,        # (N, P, P) image to track within
    T: jax.Array,            # (N, w, w) fixed template window
    Ix: jax.Array, Iy: jax.Array,   # template gradients
    inv00, inv01, inv11,     # (N,) inverse Hessian entries
    xs0: jax.Array, ys0: jax.Array,  # (N, w) window tap base coords in patch space
    flow: jax.Array,         # (N, 2) initial flow (patch-space displacement)
    gate: jax.Array,         # (N,) features allowed to move
    cfg: VisualConfig,
    P: int,
    n_iters: int | None = None,
) -> jax.Array:
    """The unrolled LK GN loop (see _lk_level comments): cv's EPS criterion
    becomes a per-feature freeze mask; converged features take zero steps."""
    def iter_body(carry, _):
        fl, active = carry
        Cw = _sample_windows(
            patch, _tent_weights(ys0 + fl[:, 1:2], P), _tent_weights(xs0 + fl[:, 0:1], P)
        )
        diff = Cw - T
        bx = jnp.sum(diff * Ix, axis=(1, 2))
        by = jnp.sum(diff * Iy, axis=(1, 2))
        dx = -(inv00 * bx + inv01 * by)
        dy = -(inv01 * bx + inv11 * by)
        step = jnp.stack([dx, dy], axis=-1)
        step = jnp.where((gate & active)[:, None], step, 0.0)
        still = jnp.max(jnp.abs(step), axis=-1) > cfg.klt_eps
        return (fl + step, active & still), None

    n = flow.shape[0]
    (flow, _), _ = jax.lax.scan(
        iter_body, (flow, jnp.ones((n,), bool)), None,
        length=cfg.klt_iters if n_iters is None else n_iters, unroll=True,
    )
    return flow


def _lk_level(
    pimg: jax.Array,
    cimg: jax.Array,
    p_lvl: jax.Array,        # (N, 2) feature positions at this level's scale
    status: jax.Array,       # (N,)
    flow: jax.Array,         # (N, 2) incoming flow at this level's scale
    cfg: VisualConfig,
    compute_err: bool,
) -> tuple[jax.Array, jax.Array, jax.Array | None]:
    """One pyramid level of Lucas-Kanade iterations (see lk_track)."""
    r = cfg.klt_window // 2
    w = 2 * r + 1
    ph = r + cfg.klt_patch_slack + 1
    P = 2 * ph
    offs1d = jnp.arange(-r, r + 1, dtype=jnp.float32)
    n = p_lvl.shape[0]
    H, W = pimg.shape

    def clip_corner(c):
        return jnp.stack(
            [jnp.clip(c[:, 0], 0, max(W - P, 0)), jnp.clip(c[:, 1], 0, max(H - P, 0))],
            axis=-1,
        )

    corner = clip_corner(jnp.round(p_lvl).astype(jnp.int32) - ph)
    # current-image patch centred on the PREDICTED position, so prior-seeded
    # flows far beyond the slack stay inside the slice
    corner_c = clip_corner(jnp.round(p_lvl + flow).astype(jnp.int32) - ph)

    # Template gradients are computed IN-PATCH below instead of slicing from
    # full-image gradient planes, so two patch gathers are all a level reads.
    Tp, Cp = _slice_patches(pimg, corner, P), _slice_patches(cimg, corner_c, P)
    Gxp, Gyp = _patch_sobel(Tp)

    # template window (fixed per level): patch-space coords of the window taps
    tx0 = p_lvl[:, 0] - corner[:, 0].astype(jnp.float32)
    ty0 = p_lvl[:, 1] - corner[:, 1].astype(jnp.float32)
    xs0 = tx0[:, None] + offs1d                         # (N, w)
    ys0 = ty0[:, None] + offs1d
    Wx0 = _tent_weights(xs0, P)
    Wy0 = _tent_weights(ys0, P)
    T = _sample_windows(Tp, Wy0, Wx0)
    Ix = _sample_windows(Gxp, Wy0, Wx0)
    Iy = _sample_windows(Gyp, Wy0, Wx0)
    inv00, inv01, inv11, ok_g = _window_hessian(Ix, Iy, w, cfg)

    xs0_c = p_lvl[:, 0:1] + offs1d - corner_c[:, 0:1].astype(jnp.float32)
    ys0_c = p_lvl[:, 1:2] + offs1d - corner_c[:, 1:2].astype(jnp.float32)

    flow = _gn_iterations(
        Cp, T, Ix, Iy, inv00, inv01, inv11, xs0_c, ys0_c, flow,
        ok_g & status, cfg, P,
    )

    tracked = p_lvl + flow
    inside = (
        (tracked[:, 0] >= r) & (tracked[:, 0] < W - r - 1)
        & (tracked[:, 1] >= r) & (tracked[:, 1] < H - r - 1)
    )
    # the window must also have stayed inside the sliced current patch
    in_patch = (
        (xs0_c[:, 0] + flow[:, 0] >= 0.0) & (xs0_c[:, -1] + flow[:, 0] <= P - 1)
        & (ys0_c[:, 0] + flow[:, 1] >= 0.0) & (ys0_c[:, -1] + flow[:, 1] <= P - 1)
    )
    status = status & inside & ok_g & in_patch
    err = None
    if compute_err:
        # photometric residual at convergence (cv::calcOpticalFlowPyrLK's
        # ``err`` output): mean |I1(x+d) - I0(x)| over the window
        Cw = _sample_windows(
            Cp, _tent_weights(ys0_c + flow[:, 1:2], P), _tent_weights(xs0_c + flow[:, 0:1], P)
        )
        err = jnp.mean(jnp.abs(Cw - T), axis=(1, 2))
    return flow, status, err


def _lk_level_fb(
    pimg: jax.Array,
    cimg: jax.Array,
    p_lvl: jax.Array,
    status: jax.Array,
    flow: jax.Array,
    cfg: VisualConfig,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Fused forward + backward final level.

    The backward consistency pass needs zero new gathers: its template is the
    forward track's converged window (inside the already-sliced current-image
    patch) and its search image is the already-sliced template patch — the
    two patches simply swap roles.  Returns (flow, status, err, fb_err).
    """
    r = cfg.klt_window // 2
    w = 2 * r + 1
    ph = r + cfg.klt_patch_slack + 1
    P = 2 * ph
    offs1d = jnp.arange(-r, r + 1, dtype=jnp.float32)
    H, W = pimg.shape

    def clip_corner(c):
        return jnp.stack(
            [jnp.clip(c[:, 0], 0, max(W - P, 0)), jnp.clip(c[:, 1], 0, max(H - P, 0))],
            axis=-1,
        )

    corner = clip_corner(jnp.round(p_lvl).astype(jnp.int32) - ph)
    corner_c = clip_corner(jnp.round(p_lvl + flow).astype(jnp.int32) - ph)

    Tp, Cp = _slice_patches(pimg, corner, P), _slice_patches(cimg, corner_c, P)
    Gxp, Gyp = _patch_sobel(Tp)

    # ---- forward (identical to _lk_level) ----------------------------------
    xs0 = (p_lvl[:, 0] - corner[:, 0].astype(jnp.float32))[:, None] + offs1d
    ys0 = (p_lvl[:, 1] - corner[:, 1].astype(jnp.float32))[:, None] + offs1d
    Wx0, Wy0 = _tent_weights(xs0, P), _tent_weights(ys0, P)
    T = _sample_windows(Tp, Wy0, Wx0)
    Ix = _sample_windows(Gxp, Wy0, Wx0)
    Iy = _sample_windows(Gyp, Wy0, Wx0)
    inv00, inv01, inv11, ok_g = _window_hessian(Ix, Iy, w, cfg)

    xs0_c = p_lvl[:, 0:1] + offs1d - corner_c[:, 0:1].astype(jnp.float32)
    ys0_c = p_lvl[:, 1:2] + offs1d - corner_c[:, 1:2].astype(jnp.float32)
    flow = _gn_iterations(
        Cp, T, Ix, Iy, inv00, inv01, inv11, xs0_c, ys0_c, flow,
        ok_g & status, cfg, P,
    )

    tracked = p_lvl + flow
    inside = (
        (tracked[:, 0] >= r) & (tracked[:, 0] < W - r - 1)
        & (tracked[:, 1] >= r) & (tracked[:, 1] < H - r - 1)
    )
    in_patch = (
        (xs0_c[:, 0] + flow[:, 0] >= 0.0) & (xs0_c[:, -1] + flow[:, 0] <= P - 1)
        & (ys0_c[:, 0] + flow[:, 1] >= 0.0) & (ys0_c[:, -1] + flow[:, 1] <= P - 1)
    )
    status = status & inside & ok_g & in_patch

    # forward photometric residual (also the backward template, T_b)
    Wxb = _tent_weights(xs0_c + flow[:, 0:1], P)
    Wyb = _tent_weights(ys0_c + flow[:, 1:2], P)
    T_b = _sample_windows(Cp, Wyb, Wxb)
    err = jnp.mean(jnp.abs(T_b - T), axis=(1, 2))

    # ---- backward: roles swapped, patches reused ----------------------------
    # Template gradients at the tracked window, sampled from Cp's in-patch
    # Sobel planes with the same weights that produced T_b.
    Gxc, Gyc = _patch_sobel(Cp)
    Ixb = _sample_windows(Gxc, Wyb, Wxb)
    Iyb = _sample_windows(Gyc, Wyb, Wxb)
    b00, b01, b11, ok_b = _window_hessian(Ixb, Iyb, w, cfg)

    # Backward search runs inside Tp; a zero backward flow lands exactly on
    # the original feature position (taps xs0/ys0), so fb_err = |flow_b|^2.
    flow_b = _gn_iterations(
        Tp, T_b, Ixb, Iyb, b00, b01, b11, xs0, ys0,
        jnp.zeros_like(flow), ok_b & status, cfg, P, n_iters=cfg.klt_fb_iters,
    )
    fb_err = jnp.sum(flow_b**2, axis=-1)
    return flow, status & ok_b, err, fb_err


def lk_track(
    prev_img: jax.Array,
    curr_img: jax.Array,
    pts: jax.Array,          # (N, 2) positions in prev image
    mask: jax.Array,         # (N,)
    cfg: VisualConfig,
    init_flow: jax.Array | None = None,   # (N, 2) predicted flow (OPTFLOW_USE_INITIAL_FLOW)
    return_err: bool = False,
    skip_coarse: jax.Array | None = None,  # () bool: branch past the coarse levels
) -> tuple[jax.Array, jax.Array] | tuple[jax.Array, jax.Array, jax.Array]:
    """Pyramidal Lucas-Kanade: returns (curr_pts (N, 2), status (N,)[, err (N,)]).

    Matches cv::calcOpticalFlowPyrLK semantics: per level, iterate
    d = G^-1 b with G the template-window structure tensor; status drops
    points whose window leaves the image or whose G is degenerate.
    ``init_flow`` seeds the coarsest level — with a motion prior this
    extends the trackable displacement far beyond the pyramid range.

    ``skip_coarse`` (a traced bool) selects at RUNTIME whether the coarse
    pyramid levels run at all: once a motion prior is available (frame >= 2
    in the pipeline), the prior-seeded flow lands within the level-0 patch
    slack and the coarse levels — patch gathers, pyramid construction and
    all — are dead weight.  Both branches compile once; only one executes.

    Formulation: per (feature, level) a single contiguous (P, P) patch is
    sliced from each image; every window resample inside the iteration loop
    is two batched interpolation matmuls over the patch (no gathers).
    """
    flow, status = _coarse_flow(prev_img, curr_img, pts, mask, cfg, init_flow, skip_coarse)
    flow, status, err = _lk_level(prev_img, curr_img, pts, status, flow, cfg, True)

    if return_err:
        return pts + flow, status, err
    return pts + flow, status


def _coarse_flow(prev_img, curr_img, pts, mask, cfg, init_flow, skip_coarse):
    """The coarse pyramid levels of lk_track (see its docstring for the
    runtime skip_coarse branching rationale)."""
    n = pts.shape[0]
    init = jnp.zeros((n, 2), jnp.float32) if init_flow is None else init_flow
    L = cfg.klt_levels

    def run_coarse(_):
        prev_pyr = gaussian_pyramid(prev_img, L)
        curr_pyr = gaussian_pyramid(curr_img, L)
        flow = init / (2.0 ** L)
        st = mask
        for lvl in range(L, 0, -1):
            flow, st, _ = _lk_level(
                prev_pyr[lvl], curr_pyr[lvl], pts / (2.0 ** lvl), st, flow, cfg, False
            )
            flow = flow * 2.0
        return flow, st

    if L == 0:
        return init, mask
    if skip_coarse is None:
        return run_coarse(None)
    return jax.lax.cond(skip_coarse, lambda _: (init, mask), run_coarse, None)


def lk_track_fb(
    prev_img: jax.Array,
    curr_img: jax.Array,
    pts: jax.Array,
    mask: jax.Array,
    cfg: VisualConfig,
    init_flow: jax.Array | None = None,
    skip_coarse: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """LK with a forward-backward consistency check.

    The reference relies on the remove_VO_outlier displacement gate
    (visual_odometry.cpp:363-368) to drop bad tracks; tracking each point
    back from its forward estimate and requiring a sub-pixel return is a
    strictly stronger filter that costs one extra (fully parallel) LK pass.
    """
    # The backward track starts from the exact inverse of the forward flow, so
    # it only needs a level-0 refinement: a good track returns in 1-2 GN steps
    # and a drifting one diverges past the threshold.  A backward pass seeded
    # at the answer cannot flag textureless windows (zero gradient => zero
    # steps => zero return error), so the photometric residual of the forward
    # track does that part: a genuinely matched window has low mean |I1-I0|.
    # Forward + backward share one fused level (_lk_level_fb): the backward
    # pass reuses the forward pass's patch slices with roles swapped.
    flow, status = _coarse_flow(prev_img, curr_img, pts, mask, cfg, init_flow, skip_coarse)
    flow, status, err, fb_err = _lk_level_fb(prev_img, curr_img, pts, status, flow, cfg)
    ok = status & (fb_err < cfg.klt_fb_threshold**2) & (err < cfg.klt_max_err)
    return pts + flow, ok
