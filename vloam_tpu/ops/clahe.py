"""CLAHE — contrast-limited adaptive histogram equalisation.

Reference: ``cv::createCLAHE(2.0)`` applied when the CLAHE flag is set
(visual_odometry.cpp:32-33,110-114).  OpenCV semantics: split the image into
tiles, build a 256-bin histogram per tile, clip at
``clip_limit * pixels_per_tile / 256`` redistributing the excess uniformly,
form per-tile CDF lookup tables, and map each pixel through the bilinear
blend of its four surrounding tile LUTs.

Formulation: the histograms are one-hot segment sums over tiles, the
LUT application is a gather of 4 tile LUTs per pixel + bilinear blend — all
batched, no data-dependent shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def clahe(
    img: jax.Array,          # (H, W) float32 in [0, 255]
    clip_limit: float = 2.0,
    tiles: tuple[int, int] = (8, 8),
) -> jax.Array:
    H, W = img.shape
    ty, tx = tiles
    th, tw = H // ty, W // tx
    assert th * ty == H and tw * tx == W, "image dims must divide the tile grid"

    q = jnp.clip(img, 0.0, 255.0).astype(jnp.int32)
    tiles_img = q.reshape(ty, th, tx, tw).transpose(0, 2, 1, 3).reshape(ty * tx, th * tw)

    # per-tile histogram: one-hot over 256 bins summed over pixels
    oh = jax.nn.one_hot(tiles_img, 256, dtype=jnp.float32)      # (T, P, 256)
    hist = jnp.sum(oh, axis=1)                                   # (T, 256)

    # clip + uniform redistribution (OpenCV does one redistribution pass)
    npix = float(th * tw)
    limit = jnp.maximum(clip_limit * npix / 256.0, 1.0)
    excess = jnp.sum(jnp.maximum(hist - limit, 0.0), axis=1, keepdims=True)
    hist = jnp.minimum(hist, limit) + excess / 256.0

    cdf = jnp.cumsum(hist, axis=1)
    luts = (cdf - cdf[:, :1]) / jnp.maximum(npix - cdf[:, :1], 1.0) * 255.0
    luts = jnp.clip(luts, 0.0, 255.0)                            # (T, 256) -> (ty, tx, 256)
    luts = luts.reshape(ty, tx, 256)

    # bilinear blend of the 4 surrounding tile LUTs per pixel
    yy = (jnp.arange(H, dtype=jnp.float32) + 0.5) / th - 0.5     # tile-space coords
    xx = (jnp.arange(W, dtype=jnp.float32) + 0.5) / tw - 0.5
    y0 = jnp.clip(jnp.floor(yy).astype(jnp.int32), 0, ty - 1)
    x0 = jnp.clip(jnp.floor(xx).astype(jnp.int32), 0, tx - 1)
    y1 = jnp.clip(y0 + 1, 0, ty - 1)
    x1 = jnp.clip(x0 + 1, 0, tx - 1)
    fy = jnp.clip(yy - y0, 0.0, 1.0)[:, None]
    fx = jnp.clip(xx - x0, 0.0, 1.0)[None, :]

    def lut_at(ys, xs):
        # (H, W) gather: LUT value for each pixel from tile (ys, xs)
        sel = luts[ys][:, xs]                                    # (H, W, 256)
        return jnp.take_along_axis(sel, q[..., None], axis=-1)[..., 0]

    v00 = lut_at(y0, x0)
    v01 = lut_at(y0, x1)
    v10 = lut_at(y1, x0)
    v11 = lut_at(y1, x1)
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )
