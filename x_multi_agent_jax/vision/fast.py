"""FAST-9/16 corner detection + non-max suppression + tiled top-K.

Behavioral spec: reference ``Tracker::featureDetection`` (cv::FAST with
nonmaxSuppression, ``tracker.cpp:432-449``), FAST-score-sorted candidate
selection (``tracker.cpp:564-590``) and per-tile caps
(``tiled_image.h:84-90``, ``tracker.cpp:592-620``).

Design: the segment test over the 16-pixel Bresenham circle is expressed
as 16 rolled copies of the image -> circular 9-window min/max — pure
elementwise work that XLA fuses into a handful of passes; scoring uses
OpenCV's definition (max threshold keeping the segment test true = max
over 9-arcs of the arc-min absolute difference).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

# Bresenham circle radius 3, clockwise from 12 o'clock: (dy, dx)
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9


def fast_score(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Per-pixel FAST-9 corner score (0 where not a corner).

    Border pixels (3 px) score 0.
    """
    h, w = img.shape
    if not jnp.issubdtype(img.dtype, jnp.floating):
        img = img.astype(jnp.float32)
    diffs = [jnp.roll(img, (-dy, -dx), axis=(0, 1)) - img for (dy, dx) in CIRCLE]
    diffs = jnp.stack(diffs)  # (16, H, W): circle pixel minus center

    def arc_score(d):
        # max over the 16 starting positions of min over the 9-arc
        mins = []
        for i in range(16):
            m = d[i]
            for j in range(1, ARC):
                m = jnp.minimum(m, d[(i + j) % 16])
            mins.append(m)
        return jnp.max(jnp.stack(mins), axis=0)

    score_bright = arc_score(diffs)  # arc all brighter: min diff over arc
    score_dark = arc_score(-diffs)  # arc all darker
    score = jnp.maximum(score_bright, score_dark)
    score = jnp.where(score > threshold, score, 0.0)

    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return jnp.where(interior, score, 0.0)


def nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-max suppression (keep strict local maxima)."""
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= neigh, score, 0.0)


def _tile_topk(
    score: jnp.ndarray,
    n_tiles_h: int,
    n_tiles_w: int,
    cap_per_tile: int,
    dtype,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-tile top-K selection from a (H, W) score map."""
    h, w = score.shape
    th, tw = h // n_tiles_h, w // n_tiles_w
    tiles = score.reshape(n_tiles_h, th, n_tiles_w, tw).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(n_tiles_h * n_tiles_w, th * tw)
    top, idx = jax.lax.top_k(tiles, cap_per_tile)  # (T, cap)

    ty = jnp.arange(n_tiles_h).repeat(n_tiles_w)[:, None]
    tx = jnp.tile(jnp.arange(n_tiles_w), n_tiles_h)[:, None]
    py = ty * th + idx // tw
    px = tx * tw + idx % tw
    xy = jnp.stack([px, py], axis=-1).reshape(-1, 2).astype(dtype)
    scores = top.reshape(-1)
    return xy, scores, scores > 0


def detect(
    img: jnp.ndarray,
    threshold: float,
    n_tiles_h: int,
    n_tiles_w: int,
    cap_per_tile: int,
    non_max_supp: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Tiled FAST detection.

    Returns (xy (K, 2) float pixel coords, score (K,), valid (K,)) with
    K = n_tiles_h * n_tiles_w * cap_per_tile, sorted by score within tiles.
    Image dims must be divisible by the tile counts.
    """
    score = fast_score(img, threshold)
    if non_max_supp:
        score = nms3(score)
    return _tile_topk(score, n_tiles_h, n_tiles_w, cap_per_tile, img.dtype)


def detect_batch(
    imgs: jnp.ndarray,  # (A, H, W)
    threshold: float,
    n_tiles_h: int,
    n_tiles_w: int,
    cap_per_tile: int,
    non_max_supp: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched tiled FAST detection over a leading agent axis (the score
    stencil is left to XLA's loop fusion)."""
    score = jax.vmap(lambda im: fast_score(im, threshold))(imgs)
    if non_max_supp:
        score = jax.vmap(nms3)(score)
    return jax.vmap(
        lambda s: _tile_topk(s, n_tiles_h, n_tiles_w, cap_per_tile, imgs.dtype)
    )(score)
