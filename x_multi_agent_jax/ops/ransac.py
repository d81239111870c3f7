"""Batched RANSAC for epipolar outlier rejection.

Behavioral spec: reference ``cv::findFundamentalMat(..., RANSAC,
outlier_param1, outlier_param2)`` used for match outlier rejection
(``tracker.cpp:243-272``) and ``cv::findEssentialMat`` geometric
verification in place recognition (``place_recognition.cpp:269-283``).

Design: hypothesis generation is a fixed batch of normalized 8-point
solves, inlier voting is one (S x N) Sampson-distance matrix — all
batched dense work, no data-dependent iteration.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _normalize_pts(pts: jnp.ndarray, mask: jnp.ndarray):
    """Hartley normalization (centroid 0, RMS distance sqrt(2))."""
    w = mask.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w[:, None], axis=0) / n
    d = jnp.sqrt(jnp.sum((pts - mean) ** 2, axis=-1))
    scale = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(d * w) / n, 1e-9)
    t = jnp.array(
        [
            [scale, 0.0, -scale * mean[0]],
            [0.0, scale, -scale * mean[1]],
            [0.0, 0.0, 1.0],
        ],
        pts.dtype,
    )
    return (pts - mean) * scale, t


def _eight_point(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """F from 8 correspondences (already normalized); (8,2),(8,2) -> (3,3).

    Design note: the textbook null-vector-by-SVD is an iterative
    factorization call, batched over hypotheses x agents on every frame.
    Replaced by Cholesky inverse iteration
    on A^T A (batched 9x9 HLO ops): with the smallest eigenvalue ~0 for a
    consistent 8-point sample, 3 regularized inverse-iteration steps
    recover the null vector to working precision. Rank-2 enforcement is
    skipped per hypothesis (irrelevant for Sampson voting) and applied
    once to the winning F in :func:`fundamental_ransac`.
    """
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    ones = jnp.ones_like(x1)
    a = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=1
    )  # (8, 9)
    m = a.T @ a
    eye = jnp.eye(9, dtype=a.dtype)
    m = m + (1e-10 * jnp.trace(m) + 1e-30) * eye
    c = jnp.linalg.cholesky(m)
    # start vector: structureless (no symmetry/zero-sum pattern). For
    # near-pure-translation motion the normalized F's entries sum to ~0,
    # so a constant start vector is nearly orthogonal to the null vector
    # and convergence would hinge on rounding noise; 4 iterations from a
    # generic start are robust even in that degenerate-motion case.
    x = jnp.asarray(
        [0.21, -0.43, 0.61, -0.79, 0.97, 0.33, -0.51, 0.69, 0.87], a.dtype
    )
    for _ in range(4):
        x = jax.scipy.linalg.cho_solve((c, True), x)
        x = x / jnp.maximum(jnp.linalg.norm(x), 1e-30)
    return x.reshape(3, 3)


def sampson_dist(f: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Sampson distance of correspondences under F; (N,2),(N,2) -> (N,)."""
    ones = jnp.ones(p1.shape[:-1] + (1,), p1.dtype)
    x1 = jnp.concatenate([p1, ones], axis=-1)
    x2 = jnp.concatenate([p2, ones], axis=-1)
    fx1 = x1 @ f.T  # (N, 3) = F @ x1
    ftx2 = x2 @ f  # (N, 3) = F^T @ x2
    num = jnp.sum(x2 * fx1, axis=-1) ** 2
    den = fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2 + ftx2[..., 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def fundamental_ransac(
    pts1: jnp.ndarray,  # (N, 2)
    pts2: jnp.ndarray,  # (N, 2)
    mask: jnp.ndarray,  # (N,)
    key: jnp.ndarray,
    threshold: float,
    n_hypotheses: int = 200,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (inlier_mask (N,), best F). Degenerate inputs (too few valid
    matches) return the input mask unchanged."""
    n = pts1.shape[0]
    p1n, t1 = _normalize_pts(pts1, mask)
    p2n, t2 = _normalize_pts(pts2, mask)

    # sample valid indices (with replacement, biased to valid entries)
    probs = mask.astype(pts1.dtype)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    idx = jax.random.categorical(
        key, jnp.log(jnp.maximum(probs, 1e-30)), shape=(n_hypotheses, 8)
    )

    f_all = jax.vmap(lambda i: _eight_point(p1n[i], p2n[i]))(idx)  # (S,3,3)
    # threshold is in *pixel* units; normalize per image-1 scale
    thr_n = threshold * t1[0, 0]
    d = jax.vmap(lambda f: sampson_dist(f, p1n, p2n))(f_all)  # (S, N)
    votes = jnp.sum((d < thr_n * thr_n) & mask[None, :], axis=1)
    best = jnp.argmax(votes)
    f_best_n = f_all[best]
    inliers = (d[best] < thr_n * thr_n) & mask

    enough = jnp.sum(mask) >= 8
    inliers = jnp.where(enough, inliers, mask)
    # rank-2 enforcement once, on the winner only (cv::findFundamentalMat
    # returns a rank-2 F; per-hypothesis enforcement is skipped, see
    # _eight_point)
    u, s, vt2 = jnp.linalg.svd(f_best_n)
    f_best_n = u @ jnp.diag(s.at[2].set(0.0)) @ vt2
    f_best = t2.T @ f_best_n @ t1
    return inliers, f_best
