"""Pyramidal Lucas-Kanade optical flow (Bouguet).

Behavioral spec: reference ``Tracker::featureTracking`` using
``cv::calcOpticalFlowPyrLK`` (``tracker.cpp:623-690``): window win_size,
pyramid max_level, iterative refinement, minimum-eigenvalue quality gate
(min_eig_thr) and border rejection.

Plain-JAX form (the oracle, and the CPU path): all features solved
simultaneously with PATCH-based memory access: because the LK window
offsets are integers, the bilinear fraction is constant per feature, so
each feature needs one contiguous (w+1)x(w+1) slab per image (a vmapped
``lax.dynamic_slice``) and interpolation is four shifted static slices of
the slab. Levels are edge-padded by ``half_win + 1`` so border behavior
matches clamped sampling. The 2x2 normal-equation solve is closed form;
iteration is a ``fori_loop``; everything is fixed shape.

On the GPU, :func:`track_batch` runs the same arithmetic as one Pallas
kernel on the Triton route (``lk_triton.py``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from .image import scharr_gradients


def _interp_patch(p: jnp.ndarray, fx, fy, w: int) -> jnp.ndarray:
    """Constant-fraction bilinear interpolation of a (w+1, w+1) slab ->
    (w, w) window."""
    return (
        p[0:w, 0:w] * (1 - fx) * (1 - fy)
        + p[0:w, 1 : w + 1] * fx * (1 - fy)
        + p[1 : w + 1, 0:w] * (1 - fx) * fy
        + p[1 : w + 1, 1 : w + 1] * fx * fy
    )


def _track_level(
    img_prev: jnp.ndarray,
    img_cur: jnp.ndarray,
    dx_prev: jnp.ndarray,
    dy_prev: jnp.ndarray,
    pts_prev: jnp.ndarray,  # (K, 2) at this level's scale
    guess: jnp.ndarray,  # (K, 2) current flow guess at this level
    half_win: int,
    n_iters: int,
    min_eig_thr: float,
    eps: float = 0.01,
):
    """One pyramid level of LK for all features. Returns (flow, ok)."""
    w = 2 * half_win + 1
    p = w + 1  # slab size: integer coords floor(base)..floor(base)+w
    pad = half_win + 1
    dtype = img_prev.dtype

    # edge padding reproduces clamp-to-edge sampling for in-image points
    pads = ((pad, pad), (pad, pad))
    ip = jnp.pad(img_prev, pads, mode="edge")
    ic = jnp.pad(img_cur, pads, mode="edge")
    gx = jnp.pad(dx_prev, pads, mode="edge")
    gy = jnp.pad(dy_prev, pads, mode="edge")
    hp, wp = ip.shape

    def slab(img, by, bx):
        by = jnp.clip(by, 0, hp - p)
        bx = jnp.clip(bx, 0, wp - p)
        return jax.lax.dynamic_slice(img, (by, bx), (p, p))

    def base(pt_xy):
        bx = jnp.floor(pt_xy[0] - half_win)
        by = jnp.floor(pt_xy[1] - half_win)
        fx = pt_xy[0] - half_win - bx
        fy = pt_xy[1] - half_win - by
        return (by.astype(jnp.int32) + pad, bx.astype(jnp.int32) + pad, fx, fy)

    def one(pt, g):
        by, bx, fx, fy = base(pt)
        patch_prev = _interp_patch(slab(ip, by, bx), fx, fy, w)
        ix = _interp_patch(slab(gx, by, bx), fx, fy, w)
        iy = _interp_patch(slab(gy, by, bx), fx, fy, w)
        gxx = jnp.sum(ix * ix)
        gxy = jnp.sum(ix * iy)
        gyy = jnp.sum(iy * iy)
        det = gxx * gyy - gxy * gxy
        # minimum eigenvalue of G / window area (OpenCV convention)
        tr = gxx + gyy
        min_eig = (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0))) * 0.5
        ok = min_eig / (w * w) > min_eig_thr
        det_safe = jnp.where(jnp.abs(det) > 1e-12, det, 1.0)

        # convergence early-exit with OpenCV termcrit semantics: apply
        # dnu, stop once |dnu|^2 <= eps^2
        eps2 = jnp.asarray(eps * eps, dtype)

        def body(_, carry):
            nu, d2 = carry
            active = d2 > eps2
            byc, bxc, fxc, fyc = base(pt + nu)
            patch_cur = _interp_patch(slab(ic, byc, bxc), fxc, fyc, w)
            di = patch_prev - patch_cur
            bx_ = jnp.sum(di * ix)
            by_ = jnp.sum(di * iy)
            dnu = jnp.stack([gyy * bx_ - gxy * by_, gxx * by_ - gxy * bx_]) / det_safe
            dnu = jnp.where(active, dnu, 0.0)
            return nu + dnu, jnp.where(active, jnp.sum(dnu * dnu), d2)

        nu, _ = jax.lax.fori_loop(
            0, n_iters, body, (g.astype(dtype), jnp.asarray(1e9, dtype))
        )
        return nu, ok

    return jax.vmap(one)(pts_prev.astype(dtype), guess)


def track(
    pyr_prev: Sequence[jnp.ndarray],
    pyr_cur: Sequence[jnp.ndarray],
    pts_prev: jnp.ndarray,  # (K, 2) pixel coords at level 0
    valid: jnp.ndarray,  # (K,)
    half_win: int = 10,
    n_iters: int = 10,
    min_eig_thr: float = 1e-4,
    eps: float = 0.01,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Track points from the previous to the current pyramid.

    Returns (pts_cur (K,2), ok (K,)). Points out of bounds or failing the
    min-eigenvalue gate are flagged.
    """
    n_levels = len(pyr_prev)
    flow = jnp.zeros_like(pts_prev)
    ok = valid

    grads = [scharr_gradients(lvl) for lvl in pyr_prev]

    for lvl in range(n_levels - 1, -1, -1):
        scale = 2.0**lvl
        pts_l = pts_prev / scale
        flow = flow * 2.0 if lvl < n_levels - 1 else flow / scale
        dx, dy = grads[lvl]
        flow, lvl_ok = _track_level(
            pyr_prev[lvl], pyr_cur[lvl], dx, dy, pts_l, flow,
            half_win, n_iters, min_eig_thr, eps,
        )
        ok = ok & lvl_ok

    pts_cur = pts_prev + flow * 1.0  # flow is at level-0 scale after loop
    return pts_cur, ok & in_image(pts_cur, pyr_prev[0].shape, half_win) & valid


def in_image(pts: jnp.ndarray, shape, margin: int) -> jnp.ndarray:
    """(..., 2) pixel coords at least ``margin`` px inside an (h, w) image."""
    h, w = shape
    return (
        (pts[..., 0] >= margin)
        & (pts[..., 0] < w - margin)
        & (pts[..., 1] >= margin)
        & (pts[..., 1] < h - margin)
    )


def uses_kernel(platform: str) -> bool:
    """The LK implementation is a static choice of the platform: the Triton
    kernel on ``gpu``, the plain-JAX levels everywhere else."""
    return platform == "gpu"


def track_batch(
    pyr_prev: Sequence[jnp.ndarray],  # levels of (A, h_l, w_l)
    pyr_cur: Sequence[jnp.ndarray],
    pts_prev: jnp.ndarray,  # (A, K, 2) pixel coords at level 0
    valid: jnp.ndarray,  # (A, K)
    half_win: int = 10,
    n_iters: int = 10,
    min_eig_thr: float = 1e-4,
    eps: float = 0.01,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`track` for a batch of agents. Returns (pts_cur (A, K, 2),
    ok (A, K))."""
    if uses_kernel(jax.default_backend()):
        from . import lk_triton

        return lk_triton.track_batch(
            pyr_prev, pyr_cur, pts_prev, valid, half_win, n_iters,
            min_eig_thr, eps,
        )
    return jax.vmap(
        lambda pp, pc, pts, v: track(
            pp, pc, pts, v, half_win, n_iters, min_eig_thr, eps
        )
    )(list(pyr_prev), list(pyr_cur), pts_prev, valid)
