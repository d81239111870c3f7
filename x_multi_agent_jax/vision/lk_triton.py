"""Pyramidal Lucas-Kanade for a batch of agents as ONE Pallas kernel on the
Triton route (GPU).

Same arithmetic as :func:`lk._track_level` applied level by level in
:func:`lk.track` (the plain-JAX oracle), laid out for the GPU:

  * grid = (agent, feature); a program owns one feature;
  * each feature's (2*half_win+1)^2 window is one row of ``n_lanes``
    (next power of two) lanes; the four bilinear taps are unmasked
    gathers at clamped indices, which reproduces the oracle's edge padding
    exactly without materializing padded images;
  * template patch, gradients and the 2x2 normal matrix stay in registers;
  * every pyramid level and every iteration runs inside the launch; the
    iteration loop exits as soon as the feature has converged (a converged
    feature stays frozen, as in the oracle).

Invalid features start converged: they never iterate, their flow stays
zero and they are reported not ``ok``.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .image import scharr_gradients
from .lk import in_image

# chosen on an H100 at 16 and 64 agents x 200 features, 480x640 pyramid,
# against 2, 4 and 8 features per program and 1 to 8 warps
NUM_WARPS = 2


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _kernel(px_ref, py_ref, valid_ref, *refs, shapes, half_win, n_iters,
            min_eig_thr, eps, n_lanes):
    n_levels = len(shapes)
    level_refs = refs[: 4 * n_levels]
    fx_ref, fy_ref, ok_ref = refs[4 * n_levels :]
    a = pl.program_id(0)
    ks = pl.ds(pl.program_id(1), 1)
    x0 = px_ref[a, ks]
    y0 = py_ref[a, ks]
    dtype = x0.dtype

    w = 2 * half_win + 1
    p = w + 1  # slab size of the oracle
    pad = half_win + 1  # edge padding of the oracle
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, n_lanes), 1)
    li = lane // w
    lj = lane % w
    in_win = lane < w * w

    def base(x, y, h, wd):
        """Slab origin (padded coords, clipped as the oracle clips) and the
        constant bilinear fractions, each (1, 1)."""
        bxf = jnp.floor(x - half_win)
        byf = jnp.floor(y - half_win)
        fx = x - half_win - bxf
        fy = y - half_win - byf
        by = jnp.clip(byf.astype(jnp.int32) + pad, 0, h + 2 * pad - p)
        bx = jnp.clip(bxf.astype(jnp.int32) + pad, 0, wd + 2 * pad - p)
        return by[:, None], bx[:, None], fx[:, None], fy[:, None]

    def sample(ref, h, wd, by, bx, fx, fy):
        """(1, n_lanes) bilinear window; lanes past w*w are zero."""
        r0 = jnp.clip(by + li - pad, 0, h - 1)
        r1 = jnp.clip(by + li + 1 - pad, 0, h - 1)
        c0 = jnp.clip(bx + lj - pad, 0, wd - 1)
        c1 = jnp.clip(bx + lj + 1 - pad, 0, wd - 1)
        patch = (
            ref[a, r0, c0] * (1 - fx) * (1 - fy)
            + ref[a, r0, c1] * fx * (1 - fy)
            + ref[a, r1, c0] * (1 - fx) * fy
            + ref[a, r1, c1] * fx * fy
        )
        return jnp.where(in_win, patch, 0.0)

    valid = valid_ref[a, ks] > 0
    ok = valid
    nux = jnp.zeros_like(x0)
    nuy = jnp.zeros_like(y0)
    eps2 = jnp.asarray(eps * eps, dtype)
    for lvl in range(n_levels - 1, -1, -1):
        h, wd = shapes[lvl]
        prev_ref, cur_ref, gx_ref, gy_ref = level_refs[4 * lvl : 4 * lvl + 4]
        scale = 2.0**lvl
        xl = x0 / scale
        yl = y0 / scale
        if lvl < n_levels - 1:
            nux = nux * 2.0
            nuy = nuy * 2.0

        by, bx, fx, fy = base(xl, yl, h, wd)
        tmpl = sample(prev_ref, h, wd, by, bx, fx, fy)
        ix = sample(gx_ref, h, wd, by, bx, fx, fy)
        iy = sample(gy_ref, h, wd, by, bx, fx, fy)
        gxx = jnp.sum(ix * ix, axis=1)
        gxy = jnp.sum(ix * iy, axis=1)
        gyy = jnp.sum(iy * iy, axis=1)
        det = gxx * gyy - gxy * gxy
        tr = gxx + gyy
        min_eig = (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0))) * 0.5
        ok = ok & (min_eig / (w * w) > min_eig_thr)
        det_safe = jnp.where(jnp.abs(det) > 1e-12, det, 1.0)

        def cond(carry):
            it, _, _, d2 = carry
            return (it < n_iters) & (jnp.max((d2 > eps2).astype(jnp.int32)) > 0)

        def body(carry):
            it, nux, nuy, d2 = carry
            active = d2 > eps2
            byc, bxc, fxc, fyc = base(xl + nux, yl + nuy, h, wd)
            di = tmpl - sample(cur_ref, h, wd, byc, bxc, fxc, fyc)
            bx_ = jnp.sum(di * ix, axis=1)
            by_ = jnp.sum(di * iy, axis=1)
            dx = (gyy * bx_ - gxy * by_) / det_safe
            dy = (gxx * by_ - gxy * bx_) / det_safe
            dx = jnp.where(active, dx, 0.0)
            dy = jnp.where(active, dy, 0.0)
            return it + 1, nux + dx, nuy + dy, jnp.where(active, dx * dx + dy * dy, d2)

        d2 = jnp.where(valid, jnp.asarray(1e9, dtype), 0.0)
        _, nux, nuy, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), nux, nuy, d2)
        )

    fx_ref[a, ks] = nux
    fy_ref[a, ks] = nuy
    ok_ref[a, ks] = ok.astype(jnp.int32)


def track_batch(
    pyr_prev: Sequence[jnp.ndarray],  # levels of (A, h_l, w_l)
    pyr_cur: Sequence[jnp.ndarray],
    pts_prev: jnp.ndarray,  # (A, K, 2) level-0 pixel coords
    valid: jnp.ndarray,  # (A, K)
    half_win: int = 10,
    n_iters: int = 10,
    min_eig_thr: float = 1e-4,
    eps: float = 0.01,
    *,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched :func:`lk.track`: returns (pts_cur (A, K, 2), ok (A, K))."""
    a, k = valid.shape
    dtype = pyr_prev[0].dtype
    pts = pts_prev.astype(dtype)

    level_args = []
    for prev, cur in zip(pyr_prev, pyr_cur):
        gx, gy = jax.vmap(scharr_gradients)(prev)
        level_args += [prev, cur, gx, gy]
    shapes = tuple(tuple(lvl.shape[1:]) for lvl in pyr_prev)
    w = 2 * half_win + 1
    kernel = functools.partial(
        _kernel, shapes=shapes, half_win=half_win, n_iters=n_iters,
        min_eig_thr=min_eig_thr, eps=eps, n_lanes=_next_pow2(w * w),
    )
    out = jax.ShapeDtypeStruct((a, k), dtype)
    fx, fy, ok = pl.pallas_call(
        kernel,
        out_shape=(out, out, jax.ShapeDtypeStruct((a, k), jnp.int32)),
        grid=(a, k),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="lk_pyramid",
    )(pts[..., 0], pts[..., 1], valid.astype(jnp.int32), *level_args)

    pts_cur = pts_prev + jnp.stack([fx, fy], axis=-1)
    inb = in_image(pts_cur, shapes[0], half_win)
    return pts_cur, (ok > 0) & inb & valid
