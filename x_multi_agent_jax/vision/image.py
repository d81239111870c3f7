"""Image pyramid + interpolation primitives.

Behavioral spec: reference ``Tracker::getImagePyramid`` (cv::pyrDown,
``tracker.cpp:400-418``). pyrDown = 5-tap Gaussian [1 4 6 4 1]/16 separable
blur + 2x decimation; implemented as shifted adds fused by the compiler
(no hand kernel needed at these sizes).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_K5 = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]  # host-side taps


def _sep_stencil(img: jnp.ndarray, kr, kc) -> jnp.ndarray:
    """Separable small stencil as shift-and-add over static slices of an
    edge-padded image: the shifted adds fuse into one elementwise pass,
    where a single-channel tiny convolution would not."""
    h, w = img.shape
    rr = len(kr) // 2
    rc = len(kc) // 2
    x = jnp.pad(img, ((rr, rr), (0, 0)), mode="edge")
    out = None
    for i, k in enumerate(kr):
        if k == 0.0:
            continue
        term = x[i : i + h, :] * jnp.asarray(k, img.dtype)
        out = term if out is None else out + term
    x = jnp.pad(out, ((0, 0), (rc, rc)), mode="edge")
    out = None
    for j, k in enumerate(kc):
        if k == 0.0:
            continue
        term = x[:, j : j + w] * jnp.asarray(k, img.dtype)
        out = term if out is None else out + term
    return out


def _sep_blur5(img: jnp.ndarray) -> jnp.ndarray:
    """Separable 5-tap Gaussian blur with edge replication (cv::pyrDown's
    BORDER_REFLECT_101 is approximated by edge replication)."""
    k = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]
    return _sep_stencil(img, k, k)


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """One pyramid level: blur then take every other pixel."""
    return _sep_blur5(img)[::2, ::2]


def build_pyramid(img: jnp.ndarray, depth: int):
    """List of `depth + 1` levels (level 0 = input), reference
    ``pyramid_depth_`` semantics (tracker.h:272)."""
    levels = [img]
    for _ in range(depth):
        levels.append(pyr_down(levels[-1]))
    return levels


def bilinear_sample(img: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Bilinear interpolation at float (x, y) positions.

    pts: (..., 2) in (x, y) pixel coords. Out-of-bounds clamps to the edge.
    """
    h, w = img.shape
    x = jnp.clip(pts[..., 0], 0.0, w - 1.001)
    y = jnp.clip(pts[..., 1], 0.0, h - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def scharr_gradients(img: jnp.ndarray):
    """(dx, dy) image gradients with the 3x3 Scharr operator (what
    cv::calcOpticalFlowPyrLK uses internally)."""
    gk = [3.0 / 32, 10.0 / 32, 3.0 / 32]
    dk = [-1.0, 0.0, 1.0]
    dx = _sep_stencil(img, gk, dk)
    dy = _sep_stencil(img, dk, gk)
    return dx, dy
