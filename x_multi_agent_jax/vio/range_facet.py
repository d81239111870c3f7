"""Facet selection for the LRF range update.

Behavioral spec: reference ``TrackManager::featureTriangleAtPoint``
(``track_manager.cpp:443-544``) builds a cv::Subdiv2D Delaunay
triangulation of the SLAM feature image points and returns the facet
containing the LRF impact point.

Fixed-shape redesign (SURVEY §2.8): with N <= 15 SLAM features, test all C(N,3)
triangles for containment of the LRF point and pick the containing
triangle of minimal area — fixed shape, no host geometry library, and the
minimal-area containing triangle of a point IS its Delaunay facet whenever
the Delaunay triangulation covers it (any other containing triangle is a
union of facets).
"""
from __future__ import annotations

import itertools
from typing import Tuple

import jax.numpy as jnp
import numpy as np


def _triples(n: int) -> np.ndarray:
    return np.asarray(list(itertools.combinations(range(n), 3)), np.int32)


def feature_triangle_at_point(
    pts: jnp.ndarray,  # (N, 2) SLAM feature image coords (normalized ok)
    valid: jnp.ndarray,  # (N,)
    query: jnp.ndarray,  # (2,)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (feature ids (3,), found bool)."""
    n = pts.shape[0]
    tri = jnp.asarray(_triples(n))  # (T, 3)
    a = pts[tri[:, 0]]
    b = pts[tri[:, 1]]
    c = pts[tri[:, 2]]

    def cross(o, u, v):
        return (u[:, 0] - o[:, 0]) * (v[:, 1] - o[:, 1]) - (
            u[:, 1] - o[:, 1]
        ) * (v[:, 0] - o[:, 0])

    q = jnp.broadcast_to(query, a.shape)
    d0 = cross(a, b, q)
    d1 = cross(b, c, q)
    d2 = cross(c, a, q)
    inside = ((d0 >= 0) & (d1 >= 0) & (d2 >= 0)) | ((d0 <= 0) & (d1 <= 0) & (d2 <= 0))
    area = jnp.abs(cross(a, b, c))
    nondegenerate = area > 1e-12
    ok = (
        inside & nondegenerate
        & valid[tri[:, 0]] & valid[tri[:, 1]] & valid[tri[:, 2]]
    )
    big = jnp.asarray(jnp.inf, area.dtype)
    key = jnp.where(ok, area, big)
    best = jnp.argmin(key)
    found = ok[best]
    return tri[best], found
