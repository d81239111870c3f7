"""Ground-truth landmark matching (GT_DEBUG mode).

Behavioral spec: reference ``place_recognition.cpp:387-517`` — with
GT_DEBUG the descriptor front-end is bypassed and cross-agent
correspondences come from 3D landmark proximity. This is the deterministic
test harness for the collaborative back-end (SURVEY §4.2).

Design: all-gathered landmark tables -> pairwise distance matrix ->
mutual-nearest-neighbor + radius gate, emitted into fixed match budgets.

Breadth note (round 5): this module covers the SLAM-SLAM loop of the
reference's GT classification; the OPP-side loops (own-OPP x peer
MSCKF/OPP -> MsckfMatch, own-OPP x peer SLAM -> OppMatch,
place_recognition.cpp:436-517) are `parallel.match_store.record_gt` —
id-equality classification feeding the same stored-match upgrade
machinery as the descriptor path, so GT mode exercises the stored
MSCKF/short-CI/SLAM-upgrade paths deterministically
(tests/test_match_store.py::test_record_gt_three_type_classification).
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def match_landmarks(
    own_lm: jnp.ndarray,  # (N, 3)
    own_valid: jnp.ndarray,  # (N,)
    other_lm: jnp.ndarray,  # (N, 3)
    other_valid: jnp.ndarray,  # (N,)
    max_dist: float,
    budget: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (own_idx (budget,), other_idx (budget,), valid (budget,))."""
    n = own_lm.shape[0]
    d2 = jnp.sum((own_lm[:, None, :] - other_lm[None, :, :]) ** 2, axis=-1)
    big = jnp.asarray(jnp.inf, d2.dtype)
    d2 = jnp.where(own_valid[:, None] & other_valid[None, :], d2, big)

    nn_other = jnp.argmin(d2, axis=1)  # for each own feature
    nn_own = jnp.argmin(d2, axis=0)  # for each other feature
    own_ids = jnp.arange(n)
    mutual = nn_own[nn_other] == own_ids
    close = d2[own_ids, nn_other] < max_dist * max_dist
    good = mutual & close & own_valid

    order = jnp.argsort(~good, stable=True)[:budget]
    valid = good[order]
    return order.astype(jnp.int32), nn_other[order].astype(jnp.int32), valid
