"""Covariance-intersection weight optimization (reference ci.cpp:143-190).

The reference solves min det((sum w_i M_i)^-1) s.t. sum w = 1, w in
[1e-4, 1] with NLopt COBYLA; here a fixed-point simplex iteration runs on
device. Oracle: scipy scalar optimization for the 2-matrix case.
"""
import numpy as np
import jax.numpy as jnp

from x_multi_agent_jax.ekf import ci as ci_mod


def _info(rng, d, scales):
    """Random SPD information matrix with given axis scales."""
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return q @ np.diag(scales) @ q.T


def test_optimize_weights_matches_scalar_oracle(rng):
    from scipy.optimize import minimize_scalar

    d = 4
    m0 = _info(rng, d, [10.0, 5.0, 0.1, 0.05])
    m1 = _info(rng, d, [0.1, 0.2, 8.0, 6.0])

    w = np.asarray(
        ci_mod.optimize_weights_nway(
            jnp.asarray(m0), jnp.asarray(m1)[None], jnp.ones((1,), bool),
            w_fallback=0.5, n_iters=200,
        )
    )
    assert abs(w.sum() - 1.0) < 1e-9

    def neg_logdet(w0):
        s = w0 * m0 + (1.0 - w0) * m1
        return -np.linalg.slogdet(s)[1]

    res = minimize_scalar(neg_logdet, bounds=(1e-4, 1.0 - 1e-4), method="bounded")
    assert abs(w[0] - res.x) < 1e-3
    assert abs(neg_logdet(w[0]) - res.fun) < 1e-8


def test_optimized_beats_fixed_weights(rng):
    # constructed asymmetric case: the peer is far more informative, so the
    # reference's fixed w_peer = 0.01 is badly suboptimal
    d = 3
    m_own = _info(rng, d, [0.01, 0.02, 0.01])
    m_peer = _info(rng, d, [50.0, 40.0, 30.0])

    w = np.asarray(
        ci_mod.optimize_weights_nway(
            jnp.asarray(m_own), jnp.asarray(m_peer)[None],
            jnp.ones((1,), bool), w_fallback=0.01,
        )
    )

    def logdet(w_vec):
        return np.linalg.slogdet(w_vec[0] * m_own + w_vec[1] * m_peer)[1]

    fixed = np.array([0.99, 0.01])
    assert logdet(w) > logdet(fixed) + 1.0  # strictly better information
    # peer ends up with the dominant weight
    assert w[1] > 0.9


def test_invalid_peers_get_zero_weight(rng):
    d = 3
    m_own = _info(rng, d, [1.0, 2.0, 3.0])
    m_p = np.stack([_info(rng, d, [5.0, 1.0, 0.5]), np.zeros((d, d))])
    valid = jnp.asarray([True, False])
    w = np.asarray(
        ci_mod.optimize_weights_nway(
            jnp.asarray(m_own), jnp.asarray(m_p), valid, w_fallback=0.01
        )
    )
    assert w[2] == 0.0
    assert abs(w.sum() - 1.0) < 1e-9
    assert np.all(w[:2] >= 1e-4)


def test_fallback_on_degenerate_input():
    # non-finite input -> iteration fails -> reference fixed weights
    # (ci.cpp:70-73: NLopt failure falls back to w0 = 1 - K*w)
    d = 3
    bad = jnp.full((d, d), jnp.nan)
    w = np.asarray(
        ci_mod.optimize_weights_nway(
            bad, jnp.zeros((2, d, d)), jnp.ones((2,), bool), w_fallback=0.01
        )
    )
    np.testing.assert_allclose(w, [0.98, 0.01, 0.01], atol=1e-12)
