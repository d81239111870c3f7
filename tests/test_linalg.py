"""Measurement-compression equivalence: Gram/Cholesky vs Householder QR.

The Kalman update is a function of the whitened rows only through
G = [H|r]^T [H|r]; both compressions must therefore produce identical
corrections and covariance updates (up to factorization roundoff).
"""
import jax.numpy as jnp
import numpy as np

from x_multi_agent_jax.ops import linalg


def _system(rng, r, d, zero_cols=(), zero_row_frac=0.3):
    h = rng.normal(size=(r, d))
    res = rng.normal(size=(r,))
    std = rng.uniform(0.004, 0.05, size=(r,))
    # masked rows are zero in H and res
    mask = rng.uniform(size=r) < zero_row_frac
    h[mask] = 0.0
    res[mask] = 0.0
    for c in zero_cols:
        h[:, c] = 0.0
    a = rng.normal(size=(d, d))
    cov = a @ a.T * 1e-4 + np.eye(d) * 1e-6
    return jnp.asarray(h), jnp.asarray(res), jnp.asarray(std), jnp.asarray(cov)


def test_gram_chol_matches_householder_qr(rng):
    r, d = 300, 60
    h, res, std, cov = _system(rng, r, d, zero_cols=(55, 56, 57, 58, 59))
    corr_tot = jnp.asarray(rng.normal(size=d) * 1e-3)

    hg, rg = linalg.qr_compress(h, res, std)
    hq, rq = linalg.qr_compress_householder(h, res, std)

    # identical Gram (the sufficient statistic)
    np.testing.assert_allclose(
        np.asarray(hg.T @ hg), np.asarray(hq.T @ hq), rtol=1e-7, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(hg.T @ rg), np.asarray(hq.T @ rq), rtol=1e-7, atol=1e-7
    )

    cg, pg = linalg.kalman_update(cov, hg, rg, corr_tot)
    cq, pq = linalg.kalman_update(cov, hq, rq, corr_tot)
    np.testing.assert_allclose(np.asarray(cg), np.asarray(cq), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(np.asarray(pg), np.asarray(pq), rtol=1e-6, atol=1e-12)


def test_gram_chol_all_masked_rows_noop(rng):
    r, d = 120, 40
    h = jnp.zeros((r, d))
    res = jnp.zeros((r,))
    std = jnp.full((r,), 0.005)
    a = rng.normal(size=(d, d))
    cov = jnp.asarray(a @ a.T * 1e-4 + np.eye(d) * 1e-6)

    hc, rc = linalg.qr_compress(h, res, std)
    corr, cov1 = linalg.kalman_update(cov, hc, rc, jnp.zeros(d))
    assert np.isfinite(np.asarray(cov1)).all()
    np.testing.assert_allclose(np.asarray(corr), 0.0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(cov1), np.asarray(cov), rtol=1e-6, atol=1e-9)


def test_mahalanobis_gamma_unrolled_vs_solve(rng):
    for r in (5, 27):
        a = rng.normal(size=(r, r))
        s_in = a @ a.T + np.eye(r)
        res = jnp.asarray(rng.normal(size=(r,)))
        got = float(linalg._gamma_chol_unrolled(jnp.asarray(s_in), res))
        want = float(np.asarray(res) @ np.linalg.solve(s_in, np.asarray(res)))
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_blocked_chol_and_neumann_solves(rng):
    for n in (5, 16, 37, 151):
        a = rng.normal(size=(3, n, n))
        s = a @ np.swapaxes(a, -1, -2) + 2.0 * np.eye(n)
        l = np.asarray(linalg.chol_blocked(jnp.asarray(s)))
        want = np.linalg.cholesky(s)
        np.testing.assert_allclose(l, want, rtol=1e-9, atol=1e-9)

        b = rng.normal(size=(3, n, 7))
        x = np.asarray(linalg.spd_solve(jnp.asarray(s), jnp.asarray(b)))
        np.testing.assert_allclose(x, np.linalg.solve(s, b), rtol=1e-8, atol=1e-9)


def test_solve3_general_matrices(rng):
    """Cross-product Cramer solve3 must hold for NON-symmetric A too (the
    production callers are all symmetric normal/innovation matrices, but
    the utility is general)."""
    a = rng.normal(size=(64, 3, 3))
    b = rng.normal(size=(64, 3))
    x = np.asarray(linalg.solve3(jnp.asarray(a), jnp.asarray(b)))
    want = np.linalg.solve(a, b[..., None])[..., 0]
    np.testing.assert_allclose(x, want, rtol=1e-8, atol=1e-8)


def test_newton_schulz_solve_matches_chol_oracle(rng):
    """spd_solve (Newton-Schulz + refinement) vs the blocked-Cholesky
    oracle across conditionings, including the whitened-innovation shape
    S = I + H P H^T the Kalman path feeds it."""
    n = 150
    for kappa in (1e1, 1e3, 1e5):
        q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        lam = np.logspace(0, np.log10(kappa), n)
        s = (q * lam) @ q.T + np.eye(n)
        s = 0.5 * (s + s.T)
        b = rng.normal(size=(n, 8))
        want = np.linalg.solve(s, b)
        got = np.asarray(linalg.spd_solve(jnp.asarray(s), jnp.asarray(b)))
        chol = np.asarray(linalg.spd_solve_chol(jnp.asarray(s), jnp.asarray(b)))
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        rel_chol = np.linalg.norm(chol - want) / np.linalg.norm(want)
        # at least as accurate as the oracle path it replaced (x64 here;
        # the f32 comparison on realistic kappa is in the module docstring)
        assert rel <= max(2 * rel_chol, 1e-10), (kappa, rel, rel_chol)


def test_mahalanobis_gamma_fixed_ns_ill_conditioned(rng):
    """The chi2-gate gamma uses a FIXED-count Newton-Schulz solve
    (linalg.mahalanobis_gamma, r > 3 branch); it must stay accurate on the
    strongly-informative tracks the EKF actually produces, where
    S = I + H P H^T reaches kappa ~ 1e5-1e6 with highly correlated rows
    (one landmark seen from nearby poses)."""
    d, r = 40, 27
    for kappa in (1e2, 1e4, 1e6):
        # low-rank highly-correlated information: a few dominant directions
        u = rng.normal(size=(r, 3))
        h = (u @ rng.normal(size=(3, d))) * np.sqrt(kappa) / 10.0 + rng.normal(
            size=(r, d)
        )
        a = rng.normal(size=(d, d))
        cov = (a @ a.T) / d + np.eye(d) * 1e-6
        s = h @ cov @ h.T + np.eye(r)
        res = rng.normal(size=(r,))
        want = float(res @ np.linalg.solve(s, res))
        got = float(
            linalg.mahalanobis_gamma(
                jnp.asarray(cov, jnp.float64),
                jnp.asarray(h, jnp.float64),
                jnp.asarray(res, jnp.float64),
            )
        )
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=2e-2), kappa
