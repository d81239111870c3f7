"""EKF linear-algebra building blocks.

Fixed-shape, mask-aware versions of:
  * left-nullspace projection of the feature Jacobian
    (reference ``msckf_update.cpp:419-432,494-501``)
  * Householder QR measurement compression on the augmented [H | res]
    (Dongarra trick, reference ``vio_updater.cpp:487-512``)
  * the (I)EKF gain/covariance update (reference ``updater.cpp:117-141``)

Row masking convention: disabled measurement rows are identically zero in
H *and* res. Zero rows survive every orthogonal transform here as
zero-information rows (their S block is the noise floor), so padding never
changes the update — verified in tests against ragged NumPy oracles.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def highprec(fn):
    """Run ``fn``'s matmuls at float32 ``highest`` matmul precision.

    An accelerator's default matmul precision may run float32 contractions
    with reduced mantissas (TF32 on the GPU keeps 10 bits). That is fine
    for image work but fatal for the filter: the 150-dim covariance loses
    positive definiteness within a few frames and the Cholesky in the
    Kalman gain goes NaN (the float64 CPU test path never sees it).
    Everything under the filter entry points is <=~200-dim, so
    full-precision passes are cheap.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def symmetrize(p: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (p + jnp.swapaxes(p, -1, -2))


def solve3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 solve — pure arithmetic, avoids the LU custom call
    for the many tiny solves in triangulation.

    Cramer via cross products of the COLUMNS: with columns a0, a1, a2,
    the rows of A^-1 are (a1xa2)/det, (a2xa0)/det, (a0xa1)/det with
    det = a0 . (a1 x a2), so x = [ (a1xa2).b, (a2xa0).b, (a0xa1).b ]
    / det. Three batched crosses + dots lower to ~1/4 the HLOs of the
    9-entry adjugate stack (the GN triangulation chain runs this every
    unrolled iteration)."""
    a0, a1, a2 = a[..., :, 0], a[..., :, 1], a[..., :, 2]
    c0 = jnp.cross(a1, a2)
    c1 = jnp.cross(a2, a0)
    c2 = jnp.cross(a0, a1)
    det = jnp.sum(a0 * c0, axis=-1)
    safe = jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
    num = jnp.stack(
        [jnp.sum(c0 * b, axis=-1), jnp.sum(c1 * b, axis=-1),
         jnp.sum(c2 * b, axis=-1)],
        axis=-1,
    )
    return num / safe[..., None]


def inv3(a: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 inverse (adjugate over determinant), batched.

    ``jnp.linalg.inv`` on tiny batched matrices lowers to an LU custom
    call (~1.5 ms/frame for (128,15,3,3) in the feature-init path of the
    device trace); three cross products do the same work in a handful of
    fused vector ops."""
    a0, a1, a2 = a[..., :, 0], a[..., :, 1], a[..., :, 2]
    c0 = jnp.cross(a1, a2)
    c1 = jnp.cross(a2, a0)
    c2 = jnp.cross(a0, a1)
    det = jnp.sum(a0 * c0, axis=-1)
    safe = jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
    # rows of A^-1 are c0/det, c1/det, c2/det
    return jnp.stack([c0, c1, c2], axis=-2) / safe[..., None, None]


@highprec  # the left-nullspace projection must be exact: reduced-mantissa
# dots leave O(1e-3) feature-direction leakage in h0, and the unmodeled
# triangulation error then enters the stacked update at 1/sigma^2 weight
def householder_qt(hf: jnp.ndarray, *mats):
    """Apply Q^T (from the QR of the (r, 3) matrix ``hf``) to each matrix
    in ``mats`` via three explicit Householder reflections.

    Pure rank-1 updates — avoids a generic QR call for these tiny
    factorizations. Rank-deficient columns
    (e.g. fully masked tracks) skip their reflection (beta = 0), matching
    the zero-row padding semantics. Returns (hf_transformed, *mats_t).
    """
    r = hf.shape[0]
    dtype = hf.dtype
    a = hf
    outs = list(mats)
    rows = jnp.arange(r)
    for k in range(hf.shape[1]):
        x = jnp.where(rows >= k, a[:, k], 0.0)
        norm = jnp.sqrt(jnp.sum(x * x))
        sign = jnp.where(x[k] >= 0, 1.0, -1.0)
        alpha = -sign * norm
        v = x - alpha * (rows == k).astype(dtype)
        vn2 = jnp.sum(v * v)
        beta = jnp.where(vn2 > 1e-24, 2.0 / jnp.where(vn2 > 1e-24, vn2, 1.0), 0.0)
        a = a - beta * jnp.outer(v, v @ a)
        outs = [
            m - beta * (jnp.outer(v, v @ m) if m.ndim == 2 else v * (v @ m))
            for m in outs
        ]
    return (a, *outs)


def nullspace_project(
    hf: jnp.ndarray, h: jnp.ndarray, res: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Project (h, res) onto the left nullspace of ``hf``; also return the
    column-space projections used by MSCKF-SLAM init (Li 2012).

    hf: (r, 3) feature Jacobian (zero rows where masked)
    h: (r, d), res: (r,)

    Returns (h0, res0, h1, r1_and_h2):
      h0 = A^T h   (r-3, d)   — nullspace part (rows beyond rank are zero)
      res0 = A^T res (r-3,)
      h1 = Q1^T h  (3, d)     — column-space part
      (r1, h2) = (Q1^T res (3,), Q1^T hf (3,3))

    Q^T is applied with explicit Householder reflections (see
    householder_qt); rows :3 are the column-space part, rows 3: the
    nullspace part — identical to splitting Q from a complete QR up to
    orthogonal equivalence.
    """
    hf_t, h_t, res_t = householder_qt(hf, h, res)
    h0 = h_t[3:]
    res0 = res_t[3:]
    h1 = h_t[:3]
    r1 = res_t[:3]
    h2 = hf_t[:3]
    return h0, res0, h1, (r1, h2)


def _tri_solve_lower_neumann(l: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L x = b for lower-triangular L via Neumann doubling.

    Write L = D (I + N) with N = D^-1 L_strict strictly lower triangular,
    hence nilpotent: N^n = 0. Then
      (I + N)^-1 = (I - N)(I + N^2)(I + N^4)... (log2(n) factors, EXACT).
    Every step is a batched matmul — no TriangularSolve/Invert call.
    Cost is ~log2(n) full (n,n) matmuls, so this serves as the small-n tip
    of the recursive :func:`tri_solve_lower`.

    l: (..., n, n), b: (..., n, r). Returns (..., n, r).
    """
    n = l.shape[-1]
    d_inv = 1.0 / jnp.diagonal(l, axis1=-2, axis2=-1)
    nmat = -(l * d_inv[..., :, None])  # -(I + N); diagonal becomes -1
    row = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    nmat = jnp.where(row > col, nmat, 0.0)  # N0 = -N, strictly lower

    x = b * d_inv[..., :, None]
    x = x + nmat @ x  # (I + N0) x
    k = 1
    while k < n - 1:
        nmat = nmat @ nmat
        x = x + nmat @ x
        k *= 2
    return x


def _tri_solve_upper_t_neumann(l: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L^T x = b for lower-triangular L (i.e. an upper solve)."""
    lt = jnp.swapaxes(l, -1, -2)
    n = l.shape[-1]
    d_inv = 1.0 / jnp.diagonal(l, axis1=-2, axis2=-1)
    nmat = -(lt * d_inv[..., :, None])
    row = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    nmat = jnp.where(row < col, nmat, 0.0)

    x = b * d_inv[..., :, None]
    x = x + nmat @ x
    k = 1
    while k < n - 1:
        nmat = nmat @ nmat
        x = x + nmat @ x
        k *= 2
    return x


def tri_solve_lower(l: jnp.ndarray, b: jnp.ndarray, base: int = 32) -> jnp.ndarray:
    """Solve L x = b for lower-triangular L, matmul-only: recursive
    half-splitting
      x1 = L11^-1 b1 ;  x2 = L22^-1 (b2 - L21 x1)
    with the Neumann-doubling tip at n <= base. ~n^3/2 FLOPs vs the
    ~log2(n) * n^3 of full-size doubling (~8x fewer at the EKF's n=150),
    still with no TriangularSolve custom call.
    """
    n = l.shape[-1]
    if n <= base:
        return _tri_solve_lower_neumann(l, b)
    h = (n + 1) // 2
    x1 = tri_solve_lower(l[..., :h, :h], b[..., :h, :], base)
    b2 = b[..., h:, :] - l[..., h:, :h] @ x1
    x2 = tri_solve_lower(l[..., h:, h:], b2, base)
    return jnp.concatenate([x1, x2], axis=-2)


def tri_solve_upper_t(l: jnp.ndarray, b: jnp.ndarray, base: int = 32) -> jnp.ndarray:
    """Solve L^T x = b for lower-triangular L, by the same recursive scheme:
    with U = L^T,  x2 = U22^-1 b2 ;  x1 = U11^-1 (b1 - U12 x2)."""
    n = l.shape[-1]
    if n <= base:
        return _tri_solve_upper_t_neumann(l, b)
    h = (n + 1) // 2
    x2 = tri_solve_upper_t(l[..., h:, h:], b[..., h:, :], base)
    b1 = b[..., :h, :] - jnp.swapaxes(l[..., h:, :h], -1, -2) @ x2
    x1 = tri_solve_upper_t(l[..., :h, :h], b1, base)
    return jnp.concatenate([x1, x2], axis=-2)


def chol_blocked(a: jnp.ndarray, base: int = 16) -> jnp.ndarray:
    """Lower Cholesky of SPD ``a`` by recursive half-splitting.

    chol([[A11, .], [A21, A22]]) = [[L11, 0], [A21 L11^-T, chol(A22 -
    L21 L21^T)]] — the off-diagonal solve uses the Neumann-doubling
    triangular solve, so the whole factorization is batched matmuls plus
    an unrolled ``base``-size tip (no Cholesky custom call).

    a: (..., n, n) SPD. Returns lower L with L L^T = a.
    """
    n = a.shape[-1]
    if n <= base:
        return _chol_unrolled(a)
    h = (n + 1) // 2
    a11 = a[..., :h, :h]
    a21 = a[..., h:, :h]
    a22 = a[..., h:, h:]
    l11 = chol_blocked(a11, base)
    # L21 = A21 L11^-T  <=>  L11 L21^T = A21^T
    l21 = jnp.swapaxes(tri_solve_lower(l11, jnp.swapaxes(a21, -1, -2)), -1, -2)
    s22 = a22 - l21 @ jnp.swapaxes(l21, -1, -2)
    l22 = chol_blocked(s22, base)
    top = jnp.concatenate([l11, jnp.zeros_like(a[..., :h, h:])], axis=-1)
    bot = jnp.concatenate([l21, l22], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _chol_unrolled(a: jnp.ndarray) -> jnp.ndarray:
    """Compile-time-unrolled left-looking Cholesky for small static n."""
    n = a.shape[-1]
    dtype = a.dtype
    rows = jnp.arange(n)
    l = jnp.zeros_like(a)
    for j in range(n):
        lj = l[..., j, :]
        pivot2 = a[..., j, j] - jnp.sum(lj * lj, axis=-1)
        pivot = jnp.sqrt(jnp.maximum(pivot2, 1e-30))
        col = (a[..., :, j] - jnp.einsum("...ik,...k->...i", l, lj)) / pivot[..., None]
        col = jnp.where(rows > j, col, 0.0)
        col = col.at[..., j].set(pivot)
        l = l.at[..., :, j].set(col)
    return l


def spd_solve_chol(s: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(L L^T)^-1 b for SPD ``s`` via blocked Cholesky + recursive
    triangular solves (custom-call-free; oracle for :func:`spd_solve`).

    Safe here because the whitened innovation S = H P H^T + I is bounded
    below by I, so Cholesky pivots are >= 1 and the Neumann tips of the
    recursive solves cannot amplify through near-zero pivots (unlike the
    near-singular equilibrated Gram in qr_compress, which uses the native
    factorization — see there).
    """
    l = chol_blocked(s)
    return tri_solve_upper_t(l, tri_solve_lower(l, b))


def _jacobi_scale(s: jnp.ndarray):
    """Symmetric Jacobi equilibration scale for SPD ``s`` (diag >= 0)."""
    d = jnp.diagonal(s, axis1=-2, axis2=-1)
    return 1.0 / jnp.sqrt(jnp.maximum(d, 1e-30))


def inv_spd_newton(s: jnp.ndarray, max_iter: int = 48,
                   tol: float = 3e-6) -> jnp.ndarray:
    """Approximate S^-1 for SPD ``s`` by Newton-Schulz iteration.

    X_{k+1} = X_k (2I - S X_k), X_0 = alpha I with alpha = 2/(lam_lb +
    lam_ub) from the Gershgorin row-sum bound — then ||I - S X_k||_2
    squares each step, so convergence is ~log2(kappa) + 5 iterations.
    Every step is ONE pair of full-size matmuls: this replaces the ~12k-HLO
    blocked-Cholesky/triangular-solve pipeline (whose tiny unrolled-tip ops
    each run at their latency floor) with ~2 ops per iteration. The
    while_loop exits on the Frobenius residual, so the common
    well-conditioned frame pays only its own kappa.

    Accuracy is f32-limited (residual ~kappa * eps); :func:`spd_solve`
    adds iterative refinement on the actual solve to recover
    Cholesky-level accuracy (verified against the chol oracle in
    tests/test_linalg.py).
    """
    n = s.shape[-1]
    dtype = s.dtype
    eye = jnp.eye(n, dtype=dtype)
    # symmetric Jacobi equilibration (exact outer rescale, undone on
    # return): NS iteration count is ~log2(kappa) + 5, and the whitened
    # innovation S = I + H P H^T mixes O(1) rows with O(1e4) informative
    # rows — equilibration moves that spread out of the spectrum and saves
    # about a third of the iterations.
    ds = _jacobi_scale(s)
    s_eq = s * ds[..., :, None] * ds[..., None, :]
    lam_ub = jnp.max(jnp.sum(jnp.abs(s_eq), axis=-1), axis=-1)  # Gershgorin
    alpha = 2.0 / (1.0 + lam_ub)
    x0 = jnp.broadcast_to(alpha[..., None, None] * eye, s.shape)
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)

    def cond(carry):
        x, it, resid, prev = carry
        # exit on convergence, on the roundoff floor (residual stopped
        # decreasing — quadratic convergence means every healthy iteration
        # strictly shrinks it), or on the iteration cap
        return (resid > tol) & (resid < prev) & (it < max_iter)

    def body(carry):
        x, it, resid, _ = carry
        # two NS steps per loop trip: the residual reduce + condition sync
        # cost about as much as an iteration's matmuls at fleet batch
        # sizes, so checking every other step halves that overhead at the
        # price of <= 1 overshoot iteration
        e = eye - s_eq @ x
        x = x + x @ e  # = x (2I - s_eq x)
        e = eye - s_eq @ x
        x = x + x @ e
        r = jnp.max(jnp.sqrt(jnp.sum(e * e, axis=(-2, -1))))
        return x, it + 2, r / jnp.sqrt(jnp.asarray(n, dtype)), resid

    # The iteration runs at "highest" (true float32) matmul precision. The
    # refinement sweeps in spd_solve contract the final solve by
    # ||I - S X|| per sweep, so X only needs ~1e-4-level accuracy, but a
    # reduced-mantissa loop stalls at too coarse a residual on
    # ill-conditioned matrices: on the GPU, "high" (TF32) and
    # BF16_BF16_F32_X3 both leave solve residuals hundreds of times the
    # Cholesky oracle's at kappa up to 1e6 (chip_smoke.py's solve phase).
    with jax.default_matmul_precision("highest"):
        x, _, _, _ = jax.lax.while_loop(
            cond, body,
            (x0, jnp.asarray(0, jnp.int32), big * jnp.asarray(0.5, dtype), big),
        )
    return x * ds[..., :, None] * ds[..., None, :]


def spd_solve(s: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """S^-1 b for SPD ``s``: fixed-count Newton-Schulz approximate inverse
    + three iterative-refinement sweeps on the solve itself.

    The adaptive while loop lets the common frame, which converges in far
    fewer iterations than the worst case, stop early. Refinement contracts the
    solve residual by ||I - S X|| per sweep, so an X accurate to ~1e-4
    yields a solve at f32 roundoff — matching the Cholesky path
    (:func:`spd_solve_chol`, kept as the oracle) at a tiny fraction of
    its HLO count.
    """
    x = inv_spd_newton(s)
    y = x @ b
    y = y + x @ (b - s @ y)
    y = y + x @ (b - s @ y)
    return y


def qr_compress(
    h: jnp.ndarray, res: jnp.ndarray, noise_std: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Whitened measurement compression via the Gram matrix.

    The reference QR-decomposes the *unwhitened* augmented [H|res] and then
    replaces R with sigma_img^2 I (``vio_updater.cpp:487-512``) — exact only
    when every row shares sigma_img. We whiten each row by its own std
    first, which is algebraically exact for mixed sensors (image + range +
    solar rows) and reduces the post-QR noise model to exactly I.

    Design note: the Kalman update depends on the whitened rows ONLY
    through the Gram matrix G = [H|r]^T [H|r] (S, K, and the correction are
    all functions of H^T H, H^T r, r^T r). So instead of a Householder QR
    we form G with ONE tall-skinny matmul and take R = chol(G)^T — any compressed rows with the same
    Gram give the identical update. Symmetric Jacobi equilibration keeps
    chol well-conditioned in float32; a tiny relative ridge guards the
    all-masked (G = 0) case.

    h: (r, d), res: (r,), noise_std: (r,) — masked rows must be zero (their
    std may be anything positive).
    Returns (h_c, res_c) with shapes ((d, d), (d,)) and implicit R = I.
    """
    d = h.shape[1]
    dtype = h.dtype
    w = 1.0 / noise_std
    aug = jnp.concatenate([h * w[:, None], (res * w)[:, None]], axis=1)
    g = aug.T @ aug  # (d+1, d+1)
    diag = jnp.diagonal(g)
    s = 1.0 / jnp.sqrt(jnp.maximum(diag, 1e-20))
    gs = g * s[:, None] * s[None, :]
    ridge = jnp.asarray(1e-6 if dtype == jnp.float32 else 1e-12, dtype)
    # native Cholesky: the equilibrated Gram can be near-singular (ridge
    # floor), where the Neumann-doubling factorization amplifies 1/pivot
    # quadratically per doubling level and corrupts the compressed rows
    # (observed in the thermal e2e test)
    l = jnp.linalg.cholesky(gs + ridge * jnp.eye(d + 1, dtype=dtype))
    r_fact = l.T * (1.0 / s)[None, :]  # R with R^T R = G (+ ridge)
    r_fact = jnp.where(jnp.isfinite(r_fact), r_fact, 0.0)
    return r_fact[:d, :d], r_fact[:d, d]


def qr_compress_householder(
    h: jnp.ndarray, res: jnp.ndarray, noise_std: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reference-style whitened Householder-QR compression (oracle for
    tests; the production path is the Gram/Cholesky :func:`qr_compress`)."""
    d = h.shape[1]
    w = 1.0 / noise_std
    aug = jnp.concatenate([h * w[:, None], (res * w)[:, None]], axis=1)
    r_fact = jnp.linalg.qr(aug, mode="r")  # (min(r, d+1), d+1)
    return r_fact[:d, :d], r_fact[:d, d]


def whiten(h: jnp.ndarray, res: jnp.ndarray, noise_std: jnp.ndarray):
    w = 1.0 / noise_std
    return h * w[:, None], res * w


def kalman_update(
    cov: jnp.ndarray,
    h: jnp.ndarray,
    res: jnp.ndarray,
    correction_total: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One (I)EKF update with whitened rows (R = I).

    Mirrors ``Updater::applyUpdate`` (``updater.cpp:117-141``):
      S = H P H^T + I ;  K = P H^T S^-1
      correction = K (res + H @ corr_total) - corr_total
      P <- sym((I - K H) P)
    Returns (correction, new_cov).
    """
    d = cov.shape[0]
    pht = cov @ h.T
    s = h @ pht + jnp.eye(h.shape[0], dtype=cov.dtype)
    # K = P H^T S^-1  via solving S K^T = H P (Newton-Schulz + refinement
    # — pure matmuls, no factorization call)
    k = spd_solve(s, pht.T).T
    correction = k @ (res + h @ correction_total) - correction_total
    new_cov = symmetrize((jnp.eye(d, dtype=cov.dtype) - k @ h) @ cov)
    return correction, new_cov


def mahalanobis_gamma(
    cov: jnp.ndarray, h: jnp.ndarray, res: jnp.ndarray
) -> jnp.ndarray:
    """gamma = res^T (H P H^T + I)^-1 res for whitened rows.

    Tiny systems (r <= 3) use closed-form inverses to avoid per-row
    factorization calls."""
    r = h.shape[0]
    s = h @ (cov @ h.T) + jnp.eye(r, dtype=cov.dtype)
    if r == 1:
        return res[0] * res[0] / s[0, 0]
    if r == 2:
        det = s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]
        det = jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
        return (
            res[0] * (s[1, 1] * res[0] - s[0, 1] * res[1])
            + res[1] * (s[0, 0] * res[1] - s[1, 0] * res[0])
        ) / det
    if r == 3:
        return res @ solve3(s, res)
    # r > 3: adaptive Newton-Schulz solve (S >= I here too) — the
    # unrolled-Cholesky forward substitution (_gamma_chol_unrolled, kept as
    # the oracle) costs ~50 HLOs per unrolled row, i.e. ~900 small
    # sequential ops at the MSCKF row count, in EVERY builder. A
    # fixed-count NS pays worst-case iterations on every frame, and fewer
    # fixed iterations mis-gate strongly-informative tracks (kappa ~ 1e6;
    # tests/test_linalg.py ill-conditioned case).
    return res @ spd_solve(s, res[:, None])[:, 0]


def _gamma_chol_unrolled(s: jnp.ndarray, res: jnp.ndarray) -> jnp.ndarray:
    """gamma = res^T S^-1 res via a compile-time-unrolled Cholesky forward
    substitution (S SPD, static size).

    An unrolled chain of fused vector ops that batches cleanly under vmap
    (no factorization call). gamma = ||y||^2 with
    L y = res computed column by column alongside the factorization.
    """
    r = s.shape[0]
    dtype = s.dtype
    rows = jnp.arange(r)
    l = jnp.zeros((r, r), dtype)
    y = jnp.zeros((r,), dtype)
    for j in range(r):
        # pivot and column j of L (uses columns < j of L, rest are zero)
        pivot2 = s[j, j] - l[j, :] @ l[j, :]
        pivot = jnp.sqrt(jnp.maximum(pivot2, 1e-30))
        col = (s[:, j] - l @ l[j, :]) / pivot
        col = jnp.where(rows > j, col, 0.0)
        l = l.at[:, j].set(col.at[j].set(pivot))
        # forward substitution step: y_j = (res_j - L[j,:j] y[:j]) / pivot
        y = y.at[j].set((res[j] - l[j, :] @ y) / pivot)
    return y @ y
