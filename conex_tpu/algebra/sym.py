"""Dense symmetric-matrix kernels: Padé exponential and asymmetric Lanczos.

Re-implementations of the reference's exponential_map_pade.{h,cc} and
approximate_eigenvalues.{h,cc}.  Everything is batched over a leading
axis and built from batched matmuls; the
Lanczos early-exit (a data-dependent break in the reference,
approximate_eigenvalues.cc:217-232) becomes a fixed-length ``lax.scan`` with
masking so the whole thing stays inside one compiled program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import mm


def expm_pade(A: jnp.ndarray) -> jnp.ndarray:
    """Pade(3,3)-style rational approximation of exp(A).

    reference: ComputeWeightedPowers + ExponentialMapPadeApproximation
    (exponential_map_pade.cc:10-32): with b = [120, 60, 12, 1],
    U = A (b3 A^2 + b1 I), V = b2 A^2 + b0 I, exp(A) ~ (V - U)^{-1}(V + U).
    Batched over leading axes (jnp.linalg.solve broadcasts).
    """
    n = A.shape[-1]
    eye = jnp.eye(n, dtype=A.dtype)
    A2 = A @ A
    U = A @ (A2 + 60.0 * eye)
    V = 12.0 * A2 + 120.0 * eye
    return jnp.linalg.solve(V - U, V + U)


def expm_taylor(A: jnp.ndarray, degree: int = 8, squarings: int = 3):
    """exp(A) via degree-``degree`` Taylor of exp(A / 2^s) + s squarings.

    Pure matmuls — the exponential for the geodesic step, where the
    argument satisfies ||step * d|| <= sqrt(2) by the step-size rule
    (cone_program.cc:423-426), giving ~1e-12 accuracy at the defaults.
    Replaces the Pade solve in the hot path: it needs no batched LU
    factorization and runs in any precision mode of algebra/mm.py.
    Batched over leading axes.
    """
    n = A.shape[-1]
    eye = jnp.eye(n, dtype=A.dtype)
    X = A / (2.0 ** squarings)
    # In ozaki mode, X is the left operand of every Horner matmul: slice
    # it once instead of degree-1 times.
    X_prep = None
    if mm.get_mode() == "ozaki" and X.dtype == jnp.float64 and X.ndim >= 2:
        pat = mm.matmul_pattern(X.ndim)
        X_prep = mm.ozaki_prepare(pat, X.shape, X.shape, X, which="x")
    # Horner evaluation of sum X^k / k!.
    Y = eye + X / degree
    for k in range(degree - 1, 0, -1):
        Y = eye + mm.matmul(X, Y, x_prep=X_prep) / k
    for _ in range(squarings):
        Y = mm.matmul(Y, Y)
    return Y


def _pair_ip(V, U):
    """<V, U> = V[:, 0] . U[:, 1] — the two-column polynomial inner product.

    reference: inner_product (approximate_eigenvalues.cc:173-176).
    """
    return jnp.dot(V[:, 0], U[:, 1])


def asymmetric_lanczos(WS, W, r, num_iter: int):
    """Eigenvalue estimates of WS (similar to symmetric W^{1/2} S W^{1/2}).

    reference: AsymmetricLanczos (approximate_eigenvalues.cc:178-239).
    Tracks V = [p(WS) W r, p(WS)^T r] and builds the Jacobi (tridiagonal)
    matrix of the induced inner product; returns its eigenvalues.  The
    reference breaks when beta < 1e-6; here the break is a mask — once
    inactive, the emitted diagonal entries repeat alpha_0 (a valid Ritz
    value, inside the converged spectrum interval) and the off-diagonals are
    zero, which leaves min/max eigenvalues of the padded tridiagonal equal
    to those of the truncated one.
    """
    n = WS.shape[0]
    dtype = WS.dtype

    V = jnp.stack([W @ r, r], axis=1)
    V = V / jnp.sqrt(_pair_ip(V, V))
    U = jnp.stack([WS @ V[:, 0], WS.T @ V[:, 1]], axis=1)
    alpha0 = _pair_ip(V, U)
    U = U - alpha0 * V

    def step(carry, _):
        V, Vprev, U, active = carry
        beta_sq = _pair_ip(U, U)
        go = active & (beta_sq >= 1e-6)
        beta = jnp.sqrt(jnp.maximum(beta_sq, 1e-300))
        V_new = U / beta
        U_new = jnp.stack([WS @ V_new[:, 0], WS.T @ V_new[:, 1]], axis=1)
        alpha = _pair_ip(V_new, U_new)
        U_new = U_new - alpha * V_new - beta * V

        V_out = jnp.where(go, V_new, V)
        Vp_out = jnp.where(go, V, Vprev)
        U_out = jnp.where(go, U_new, U)
        alpha_out = jnp.where(go, alpha, alpha0)
        beta_out = jnp.where(go, beta, 0.0)
        return (V_out, Vp_out, U_out, go), (alpha_out, beta_out)

    if num_iter > 1:
        (_, _, _, _), (alphas, betas) = jax.lax.scan(
            step, (V, V, U, jnp.asarray(True)), None, length=num_iter - 1
        )
        diag = jnp.concatenate([alpha0[None], alphas])
        offdiag = betas
    else:
        diag = alpha0[None]
        offdiag = jnp.zeros((0,), dtype)

    if num_iter == 1:
        return diag
    return jax.scipy.linalg.eigh_tridiagonal(
        diag, offdiag, eigvals_only=True
    )


def approximate_eigenvalues(WS, W, r, num_iter: int):
    """Dispatcher (reference approximate_eigenvalues.cc:241-256): n = 1
    inputs are returned unchanged; otherwise asymmetric Lanczos."""
    if WS.shape[0] == 1:
        return WS[0]
    return asymmetric_lanczos(WS, W, r, num_iter)


def _dominant_rayleigh_vec(B, num_squarings: int):
    """(lam_max, u, v) of B (real positive spectrum) via normalized repeated
    squaring + a two-sided Rayleigh quotient on the dominant left/right
    eigenvector estimates.  Pure matmuls — the replacement for
    tridiagonal eigensolvers, which are branchy bisection loops that destroy
    XLA compile and runtime inside the jitted iteration.

    On f64 inputs the squaring passes run in f32 (eigenvector estimates
    only — the Rayleigh quotient below is second-order accurate in the
    eigenvector error, so f32-quality vectors give ~1e-14-class
    eigenvalues) while the quotient itself uses the f64 matrix."""
    in_dtype = B.dtype
    Bq = B.astype(jnp.float32) if in_dtype == jnp.float64 else B
    n = B.shape[-1]

    def fro(X):
        return jnp.sqrt(jnp.sum(X * X, axis=(-2, -1), keepdims=True))

    X = Bq / jnp.maximum(fro(Bq), 1e-30)
    for _ in range(num_squarings):
        X = X @ X
        X = X / jnp.maximum(fro(X), 1e-30)
    # Columns of X -> dominant right eigenvector; rows -> left eigenvector.
    j = jnp.argmax(jnp.sum(X * X, axis=-2), axis=-1)
    v = jnp.take_along_axis(X, j[..., None, None], axis=-1)[..., 0]
    i = jnp.argmax(jnp.sum(X * X, axis=-1), axis=-1)
    u = jnp.take_along_axis(X, i[..., None, None], axis=-2)[..., 0, :]
    u = u.astype(in_dtype)
    v = v.astype(in_dtype)
    Bv = jnp.einsum("...ij,...j->...i", B, v)
    uv = jnp.einsum("...i,...i->...", u, v)
    vv = jnp.einsum("...i,...i->...", v, v)
    two_sided = jnp.einsum("...i,...i->...", u, Bv) / uv
    one_sided = jnp.einsum("...i,...i->...", v, Bv) / vv
    # Two-sided RQ is second-order accurate but needs u.v bounded away
    # from 0; fall back to the one-sided quotient otherwise.
    lam = jnp.where(
        jnp.abs(uv) > 1e-6 * jnp.sqrt(vv) * jnp.linalg.norm(u, axis=-1),
        two_sided,
        one_sided,
    )
    return jnp.where(jnp.isfinite(lam), lam, 0.0), u, v


def _dominant_rayleigh(B, num_squarings: int):
    return _dominant_rayleigh_vec(B, num_squarings)[0]


def extreme_eigenvalues(M, num_squarings: int = 9):
    """(lam_min, lam_max) of a matrix with real spectrum (similar to a
    symmetric matrix — e.g. WS = W S with W PSD).

    Replaces the reference's Lanczos + tridiagonal-eigenvalue pipeline
    (psd_constraint.cc:63-77) for the estimates the solver actually consumes
    (only the spectrum extremes).  Shift by sigma >= rho(M) to make the
    target eigenvalue dominant on each side, then repeated squaring: after
    2^9 = 512 effective power steps the Rayleigh quotient is accurate to
    ~machine precision for well-separated extremes.  Broadcasts over leading
    batch axes; ~28 small matmuls total.

    The shift is computed in two stages: a cheap squaring pass on M @ M
    (positive spectrum rho(M)^2) gives a tight estimate of the spectral
    radius, and sigma = 1.05 rho_est replaces the Frobenius norm of the
    original design.  With the Frobenius shift (up to sqrt(n) rho) the
    per-step dominance ratio 1 + gap/sigma is deflated by ~sqrt(n), which
    left interior-eigenvector contamination of ~0.5 after 512 steps on
    clustered spectra at n = 64 (lam_min relative error ~50% on the
    adversarial cases in test_sdp.py::test_extreme_eigenvalues_clustered);
    the tight shift decays the same contamination to ~1e-5.
    """
    fro = jnp.sqrt(jnp.sum(M * M, axis=(-2, -1)))[..., None, None] + 1e-30
    # Stage 1: rho(M)^2 = dominant eigenvalue of M @ M (positive spectrum).
    # The shift estimate only needs a few digits: compute it in f32.
    Mq = (M / fro).astype(jnp.float32) if M.dtype == jnp.float64 else M / fro
    rho2 = _dominant_rayleigh(Mq @ Mq, 6).astype(M.dtype)
    rho = jnp.sqrt(jnp.maximum(rho2, 0.0))[..., None, None] * fro
    # A squaring-pass Rayleigh quotient on a positive spectrum lies inside
    # the spectrum interval, so rho is a slight *under*-estimate; the 1.05
    # margin keeps sigma >= rho(M).  Fall back to Frobenius if degenerate.
    sigma = jnp.where(
        jnp.isfinite(rho) & (rho > 1e-3 * fro), 1.05 * rho, fro
    )
    eye = jnp.eye(M.shape[-1], dtype=M.dtype)
    lam_hi = _dominant_rayleigh(M + sigma * eye, num_squarings)
    lam_lo = _dominant_rayleigh(sigma * eye - M, num_squarings)
    sig = sigma[..., 0, 0]
    return sig - lam_lo, lam_hi - sig


def extreme_eigenvalues_seeded(M, num_squarings: int = 9):
    """Cold-start variant of extreme_eigenvalues that also returns the
    eigenvector estimates, seeding extreme_eigenvalues_warm."""
    fro = jnp.sqrt(jnp.sum(M * M, axis=(-2, -1)))[..., None, None] + 1e-30
    Mq = (M / fro).astype(jnp.float32) if M.dtype == jnp.float64 else M / fro
    rho2 = _dominant_rayleigh(Mq @ Mq, 6).astype(M.dtype)
    rho = jnp.sqrt(jnp.maximum(rho2, 0.0))[..., None, None] * fro
    sigma = jnp.where(
        jnp.isfinite(rho) & (rho > 1e-3 * fro), 1.05 * rho, fro
    )
    eye = jnp.eye(M.shape[-1], dtype=M.dtype)
    hi_s, uhi, vhi = _dominant_rayleigh_vec(M + sigma * eye, num_squarings)
    lo_s, ulo, vlo = _dominant_rayleigh_vec(sigma * eye - M, num_squarings)
    sig = sigma[..., 0, 0]
    lam_lo, lam_hi = sig - lo_s, hi_s - sig
    lam = jnp.stack([lam_lo, lam_hi], axis=-1)
    return lam_lo, lam_hi, (vhi, uhi, vlo, ulo), lam


def extreme_eigenvalues_warm(M, vhi, uhi, vlo, ulo, lam_prev,
                             num_steps: int = 16):
    """(lam_lo, lam_hi, new seeds) with eigenvector estimates carried across
    solver iterations.

    The interior-point iterate drifts by a bounded geodesic step per
    iteration (||step d|| <= sqrt(2), so eigenvalues move by at most a
    factor e^sqrt(2) ~ 4), which makes shifted power iteration from the
    previous iteration's eigenvector estimates converge in a handful of
    matvecs — ~60 matvecs (= 0.6 matmul-equivalents) instead of the ~28
    batched matmuls of the cold squaring estimator.  This is the hot-path
    estimator of the PSD cone (psd.py); the cold squaring estimator remains
    for the first iteration (seeds empty -> Frobenius shift + more steps
    are implied by the carried-lambda sentinel) and as the standalone API.

    Arguments: M (..., n, n) with real spectrum; vhi/uhi/vlo/ulo (..., n)
    right/left eigenvector seeds for the max/min ends; lam_prev (..., 2)
    previous (lo, hi) estimates (zeros = cold start).  The shift is
    4 * max|lam_prev| (covering the per-iteration drift bound) or the
    Frobenius norm on cold start.

    reference role: PrepareStep / GetWeightedSlackEigenvalues norms
    (psd_constraint.cc:63-77) — the reference re-runs n/2 Lanczos
    iterations from a fresh seed every time.
    """
    fro = jnp.sqrt(jnp.sum(M * M, axis=(-2, -1))) + 1e-30
    sig_warm = 4.0 * jnp.max(jnp.abs(lam_prev), axis=-1)
    # The 1.25 margin keeps sigma strictly above rho(M): with sigma == rho
    # exactly (e.g. WS ~ -rho I at a converged centering point, where
    # rho == fro), M + sigma I ~ 0 and the shifted power iteration collapses
    # to the zero vector, poisoning the Rayleigh quotient.
    sigma = 1.25 * jnp.where(
        sig_warm > 1e-6 * fro, jnp.minimum(sig_warm, fro), fro
    )
    # The power-iteration sweep only produces eigenvector *estimates* (the
    # Rayleigh quotient below is second-order accurate in their error), so
    # on f64 inputs it runs in f32.
    in_dtype = M.dtype
    it_dtype = jnp.float32 if in_dtype == jnp.float64 else in_dtype
    Mi = M.astype(it_dtype)
    sig = sigma[..., None].astype(it_dtype)

    def norm(v):
        return v / (jnp.linalg.norm(v, axis=-1, keepdims=True) + 1e-30)

    Mt = jnp.swapaxes(Mi, -2, -1)

    def step(c, _):
        vh, uh, vl, ul = c
        # One read of M (and one of M^T) drives both ends: stack the
        # max-end and min-end vectors into a 2-column block.
        V = jnp.stack([vh, vl], axis=-1)  # (..., n, 2)
        MV = jnp.einsum("...ij,...jk->...ik", Mi, V)
        U = jnp.stack([uh, ul], axis=-1)
        MtU = jnp.einsum("...ij,...jk->...ik", Mt, U)
        vh = norm(MV[..., 0] + sig * vh)
        vl = norm(sig * vl - MV[..., 1])
        uh = norm(MtU[..., 0] + sig * uh)
        ul = norm(sig * ul - MtU[..., 1])
        return (vh, uh, vl, ul), None

    seeds0 = tuple(
        norm(v.astype(it_dtype)) for v in (vhi, uhi, vlo, ulo)
    )
    (vhi, uhi, vlo, ulo), _ = jax.lax.scan(
        step, seeds0, None, length=num_steps,
    )
    vhi, uhi, vlo, ulo = (
        x.astype(in_dtype) for x in (vhi, uhi, vlo, ulo)
    )

    def rq(u, v, prev):
        Mv = jnp.einsum("...ij,...j->...i", M, v)
        uv = jnp.einsum("...i,...i->...", u, v)
        vv = jnp.einsum("...i,...i->...", v, v)
        two = jnp.einsum("...i,...i->...", u, Mv) / uv
        one = jnp.einsum("...i,...i->...", v, Mv) / vv
        lam = jnp.where(
            jnp.abs(uv) > 1e-6 * jnp.sqrt(vv) * jnp.linalg.norm(u, axis=-1),
            two,
            one,
        )
        # Degenerate iteration (zero vector / non-finite RQ): carry the
        # previous estimate forward rather than reporting 0, which would
        # masquerade as a converged direction (dinf floor at 1).
        return jnp.where(jnp.isfinite(lam) & (vv > 1e-30), lam, prev)

    lam_hi = rq(uhi, vhi, lam_prev[..., 1])
    lam_lo = rq(ulo, vlo, lam_prev[..., 0])
    lam = jnp.stack([lam_lo, lam_hi], axis=-1)
    return lam_lo, lam_hi, (vhi, uhi, vlo, ulo), lam
