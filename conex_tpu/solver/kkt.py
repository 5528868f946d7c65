"""Dense KKT solvers: Cholesky (LLT), clamped LDLT, QR; iterative refinement.

Round-1 implementation factors the assembled dense KKT matrix on-device.
This replaces the reference's SupernodalKKTSolver (/root/reference/conex/
kkt_solver.{h,cc}) for dense programs; the supernodal clique-tree path for
sparse programs is layered on top later (conex_tpu/supernodal).

Mode semantics (reference kkt_solver.cc:172-199):
  LLT  — used when there are no equality-constraint duals.
  LDLT — indefinite KKT systems.  The reference uses a *fully pivoted* LDLT
         with pivots clamped to +/-1e-9 (RLDLT.h:381-393).  Pivoting needs
         data-dependent permutations that defeat XLA tiling, so we
         use a fixed-order LDLT with the same +/-1e-9 clamp and compensate
         with iterative refinement — the reference's own remedy
         (kkt_solver.cc:248-261).
  QR   — dense least-squares fallback for rank-deficient systems.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..algebra import mm
from ..config import KKT_SOLVER_LDLT, KKT_SOLVER_LLT, KKT_SOLVER_QR

# Pivot clamp magnitude (reference RLDLT.h:261-263, 310-318).
LDLT_PIVOT_CLAMP = 1e-9


class KKTFactor(NamedTuple):
    """Factored KKT matrix.  ``mode`` is static (baked into the trace)."""

    matrix: jnp.ndarray  # densified KKT matrix (kept for refinement)
    # Cholesky L, unit-L with d on the diagonal (LDLT), or the (Q, R) pair
    # for QR mode — factored ONCE here so the 3+ solves per line-search
    # iteration reuse it (reference factors once too, kkt_solver.cc:174-177,
    # 227-231).
    factor: jnp.ndarray
    fail: jnp.ndarray  # scalar bool: factorization failed


def _cholesky(K):
    L = jnp.linalg.cholesky(K)
    # A non-PSD input yields NaNs in L (XLA semantics); the reference treats
    # Eigen::LLT info() != Success as failure (kkt_solver.cc:178-189).
    fail = ~jnp.all(jnp.isfinite(L))
    return L, fail


def _ldlt_scalar(K):
    """Fixed-order LDLT with pivot clamping, right-looking, via fori_loop.

    Produces M with unit-lower-triangular L strictly below the diagonal and
    d on the diagonal.  Pivots with |d| < 1e-9 are clamped to +/-1e-9
    (matching RLDLT.h:381-393) instead of failing.
    """
    n = K.shape[0]
    dtype = K.dtype

    def body(j, M):
        d = M[j, j]
        d = jnp.where(jnp.abs(d) < LDLT_PIVOT_CLAMP,
                      jnp.where(d >= 0, LDLT_PIVOT_CLAMP, -LDLT_PIVOT_CLAMP),
                      d)
        col = M[:, j]
        row_idx = jnp.arange(n)
        below = row_idx > j
        l_col = jnp.where(below, col / d, 0.0)
        # Trailing Schur update: M -= d * l l^T on rows/cols > j.
        M = M - d * jnp.outer(l_col, l_col)
        # Write the L column and the clamped pivot back.
        M = jnp.where(below[:, None] & (row_idx[None, :] == j), l_col[:, None], M)
        M = M.at[j, j].set(d)
        return M

    M = jax.lax.fori_loop(0, n, body, K.astype(dtype))
    fail = ~jnp.all(jnp.isfinite(M))
    return M, fail


# Panel width for the blocked LDLT: an untuned default.  The within-panel
# factor is the O(P) scalar loop, everything else (panel solve + trailing
# update) is batched matmuls.
LDLT_PANEL = 128


def _ldlt_clamped(K, panel: int = LDLT_PANEL):
    """Blocked right-looking fixed-order LDLT with the +/-1e-9 pivot clamp.

    Replacement for the pure scalar loop: the scalar variant performs n
    sequential steps each doing a full (n, n) rank-1 update; this version
    does n/P scalar steps of size (P, P) and moves the O(n^2 P) trailing
    work into (n, P) x (P, n) matmuls.
    Same clamp semantics (fixed elimination order, so the pivot sequence
    and clamping decisions match the scalar variant exactly in exact
    arithmetic).  reference: BlockLDLTInPlace
    (block_triangular_operations.cc:315-349) factors per-supernode panels
    the same way, with RLDLT (RLDLT.h:381-393) as the panel kernel.

    ``K`` is padded to a multiple of ``panel`` with an identity diagonal:
    LDLT(blockdiag(K, I)) == blockdiag(LDLT(K), I), so slicing back is
    exact.
    """
    n = K.shape[0]
    if n <= panel:
        return _ldlt_scalar(K)
    dtype = K.dtype
    P = panel
    nb = -(-n // P)
    n_pad = nb * P
    if n_pad != n:
        Kp = jnp.zeros((n_pad, n_pad), dtype)
        Kp = Kp.at[:n, :n].set(K)
        Kp = Kp.at[jnp.arange(n, n_pad), jnp.arange(n, n_pad)].set(1.0)
    else:
        Kp = K
    eyeP = jnp.eye(P, dtype=dtype)
    pidx = jnp.arange(P)
    ridx = jnp.arange(n_pad)

    def panel_factor(j, S):
        d = S[j, j]
        d = jnp.where(jnp.abs(d) < LDLT_PIVOT_CLAMP,
                      jnp.where(d >= 0, LDLT_PIVOT_CLAMP, -LDLT_PIVOT_CLAMP),
                      d)
        col = S[:, j]
        below = pidx > j
        l_col = jnp.where(below, col / d, 0.0)
        S = S - d * jnp.outer(l_col, l_col)
        S = jnp.where(below[:, None] & (pidx[None, :] == j), l_col[:, None], S)
        S = S.at[j, j].set(d)
        return S

    def body(jb, M):
        j0 = jb * P
        # Factor the P x P diagonal block with the scalar kernel.
        Ablk = jax.lax.dynamic_slice(M, (j0, j0), (P, P))
        Dfac = jax.lax.fori_loop(0, P, panel_factor, Ablk)
        d = jnp.diagonal(Dfac)
        L11 = jnp.tril(Dfac, -1) + eyeP
        # Panel solve: A21 = L21 d L11^T  =>  L21 = (A21 L11^{-T}) / d.
        cols = jax.lax.dynamic_slice(M, (0, j0), (n_pad, P))
        below_mask = (ridx >= j0 + P)[:, None]
        A21 = jnp.where(below_mask, cols, 0.0)
        X = jax.scipy.linalg.solve_triangular(
            L11, A21.T, lower=True, unit_diagonal=True
        ).T
        L21 = X / d[None, :]
        # Write the finished column block back.
        in_panel = ((ridx >= j0) & (ridx < j0 + P))[:, None]
        colnew = jnp.where(in_panel, 0.0, cols)
        colnew = jax.lax.dynamic_update_slice(colnew, Dfac, (j0, 0))
        colnew = jnp.where(below_mask, L21, colnew)
        M = jax.lax.dynamic_update_slice(M, colnew, (0, j0))
        # Trailing update.  L21 vanishes on rows < j0 + P, so this touches
        # only the trailing square.  Routed through the active precision
        # mode (algebra/mm.py), so the blocked factor runs at the
        # configured precision and a default-precision product (TF32 on a
        # GPU) does not become the precision bottleneck.
        M = M - mm.matmul(L21 * d[None, :], L21.T)
        return M

    M = jax.lax.fori_loop(0, nb, body, Kp)
    M = M[:n, :n]
    fail = ~jnp.all(jnp.isfinite(M))
    return M, fail


def _supernodal_impl(structure):
    """Pick the unrolled (per-clique XLA ops) or scan-compiled supernodal
    implementation from the static structure type."""
    from ..supernodal.scan import ScanSupernodalStructure

    if isinstance(structure, ScanSupernodalStructure):
        from ..supernodal import scan as sn
    else:
        from ..supernodal import solver as sn
    return sn


def factor(K: jnp.ndarray, mode: int, structure=None,
           axis_name=None, island_dtype=None) -> KKTFactor:
    """``structure``: optional static SupernodalStructure — factors along
    the clique tree instead of densely (QR mode ignores it).  A
    DistributedSupernodalStructure shards the clique tree over the
    ``axis_name`` mesh axis (requires shard_map context).  With a
    CompressedSupernodalStructure, ``K`` is the flat block-compressed
    buffer (supernodal/compressed.py), not a dense matrix.

    ``island_dtype``: optional precision island (e.g. jnp.float64) for the
    dense path — the assembled KKT matrix is cast up before factorization
    and ``solve`` casts solutions back to the rhs dtype.  The matrix is
    small relative to the cone kernels, so this buys f64 factorization
    robustness at little cost (SolverConfig.kkt_island_dtype)."""
    if island_dtype is not None and structure is None:
        if (jnp.dtype(island_dtype) == jnp.dtype("float64")
                and not jax.config.jax_enable_x64):
            # Without x64, astype(float64) silently canonicalizes to f32
            # and the configured precision island would be absent.
            raise ValueError(
                "kkt_island_dtype='float64' requires jax_enable_x64; "
                "enable it (jax.config.update('jax_enable_x64', True)) "
                "before solving"
            )
        K = K.astype(island_dtype)
    if structure is not None and mode in (KKT_SOLVER_LLT, KKT_SOLVER_LDLT):
        from ..supernodal.compressed import CompressedSupernodalStructure

        if isinstance(structure, CompressedSupernodalStructure):
            from ..supernodal import compressed as cn

            fn = cn.factor_llt if mode == KKT_SOLVER_LLT else cn.factor_ldlt
            fac, fail = fn(K, structure)
            return KKTFactor(matrix=K, factor=fac, fail=fail)
        from ..supernodal.dist_compressed import (
            DistributedCompressedStructure,
        )

        if isinstance(structure, DistributedCompressedStructure):
            if axis_name is None:
                raise ValueError(
                    "DistributedCompressedStructure requires axis_name"
                )
            from ..supernodal import dist_compressed as dc

            fn = dc.factor_llt if mode == KKT_SOLVER_LLT else dc.factor_ldlt
            fac, fail = fn(K, structure, axis_name)
            return KKTFactor(matrix=K, factor=fac, fail=fail)
        from ..supernodal.distributed import DistributedSupernodalStructure

        if isinstance(structure, DistributedSupernodalStructure):
            if axis_name is None:
                raise ValueError(
                    "DistributedSupernodalStructure requires axis_name"
                )
            from ..supernodal import distributed as dn

            fn = dn.factor_llt if mode == KKT_SOLVER_LLT else dn.factor_ldlt
            fac, fail = fn(K, structure, axis_name)
            return KKTFactor(matrix=K, factor=fac, fail=fail)
        sn = _supernodal_impl(structure)
        if mode == KKT_SOLVER_LLT:
            fac, fail = sn.factor_llt(K, structure)
        else:
            fac, fail = sn.factor_ldlt(K, structure)
        return KKTFactor(matrix=K, factor=fac, fail=fail)
    if mode == KKT_SOLVER_LLT:
        L, fail = _cholesky(K)
    elif mode == KKT_SOLVER_LDLT:
        L, fail = _ldlt_clamped(K)
    elif mode == KKT_SOLVER_QR:
        L, fail = jnp.linalg.qr(K), jnp.asarray(False)
    else:
        raise ValueError(f"unknown kkt solver mode {mode}")
    return KKTFactor(matrix=K, factor=L, fail=fail)


def _solve_llt(L, b):
    y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


def _solve_ldlt(M, b):
    n = M.shape[0]
    eye = jnp.eye(n, dtype=M.dtype)
    L = jnp.tril(M, -1) + eye
    d = jnp.diagonal(M)
    y = jax.scipy.linalg.solve_triangular(L, b, lower=True, unit_diagonal=True)
    y = y / d
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False, unit_diagonal=True)


def _solve_qr(qr, b):
    # Least-squares solve for rank-deficient KKT systems, reusing the
    # decomposition computed in factor() (reference kkt_solver.cc:174-177,
    # 227-231: one QR per Factor, reused across line-search solves).
    q, r = qr
    return jax.scipy.linalg.solve_triangular(r, q.T @ b, lower=False)


def solve(f: KKTFactor, b: jnp.ndarray, mode: int, refinement_steps: int = 0,
          structure=None, axis_name=None):
    """Solve K x = b with optional iterative refinement.

    reference: SolveInPlace + refinement loop, kkt_solver.cc:220-263.
    """

    out_dtype = b.dtype
    if structure is None and f.matrix.dtype != b.dtype:
        b = b.astype(f.matrix.dtype)

    def base_solve(rhs):
        if structure is not None and mode in (KKT_SOLVER_LLT, KKT_SOLVER_LDLT):
            from ..supernodal.compressed import CompressedSupernodalStructure

            if isinstance(structure, CompressedSupernodalStructure):
                from ..supernodal import compressed as cn

                fn = cn.solve_llt if mode == KKT_SOLVER_LLT else cn.solve_ldlt
                return fn(f.factor, structure, rhs)
            from ..supernodal.dist_compressed import (
                DistributedCompressedStructure,
            )

            if isinstance(structure, DistributedCompressedStructure):
                from ..supernodal import dist_compressed as dc

                fn = (
                    dc.solve_llt if mode == KKT_SOLVER_LLT else dc.solve_ldlt
                )
                return fn(f.factor, structure, rhs, axis_name)
            from ..supernodal.distributed import (
                DistributedSupernodalStructure,
            )

            if isinstance(structure, DistributedSupernodalStructure):
                from ..supernodal import distributed as dn

                fn = (
                    dn.solve_llt if mode == KKT_SOLVER_LLT else dn.solve_ldlt
                )
                return fn(f.factor, structure, rhs, axis_name)
            sn = _supernodal_impl(structure)
            if mode == KKT_SOLVER_LLT:
                return sn.solve_llt(f.factor, structure, rhs)
            return sn.solve_ldlt(f.factor, structure, rhs)
        if mode == KKT_SOLVER_LLT:
            return _solve_llt(f.factor, rhs)
        if mode == KKT_SOLVER_LDLT:
            return _solve_ldlt(f.factor, rhs)
        return _solve_qr(f.factor, rhs)

    def residual_matvec(x):
        if structure is not None:
            from ..supernodal.compressed import CompressedSupernodalStructure
            from ..supernodal.dist_compressed import (
                DistributedCompressedStructure,
            )

            if isinstance(structure, CompressedSupernodalStructure):
                from ..supernodal import compressed as cn

                return cn.matvec(f.matrix, structure, x)
            if isinstance(structure, DistributedCompressedStructure):
                from ..supernodal import compressed as cn

                return cn.matvec(f.matrix, structure.base, x)
        return f.matrix @ x

    x = base_solve(b)
    for _ in range(refinement_steps):
        r = b - residual_matvec(x)
        x = x + base_solve(r)
    return x.astype(out_dtype)
