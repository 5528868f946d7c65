"""Supernodal block Cholesky / clamped-LDLT over a clique tree.

A JAX re-implementation of the reference's supernodal KKT machinery
(supernodal_solver.{h,cc}, block_triangular_operations.{h,cc},
kkt_solver.{h,cc}).  The clique ordering and fill-in are computed once on
the host (ordering.py); the resulting *static* supernode/separator index
sets are baked into the compiled factorization as constant gathers, so the
whole factor+solve is one XLA program of dense block ops — no pointers, no
scatter indirection at runtime.

The reference's fully-pivoted RLDLT is replaced by fixed-order LDLT with
the same +/-1e-9 pivot clamp (RLDLT.h:381-393): pivoting is data-dependent
control flow that XLA cannot tile; iterative refinement (kkt_solver.cc:
248-263) compensates, as in the reference.

Design note vs the reference: storage is a dense (N, N) backing array
rather than per-clique buffers with cross-clique pointer scatter
(triangular_matrix_workspace.cc:149-159) — the *computation* only touches
the supernodal pattern blocks, so FLOPs match the supernodal algorithm;
dense backing keeps XLA layouts trivial.  Block-compressed storage is a
later optimization.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..solver.kkt import LDLT_PIVOT_CLAMP
from .ordering import pick_clique_order


class SupernodalStructure(NamedTuple):
    """Static elimination structure: per clique (in elimination order) its
    supernode and separator variable index tuples.  Hashable — usable as a
    static jit argument."""

    blocks: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]
    n: int  # KKT dimension

    @staticmethod
    def from_cliques(cliques: Sequence[Sequence[int]], n: int,
                     valid_leaf=None, root: int = -1):
        co = pick_clique_order(cliques, valid_leaf=valid_leaf, root=root)
        blocks = []
        for e in co.order:
            s = tuple(co.supernodes[e])
            p = tuple(co.separators[e])
            if s:
                blocks.append((s, p))
        covered = {v for s, _ in blocks for v in s}
        # Variables not covered by any clique (shouldn't happen for
        # well-formed programs) get their own trailing supernode.
        rest = tuple(v for v in range(n) if v not in covered)
        if rest:
            blocks.append((rest, ()))
        return SupernodalStructure(blocks=tuple(blocks), n=n)


def _gather(G, rows, cols):
    ri = jnp.array(rows, jnp.int32)
    ci = jnp.array(cols, jnp.int32)
    return G[ri[:, None], ci[None, :]]


def factor_llt(G, structure: SupernodalStructure):
    """Supernodal block Cholesky.

    reference: BlockCholeskyInPlace (block_triangular_operations.cc:184-219):
    per supernode an in-place dense LLT, a triangular solve of the
    off-diagonal block, then the separator Schur update.
    """
    Ls, Bs = [], []
    fail = jnp.asarray(False)
    for s, p in structure.blocks:
        D = _gather(G, s, s)
        L = jnp.linalg.cholesky(D)
        fail = fail | ~jnp.all(jnp.isfinite(L))
        if p:
            B = jax.scipy.linalg.solve_triangular(L, _gather(G, s, p),
                                                  lower=True)
            pi = jnp.array(p, jnp.int32)
            G = G.at[pi[:, None], pi[None, :]].add(-(B.T @ B))
        else:
            B = jnp.zeros((len(s), 0), G.dtype)
        Ls.append(L)
        Bs.append(B)
    return (tuple(Ls), tuple(Bs)), fail


def solve_llt(fac, structure: SupernodalStructure, b):
    """Forward/backward block substitution.

    reference: ApplyBlockInverseInPlace / ...OfTransposeInPlace
    (block_triangular_operations.cc:114-182).
    """
    Ls, Bs = fac
    z = b
    for (s, p), L, B in zip(structure.blocks, Ls, Bs):
        si = jnp.array(s, jnp.int32)
        zs = jax.scipy.linalg.solve_triangular(L, z[si], lower=True)
        z = z.at[si].set(zs)
        if p:
            pi = jnp.array(p, jnp.int32)
            z = z.at[pi].add(-(B.T @ zs))
    for (s, p), L, B in zip(reversed(structure.blocks), reversed(Ls),
                            reversed(Bs)):
        si = jnp.array(s, jnp.int32)
        rhs = z[si]
        if p:
            pi = jnp.array(p, jnp.int32)
            rhs = rhs - B @ z[pi]
        z = z.at[si].set(
            jax.scipy.linalg.solve_triangular(L.T, rhs, lower=False)
        )
    return z


def _dense_ldlt_clamped(D):
    """Unrolled fixed-order LDLT with the RLDLT pivot clamp on a small
    static-size block; returns (unit_lower, d)."""
    k = D.shape[0]
    M = D
    for j in range(k):
        d = M[j, j]
        d = jnp.where(jnp.abs(d) < LDLT_PIVOT_CLAMP,
                      jnp.where(d >= 0, LDLT_PIVOT_CLAMP, -LDLT_PIVOT_CLAMP),
                      d)
        col = M[:, j]
        mask = jnp.arange(k) > j
        l_col = jnp.where(mask, col / d, 0.0)
        M = M - d * jnp.outer(l_col, l_col)
        M = jnp.where(
            mask[:, None] & (jnp.arange(k)[None, :] == j), l_col[:, None], M
        )
        M = M.at[j, j].set(d)
    L = jnp.tril(M, -1) + jnp.eye(k, dtype=D.dtype)
    return L, jnp.diagonal(M)


def factor_ldlt(G, structure: SupernodalStructure):
    """Supernodal clamped LDLT (reference BlockLDLTInPlace,
    block_triangular_operations.cc:315-349, with fixed-order clamped pivots
    instead of full pivoting)."""
    Ls, ds, Cs = [], [], []
    fail = jnp.asarray(False)
    for s, p in structure.blocks:
        D = _gather(G, s, s)
        Lu, d = _dense_ldlt_clamped(D)
        fail = fail | ~jnp.all(jnp.isfinite(Lu)) | ~jnp.all(jnp.isfinite(d))
        if p:
            # C = L[p,s] = G[p,s] Lu^{-T} d^{-1}
            Gps = _gather(G, p, s)
            tmp = jax.scipy.linalg.solve_triangular(
                Lu, Gps.T, lower=True, unit_diagonal=True
            ).T  # = G[p,s] Lu^{-T}
            C = tmp / d[None, :]
            pi = jnp.array(p, jnp.int32)
            G = G.at[pi[:, None], pi[None, :]].add(-(C * d[None, :]) @ C.T)
        else:
            C = jnp.zeros((0, len(s)), G.dtype)
        Ls.append(Lu)
        ds.append(d)
        Cs.append(C)
    return (tuple(Ls), tuple(ds), tuple(Cs)), fail


def solve_ldlt(fac, structure: SupernodalStructure, b):
    Ls, ds, Cs = fac
    z = b
    for (s, p), Lu, C in zip(structure.blocks, Ls, Cs):
        si = jnp.array(s, jnp.int32)
        zs = jax.scipy.linalg.solve_triangular(
            Lu, z[si], lower=True, unit_diagonal=True
        )
        z = z.at[si].set(zs)
        if p:
            pi = jnp.array(p, jnp.int32)
            z = z.at[pi].add(-(C @ zs))
    # diagonal scale
    for (s, p), d in zip(structure.blocks, ds):
        si = jnp.array(s, jnp.int32)
        z = z.at[si].set(z[si] / d)
    for (s, p), Lu, C in zip(reversed(structure.blocks), reversed(Ls),
                             reversed(Cs)):
        si = jnp.array(s, jnp.int32)
        rhs = z[si]
        if p:
            pi = jnp.array(p, jnp.int32)
            rhs = rhs - C.T @ z[pi]
        z = z.at[si].set(
            jax.scipy.linalg.solve_triangular(
                Lu.T, rhs, lower=False, unit_diagonal=True
            )
        )
    return z


class SupernodalKKTSolver:
    """Standalone host-facing wrapper (reference SupernodalKKTSolver,
    kkt_solver.h:16-65): analyze once, then factor/solve dense KKT
    matrices restricted to the clique-tree pattern."""

    def __init__(self, cliques: Sequence[Sequence[int]], n: int,
                 mode: str = "llt", scan: bool = False):
        self.structure = SupernodalStructure.from_cliques(cliques, n)
        self.mode = mode
        if scan:
            from . import scan as impl
            from .scan import ScanSupernodalStructure

            self.structure = ScanSupernodalStructure.from_structure(
                self.structure
            )
        else:
            import conex_tpu.supernodal.solver as impl
        if mode == "llt":
            fct, slv = impl.factor_llt, impl.solve_llt
        else:
            fct, slv = impl.factor_ldlt, impl.solve_ldlt
        self._factor = jax.jit(lambda G: fct(G, self.structure))
        self._solve = jax.jit(lambda fac, b: slv(fac, self.structure, b))
        self._fac = None

    def factor(self, G) -> bool:
        self._fac, fail = self._factor(jnp.asarray(G))
        return not bool(fail)

    def solve(self, b):
        return np.asarray(self._solve(self._fac, jnp.asarray(b)))
