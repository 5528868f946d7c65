"""Block-compressed supernodal storage: O(sum of block sizes) memory.

The reference stores the Cholesky factor as per-clique dense blocks in one
contiguous buffer — a supernode x supernode ``diagonal`` and a supernode x
separator ``off_diagonal`` per clique — with the separator x separator Schur
updates scattered into *other* cliques' storage through precomputed pointers
(/root/reference/conex/triangular_matrix_workspace.cc:123-159,
supernodal_solver.h:64-106, block_triangular_operations.cc:184-219).

This module is the equivalent.  Storage is ONE flat device array
holding the padded per-clique blocks

    buf = [ D_0 .. D_{K-1} | O_0 .. O_{K-1} | dump ]

with D_k: (smax, smax) supernode diagonal and O_k: (smax, pmax) supernode x
separator blocks (padded slots stay zero).  The reference's pointer scatter
becomes a host-precomputed int32 map per clique: entry (i, j) of clique k's
separator Schur update lands at a flat position inside an ancestor's D or O
block (or the dump slot for padding / the redundant mirrored orientation).
Assembly is the same mechanism: each cone block's dense Schur contribution
G_b over its variable clique scatters through a per-block flat-index map —
the compressed counterpart of SupernodalAssembler::Scatter
(supernodal_assembler.cc:103-111) — so the dense (N, N) KKT matrix is never
materialized anywhere.

Factorization/solves run as ``lax.scan`` over the elimination order with
O(1) compile cost in the clique count (same approach as supernodal/scan.py)
but with the flat compressed buffer as the carry instead of a dense (N, N)
matrix: memory is O(K * (smax^2 + smax*pmax)) instead of O(N^2).

Pivot semantics match the reference RLDLT clamp (RLDLT.h:381-393).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..solver.kkt import LDLT_PIVOT_CLAMP
from .solver import SupernodalStructure


class CompressedSupernodalStructure(NamedTuple):
    """Static, hashable elimination structure for the compressed path.

    Same (supernode, separator) block tuples as SupernodalStructure; all
    index maps are derived on the host and cached (the structure itself is
    a static jit argument, so derived maps are trace-time constants).
    """

    blocks: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]
    n: int

    @staticmethod
    def from_cliques(cliques: Sequence[Sequence[int]], n: int,
                     valid_leaf=None, root: int = -1):
        base = SupernodalStructure.from_cliques(
            cliques, n, valid_leaf=valid_leaf, root=root
        )
        return CompressedSupernodalStructure(blocks=base.blocks, n=base.n)

    @staticmethod
    def from_structure(s: SupernodalStructure):
        return CompressedSupernodalStructure(blocks=s.blocks, n=s.n)

    @property
    def smax(self) -> int:
        return max((len(s) for s, _ in self.blocks), default=1)

    @property
    def pmax(self) -> int:
        return max((len(p) for _, p in self.blocks), default=0)

    # -- flat buffer layout -------------------------------------------------

    @property
    def d_size(self) -> int:
        return len(self.blocks) * self.smax * self.smax

    @property
    def o_size(self) -> int:
        return len(self.blocks) * self.smax * max(self.pmax, 1)

    @property
    def buf_size(self) -> int:
        """Flat buffer length: D region + O region + one dump slot."""
        return self.d_size + self.o_size + 1

    @property
    def dump(self) -> int:
        return self.buf_size - 1

    def d_pos(self, k: int, i: int, j: int) -> int:
        return (k * self.smax + i) * self.smax + j

    def o_pos(self, k: int, i: int, j: int) -> int:
        return self.d_size + (k * self.smax + i) * max(self.pmax, 1) + j


# ---------------------------------------------------------------------------
# Host-side index-map construction (cached per structure)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _maps(structure: CompressedSupernodalStructure):
    """Ownership and position maps.

    owner[v]   — elimination-order index of the clique whose supernode holds v
    sn_pos[v]  — v's position within that supernode
    sep_pos[k] — {var: position in separator(k)}
    """
    n = structure.n
    owner = np.full(n, -1, np.int64)
    sn_pos = np.full(n, -1, np.int64)
    sep_pos = []
    for k, (s, p) in enumerate(structure.blocks):
        for i, v in enumerate(s):
            owner[v] = k
            sn_pos[v] = i
        sep_pos.append({v: i for i, v in enumerate(p)})
    return owner, sn_pos, tuple(sep_pos)


def _pair_target(structure, owner, sn_pos, sep_pos, row: int, col: int) -> int:
    """Flat position of KKT entry (row, col), or the dump slot.

    Each unordered pair {row, col} is stored exactly once unless both
    variables share a supernode (then both orientations live in the D
    block, which is kept full-symmetric so the block Cholesky can consume
    it directly).  The cross-supernode orientation with ``col`` eliminated
    first lives in owner(col)'s off-diagonal block at (sn_pos(col),
    sep_pos(row)) — the compressed equivalent of the reference's
    seperator_diagonal pointers (triangular_matrix_workspace.cc:149-159);
    the mirrored orientation dumps.
    """
    tr, tc = owner[row], owner[col]
    if tr < 0 or tc < 0:
        return structure.dump
    if tr == tc:
        return structure.d_pos(int(tc), int(sn_pos[row]), int(sn_pos[col]))
    if tc < tr:
        j = sep_pos[tc].get(row)
        if j is None:
            raise ValueError(
                f"entry ({row},{col}) outside the clique-tree fill pattern"
            )
        return structure.o_pos(int(tc), int(sn_pos[col]), int(j))
    return structure.dump


@functools.lru_cache(maxsize=None)
def _update_map(structure: CompressedSupernodalStructure):
    """(K, pmax, pmax) int32: flat targets of each clique's separator
    Schur-update entries (dump for padding and mirrored orientations)."""
    owner, sn_pos, sep_pos = _maps(structure)
    K = len(structure.blocks)
    pmax = max(structure.pmax, 1)
    out = np.full((K, pmax, pmax), structure.dump, np.int64)
    for k, (_, p) in enumerate(structure.blocks):
        for i, a in enumerate(p):
            for j, b in enumerate(p):
                out[k, i, j] = _pair_target(
                    structure, owner, sn_pos, sep_pos, a, b
                )
    return out


@functools.lru_cache(maxsize=None)
def assembly_map(structure: CompressedSupernodalStructure,
                 rows: Tuple[int, ...], cols: Tuple[int, ...]):
    """(len(rows), len(cols)) int64 flat targets for scattering a dense
    contribution over KKT rows x cols into the compressed buffer.  The
    compressed counterpart of SupernodalAssembler block binding
    (supernodal_assembler.cc:72-111)."""
    owner, sn_pos, sep_pos = _maps(structure)
    out = np.empty((len(rows), len(cols)), np.int64)
    for i, r in enumerate(rows):
        for j, c in enumerate(cols):
            out[i, j] = _pair_target(structure, owner, sn_pos, sep_pos, r, c)
    return out


@functools.lru_cache(maxsize=None)
def _padded_indices(structure: CompressedSupernodalStructure):
    """Solve-time gather indices, same dummy-slot scheme as scan.py:
    padded supernode slots n..n+smax-1 and disjoint separator slots
    n+smax..; plus per-clique diagonal padding masks for the factor."""
    smax, pmax = structure.smax, max(structure.pmax, 1)
    K = len(structure.blocks)
    n = structure.n
    s_idx = np.zeros((K, smax), np.int32)
    p_idx = np.zeros((K, pmax), np.int32)
    diag_pad = np.zeros((K, smax), np.float64)
    for k, (s, p) in enumerate(structure.blocks):
        s_idx[k, : len(s)] = s
        s_idx[k, len(s):] = n + np.arange(smax - len(s))
        diag_pad[k, len(s):] = 1.0
        p_idx[k, : len(p)] = p
        p_idx[k, len(p):] = n + smax + np.arange(pmax - len(p))
    return s_idx, p_idx, diag_pad, n + smax + pmax


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------


def empty_buffer(structure: CompressedSupernodalStructure, dtype):
    return jnp.zeros((structure.buf_size,), dtype)


def scatter_contribution(buf, structure, vars_rows, vars_cols, value):
    """buf[map] += value for a dense contribution over rows x cols."""
    idx = jnp.asarray(
        assembly_map(structure, tuple(vars_rows), tuple(vars_cols))
    )
    return buf.at[idx.ravel()].add(value.ravel())


# ---------------------------------------------------------------------------
# Factorization (lax.scan over the elimination order, compressed carry)
# ---------------------------------------------------------------------------


def _read_blocks(buf, k, structure):
    smax, pmax = structure.smax, max(structure.pmax, 1)
    D = jax.lax.dynamic_slice(buf, (k * smax * smax,), (smax * smax,))
    O = jax.lax.dynamic_slice(
        buf, (structure.d_size + k * smax * pmax,), (smax * pmax,)
    )
    return D.reshape(smax, smax), O.reshape(smax, pmax)


def factor_llt(buf, structure: CompressedSupernodalStructure):
    """Supernodal block Cholesky on compressed storage.

    reference: BlockCholeskyInPlace (block_triangular_operations.cc:184-219)
    — per supernode an in-place dense LLT, a triangular solve of the
    off-diagonal block, then the separator Schur update scattered through
    the ancestor-block map.
    """
    upd = jnp.asarray(_update_map(structure))
    _, _, diag_pad, _ = _padded_indices(structure)
    diag_pad = jnp.asarray(diag_pad, buf.dtype)
    K = len(structure.blocks)

    def body(bc, inp):
        k, upd_k, pad_k = inp
        D, O = _read_blocks(bc, k, structure)
        D = D + jnp.diag(pad_k)
        L = jnp.linalg.cholesky(D)
        B = jax.scipy.linalg.solve_triangular(L, O, lower=True)
        U = -(B.T @ B)
        bc = bc.at[upd_k.ravel()].add(U.ravel())
        return bc, (L, B)

    _, (Ls, Bs) = jax.lax.scan(
        body, buf, (jnp.arange(K), upd, diag_pad)
    )
    fail = ~(jnp.all(jnp.isfinite(Ls)) & jnp.all(jnp.isfinite(Bs)))
    return (Ls, Bs), fail


def solve_llt(fac, structure: CompressedSupernodalStructure, b):
    """Forward/backward block substitution (reference
    ApplyBlockInverseInPlace / ...OfTransposeInPlace,
    block_triangular_operations.cc:114-182)."""
    Ls, Bs = fac
    s_idx, p_idx, _, n_ext = _padded_indices(structure)
    s_idx = jnp.asarray(s_idx)
    p_idx = jnp.asarray(p_idx)
    z = jnp.zeros((n_ext,), b.dtype).at[: structure.n].set(b)

    def fwd(zc, x):
        s, p, L, B = x
        zs = jax.scipy.linalg.solve_triangular(L, zc[s], lower=True)
        zc = zc.at[s].set(zs)
        zc = zc.at[p].add(-(B.T @ zs))
        return zc, None

    z, _ = jax.lax.scan(fwd, z, (s_idx, p_idx, Ls, Bs))

    def bwd(zc, x):
        s, p, L, B = x
        rhs = zc[s] - B @ zc[p]
        zc = zc.at[s].set(
            jax.scipy.linalg.solve_triangular(L.T, rhs, lower=False)
        )
        return zc, None

    z, _ = jax.lax.scan(bwd, z, (s_idx, p_idx, Ls, Bs), reverse=True)
    return z[: structure.n]


def _ldlt_clamped_block(D):
    """Fixed-order clamped LDLT of one padded block (RLDLT.h:381-393)."""
    k = D.shape[0]
    idx = jnp.arange(k)

    def body(j, M):
        d = M[j, j]
        d = jnp.where(
            jnp.abs(d) < LDLT_PIVOT_CLAMP,
            jnp.where(d >= 0, LDLT_PIVOT_CLAMP, -LDLT_PIVOT_CLAMP),
            d,
        )
        col = M[:, j]
        below = idx > j
        l_col = jnp.where(below, col / d, 0.0)
        M = M - d * jnp.outer(l_col, l_col)
        M = jnp.where(below[:, None] & (idx[None, :] == j), l_col[:, None], M)
        M = M.at[j, j].set(d)
        return M

    M = jax.lax.fori_loop(0, k, body, D)
    L = jnp.tril(M, -1) + jnp.eye(k, dtype=D.dtype)
    return L, jnp.diagonal(M)


def factor_ldlt(buf, structure: CompressedSupernodalStructure):
    """Supernodal clamped LDLT on compressed storage (reference
    BlockLDLTInPlace, block_triangular_operations.cc:315-349)."""
    upd = jnp.asarray(_update_map(structure))
    _, _, diag_pad, _ = _padded_indices(structure)
    diag_pad = jnp.asarray(diag_pad, buf.dtype)
    K = len(structure.blocks)

    def body(bc, inp):
        k, upd_k, pad_k = inp
        D, O = _read_blocks(bc, k, structure)
        D = D + jnp.diag(pad_k)
        Lu, d = _ldlt_clamped_block(D)
        tmp = jax.scipy.linalg.solve_triangular(
            Lu, O, lower=True, unit_diagonal=True
        ).T  # = (Lu^{-1} O)^T = O^T Lu^{-T}
        C = tmp / d[None, :]
        U = -(C * d[None, :]) @ C.T
        bc = bc.at[upd_k.ravel()].add(U.ravel())
        return bc, (Lu, d, C)

    _, (Ls, ds, Cs) = jax.lax.scan(
        body, buf, (jnp.arange(K), upd, diag_pad)
    )
    fail = ~(
        jnp.all(jnp.isfinite(Ls))
        & jnp.all(jnp.isfinite(ds))
        & jnp.all(jnp.isfinite(Cs))
    )
    return (Ls, ds, Cs), fail


def solve_ldlt(fac, structure: CompressedSupernodalStructure, b):
    Ls, ds, Cs = fac
    s_idx, p_idx, _, n_ext = _padded_indices(structure)
    s_idx = jnp.asarray(s_idx)
    p_idx = jnp.asarray(p_idx)
    z = jnp.zeros((n_ext,), b.dtype).at[: structure.n].set(b)

    def fwd(zc, x):
        s, p, Lu, C = x
        zs = jax.scipy.linalg.solve_triangular(
            Lu, zc[s], lower=True, unit_diagonal=True
        )
        zc = zc.at[s].set(zs)
        zc = zc.at[p].add(-(C @ zs))
        return zc, None

    z, _ = jax.lax.scan(fwd, z, (s_idx, p_idx, Ls, Cs))

    def dscale(zc, x):
        s, d = x
        return zc.at[s].set(zc[s] / d), None

    z, _ = jax.lax.scan(dscale, z, (s_idx, ds))

    def bwd(zc, x):
        s, p, Lu, C = x
        rhs = zc[s] - C.T @ zc[p]
        zc = zc.at[s].set(
            jax.scipy.linalg.solve_triangular(
                Lu.T, rhs, lower=False, unit_diagonal=True
            )
        )
        return zc, None

    z, _ = jax.lax.scan(bwd, z, (s_idx, p_idx, Ls, Cs), reverse=True)
    return z[: structure.n]


# ---------------------------------------------------------------------------
# Matvec (for iterative refinement) and densify (tests / QR fallback)
# ---------------------------------------------------------------------------


def matvec(buf, structure: CompressedSupernodalStructure, x):
    """K @ x from compressed storage (used by the refinement loop,
    reference kkt_solver.cc:248-261).  D blocks are full-symmetric; O
    blocks represent both orientations of their pairs."""
    s_idx, p_idx, _, n_ext = _padded_indices(structure)
    s_idx = jnp.asarray(s_idx)
    p_idx = jnp.asarray(p_idx)
    K = len(structure.blocks)
    xe = jnp.zeros((n_ext,), x.dtype).at[: structure.n].set(x)
    ye = jnp.zeros((n_ext,), x.dtype)

    def body(yc, inp):
        k, s, p = inp
        D, O = _read_blocks(buf, k, structure)
        xs = xe[s]
        xp = xe[p]
        yc = yc.at[s].add(D @ xs + O @ xp)
        yc = yc.at[p].add(O.T @ xs)
        return yc, None

    ye, _ = jax.lax.scan(body, ye, (jnp.arange(K), s_idx, p_idx))
    return ye[: structure.n]


def compress_dense(G, structure: CompressedSupernodalStructure):
    """Pack a dense clique-patterned matrix into the compressed buffer
    (test oracle / standalone-solver entry).  Only pattern entries are
    read: for each clique, the (supernode u separator) x supernode column
    block."""
    buf = empty_buffer(structure, G.dtype)
    for s, p in structure.blocks:
        rows = tuple(s) + tuple(p)
        cols = tuple(s)
        ri = jnp.asarray(rows, jnp.int32)
        ci = jnp.asarray(cols, jnp.int32)
        buf = scatter_contribution(
            buf, structure, rows, cols, G[ri[:, None], ci[None, :]]
        )
    return buf.at[structure.dump].set(0.0)


def densify(buf, structure: CompressedSupernodalStructure):
    """Reconstruct the dense KKT matrix (test oracle; reference
    KKTMatrix(), kkt_solver.cc:265-269)."""
    n = structure.n
    cols = jax.vmap(
        lambda e: matvec(buf, structure, e)
    )(jnp.eye(n, dtype=buf.dtype))
    return cols.T
