"""Distributed supernodal factorization: clique subtrees sharded over chips.

The reference factors the whole clique tree on one core
(BlockCholeskyInPlace, block_triangular_operations.cc:184-219).  On a
device mesh the clique tree is instead *partitioned*:

- the tree is cut into a small upward-closed **root region** and the forest
  of subtrees hanging below it;
- subtrees are bin-packed onto the ``tp`` mesh axis by estimated
  factorization work; each device eliminates its local cliques
  independently (same padded-scan elimination as scan.py);
- the Schur-complement contributions of every subtree land on the root
  separator set R (upward-closedness + the running-intersection property
  guarantee subtree locality: a variable shared by two subtrees is owned by
  a root-region supernode, so cross-subtree coupling flows ONLY through R);
- one ``psum`` combines the R-block contributions, after which the
  (small) root system is factored replicated on every device;
- solves mirror this: local forward substitution, psum of the R residual
  contributions, replicated root solve, local backward substitution, and a
  final psum assembles the owner-masked solution.

This is the "per-subtree factorization, separator reductions across
devices" design of SURVEY.md §5.7/§7 phase 6c.  Communication per
factor+solve: one (r, r) psum and two length-n psums, r = |R|.

Pivot semantics for the LDLT variant match the reference RLDLT clamp
(RLDLT.h:381-393) as in scan.py.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .ordering import pick_clique_order
from .scan import ScanSupernodalStructure, _ldlt_clamped_block

Block = Tuple[Tuple[int, ...], Tuple[int, ...]]


class DistributedSupernodalStructure(NamedTuple):
    """Static, hashable partitioned elimination structure.

    ``local_blocks[d]`` is device d's (supernode, separator) sequence in
    elimination order (global variable numbering); ``root_blocks`` is the
    root region's sequence; ``r_vars`` the sorted root separator set R.
    """

    local_blocks: Tuple[Tuple[Block, ...], ...]
    root_blocks: Tuple[Block, ...]
    r_vars: Tuple[int, ...]
    n: int
    n_devices: int

    @staticmethod
    def from_cliques(cliques: Sequence[Sequence[int]], n: int,
                     n_devices: int, valid_leaf=None, root: int = -1):
        co = pick_clique_order(cliques, valid_leaf=valid_leaf, root=root)
        pos = {e: i for i, e in enumerate(co.order)}

        def work(e):
            s, p = len(co.supernodes[e]), len(co.separators[e])
            return s * (s + p) ** 2

        # Root region: start at the tree roots, then peel the top clique of
        # the heaviest remaining component until there is enough parallelism.
        # Upward-closed by construction (a peeled top's parent was already
        # in the region).
        root_set = {e for e in co.order if co.parent[e] == e}

        def components():
            # Group non-root cliques by their highest ancestor outside the
            # root region (parents precede children in -pos order).
            comp = {}
            top_of = {}
            for e in sorted(co.order, key=lambda e: -pos[e]):  # parents first
                if e in root_set:
                    continue
                p = co.parent[e]
                top_of[e] = e if p in root_set else top_of[p]
            for e, t in top_of.items():
                comp.setdefault(t, []).append(e)
            return comp

        total = sum(work(e) for e in co.order) or 1
        for _ in range(len(co.order)):
            comp = components()
            if not comp:
                break
            heaviest = max(
                comp.values(), key=lambda es: sum(work(e) for e in es)
            )
            w_heaviest = sum(work(e) for e in heaviest)
            if len(comp) >= n_devices and w_heaviest <= total / n_devices:
                break
            if len(heaviest) <= 1 and len(comp) >= n_devices:
                break
            # peel the top clique (max elimination position) of the
            # heaviest component into the root region
            top = max(heaviest, key=lambda e: pos[e])
            root_set.add(top)

        comp = components()
        # LPT bin-packing of components onto devices.
        bins = [[] for _ in range(n_devices)]
        bin_work = [0] * n_devices
        for es in sorted(
            comp.values(), key=lambda es: -sum(work(e) for e in es)
        ):
            d = int(np.argmin(bin_work))
            bins[d].extend(es)
            bin_work[d] += sum(work(e) for e in es)

        def blocks_of(es):
            out = []
            for e in sorted(es, key=lambda e: pos[e]):
                s = tuple(co.supernodes[e])
                if s:
                    out.append((s, tuple(co.separators[e])))
            return tuple(out)

        local_blocks = tuple(blocks_of(es) for es in bins)
        root_blocks = list(blocks_of(root_set))
        covered = {
            v
            for blks in local_blocks + (tuple(root_blocks),)
            for s, _ in blks
            for v in s
        }
        rest = tuple(v for v in range(n) if v not in covered)
        if rest:
            root_blocks.append((rest, ()))
        root_blocks = tuple(root_blocks)
        r_vars = tuple(sorted({v for s, _ in root_blocks for v in s}))
        return DistributedSupernodalStructure(
            local_blocks=local_blocks,
            root_blocks=root_blocks,
            r_vars=r_vars,
            n=n,
            n_devices=n_devices,
        )

    # -- derived padded arrays (computed at trace time, cached by jit) -----

    def padded_arrays(self):
        """Stacked per-device local index arrays + root structure.

        Returns (s_all[D,K,smax], p_all[D,K,pmax], own[D,n] bool,
        r_idx[r], root_struct (R-local ScanSupernodalStructure), n_ext).
        Padding uses disjoint dummy identity slots as in scan.py.
        """
        D = self.n_devices
        K = max((len(b) for b in self.local_blocks), default=0)
        smax = max(
            (len(s) for b in self.local_blocks for s, _ in b), default=1
        )
        pmax = max(
            (len(p) for b in self.local_blocks for _, p in b), default=0
        )
        K, smax, pmax_w = max(K, 1), max(smax, 1), max(pmax, 1)
        n = self.n
        s_all = np.zeros((D, K, smax), np.int32)
        p_all = np.zeros((D, K, pmax_w), np.int32)
        own = np.zeros((D, n), bool)
        for d, blks in enumerate(self.local_blocks):
            for k in range(K):
                if k < len(blks):
                    s, p = blks[k]
                else:
                    s, p = (), ()
                s_all[d, k, : len(s)] = s
                s_all[d, k, len(s):] = n + np.arange(smax - len(s))
                p_all[d, k, : len(p)] = p
                p_all[d, k, len(p):] = n + smax + np.arange(pmax_w - len(p))
                own[d, list(s)] = True
        r_idx = np.asarray(self.r_vars, np.int32)
        rmap = {v: i for i, v in enumerate(self.r_vars)}
        root_local = tuple(
            (tuple(rmap[v] for v in s), tuple(rmap[v] for v in p))
            for s, p in self.root_blocks
        )
        root_struct = ScanSupernodalStructure(
            blocks=root_local, n=len(self.r_vars)
        )
        return s_all, p_all, own, r_idx, root_struct, n + smax + pmax_w


def _local_indices(ds: DistributedSupernodalStructure, axis_name: str):
    s_all, p_all, own, r_idx, root_struct, n_ext = ds.padded_arrays()
    d = jax.lax.axis_index(axis_name)
    s_idx = jnp.asarray(s_all)[d]
    p_idx = jnp.asarray(p_all)[d]
    own_d = jnp.asarray(own)[d]
    return s_idx, p_idx, own_d, jnp.asarray(r_idx), root_struct, n_ext


def _extend(G, n, n_ext):
    Gext = jnp.zeros((n_ext, n_ext), G.dtype).at[:n, :n].set(G)
    r = jnp.arange(n, n_ext)
    return Gext.at[r, r].set(1.0)


def factor_llt(G, ds: DistributedSupernodalStructure, axis_name: str):
    """Subtree-local block Cholesky + psum'd root Schur complement.

    Must run inside shard_map over ``axis_name`` with G replicated (each
    device holds the full assembled KKT matrix, e.g. after the cone-sharded
    assembly psum)."""
    from . import scan as sc

    s_idx, p_idx, own_d, r_idx, root_struct, n_ext = _local_indices(
        ds, axis_name
    )
    Gext = _extend(G, ds.n, n_ext)

    def body(Gc, idx):
        s, p = idx
        D = Gc[s[:, None], s[None, :]]
        L = jnp.linalg.cholesky(D)
        B = jax.scipy.linalg.solve_triangular(
            L, Gc[s[:, None], p[None, :]], lower=True
        )
        Gc = Gc.at[p[:, None], p[None, :]].add(-(B.T @ B))
        return Gc, (L, B)

    Gc, (Ls, Bs) = jax.lax.scan(body, Gext, (s_idx, p_idx))
    fail_local = ~(jnp.all(jnp.isfinite(Ls)) & jnp.all(jnp.isfinite(Bs)))

    RR = (r_idx[:, None], r_idx[None, :])
    delta = Gc[RR] - Gext[RR]
    S = Gext[RR] + jax.lax.psum(delta, axis_name)
    root_fac, fail_root = sc.factor_llt(S, root_struct)

    fail = (
        jax.lax.psum(fail_local.astype(jnp.int32), axis_name) > 0
    ) | fail_root
    return (Ls, Bs, root_fac), fail


def solve_llt(fac, ds: DistributedSupernodalStructure, b, axis_name: str):
    from . import scan as sc

    Ls, Bs, root_fac = fac
    s_idx, p_idx, own_d, r_idx, root_struct, n_ext = _local_indices(
        ds, axis_name
    )
    z = jnp.zeros((n_ext,), b.dtype).at[: ds.n].set(b)

    def fwd(zc, x):
        s, p, L, B = x
        zs = jax.scipy.linalg.solve_triangular(L, zc[s], lower=True)
        zc = zc.at[s].set(zs)
        zc = zc.at[p].add(-(B.T @ zs))
        return zc, None

    z, _ = jax.lax.scan(fwd, z, (s_idx, p_idx, Ls, Bs))

    # Combine the R-residual contributions and solve the root system.
    delta_r = z[r_idx] - b[r_idx]
    zR = b[r_idx] + jax.lax.psum(delta_r, axis_name)
    xR = sc.solve_llt(root_fac, root_struct, zR)
    z = z.at[r_idx].set(xR)

    def bwd(zc, x):
        s, p, L, B = x
        rhs = zc[s] - B @ zc[p]
        zc = zc.at[s].set(
            jax.scipy.linalg.solve_triangular(L.T, rhs, lower=False)
        )
        return zc, None

    z, _ = jax.lax.scan(bwd, z, (s_idx, p_idx, Ls, Bs), reverse=True)

    x_local = jnp.where(own_d, z[: ds.n], 0.0)
    x = jax.lax.psum(x_local, axis_name)
    return x.at[r_idx].set(xR)


def factor_ldlt(G, ds: DistributedSupernodalStructure, axis_name: str):
    """Subtree-local clamped LDLT + psum'd root Schur complement
    (indefinite KKT systems with equality duals)."""
    from . import scan as sc

    s_idx, p_idx, own_d, r_idx, root_struct, n_ext = _local_indices(
        ds, axis_name
    )
    Gext = _extend(G, ds.n, n_ext)

    def body(Gc, idx):
        s, p = idx
        D = Gc[s[:, None], s[None, :]]
        Lu, d = _ldlt_clamped_block(D)
        Gps = Gc[p[:, None], s[None, :]]
        tmp = jax.scipy.linalg.solve_triangular(
            Lu, Gps.T, lower=True, unit_diagonal=True
        ).T
        C = tmp / d[None, :]
        Gc = Gc.at[p[:, None], p[None, :]].add(-(C * d[None, :]) @ C.T)
        return Gc, (Lu, d, C)

    Gc, (Ls, dsg, Cs) = jax.lax.scan(body, Gext, (s_idx, p_idx))
    fail_local = ~(
        jnp.all(jnp.isfinite(Ls))
        & jnp.all(jnp.isfinite(dsg))
        & jnp.all(jnp.isfinite(Cs))
    )

    RR = (r_idx[:, None], r_idx[None, :])
    delta = Gc[RR] - Gext[RR]
    S = Gext[RR] + jax.lax.psum(delta, axis_name)
    root_fac, fail_root = sc.factor_ldlt(S, root_struct)

    fail = (
        jax.lax.psum(fail_local.astype(jnp.int32), axis_name) > 0
    ) | fail_root
    return (Ls, dsg, Cs, root_fac), fail


def solve_ldlt(fac, ds: DistributedSupernodalStructure, b, axis_name: str):
    from . import scan as sc

    Ls, dsg, Cs, root_fac = fac
    s_idx, p_idx, own_d, r_idx, root_struct, n_ext = _local_indices(
        ds, axis_name
    )
    z = jnp.zeros((n_ext,), b.dtype).at[: ds.n].set(b)

    def fwd(zc, x):
        s, p, Lu, C = x
        zs = jax.scipy.linalg.solve_triangular(
            Lu, zc[s], lower=True, unit_diagonal=True
        )
        zc = zc.at[s].set(zs)
        zc = zc.at[p].add(-(C @ zs))
        return zc, None

    z, _ = jax.lax.scan(fwd, z, (s_idx, p_idx, Ls, Cs))

    delta_r = z[r_idx] - b[r_idx]
    zR = b[r_idx] + jax.lax.psum(delta_r, axis_name)
    xR = sc.solve_ldlt(root_fac, root_struct, zR)
    z = z.at[r_idx].set(xR)

    def dscale(zc, x):
        s, d = x
        return zc.at[s].set(zc[s] / d), None

    z, _ = jax.lax.scan(dscale, z, (s_idx, dsg))

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

    x_local = jnp.where(own_d, z[: ds.n], 0.0)
    x = jax.lax.psum(x_local, axis_name)
    return x.at[r_idx].set(xR)
