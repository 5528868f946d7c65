"""Distributed supernodal factorization on block-compressed storage.

Composes the two round-2 designs that VERDICT r2 #5 found disjoint:

* supernodal/compressed.py — the factor lives in ONE flat buffer of padded
  per-clique blocks (O(sum of block sizes), never a dense (N, N) matrix),
  the equivalent of the reference's contiguous per-clique storage with
  pointer-scattered separator updates
  (/root/reference/conex/triangular_matrix_workspace.cc:123-159).
* supernodal/distributed.py — the clique tree is cut into an upward-closed
  root region plus per-device subtrees; devices eliminate their subtrees
  independently and couple only through the root separator set
  (SURVEY.md §5.7/§7 phase 6c).

The global elimination order is laid out subtree-contiguous (device 0's
cliques, device 1's, ..., root cliques last — a valid elimination order
because the running-intersection property routes every local clique's
separator updates to later cliques of the SAME subtree or to the root
region).  Assembly scatters cone contributions into the global compressed
buffer through the host-precomputed flat maps and one psum combines them
(O(buffer) traffic, not O(N^2)).

Factorization carries only a LOCAL buffer per device: the device's own
clique blocks plus a copy of the root-region blocks, gathered from the
global buffer in one shot.  (Carrying the full global buffer through the
elimination scan makes the per-step carry traffic O(global) and destroys
weak scaling — each scan step rewrites the carry.)  Each device scans its
own cliques with update targets remapped into local coordinates, one psum
of the root-region delta combines the cross-device Schur contributions,
and the (small) root system factors replicated by the same scan in
root-local coordinates.  Solves mirror it on O(n) vectors: local forward
substitution, one root-residual psum, replicated root solve, local
backward substitution, owner-masked psum.

Pivot semantics for LDLT match the reference RLDLT clamp (RLDLT.h:381-393).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .compressed import (
    CompressedSupernodalStructure,
    _padded_indices,
    _update_map,
    _ldlt_clamped_block,
)
from .distributed import DistributedSupernodalStructure


class DistributedCompressedStructure(NamedTuple):
    """Static, hashable partitioned compressed elimination structure.

    ``base`` is the global compressed structure in subtree-contiguous
    elimination order; ``device_cliques[d]`` are device d's global clique
    indices (its subtrees, in elimination order); ``root_cliques`` are the
    root region's clique indices (last in the global order).
    """

    base: CompressedSupernodalStructure
    device_cliques: Tuple[Tuple[int, ...], ...]
    root_cliques: Tuple[int, ...]
    n_devices: int

    @property
    def n(self) -> int:
        return self.base.n

    @staticmethod
    def from_cliques(cliques: Sequence[Sequence[int]], n: int,
                     n_devices: int, valid_leaf=None, root: int = -1):
        ds = DistributedSupernodalStructure.from_cliques(
            cliques, n, n_devices, valid_leaf=valid_leaf, root=root
        )
        blocks = []
        device_cliques = []
        for blks in ds.local_blocks:
            device_cliques.append(
                tuple(range(len(blocks), len(blocks) + len(blks)))
            )
            blocks.extend(blks)
        root_ids = tuple(
            range(len(blocks), len(blocks) + len(ds.root_blocks))
        )
        blocks.extend(ds.root_blocks)
        return DistributedCompressedStructure(
            base=CompressedSupernodalStructure(blocks=tuple(blocks), n=n),
            device_cliques=tuple(device_cliques),
            root_cliques=root_ids,
            n_devices=n_devices,
        )


@functools.lru_cache(maxsize=None)
def _device_arrays(dcs: DistributedCompressedStructure):
    """Host-precomputed local-coordinate maps.

    Local buffer layout per device (identical shape on every device):
        [ Dloc: Kd*smax^2 | Oloc: Kd*smax*pmax
        | Droot: Kr*smax^2 | Oroot: Kr*smax*pmax | dump ]
    Root-only buffer layout (for the replicated root scan):
        [ Droot | Oroot | dump ]
    """
    struct = dcs.base
    upd = np.asarray(_update_map(struct))
    s_idx, p_idx, diag_pad, n_ext = _padded_indices(struct)
    smax, pmax = struct.smax, max(struct.pmax, 1)
    dsz, osz = smax * smax, smax * pmax
    D = dcs.n_devices
    Kd = max((len(c) for c in dcs.device_cliques), default=0) or 1
    Kr = len(dcs.root_cliques)

    o_loc_off = Kd * dsz
    d_root_off = Kd * (dsz + osz)
    root_len = Kr * (dsz + osz)
    dump_local = d_root_off + root_len
    dump_root = root_len

    root_index = {k: i for i, k in enumerate(dcs.root_cliques)}

    def decode(t):
        """Global flat position -> (clique, region, offset) or None."""
        if t == struct.dump:
            return None
        if t < struct.d_size:
            return t // dsz, "D", t % dsz
        t2 = t - struct.d_size
        return t2 // osz, "O", t2 % osz

    def root_local(t):
        dec = decode(t)
        if dec is None:
            return dump_root
        k2, reg, off = dec
        i2 = root_index.get(k2)
        if i2 is None:
            return dump_root
        return i2 * dsz + off if reg == "D" else Kr * dsz + i2 * osz + off

    ids = np.zeros((D, Kd), np.int32)
    pad = np.ones((D, Kd), bool)
    gather = np.full((D, d_root_off), struct.dump, np.int64)
    upd_loc = np.full((D, Kd, pmax, pmax), dump_local, np.int64)
    s_dev = np.zeros((D, Kd, smax), np.int32)
    p_dev = np.zeros((D, Kd, pmax), np.int32)
    dpad_dev = np.zeros((D, Kd, smax), diag_pad.dtype)
    own = np.zeros((D, struct.n), bool)
    for d, cl in enumerate(dcs.device_cliques):
        loc_index = {k: j for j, k in enumerate(cl)}
        for j, k in enumerate(cl):
            ids[d, j] = k
            pad[d, j] = False
            gather[d, j * dsz:(j + 1) * dsz] = k * dsz + np.arange(dsz)
            gather[d, o_loc_off + j * osz: o_loc_off + (j + 1) * osz] = (
                struct.d_size + k * osz + np.arange(osz)
            )
            s_dev[d, j] = s_idx[k]
            p_dev[d, j] = p_idx[k]
            dpad_dev[d, j] = diag_pad[k]
            s, _ = struct.blocks[k]
            own[d, list(s)] = True
            for a in range(pmax):
                for bb in range(pmax):
                    t = upd[k, a, bb]
                    dec = decode(t)
                    if dec is None:
                        continue
                    k2, reg, off = dec
                    j2 = loc_index.get(k2)
                    if j2 is not None:
                        upd_loc[d, j, a, bb] = (
                            j2 * dsz + off
                            if reg == "D"
                            else o_loc_off + j2 * osz + off
                        )
                    elif k2 in root_index:
                        upd_loc[d, j, a, bb] = d_root_off + root_local(t)
                    # else: outside device+root => dump (impossible by RIP)
        # padded steps' s/p indices alias real slots harmlessly (L=I, B=0);
        # point them at clique 0 of the structure.
        for j in range(len(cl), Kd):
            s_dev[d, j] = s_idx[0]
            p_dev[d, j] = p_idx[0]

    rids = np.asarray(dcs.root_cliques, np.int32)
    r_upd_loc = np.full((max(Kr, 1), pmax, pmax), dump_root, np.int64)
    for i, k in enumerate(dcs.root_cliques):
        for a in range(pmax):
            for bb in range(pmax):
                r_upd_loc[i, a, bb] = root_local(upd[k, a, bb])
    r_vars = np.asarray(
        sorted({v for k in dcs.root_cliques for v in struct.blocks[k][0]}),
        np.int32,
    )
    # Root cliques are contiguous at the END of the global order: their D
    # and O blocks are two contiguous tail slices of the global buffer.
    r0 = int(rids.min()) if Kr else len(struct.blocks)
    root_slices = (
        (r0 * dsz, struct.d_size),
        (struct.d_size + r0 * osz, struct.d_size + struct.o_size),
    )
    geom = dict(
        smax=smax, pmax=pmax, dsz=dsz, osz=osz, Kd=Kd, Kr=Kr,
        o_loc_off=o_loc_off, d_root_off=d_root_off, root_len=root_len,
        dump_local=dump_local, dump_root=dump_root, n_ext=n_ext,
        root_slices=root_slices,
    )
    return dict(
        ids=ids, pad=pad, gather=gather, upd_loc=upd_loc, s_dev=s_dev,
        p_dev=p_dev, dpad_dev=dpad_dev, own=own, rids=rids,
        r_upd_loc=r_upd_loc, r_s=s_idx[rids], r_p=p_idx[rids],
        r_dpad=diag_pad[rids], r_vars=r_vars, geom=geom,
    )


def _my(dcs, axis_name):
    a = _device_arrays(dcs)
    d = jax.lax.axis_index(axis_name)
    return dict(
        pad=jnp.asarray(a["pad"])[d],
        gather=jnp.asarray(a["gather"])[d],
        upd=jnp.asarray(a["upd_loc"])[d],
        s=jnp.asarray(a["s_dev"])[d],
        p=jnp.asarray(a["p_dev"])[d],
        dpad=jnp.asarray(a["dpad_dev"])[d],
        own=jnp.asarray(a["own"])[d],
        r_upd=jnp.asarray(a["r_upd_loc"]),
        r_s=jnp.asarray(a["r_s"]),
        r_p=jnp.asarray(a["r_p"]),
        r_dpad=jnp.asarray(a["r_dpad"]),
        r_vars=jnp.asarray(a["r_vars"]),
        geom=a["geom"],
    )


def _local_buffer(buf, m):
    """Gather [Dloc | Oloc | Droot | Oroot | dump] from the global buffer."""
    g = m["geom"]
    (lo1, hi1), (lo2, hi2) = g["root_slices"]
    return jnp.concatenate(
        [buf[m["gather"]], buf[lo1:hi1], buf[lo2:hi2],
         jnp.zeros((1,), buf.dtype)]
    )


def _combined_root(buf, lc, m, axis_name):
    """Root-only buffer: original root blocks + psum of local deltas."""
    g = m["geom"]
    (lo1, hi1), (lo2, hi2) = g["root_slices"]
    root_orig = jnp.concatenate([buf[lo1:hi1], buf[lo2:hi2]])
    delta = lc[g["d_root_off"]: g["dump_local"]] - root_orig
    combined = root_orig + jax.lax.psum(delta, axis_name)
    return jnp.concatenate([combined, jnp.zeros((1,), buf.dtype)])


def _read_local(lc, j, g):
    D = jax.lax.dynamic_slice(lc, (j * g["dsz"],), (g["dsz"],))
    O = jax.lax.dynamic_slice(
        lc, (g["o_loc_off"] + j * g["osz"],), (g["osz"],)
    )
    return D.reshape(g["smax"], g["smax"]), O.reshape(g["smax"], g["pmax"])


def _read_root(rb, i, g):
    D = jax.lax.dynamic_slice(rb, (i * g["dsz"],), (g["dsz"],))
    O = jax.lax.dynamic_slice(
        rb, (g["Kr"] * g["dsz"] + i * g["osz"],), (g["osz"],)
    )
    return D.reshape(g["smax"], g["smax"]), O.reshape(g["smax"], g["pmax"])


# ---------------------------------------------------------------------------
# LLT
# ---------------------------------------------------------------------------


def factor_llt(buf, dcs: DistributedCompressedStructure, axis_name: str):
    """Subtree-parallel block Cholesky on compressed storage.

    ``buf`` is the psum-combined assembled global compressed buffer,
    replicated on every device; must run inside shard_map over
    ``axis_name``.  Per-device work and carry are O(local blocks + root);
    communication is one O(root) psum.

    reference: BlockCholeskyInPlace semantics
    (block_triangular_operations.cc:184-219) with the separator pointer
    scatter becoming the remapped local-coordinate index add."""
    m = _my(dcs, axis_name)
    g = m["geom"]

    def body(lc, inp):
        j, is_pad, upd_j, dpad_j = inp
        D, O = _read_local(lc, j, g)
        D = D + jnp.diag(dpad_j)
        D = jnp.where(is_pad, jnp.eye(g["smax"], dtype=lc.dtype), D)
        L = jnp.linalg.cholesky(D)
        B = jax.scipy.linalg.solve_triangular(L, O, lower=True)
        B = jnp.where(is_pad, 0.0, B)
        lc = lc.at[upd_j.ravel()].add(-(B.T @ B).ravel())
        return lc, (L, B)

    lc0 = _local_buffer(buf, m)
    lc, (Ls, Bs) = jax.lax.scan(
        body, lc0,
        (jnp.arange(g["Kd"]), m["pad"], m["upd"], m["dpad"]),
    )
    fail_local = ~(jnp.all(jnp.isfinite(Ls)) & jnp.all(jnp.isfinite(Bs)))

    rb = _combined_root(buf, lc, m, axis_name)

    def rbody(rbc, inp):
        i, upd_i, dpad_i = inp
        D, O = _read_root(rbc, i, g)
        D = D + jnp.diag(dpad_i)
        L = jnp.linalg.cholesky(D)
        B = jax.scipy.linalg.solve_triangular(L, O, lower=True)
        rbc = rbc.at[upd_i.ravel()].add(-(B.T @ B).ravel())
        return rbc, (L, B)

    _, (Lr, Br) = jax.lax.scan(
        rbody, rb, (jnp.arange(g["Kr"]), m["r_upd"], m["r_dpad"])
    )
    fail_root = ~(jnp.all(jnp.isfinite(Lr)) & jnp.all(jnp.isfinite(Br)))
    fail = (
        jax.lax.psum(fail_local.astype(jnp.int32), axis_name) > 0
    ) | fail_root
    return (Ls, Bs, Lr, Br), fail


def solve_llt(fac, dcs: DistributedCompressedStructure, b, axis_name: str):
    Ls, Bs, Lr, Br = fac
    m = _my(dcs, axis_name)
    z = jnp.zeros((m["geom"]["n_ext"],), b.dtype).at[: dcs.n].set(b)
    r = m["r_vars"]

    def fwd(zc, x):
        s, p, L, B = x
        zs = jax.scipy.linalg.solve_triangular(L, zc[s], lower=True)
        zc = zc.at[s].set(zs)
        zc = zc.at[p].add(-(B.T @ zs))
        return zc, None

    z, _ = jax.lax.scan(fwd, z, (m["s"], m["p"], Ls, Bs))

    # Root residual: local forward substitution only ADDS to root
    # positions, so the deltas are additive contributions.
    zr = b[r] + jax.lax.psum(z[r] - b[r], axis_name)
    z = z.at[r].set(zr)

    z, _ = jax.lax.scan(fwd, z, (m["r_s"], m["r_p"], Lr, Br))

    def bwd(zc, x):
        s, p, L, B = x
        rhs = zc[s] - B @ zc[p]
        zc = zc.at[s].set(
            jax.scipy.linalg.solve_triangular(L.T, rhs, lower=False)
        )
        return zc, None

    z, _ = jax.lax.scan(bwd, z, (m["r_s"], m["r_p"], Lr, Br), reverse=True)
    z, _ = jax.lax.scan(bwd, z, (m["s"], m["p"], Ls, Bs), reverse=True)

    x_local = jnp.where(m["own"], z[: dcs.n], 0.0)
    x = jax.lax.psum(x_local, axis_name)
    return x.at[r].set(z[r])


# ---------------------------------------------------------------------------
# LDLT (clamped, fixed order)
# ---------------------------------------------------------------------------


def factor_ldlt(buf, dcs: DistributedCompressedStructure, axis_name: str):
    """Subtree-parallel clamped LDLT (indefinite KKT systems with equality
    duals; RLDLT 1e-9 pivot clamp semantics)."""
    m = _my(dcs, axis_name)
    g = m["geom"]

    def body(lc, inp):
        j, is_pad, upd_j, dpad_j = inp
        D, O = _read_local(lc, j, g)
        D = D + jnp.diag(dpad_j)
        D = jnp.where(is_pad, jnp.eye(g["smax"], dtype=lc.dtype), D)
        Lu, d = _ldlt_clamped_block(D)
        tmp = jax.scipy.linalg.solve_triangular(
            Lu, O, lower=True, unit_diagonal=True
        ).T
        C = tmp / d[None, :]
        C = jnp.where(is_pad, 0.0, C)
        lc = lc.at[upd_j.ravel()].add((-(C * d[None, :]) @ C.T).ravel())
        return lc, (Lu, d, C)

    lc0 = _local_buffer(buf, m)
    lc, (Ls, ds, Cs) = jax.lax.scan(
        body, lc0,
        (jnp.arange(g["Kd"]), m["pad"], m["upd"], m["dpad"]),
    )
    fail_local = ~(
        jnp.all(jnp.isfinite(Ls))
        & jnp.all(jnp.isfinite(ds))
        & jnp.all(jnp.isfinite(Cs))
    )

    rb = _combined_root(buf, lc, m, axis_name)

    def rbody(rbc, inp):
        i, upd_i, dpad_i = inp
        D, O = _read_root(rbc, i, g)
        D = D + jnp.diag(dpad_i)
        Lu, d = _ldlt_clamped_block(D)
        tmp = jax.scipy.linalg.solve_triangular(
            Lu, O, lower=True, unit_diagonal=True
        ).T
        C = tmp / d[None, :]
        rbc = rbc.at[upd_i.ravel()].add((-(C * d[None, :]) @ C.T).ravel())
        return rbc, (Lu, d, C)

    _, (Lrr, drr, Crr) = jax.lax.scan(
        rbody, rb, (jnp.arange(g["Kr"]), m["r_upd"], m["r_dpad"])
    )
    fail_root = ~(
        jnp.all(jnp.isfinite(Lrr))
        & jnp.all(jnp.isfinite(drr))
        & jnp.all(jnp.isfinite(Crr))
    )
    fail = (
        jax.lax.psum(fail_local.astype(jnp.int32), axis_name) > 0
    ) | fail_root
    return (Ls, ds, Cs, Lrr, drr, Crr), fail


def solve_ldlt(fac, dcs: DistributedCompressedStructure, b, axis_name: str):
    Ls, ds, Cs, Lrr, drr, Crr = fac
    m = _my(dcs, axis_name)
    z = jnp.zeros((m["geom"]["n_ext"],), b.dtype).at[: dcs.n].set(b)
    r = m["r_vars"]

    def fwd(zc, x):
        s, p, Lu, C = x
        zs = jax.scipy.linalg.solve_triangular(
            Lu, zc[s], lower=True, unit_diagonal=True
        )
        zc = zc.at[s].set(zs)
        zc = zc.at[p].add(-(C @ zs))
        return zc, None

    z, _ = jax.lax.scan(fwd, z, (m["s"], m["p"], Ls, Cs))
    zr = b[r] + jax.lax.psum(z[r] - b[r], axis_name)
    z = z.at[r].set(zr)
    z, _ = jax.lax.scan(fwd, z, (m["r_s"], m["r_p"], Lrr, Crr))

    def dscale(zc, x):
        s, d = x
        return zc.at[s].set(zc[s] / d), None

    z, _ = jax.lax.scan(dscale, z, (m["r_s"], drr))
    z, _ = jax.lax.scan(dscale, z, (m["s"], ds))

    def bwd(zc, x):
        s, p, Lu, C = x
        rhs = zc[s] - C.T @ zc[p]
        zc = zc.at[s].set(
            jax.scipy.linalg.solve_triangular(
                Lu.T, rhs, lower=False, unit_diagonal=True
            )
        )
        return zc, None

    z, _ = jax.lax.scan(bwd, z, (m["r_s"], m["r_p"], Lrr, Crr), reverse=True)
    z, _ = jax.lax.scan(bwd, z, (m["s"], m["p"], Ls, Cs), reverse=True)

    x_local = jnp.where(m["own"], z[: dcs.n], 0.0)
    x = jax.lax.psum(x_local, axis_name)
    return x.at[r].set(z[r])
