"""The geodesic interior-point iteration as one jitted XLA program.

Re-implements the reference solve loop (/root/reference/conex/cone_program.cc:
235-533) as a fixed-shape ``lax.while_loop``: all of the reference's
data-dependent branching (mu-update mode, initial/final centering state
machine, warmstart aborts, factorization-failure recovery) is carried as
scalar booleans in the loop state and applied with ``lax.cond``/``jnp.where``.
Per-constraint virtual dispatch becomes a static unrolled loop over cone
blocks (the block list is part of the pytree structure, so XLA sees a single
fused graph).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import KKT_SOLVER_LDLT, KKT_SOLVER_LLT, WARMSTART, SolverConfig
from ..algebra import mm
from ..cones.base import local_vars
from ..cones.equality import EqualityBlock
from . import kkt
from .mu import SlackAgg, mu_from_divergence


class LoopState(NamedTuple):
    i: jnp.ndarray
    ws: Tuple  # per-block cone iterates
    y: jnp.ndarray  # (N,) KKT solution of the last iteration
    k: jnp.ndarray  # inv_sqrt_mu
    k_max: jnp.ndarray  # dynamic inv_sqrt_mu_max (updated by rescaling)
    b_scaling: jnp.ndarray
    c_scaling: jnp.ndarray
    kkt_error: jnp.ndarray
    centering_steps: jnp.ndarray
    warmstart_aborted: jnp.ndarray
    by: jnp.ndarray
    cx: jnp.ndarray
    d_inf: jnp.ndarray
    done: jnp.ndarray
    fail: jnp.ndarray
    max_iters_reached: jnp.ndarray
    num_iter: jnp.ndarray
    stall_count: jnp.ndarray  # consecutive low-progress mu updates
    fc_latch: jnp.ndarray  # numerical-floor final-centering latch
    stats_k: jnp.ndarray  # (max_iterations,) sqrt_inv_mu per iteration
    stats_dinf: jnp.ndarray  # (max_iterations,) norm_inf_d per iteration
    stats_d2: jnp.ndarray  # (max_iterations,) ||d||_2
    stats_by: jnp.ndarray  # (max_iterations,) scaled objective b'y
    stats_cx: jnp.ndarray  # (max_iterations,) scaled dual objective c'x
    stats_err: jnp.ndarray  # (max_iterations,) kkt_error


class SolveResult(NamedTuple):
    y: jnp.ndarray  # (m,) primal variable (scaled back)
    solved: jnp.ndarray
    primal_infeasible: jnp.ndarray
    dual_infeasible: jnp.ndarray
    num_iterations: jnp.ndarray
    ws: Tuple  # final cone iterates (warmstart state / dual variables)
    y_kkt: jnp.ndarray  # (N,) raw final KKT solution (equality duals in tail)
    k: jnp.ndarray
    b_scaling: jnp.ndarray
    c_scaling: jnp.ndarray
    stats_k: jnp.ndarray
    stats_dinf: jnp.ndarray
    stats_d2: jnp.ndarray
    stats_by: jnp.ndarray
    stats_cx: jnp.ndarray
    stats_err: jnp.ndarray
    fail: jnp.ndarray
    mu_stalled: jnp.ndarray


# ---------------------------------------------------------------------------
# Schur-complement assembly
# ---------------------------------------------------------------------------


def _scatter_mat(G, vars_, Gi):
    v = Gi.shape[0]
    if vars_ is None:
        if G.shape[0] == v:
            return G + Gi
        return G.at[:v, :v].add(Gi)
    ix = jnp.array(vars_, dtype=jnp.int32)
    return G.at[ix[:, None], ix[None, :]].add(Gi)


def _scatter_vec(x, vars_, xi):
    v = xi.shape[0]
    if vars_ is None:
        if x.shape[0] == v:
            return x + xi
        return x.at[:v].add(xi)
    ix = jnp.array(vars_, dtype=jnp.int32)
    return x.at[ix].add(xi)


def assemble(blocks, eq_blocks, ws, n_kkt: int, m: int, dtype, axis_name=None,
             structure=None):
    """Assemble the KKT matrix and residuals from block contributions.

    reference: Assemble + AssembleSchurComplementResiduals
    (cone_program.cc:339-340, constraint_manager.h:107-124,
    equality_constraint.cc:13-28).  The global system is a sum of independent
    per-block contributions; with ``axis_name`` set (constraint-sharded SPMD
    via shard_map) the partial sums travel as a single psum — the additive
    structure called out in SURVEY.md §5.8.

    With a CompressedSupernodalStructure the matrix is returned as the flat
    block-compressed buffer (supernodal/compressed.py): each contribution
    scatters directly into the per-clique blocks through a host-precomputed
    index map — the compressed counterpart of SupernodalAssembler
    (supernodal_assembler.cc:72-141) — and the dense (N, N) matrix is never
    built.
    """
    compressed = None
    if structure is not None:
        from ..supernodal.compressed import (
            CompressedSupernodalStructure,
            empty_buffer,
            scatter_contribution,
        )
        from ..supernodal.dist_compressed import (
            DistributedCompressedStructure,
        )

        if isinstance(structure, CompressedSupernodalStructure):
            compressed = structure
        elif isinstance(structure, DistributedCompressedStructure):
            # Same compressed buffer layout; the psum below combines the
            # per-device cone contributions (O(buffer), never dense (N,N)).
            compressed = structure.base

    if compressed is not None:
        G = empty_buffer(compressed, dtype)
    else:
        G = jnp.zeros((n_kkt, n_kkt), dtype=dtype)
    AW = jnp.zeros((n_kkt,), dtype=dtype)
    AQc = jnp.zeros((n_kkt,), dtype=dtype)
    w_dot_c = jnp.zeros((), dtype=dtype)
    c_dot_Qc = jnp.zeros((), dtype=dtype)
    for blk, w in zip(blocks, ws):
        out = blk.schur(w)
        if compressed is not None:
            v = blk.vars_ if blk.vars_ is not None else tuple(
                range(out.G.shape[0])
            )
            G = scatter_contribution(G, compressed, v, v, out.G)
        else:
            G = _scatter_mat(G, blk.vars_, out.G)
        AW = _scatter_vec(AW, blk.vars_, out.AW)
        AQc = _scatter_vec(AQc, blk.vars_, out.AQc)
        w_dot_c = w_dot_c + out.w_dot_c
        c_dot_Qc = c_dot_Qc + out.c_dot_Qc
    for eq in eq_blocks:
        off = m + eq.dual_offset
        p, v = eq.A.shape
        if compressed is not None:
            rows = tuple(range(off, off + p))
            cols = eq.vars_ if eq.vars_ is not None else tuple(range(v))
            G = scatter_contribution(G, compressed, rows, cols, eq.A)
            G = scatter_contribution(G, compressed, cols, rows, eq.A.T)
        elif eq.vars_ is None:
            G = G.at[off:off + p, :v].add(eq.A)
            G = G.at[:v, off:off + p].add(eq.A.T)
        else:
            ix = jnp.array(eq.vars_, dtype=jnp.int32)
            rows = jnp.arange(off, off + p)
            G = G.at[rows[:, None], ix[None, :]].add(eq.A)
            G = G.at[ix[:, None], rows[None, :]].add(eq.A.T)
        AQc = AQc.at[off:off + p].add(eq.b)
    if compressed is not None:
        # The dump slot collects padding and mirrored-orientation writes;
        # it must not accumulate into anything downstream.
        G = G.at[compressed.dump].set(0.0)
    if axis_name is not None:
        G, AW, AQc, w_dot_c, c_dot_Qc = jax.lax.psum(
            (G, AW, AQc, w_dot_c, c_dot_Qc), axis_name
        )
    return G, AW, AQc, w_dot_c, c_dot_Qc


# ---------------------------------------------------------------------------
# Per-iteration cone sweeps
# ---------------------------------------------------------------------------


def _prepare_step_all(blocks, ws, y, c_weight, e_weight, axis_name=None):
    """reference: PrepareStep sweep, cone_program.h:69-90."""
    caches = []
    norminf = jnp.asarray(-1.0, dtype=y.dtype)
    normsq = jnp.zeros((), dtype=y.dtype)
    for blk, w in zip(blocks, ws):
        y_loc = local_vars(y, blk.vars_, blk.num_vars)
        cache, ninf, nsq = blk.prepare_step(w, y_loc, c_weight, e_weight)
        caches.append(cache)
        norminf = jnp.maximum(norminf, ninf)
        normsq = normsq + nsq
    if axis_name is not None:
        norminf = jax.lax.pmax(norminf, axis_name)
        normsq = jax.lax.psum(normsq, axis_name)
    return tuple(caches), norminf, normsq


def _take_step_all(blocks, ws, caches, step_size):
    """reference: TakeStep sweep, cone_program.h:92-97."""
    return tuple(
        blk.take_step(w, cache, step_size)
        for blk, w, cache in zip(blocks, ws, caches)
    )


def _slack_stats_all(blocks, ws, y, c_weight, dtype, axis_name=None):
    """reference: GetWeightedSlackEigenvalues agg, cone_program.cc:31-57.

    Initial lam bounds +/-30000 replicate the reference exactly
    (cone_program.cc:37-38).
    """
    agg = SlackAgg(
        lam_min=jnp.asarray(30000.0, dtype),
        lam_max=jnp.asarray(-30000.0, dtype),
        frob_sq=jnp.zeros((), dtype),
        trace=jnp.zeros((), dtype),
    )
    for blk, w in zip(blocks, ws):
        y_loc = local_vars(y, blk.vars_, blk.num_vars)
        s = blk.slack_stats(w, y_loc, c_weight)
        agg = SlackAgg(
            lam_min=jnp.minimum(agg.lam_min, s.lam_min),
            lam_max=jnp.maximum(agg.lam_max, s.lam_max),
            frob_sq=agg.frob_sq + s.frob_sq,
            trace=agg.trace + s.trace,
        )
    if axis_name is not None:
        agg = SlackAgg(
            lam_min=jax.lax.pmin(agg.lam_min, axis_name),
            lam_max=jax.lax.pmax(agg.lam_max, axis_name),
            frob_sq=jax.lax.psum(agg.frob_sq, axis_name),
            trace=jax.lax.psum(agg.trace, axis_name),
        )
    return agg


def _identity_all(blocks, dtype):
    return tuple(blk.identity_state(dtype) for blk in blocks)


# ---------------------------------------------------------------------------
# Mu selection
# ---------------------------------------------------------------------------


def _mu_line_search(
    blocks, ws, fac, config, AW, AQc_s, b_s_vec, c_scaling, dtype,
    axis_name=None, structure=None,
):
    """reference: ComputeMuFromLineSearch, cone_program.cc:118-160."""
    refine = config.iterative_refinement_iterations
    mode = config.kkt_solver
    y0 = kkt.solve(fac, -2.0 * AW, mode, refine, structure, axis_name)
    y1 = kkt.solve(fac, AQc_s + b_s_vec - 2.0 * AW, mode, refine, structure,
                   axis_name)
    lower = jnp.asarray(-jnp.inf, dtype)
    upper = jnp.asarray(jnp.inf, dtype)
    fail = jnp.asarray(False)
    for blk, w in zip(blocks, ws):
        if not getattr(blk, "supports_line_search", False):
            # reference constraint.h:24-28: unsupported => failure.
            fail = jnp.asarray(True)
            continue
        y0_loc = local_vars(y0, blk.vars_, blk.num_vars)
        y1_loc = local_vars(y1, blk.vars_, blk.num_vars)
        lo, up, f = blk.line_search(
            w, y0_loc, y1_loc, 0.0, c_scaling, config.dinf_upper_bound
        )
        lower = jnp.maximum(lower, lo)
        upper = jnp.minimum(upper, up)
        fail = fail | f
    if axis_name is not None:
        lower = jax.lax.pmax(lower, axis_name)
        upper = jax.lax.pmin(upper, axis_name)
        fail = jax.lax.psum(fail.astype(jnp.int32), axis_name) > 0
    fail = fail | (lower > upper)
    return jnp.where(fail, -1.0, upper)


def _mu_divergence(
    blocks, ws, fac, config, AQc_s, b_s_vec, c_scaling, rank_k, dtype,
    axis_name=None, structure=None,
):
    """reference: ComputeMuFromDivergence, cone_program.cc:173-214."""
    ydiv = kkt.solve(
        fac, AQc_s - b_s_vec, config.kkt_solver,
        config.iterative_refinement_iterations, structure, axis_name,
    )
    p = _slack_stats_all(blocks, ws, ydiv, c_scaling, dtype, axis_name)
    return mu_from_divergence(p, rank_k, config.divergence_upper_bound)


# ---------------------------------------------------------------------------
# The solve loop
# ---------------------------------------------------------------------------


def _solve_impl(
    blocks,
    eq_blocks,
    b,
    init_ws,
    init_scalars,
    config: SolverConfig,
    axis_name: Optional[str] = None,
    rank_override: Optional[float] = None,
    kkt_structure=None,
):
    """Trace the solve under the config's matmul-precision mode (a
    trace-time contextvar — the mode is baked into the compiled program,
    correct because callers retrace per static config)."""
    with mm.mode(config.schur_precision):
        return _solve_impl_inner(
            blocks, eq_blocks, b, init_ws, init_scalars, config,
            axis_name, rank_override, kkt_structure,
        )


def _solve_impl_inner(
    blocks,
    eq_blocks,
    b,
    init_ws,
    init_scalars,
    config: SolverConfig,
    axis_name: Optional[str] = None,
    rank_override: Optional[float] = None,
    kkt_structure=None,
):
    """``axis_name``: set when running constraint-sharded under shard_map —
    each device holds a subset of the cone blocks; all cross-cone
    aggregations (Schur sums, norm maxima, slack-eigenvalue extrema) become
    XLA collectives over that mesh axis.  ``rank_override`` must then be the
    *global* rank sum across devices."""
    dtype = b.dtype
    m = b.shape[0]
    # Materialize per-block solve-loop invariants (e.g. the Ozaki slices of
    # a dense LMI operator) once, outside the Newton loop.
    blocks = tuple(
        blk.prepare() if hasattr(blk, "prepare") else blk for blk in blocks
    )
    n_dual = sum(eq.p for eq in eq_blocks)
    n_kkt = m + n_dual
    b_full = jnp.zeros((n_kkt,), dtype).at[:m].set(b)

    rank_k = float(sum(blk.rank() for blk in blocks))
    if rank_override is not None:
        rank_k = float(rank_override)
    has_qcost = any(getattr(blk, "is_cost", False) for blk in blocks)
    warmstart = config.initialization_mode == WARMSTART
    mode = config.kkt_solver
    refine = config.iterative_refinement_iterations
    kkt_island = (
        jnp.dtype(config.kkt_island_dtype)
        if config.kkt_island_dtype is not None else None
    )

    if kkt_structure is not None and mode not in (
        KKT_SOLVER_LLT, KKT_SOLVER_LDLT
    ):
        # QR needs the densified matrix (reference kkt_solver.cc:174-177).
        kkt_structure = None

    k_min_clamp = jnp.sqrt(1.0 / (1e-15 + config.maximum_mu))

    init_centering_steps = (
        config.initial_centering_steps_warmstart
        if warmstart
        else config.initial_centering_steps_coldstart
    )

    # Reaching the scaled-k precision cap is reaching the achievable
    # target: without this, a run configured with a scaled cap below the
    # (rescaled) k_max would plateau at the cap and burn max_iterations
    # unsolved.  inf (the default) never triggers.
    k_cap = config.inv_sqrt_mu_cap_scaled

    def run_iteration(s: LoopState) -> LoopState:
        i = s.i
        initial_centering = i < init_centering_steps
        final_centering = (
            s.fc_latch
            | (s.k >= s.k_max)
            | (s.k >= k_cap)
            | (s.kkt_error > config.kkt_error_tolerance)
            | (i >= config.max_iterations - config.final_centering_steps)
        )
        update_mu = (i == 0) | (~(initial_centering | final_centering)) | s.warmstart_aborted

        # --- Assemble (cone_program.cc:338-341) ---
        # The "schur" scope names these ops in device traces
        # (benchmarks/trace_plain_paths.py reads it).
        with jax.named_scope("schur"):
            G, AW, AQc, w_dot_c, c_dot_Qc = assemble(
                blocks, eq_blocks, s.ws, n_kkt, m, dtype, axis_name,
                kkt_structure,
            )

        # --- First-iteration rescaling (cone_program.cc:343-357) ---
        if config.enable_rescaling:
            do_rescale = i < 1
            if not warmstart:
                b_scaling = jnp.where(
                    do_rescale, 1.0 / (1.0 + jnp.linalg.norm(b_full)), s.b_scaling
                )
                c_scaling = jnp.where(
                    do_rescale, 1.0 / (1.0 + jnp.linalg.norm(AQc)), s.c_scaling
                )
            else:
                b_scaling, c_scaling = s.b_scaling, s.c_scaling
            mu_target = (1.0 / (s.k_max * s.k_max)) * b_scaling * c_scaling
            k_max = jnp.where(do_rescale, 1.0 / jnp.sqrt(mu_target), s.k_max)
        else:
            b_scaling, c_scaling, k_max = s.b_scaling, s.c_scaling, s.k_max

        # --- Factor (cone_program.cc:359-371) ---
        fac = kkt.factor(G, mode, kkt_structure, axis_name,
                         island_dtype=kkt_island)

        # The factor-fail / mu-update / centering branching of the reference
        # (cone_program.cc:360-403) is expressed branch-free: both sides are
        # computed in one fused graph and merged with selects.  This halves
        # the traced graph vs nested lax.cond (the untaken side of a cond is
        # still compiled) and keeps XLA's fusion across the "branches".  On
        # the rare discarded path the extra work is one KKT solve — noise
        # next to the per-iteration cone kernels.

        def on_factor_ok(s: LoopState) -> LoopState:
            AQc_s = AQc * c_scaling
            b_s_vec = b_full * b_scaling

            # --- Mu update (cone_program.cc:374-403), branch-free ---
            if config.enable_line_search:
                temp = _mu_line_search(
                    blocks, s.ws, fac, config, AW, AQc_s, b_s_vec,
                    c_scaling, dtype, axis_name, kkt_structure,
                )
                temp = jnp.where(temp < 0, s.k, temp)
            else:
                temp = _mu_divergence(
                    blocks, s.ws, fac, config, AQc_s, b_s_vec,
                    c_scaling, rank_k, dtype, axis_name, kkt_structure,
                )
            k_cand = jnp.where(temp > 0, temp, s.k * 0.5)

            # --- Numerical-floor latch (see SolverConfig) ---
            if config.mu_floor_drop_ratio > 0 and not config.fixed_iterations:
                floor = (
                    update_mu
                    & ~final_centering
                    & (k_cand < config.mu_floor_drop_ratio * s.k)
                    & (s.k >= config.mu_floor_kmax_fraction * k_max)
                )
                k_cand = jnp.where(floor, s.k, k_cand)
                fc_latch = s.fc_latch | floor
            else:
                fc_latch = s.fc_latch

            k = jnp.where(update_mu, k_cand, s.k)
            centering_steps = jnp.where(
                update_mu,
                s.centering_steps,
                s.centering_steps + jnp.where(initial_centering, 0, 1),
            )

            # Clamp (cone_program.cc:405-407).
            k = jnp.clip(k, k_min_clamp, k_max)
            if config.inv_sqrt_mu_cap_scaled != float("inf"):
                # Precision guard on the scaled duality measure (see
                # SolverConfig.inv_sqrt_mu_cap_scaled).
                k = jnp.minimum(k, config.inv_sqrt_mu_cap_scaled)

            # --- Newton solve (cone_program.cc:409-413) ---
            y = kkt.solve(
                fac, k * (b_s_vec + AQc_s) - 2.0 * AW, mode, refine,
                kkt_structure, axis_name,
            )

            # --- PrepareStep (cone_program.cc:416-426) ---
            c_weight = k * c_scaling
            caches, norminf, normsq = _prepare_step_all(
                blocks, s.ws, y, c_weight, 1.0, axis_name
            )
            step_size = jnp.minimum(1.0, 2.0 / (norminf * norminf))

            # --- Warmstart abort on large step (cone_program.cc:428-436) ---
            if warmstart:
                abort = (i == 0) & (norminf >= config.warmstart_abort_threshold)
            else:
                abort = jnp.asarray(False)

            ws_stepped = _take_step_all(blocks, s.ws, caches, step_size)
            ws_new = jax.tree.map(
                lambda ident, stepped: jnp.where(abort, ident, stepped),
                _identity_all(blocks, dtype),
                ws_stepped,
            )

            # --- Statistics (cone_program.cc:439-471) ---
            d_2sq = jnp.abs(normsq)
            d_inf = jnp.abs(norminf)
            by = jnp.dot(b_full, y) / (k * c_scaling)
            cx = (
                2.0 * w_dot_c + jnp.dot(AQc, y) - k * c_dot_Qc * c_scaling
            ) / (k * b_scaling)
            mu = 1.0 / (k * k)
            s_dot_x = mu * (rank_k - d_2sq) / (b_scaling * c_scaling)
            if has_qcost:
                # reference computes kkt_error only without quadratic costs
                # (cone_program.cc:463-468).
                kkt_error = s.kkt_error
            else:
                kkt_error = jnp.abs(cx - by - s_dot_x) / s_dot_x

            stats_k = s.stats_k.at[i].set(k)
            stats_dinf = s.stats_dinf.at[i].set(d_inf)
            stats_d2 = s.stats_d2.at[i].set(jnp.sqrt(d_2sq))
            stats_by = s.stats_by.at[i].set(by)
            stats_cx = s.stats_cx.at[i].set(cx)
            stats_err = s.stats_err.at[i].set(kkt_error)

            # --- Termination (cone_program.cc:476-482) ---
            stop = (final_centering | (k >= k_max) | (k >= k_cap)) & (
                d_inf <= config.final_centering_tolerance
            )
            if config.fixed_iterations:
                stop = jnp.asarray(False)

            # --- Mu-stall detection (not in the reference; see SolverConfig) ---
            if config.mu_stall_iterations > 0 and not config.fixed_iterations:
                rel = jnp.abs(k - s.k) / jnp.maximum(jnp.abs(s.k), 1e-30)
                stalled_now = (
                    update_mu
                    & ~final_centering
                    & (i > 0)
                    & (rel < config.mu_stall_tolerance)
                )
                stall_count = jnp.where(stalled_now, s.stall_count + 1, 0)
                stall_exit = stall_count >= config.mu_stall_iterations
                stop = stop | stall_exit
            else:
                stall_count = s.stall_count

            return LoopState(
                i=i + 1,
                ws=ws_new,
                y=y,
                k=k,
                k_max=k_max,
                b_scaling=b_scaling,
                c_scaling=c_scaling,
                kkt_error=kkt_error,
                centering_steps=centering_steps,
                warmstart_aborted=abort,
                by=by,
                cx=cx,
                d_inf=d_inf,
                done=stop,
                fail=s.fail,
                max_iters_reached=jnp.where(stop, False, s.max_iters_reached),
                num_iter=i + 1,
                stall_count=stall_count,
                fc_latch=fc_latch,
                stats_k=stats_k,
                stats_dinf=stats_dinf,
                stats_d2=stats_d2,
                stats_by=stats_by,
                stats_cx=stats_cx,
                stats_err=stats_err,
            )

        # --- Merge with the factor-fail path (cone_program.cc:360-371),
        # branch-free.  On failure (coldstart, or warmstart past the first
        # iteration) the run aborts: done/fail set, everything else kept.
        # On a first-iteration warmstart failure the warmstart is aborted
        # and the iterates reset to identity.  NaNs produced downstream of
        # the failed factor are discarded by the selects.
        sn = on_factor_ok(s)
        ffail = fac.fail
        if warmstart:
            abort_f = ffail & (i == 0)
        else:
            abort_f = jnp.asarray(False)
        ws_fail = jax.tree.map(
            lambda ident, old: jnp.where(abort_f, ident, old),
            _identity_all(blocks, dtype),
            s.ws,
        )
        s_fail = s._replace(
            i=i + 1,
            ws=ws_fail,
            warmstart_aborted=jnp.where(warmstart, abort_f, s.warmstart_aborted),
            done=jnp.where(abort_f, False, True),
            fail=jnp.where(abort_f, False, True),
            b_scaling=b_scaling,
            c_scaling=c_scaling,
            k_max=k_max,
        )
        return jax.tree.map(
            lambda a, b_: jnp.where(ffail, a, b_), s_fail, sn
        )

    def body(s: LoopState) -> LoopState:
        # Break-before-assemble: final centering budget exhausted
        # (cone_program.cc:331-336).  Branch-free: the iteration is always
        # computed; a finished program (done, or centering budget spent)
        # keeps its state via selects.  Under vmap the while_loop body keeps
        # running until *all* batch elements finish, so the no-op-when-done
        # select is load-bearing there; unbatched it costs one discarded
        # iteration at exit.
        i = s.i
        final_centering = (
            s.fc_latch
            | (s.k >= s.k_max)
            | (s.k >= k_cap)
            | (s.kkt_error > config.kkt_error_tolerance)
            | (i >= config.max_iterations - config.final_centering_steps)
        )
        stop_centering = final_centering & (
            s.centering_steps >= config.final_centering_steps
        )
        if config.fixed_iterations:
            stop_centering = jnp.asarray(False)

        sn = run_iteration(s)
        s_marked = s._replace(
            done=jnp.asarray(True),
            max_iters_reached=i >= config.max_iterations - 1,
        )
        keep = s.done | stop_centering
        merged = jax.tree.map(
            lambda a, b_: jnp.where(keep, a, b_), s_marked, sn
        )
        # A program that was already done must stay exactly as it was
        # (s_marked flips done/max_iters_reached, which only applies to the
        # stop_centering exit).
        return jax.tree.map(
            lambda a, b_: jnp.where(s.done, a, b_), s, merged
        )

    def cond(s: LoopState):
        return (~s.done) & (s.i < config.max_iterations)

    zero = jnp.zeros((), dtype)
    state = LoopState(
        i=jnp.zeros((), jnp.int32),
        ws=init_ws,
        y=jnp.zeros((n_kkt,), dtype),
        k=init_scalars["k"].astype(dtype),
        k_max=jnp.asarray(config.inv_sqrt_mu_max, dtype),
        b_scaling=init_scalars["b_scaling"].astype(dtype),
        c_scaling=init_scalars["c_scaling"].astype(dtype),
        kkt_error=zero,
        centering_steps=jnp.zeros((), jnp.int32),
        warmstart_aborted=jnp.asarray(False),
        by=zero - 1.0,
        cx=zero + 1.0,
        d_inf=zero,
        done=jnp.asarray(False),
        fail=jnp.asarray(False),
        max_iters_reached=jnp.asarray(True),
        num_iter=jnp.zeros((), jnp.int32),
        stall_count=jnp.zeros((), jnp.int32),
        fc_latch=jnp.asarray(False),
        stats_k=jnp.zeros((config.max_iterations,), dtype),
        stats_dinf=jnp.zeros((config.max_iterations,), dtype),
        stats_d2=jnp.zeros((config.max_iterations,), dtype),
        stats_by=jnp.zeros((config.max_iterations,), dtype),
        stats_cx=jnp.zeros((config.max_iterations,), dtype),
        stats_err=jnp.zeros((config.max_iterations,), dtype),
    )

    s = jax.lax.while_loop(cond, body, state)

    # --- Epilogue (cone_program.cc:485-532) ---
    mu = 1.0 / (s.k * s.k)
    infeasible = mu > config.infeasibility_threshold
    primal_infeasible = infeasible & (s.cx * s.k <= -0.5)
    dual_infeasible = infeasible & (s.by * s.k >= 0.5)
    if config.mu_stall_iterations > 0:
        mu_stalled = (s.stall_count >= config.mu_stall_iterations) & (
            s.k < s.k_max
        )
    else:
        mu_stalled = jnp.asarray(False)
    solved = (~infeasible) & (~s.fail) & (~mu_stalled)

    y_kkt = s.y
    ws_final = s.ws

    if config.prepare_dual_variables:
        # Dual recovery: one extra assemble/factor/solve + affine step
        # (cone_program.cc:500-516).  The reference returns before this on
        # factorization failure (cone_program.cc:360-371), so a failed run
        # must not poison the final iterates with NaNs — keep the loop's W.
        G, AW, AQc, _, _ = assemble(
            blocks, eq_blocks, ws_final, n_kkt, m, dtype, axis_name,
            kkt_structure,
        )
        fac = kkt.factor(G, mode, kkt_structure, axis_name,
                         island_dtype=kkt_island)
        bres = s.k * b_full * s.b_scaling - AW
        y2 = kkt.solve(fac, bres, mode, refine, kkt_structure, axis_name)
        skip = s.fail | fac.fail
        ws_recovered = tuple(
            blk.affine_step(w, local_vars(y2, blk.vars_, blk.num_vars), 0.0)
            for blk, w in zip(blocks, ws_final)
        )
        ws_final = jax.tree.map(
            lambda w_loop, w_rec: jnp.where(skip, w_loop, w_rec),
            ws_final,
            ws_recovered,
        )

    # Unscale (cone_program.cc:518-521): applied when mu is feasible,
    # even if the iteration limit later clears `solved`.
    y_out = jnp.where(
        infeasible | s.fail, s.y[:m], s.y[:m] / (s.k * s.c_scaling)
    )
    solved = solved & (~s.max_iters_reached)

    return SolveResult(
        y=y_out,
        solved=solved,
        primal_infeasible=primal_infeasible,
        dual_infeasible=dual_infeasible,
        num_iterations=s.num_iter,
        ws=ws_final,
        y_kkt=y_kkt,
        k=s.k,
        b_scaling=s.b_scaling,
        c_scaling=s.c_scaling,
        stats_k=s.stats_k,
        stats_dinf=s.stats_dinf,
        stats_d2=s.stats_d2,
        stats_by=s.stats_by,
        stats_cx=s.stats_cx,
        stats_err=s.stats_err,
        fail=s.fail,
        mu_stalled=mu_stalled,
    )


@functools.partial(jax.jit, static_argnames=("config", "kkt_structure"))
def solve_compiled(blocks, eq_blocks, b, init_ws, init_scalars, config,
                   kkt_structure=None):
    """Jitted entry point.  ``config`` and ``kkt_structure`` are static;
    everything else is traced."""
    return _solve_impl(
        blocks, eq_blocks, b, init_ws, init_scalars, config,
        kkt_structure=kkt_structure,
    )
