"""Multi-device execution: scenario batching (DP) and cone sharding (TP).

The reference is single-threaded (SURVEY.md §2.6); this module is the
scale-out design:

* **Scenario batching (DP)** — many independent cone programs with the same
  structure solve as one vmapped program; sharding the scenario axis over a
  mesh axis splits them across chips with zero communication.

* **Cone sharding (TP)** — one large program whose cone blocks are
  partitioned across chips.  Each chip assembles the Schur contributions of
  its local cones; the global G/AW/AQc reduce with a single psum
  per iteration (the additive structure of
  /root/reference/conex/cone_program.cc:68-76), and the scalar aggregations
  (norm maxima, slack-eigenvalue extrema) ride along as pmax/pmin.  The
  dense KKT factorization is replicated per chip (supernodal distribution
  comes with the sparse path).

Both compose: a 2D mesh ("dp", "tp") shards scenarios x cones.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SolverConfig
from ..solver.loop import _solve_impl


@functools.lru_cache(maxsize=None)
def _scenario_solver(config: SolverConfig):
    """Cached jitted vmapped solver.  Building the closure per call would
    retrace on every invocation (jit caches by function identity)."""

    @jax.jit
    def run(blocks, eq_blocks, b, init_ws, init_scalars):
        def one(blocks_, eqs_, b_, ws_, scalars_):
            return _solve_impl(blocks_, eqs_, b_, ws_, scalars_, config)

        return jax.vmap(one)(blocks, eq_blocks, b, init_ws, init_scalars)

    return run


def solve_scenarios(blocks, eq_blocks, b, init_ws, init_scalars, config,
                    mesh: Optional[Mesh] = None, axis: str = "dp"):
    """Solve a batch of same-structure programs, vmapped over the leading
    scenario axis of every array (block data, b, initial state).

    With ``mesh`` given, the scenario axis is sharded over ``axis`` —
    pure data parallelism, no cross-chip traffic inside the solve.
    """
    if mesh is not None:
        shard = NamedSharding(mesh, P(axis))
        args = (blocks, eq_blocks, b, init_ws, init_scalars)
        args = jax.tree.map(lambda x: jax.device_put(x, shard), args)
        blocks, eq_blocks, b, init_ws, init_scalars = args
    return _scenario_solver(config)(blocks, eq_blocks, b, init_ws, init_scalars)


@functools.lru_cache(maxsize=None)
def _cone_sharded_solver(config: SolverConfig, mesh: Mesh, axis: str,
                         total_rank: float, kkt_structure=None):
    @jax.jit
    def run(blocks, eq_blocks, b, init_ws, init_scalars):
        # Block *data* shards along each block's leading cone-batch axis;
        # the static metadata (vars_) rides along.  b/scalars replicate.
        blocks_spec = jax.tree.map(lambda _: P(axis), blocks)
        ws_spec = jax.tree.map(lambda _: P(axis), init_ws)
        eq_spec = jax.tree.map(lambda _: P(), eq_blocks)
        rep = P()

        def inner(blocks_loc, eqs_loc, b_, ws_loc, scalars_):
            res = _solve_impl(
                blocks_loc, eqs_loc, b_, ws_loc, scalars_, config,
                axis_name=axis, rank_override=total_rank,
                kkt_structure=kkt_structure,
            )
            ws_out = res.ws
            return res._replace(ws=()), ws_out

        fn = jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(blocks_spec, eq_spec, rep, ws_spec, rep),
            out_specs=(rep, ws_spec),
            check_vma=False,
        )
        res, ws = fn(blocks, eq_blocks, b, init_ws, init_scalars)
        return res._replace(ws=ws)

    return run


def solve_cone_sharded(blocks, eq_blocks, b, init_ws, init_scalars,
                       config: SolverConfig, mesh: Mesh, axis: str = "tp",
                       kkt_structure=None):
    """Solve one program with its cone-block *batch* axes sharded over
    ``axis``.  Every block must be a batched block (leading cone axis
    divisible by the mesh axis size); equality blocks are replicated.

    Returns the same SolveResult on every device (fully replicated), with
    block iterates sharded like their blocks.

    ``kkt_structure``: optional static supernodal structure; a
    DistributedSupernodalStructure additionally shards the KKT clique-tree
    factorization over ``axis`` (subtree elimination per device + one
    separator psum; supernodal/distributed.py).
    """
    total_rank = float(sum(blk.rank() for blk in blocks))
    return _cone_sharded_solver(config, mesh, axis, total_rank,
                                kkt_structure)(
        blocks, eq_blocks, b, init_ws, init_scalars
    )


def solve_scenarios_cone_sharded(
    blocks, eq_blocks, b, init_ws, init_scalars, config: SolverConfig,
    mesh: Mesh, total_rank: float, dp_axis: str = "dp", tp_axis: str = "tp",
):
    """2D: scenario axis over ``dp_axis``, cone-batch axes over ``tp_axis``.

    Array layouts: b is (S, m); every cone-block array and init state is
    (S, B, ...) with S the scenario count and B the cone batch.  Equality
    blocks carry (S, ...) data, replicated over tp.  ``total_rank`` is the
    global cone rank of ONE program (blocks carry an extra scenario axis
    here, so it cannot be derived from block shapes).
    """

    return _scenario_cone_sharded_solver(
        config, mesh, dp_axis, tp_axis, float(total_rank)
    )(blocks, eq_blocks, b, init_ws, init_scalars)


@functools.lru_cache(maxsize=None)
def _scenario_cone_sharded_solver(config: SolverConfig, mesh: Mesh,
                                  dp_axis: str, tp_axis: str,
                                  total_rank: float):
    @jax.jit
    def run(blocks, eq_blocks, b, init_ws, init_scalars):
        blocks_spec = jax.tree.map(lambda _: P(dp_axis, tp_axis), blocks)
        ws_spec = jax.tree.map(lambda _: P(dp_axis, tp_axis), init_ws)
        eq_spec = jax.tree.map(lambda _: P(dp_axis), eq_blocks)
        b_spec = P(dp_axis)
        scal_spec = jax.tree.map(lambda _: P(dp_axis), init_scalars)
        out_rep = P(dp_axis)

        def inner(blocks_loc, eqs_loc, b_loc, ws_loc, scalars_loc):
            def one(blocks_, eqs_, b_, ws_, scalars_):
                return _solve_impl(
                    blocks_, eqs_, b_, ws_, scalars_, config,
                    axis_name=tp_axis, rank_override=total_rank,
                )

            res = jax.vmap(one)(blocks_loc, eqs_loc, b_loc, ws_loc, scalars_loc)
            ws_out = res.ws
            return res._replace(ws=()), ws_out

        fn = jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(blocks_spec, eq_spec, b_spec, ws_spec, scal_spec),
            out_specs=(out_rep, ws_spec),
            check_vma=False,
        )
        res, ws = fn(blocks, eq_blocks, b, init_ws, init_scalars)
        return res._replace(ws=ws)

    return run
