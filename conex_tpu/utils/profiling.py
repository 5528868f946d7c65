"""Per-phase timing and XLA trace capture.

Equivalent of the reference's compile-time macro timers
(CONEX_ENABLE_TIMER, debug_macros.h:18-47, instrumented at
cone_program.cc:338/359/412/421 for Assemble/Factor/Solve/Update): runs
each phase of one Newton iteration as its own jitted call with
block_until_ready timing, plus a context manager around the jax profiler
for full XLA traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax profiler trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _time(fn, *args, reps: int = 10) -> float:
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def phase_timings(prog, config=None, reps: int = 10) -> Dict[str, float]:
    """Wall time (seconds) of Assemble / Factor / Solve / Update phases of
    one Newton iteration of ``prog`` at the identity iterate.

    The phases match the reference's timer call sites
    (cone_program.cc:338-421).
    """
    from ..config import SolverConfig
    from ..solver import kkt
    from ..solver.loop import _prepare_step_all, _take_step_all, assemble

    if config is None:
        config = SolverConfig()
    blocks = tuple(prog._blocks)
    eq_blocks = tuple(prog._eq_blocks)
    structure = prog._kkt_structure()
    dtype = prog.dtype
    n_kkt = prog.num_vars + prog._dual_size
    mode = config.kkt_solver
    ws = tuple(blk.identity_state(dtype) for blk in blocks)

    @jax.jit
    def do_assemble(ws):
        return assemble(blocks, eq_blocks, ws, n_kkt, prog.num_vars, dtype)

    G, AW, AQc, _, _ = jax.block_until_ready(do_assemble(ws))

    @jax.jit
    def do_factor(G):
        return kkt.factor(G, mode, structure)

    fac = jax.block_until_ready(do_factor(G))

    @jax.jit
    def do_solve(fac, rhs):
        return kkt.solve(fac, rhs, mode,
                         config.iterative_refinement_iterations, structure)

    rhs = AQc - AW
    y = jax.block_until_ready(do_solve(fac, rhs))

    @jax.jit
    def do_update(ws, y):
        caches, ninf, nsq = _prepare_step_all(blocks, ws, y, 1.0, 1.0)
        step = jnp.minimum(1.0, 2.0 / (ninf * ninf))
        return _take_step_all(blocks, ws, caches, step)

    return {
        "assemble": _time(do_assemble, ws, reps=reps),
        "factor": _time(do_factor, G, reps=reps),
        "solve": _time(do_solve, fac, rhs, reps=reps),
        "update": _time(do_update, ws, y, reps=reps),
    }
