"""Failure-mode corpus.

Mirrors /root/reference/conex/test/solver_failures.cc (documented
breakages) and kkt_solver_options_test.cc (solver-mode behavior on
rank-deficient systems): these instances must be handled *gracefully* —
regularized, recovered, or reported unsolved — never crash or return NaN
as a "solved" answer.
"""

import numpy as np
import pytest

from conex_tpu import (
    KKT_SOLVER_LDLT,
    KKT_SOLVER_LLT,
    KKT_SOLVER_QR,
    Program,
    SolverConfig,
)


def test_equality_failing_ldlt_regularized():
    """reference: EqualityConstraintFailingLDLT (solver_failures.cc:17-45):
    the KKT matrix [1 1 1; 1 1 -1; 1 -1 0] has a zero pivot in fixed
    order; the clamp (+ refinement) must keep the solve finite."""
    A = np.array([[1.0, 1.0]])
    C = np.array([1.0])
    eq = np.array([[1.0, -1.0]])
    eq_affine = np.array([0.0])
    b = A.T @ C

    prog = Program(2)
    prog.add_linear_constraint(A, C)
    prog.add_equality_constraint(eq, eq_affine)
    res = prog.solve(
        b, SolverConfig(max_iterations=40, iterative_refinement_iterations=2)
    )
    # Graceful: finite output; if it claims solved, the answer must be
    # feasible (y1 = y2, y1 + y2 <= 1, maximize y1 + y2 -> y = (0.5, 0.5)).
    assert np.all(np.isfinite(res.y))
    if res.solved:
        assert abs(res.y[0] - res.y[1]) < 1e-6
        assert res.y[0] == pytest.approx(0.5, abs=1e-4)


def test_bad_initialization_centering_helps():
    """reference: DoBadInitialization (solver_failures.cc:48-110): an
    instance with wildly unbalanced optimal slack/dual pairs; initial
    centering steps stabilize it."""
    rng = np.random.default_rng(0)
    num_vars = 5
    n = num_vars + 10
    A = rng.uniform(-1, 1, (n, num_vars))
    optimal_slack = np.ones(n)
    optimal_dual = np.ones(n)
    m = n // 2
    optimal_slack[:m] = 1e-3
    optimal_dual[m:] = 1e-3
    y_opt = rng.uniform(-1, 1, num_vars)
    C = optimal_slack + A @ y_opt
    b = A.T @ optimal_dual

    prog = Program(num_vars)
    prog.add_linear_constraint(A, C)
    res = prog.solve(
        b,
        SolverConfig(
            max_iterations=60,
            final_centering_steps=10,
            initial_centering_steps_coldstart=2,
        ),
    )
    assert res.solved
    assert (C - A @ res.y).min() >= -1e-6


def test_qr_succeeds_where_llt_fails():
    """reference: kkt_solver_options_test.cc:96-144 — a rank-deficient
    Schur complement (duplicated LP rows with fewer rows than variables)
    fails LLT but the QR least-squares mode still solves."""
    rng = np.random.default_rng(1)
    m = 4
    row = rng.uniform(-1, 1, m)
    # Two identical constraint rows: G = (W A)'(W A) has rank <= 2 < m.
    A = np.vstack([row, row, rng.uniform(-1, 1, m)])
    c = np.abs(rng.uniform(0.5, 1.5, 3))
    c[1] = c[0]
    b = A.T @ np.array([1.0, 1.0, 0.5])

    prog_llt = Program(m)
    prog_llt.add_linear_constraint(A, c)
    res_llt = prog_llt.solve(
        b, SolverConfig(max_iterations=30, kkt_solver=KKT_SOLVER_LLT)
    )
    assert not res_llt.solved  # factorization fails

    prog_qr = Program(m)
    prog_qr.add_linear_constraint(A, c)
    res_qr = prog_qr.solve(
        b, SolverConfig(max_iterations=30, kkt_solver=KKT_SOLVER_QR)
    )
    assert res_qr.solved
    assert (c - A @ res_qr.y).min() >= -1e-6


def test_slater_violating_lp():
    """reference: LPFailSlater (solver_failures.cc:208-252): implicit
    equalities (a row and its negation) violate strict feasibility; the
    solve must terminate gracefully."""
    rng = np.random.default_rng(2)
    m = 4
    r = rng.uniform(-1, 1, m)
    yref = rng.uniform(-1, 1, m)
    A = np.vstack([r, -r, rng.uniform(-1, 1, (4, m))])
    c = np.concatenate([[r @ yref], [-(r @ yref)], rng.uniform(1, 2, 4) + A[2:] @ yref])
    x0 = np.abs(rng.uniform(0, 1, 6))
    b = A.T @ x0
    prog = Program(m)
    prog.add_linear_constraint(A, c)
    res = prog.solve(
        b,
        SolverConfig(
            max_iterations=60, kkt_solver=KKT_SOLVER_LDLT,
            iterative_refinement_iterations=2,
        ),
    )
    assert np.all(np.isfinite(res.y))
    if res.solved:
        # On the implicit equality face.
        assert abs(r @ res.y - r @ yref) < 1e-4


def test_mu_stall_detector_exits_early():
    """A scaling-pathological LP pins k at the minimum-mu clamp and (like
    the reference, which has no detector) would burn the whole iteration
    budget; with mu_stall_iterations set the solve exits after the stall
    window and reports mu_stalled (not in the reference, SolverConfig)."""
    A = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
    c = np.array([1.0, 0.0, 1e6, 1e6])
    b = np.array([1.0, 0.0])

    prog = Program(2)
    prog.add_linear_constraint(A, c)
    r_off = prog.solve(
        b, SolverConfig(max_iterations=60, inv_sqrt_mu_max=1e7)
    )
    assert not r_off.solved and r_off.num_iterations == 60

    prog2 = Program(2)
    prog2.add_linear_constraint(A, c)
    r_on = prog2.solve(
        b,
        SolverConfig(
            max_iterations=60, inv_sqrt_mu_max=1e7, mu_stall_iterations=4
        ),
    )
    assert not r_on.solved
    assert r_on.mu_stalled
    assert r_on.num_iterations <= 8


def test_mu_stall_detector_quiet_on_wellposed():
    """The detector must not fire on a healthy solve."""
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    c = np.array([2.0, 3.0, 4.0])
    b = np.array([1.0, 2.0])
    prog = Program(2)
    prog.add_linear_constraint(A, c)
    r = prog.solve(
        b,
        SolverConfig(
            max_iterations=50, inv_sqrt_mu_max=1e4, mu_stall_iterations=4
        ),
    )
    assert r.solved and not r.mu_stalled
    assert abs(b @ r.y - 7.0) < 1e-6


def test_bad_initialization_fail_variant_graceful():
    """reference: DoBadInitialization(fail=true) (solver_failures.cc:48-110):
    initial_centering_steps_coldstart = 0, divergence_upper_bound = 0.5 on
    the unbalanced-slack instance — five random instances, run as the
    reference binary does (solver_failures.cc:256-259).  The reference
    documents occasional poor convergence; the requirement is graceful
    classification: finite output, and feasibility whenever solved=True."""
    for seed in range(5):
        rng = np.random.default_rng(100 + seed)
        num_vars = 5
        n = num_vars + 10
        A = rng.uniform(-1, 1, (n, num_vars))
        optimal_slack = np.ones(n)
        optimal_dual = np.ones(n)
        m = n // 2
        optimal_slack[:m] = 1e-3
        optimal_dual[m:] = 1e-3
        y_opt = rng.uniform(-1, 1, num_vars)
        C = optimal_slack + A @ y_opt
        b = A.T @ optimal_dual

        # The reference adds one equality constraint over vars
        # {0, 1, num_vars-1} with coefficients (1, 2, 3) and consistent rhs
        # (solver_failures.cc:73-88).
        eq = np.zeros((1, num_vars))
        eq[0, [0, 1, num_vars - 1]] = [1.0, 2.0, 3.0]
        eq_affine = eq @ y_opt

        prog = Program(num_vars)
        prog.add_equality_constraint(eq, eq_affine)
        prog.add_linear_constraint(A, C)
        res = prog.solve(
            b,
            SolverConfig(
                max_iterations=40,
                final_centering_steps=10,
                initial_centering_steps_coldstart=0,
                divergence_upper_bound=0.5,
                iterative_refinement_iterations=2,
            ),
        )
        assert np.all(np.isfinite(res.y)), seed
        if res.solved:
            assert (C - A @ res.y).min() >= -1e-4, seed
            assert np.abs(eq @ res.y - eq_affine).max() < 1e-4, seed


@pytest.mark.parametrize("n_implicit", [1, 2, 3])
def test_lp_fail_slater_reference_config(n_implicit):
    """reference: LPFailSlater (solver_failures.cc:208-252) with the
    reference's exact shape family (m=10, n1 implicit equalities as +/- row
    pairs, n2=8 strict rows) and config (inv_sqrt_mu_max=100,
    final_centering_tolerance=1, infeasibility_threshold=2e6,
    final_centering_steps=5, prepare_dual_variables).  Must terminate
    gracefully with finite output."""
    rng = np.random.default_rng(200 + n_implicit)
    m = 10
    n1, n2 = n_implicit, 8
    yref = rng.uniform(-1, 1, m)
    A1 = rng.uniform(-1, 1, (n1, m))
    C1 = A1 @ yref
    A2 = rng.uniform(-1, 1, (n2, m))
    C2 = A2 @ yref + 2.0
    A = np.vstack([A1, -A1, A2])
    c = np.concatenate([C1, -C1, C2])
    xref = np.abs(rng.uniform(-1, 1, 2 * n1 + n2))
    b = A.T @ xref

    prog = Program(m)
    prog.add_linear_constraint(A, c)
    res = prog.solve(
        b,
        SolverConfig(
            prepare_dual_variables=True,
            inv_sqrt_mu_max=100.0,
            final_centering_tolerance=1.0,
            infeasibility_threshold=2e6,
            final_centering_steps=5,
            kkt_solver=KKT_SOLVER_LDLT,
            iterative_refinement_iterations=2,
            max_iterations=60,
        ),
    )
    assert np.all(np.isfinite(res.y))
    if res.solved:
        # Any solution lies on the implicit equality face A1 y = C1.
        assert np.abs(A1 @ res.y - C1).max() < 1e-3


def test_mpc_failing_ldlt_graceful():
    """reference: MPCFailingLDLT (solver_failures.cc:112-206): a T=3 MPC
    chain — dynamics equalities, per-stage input inequalities (the
    fail-trigger), and quadratic-cost epigraphs — whose KKT matrix
    defeats the reference's LDLT.  The clamp + refinement redesign must
    keep the solve finite (solved or cleanly unsolved, never NaN)."""
    rng = np.random.default_rng(5)
    T, nu, nx = 3, 1, 2
    num_vars = T * (nu + nx + 2)

    Ai = rng.uniform(-1, 1, (nx, nx))
    Bi = rng.uniform(-1, 1, (nx, nu))
    f = rng.uniform(-1, 1, nx)
    Hxu = rng.uniform(-1, 1, (2, nu))
    gxu = rng.uniform(-1, 1, 2)

    def input_vars(i):
        off = T * nx + i * nu
        return list(range(off, off + nu))

    def state_vars(i):
        assert i >= 1
        off = (i - 1) * nx
        return list(range(off, off + nx))

    def stage_vars(i):
        y = []
        if i > 0:
            y += state_vars(i)
        y += input_vars(i)
        y += state_vars(i + 1)
        return y

    prog = Program(num_vars)
    epigraph = T * (nu + nx)
    for i in range(T):
        if i > 0:
            D = np.hstack([Ai, Bi, -np.eye(nx)])
        else:
            D = np.hstack([Bi, -np.eye(nx)])
        prog.add_equality_constraint(D, f, variables=stage_vars(i))
        if 0 < i < T - 1:
            prog.add_linear_constraint(Hxu, gxu, variables=input_vars(i))
        prog.add_quadratic_cost_epigraph(np.eye(nu), input_vars(i), epigraph)
        epigraph += 1
        prog.add_quadratic_cost_epigraph(
            np.eye(nx), state_vars(i + 1), epigraph
        )
        epigraph += 1

    b = -np.ones(num_vars)
    res = prog.solve(
        b,
        SolverConfig(
            inv_sqrt_mu_max=1e4,
            final_centering_steps=10,
            max_iterations=50,
            kkt_solver=KKT_SOLVER_LDLT,
            iterative_refinement_iterations=2,
        ),
    )
    assert np.all(np.isfinite(res.y))
    if res.solved:
        # Dynamics feasibility at the returned point.
        x1 = res.y[state_vars(1)]
        u0 = res.y[input_vars(0)]
        assert np.abs(Bi @ u0 - x1 - f).max() < 1e-3
