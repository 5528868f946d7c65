"""Batched SOCP through ``solve_scenarios`` against per-program solves.

Batched second-order-cone programs run through the general vmapped solve
loop (parallel/sharded.solve_scenarios over one SOCCone block).  Each
scenario must reproduce the ``Program.solve`` of the same program:
trajectories, solutions, iteration counts, status flags and warmstart
behaviour.  Both sides run the same arithmetic, so the tolerances only
absorb vmap's reassociation of reductions.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from conex_tpu import Program
from conex_tpu.config import WARMSTART, SolverConfig
from conex_tpu.cones.soc import SOCCone
from conex_tpu.parallel.sharded import solve_scenarios


def random_socp(rng, S, nc, n, m, feasible=True):
    """Batch of S programs, nc Lorentz cones of dim n+1, m variables."""
    A = rng.standard_normal((S, nc, n + 1, m))
    if feasible:
        # interior dual point per cone (x0 > |x1|); b = A(x) makes the
        # program feasible by construction (reference test_socp.cc recipe)
        x = rng.standard_normal((S, nc, n + 1))
        x[..., 0] = np.linalg.norm(x[..., 1:], axis=-1) + rng.uniform(
            0.5, 1.5, (S, nc)
        )
        b = 2.0 * np.einsum("scnv,scn->sv", A, x)
    else:
        b = rng.standard_normal((S, m))
    c = rng.standard_normal((S, nc, n + 1))
    c[..., 0] = np.linalg.norm(c[..., 1:], axis=-1) + rng.uniform(
        0.5, 2.0, (S, nc)
    )
    return A, c, b


def batched(A, c, b, config, init_w=None, b_scaling=None, c_scaling=None,
            mesh=None):
    S, nc, n1, m = A.shape
    blk = SOCCone(A=jnp.asarray(A), c=jnp.asarray(c))
    if init_w is None:
        init_w = jnp.zeros((S, nc, n1), A.dtype).at[:, :, 0].set(1.0)
    ones = jnp.ones((S,), A.dtype)
    scalars = dict(
        k=jnp.zeros((S,), A.dtype),
        b_scaling=ones if b_scaling is None else jnp.asarray(b_scaling),
        c_scaling=ones if c_scaling is None else jnp.asarray(c_scaling),
    )
    return solve_scenarios((blk,), (), jnp.asarray(b), (jnp.asarray(init_w),),
                           scalars, config, mesh=mesh)


def program(A_s, c_s):
    prog = Program(A_s.shape[-1])
    prog.add_soc_constraint(A_s, c_s)
    return prog


def per_program(A, c, b, config):
    out = []
    for s in range(A.shape[0]):
        prog = program(A[s], c[s])
        out.append((prog, prog.solve(b[s], config)))
    return out


def assert_matches(res, refs, y_atol=1e-8):
    for s, (_, r) in enumerate(refs):
        assert int(np.asarray(res.num_iterations)[s]) == r.num_iterations
        assert bool(np.asarray(res.solved)[s]) == r.solved
        assert bool(np.asarray(res.primal_infeasible)[s]) == r.primal_infeasible
        assert bool(np.asarray(res.dual_infeasible)[s]) == r.dual_infeasible
        assert bool(np.asarray(res.mu_stalled)[s]) == r.mu_stalled
        # k = 1/sqrt(mu) grows to ~1e4 in the endgame, where the
        # reassociated reductions show in the 6th digit
        np.testing.assert_allclose(
            np.asarray(res.stats_k)[s, : r.num_iterations],
            r.stats_inv_sqrt_mu, rtol=1e-5,
        )
        np.testing.assert_allclose(np.asarray(res.y)[s], r.y, rtol=1e-6,
                                   atol=y_atol)


CFG = SolverConfig(max_iterations=30)


@pytest.mark.parametrize("nc", [1, 3])
def test_batched_matches_program_feasible(nc):
    rng = np.random.default_rng(5 + nc)
    A, c, b = random_socp(rng, S=9, nc=nc, n=4, m=3)
    res = batched(A, c, b, CFG)
    assert_matches(res, per_program(A, c, b, CFG))
    assert np.all(np.asarray(res.solved))


def test_batched_solution_quality():
    """Primal feasibility, A'x = b and the duality gap on the batched
    path's own output."""
    rng = np.random.default_rng(11)
    A, c, b = random_socp(rng, S=6, nc=2, n=6, m=4)
    res = batched(A, c, b, CFG.replace(prepare_dual_variables=True))
    assert np.all(np.asarray(res.solved))
    y = np.asarray(res.y)
    slack = c - np.einsum("scnv,sv->scn", A, y)
    margins = slack[..., 0] - np.linalg.norm(slack[..., 1:], axis=-1)
    assert margins.min() > -1e-9
    # x = 2 w / (k b_scaling): SOCCone.dual_scale, reference
    # cone_program.h:120-134 unscaling
    scale = np.asarray(res.k) * np.asarray(res.b_scaling)
    x = 2.0 * np.asarray(res.ws[0]) / scale[:, None, None]
    r = np.einsum("scnv,scn->sv", A, x) - b
    assert np.abs(r).max() < 1e-6 * max(1.0, np.abs(b).max())
    gap = np.einsum("scn,scn->s", c, x) - np.einsum("sv,sv->s", b, y)
    assert np.abs(gap).max() < 1e-4 * (1.0 + np.abs(b).max())


def test_batched_dual_recovery_matches_program():
    rng = np.random.default_rng(7)
    A, c, b = random_socp(rng, S=5, nc=1, n=5, m=3)
    cfg = CFG.replace(prepare_dual_variables=True)
    res = batched(A, c, b, cfg)
    scale = np.asarray(res.k) * np.asarray(res.b_scaling)
    x = 2.0 * np.asarray(res.ws[0]) / scale[:, None, None]
    for s, (prog, _) in enumerate(per_program(A, c, b, cfg)):
        np.testing.assert_allclose(x[s, 0], prog.get_dual_variable(0),
                                   rtol=1e-8, atol=1e-10)


def test_batched_infeasible_detection_matches_program():
    rng = np.random.default_rng(3)
    # random objectives: some programs are unbounded (dual infeasible)
    A, c, b = random_socp(rng, S=8, nc=1, n=4, m=3, feasible=False)
    cfg = CFG.replace(max_iterations=60, infeasibility_threshold=1e3)
    refs = per_program(A, c, b, cfg)
    assert any(r.dual_infeasible for _, r in refs)
    assert any(r.solved for _, r in refs)
    assert_matches(batched(A, c, b, cfg), refs)


def test_batched_fixed_iteration_mode_matches_program():
    """The benchmark configuration: no early exit, no final centering."""
    rng = np.random.default_rng(19)
    A, c, b = random_socp(rng, S=4, nc=1, n=20, m=10)
    cfg = SolverConfig(
        max_iterations=14,
        final_centering_steps=0,
        inv_sqrt_mu_max=1e15,
        kkt_error_tolerance=1e45,
        fixed_iterations=True,
    )
    res = batched(A, c, b, cfg)
    np.testing.assert_array_equal(np.asarray(res.num_iterations), 14)
    assert_matches(res, per_program(A, c, b, cfg))


def test_batched_refinement_and_stall_options_match_program():
    rng = np.random.default_rng(23)
    A, c, b = random_socp(rng, S=3, nc=2, n=4, m=3)
    cfg = CFG.replace(iterative_refinement_iterations=1, mu_stall_iterations=4)
    assert_matches(batched(A, c, b, cfg), per_program(A, c, b, cfg))


def test_batched_2d_single_cone_and_subbatch():
    """A single cone given as a 2-D (n+1, m) operator solves like the 4-D
    batched layout, and a scenario's result does not depend on the rest
    of its batch."""
    rng = np.random.default_rng(31)
    A, c, b = random_socp(rng, S=5, nc=1, n=3, m=2)
    res = batched(A, c, b, CFG)
    for s in range(A.shape[0]):
        r = program(A[s, 0], c[s, 0]).solve(b[s], CFG)
        np.testing.assert_allclose(np.asarray(res.y)[s], r.y, rtol=1e-8,
                                   atol=1e-10)
    sub = batched(A[1:3], c[1:3], b[1:3], CFG)
    np.testing.assert_allclose(np.asarray(sub.y), np.asarray(res.y)[1:3],
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(np.asarray(sub.num_iterations),
                                  np.asarray(res.num_iterations)[1:3])


def test_batched_warmstart_matches_program():
    """Warmstart continuation: stop a coldstart solve mid-trajectory and
    resume both paths from the same saved state (reference warmstart
    contract, test_warmstart.cc:14-45)."""
    rng = np.random.default_rng(41)
    A, c, b = random_socp(rng, S=7, nc=2, n=4, m=3)
    cfg1 = SolverConfig(max_iterations=6, final_centering_steps=0,
                        fixed_iterations=True)
    cfg2 = SolverConfig(max_iterations=30, initialization_mode=WARMSTART)
    states, refs = [], []
    for s, (prog, _) in enumerate(per_program(A, c, b, cfg1)):
        states.append(prog.save_state())
        refs.append((prog, prog.solve(b[s], cfg2)))
    res = batched(
        A, c, b, cfg2,
        init_w=np.stack([st["ws"][0] for st in states]),
        b_scaling=np.array([st["b_scaling"] for st in states]),
        c_scaling=np.array([st["c_scaling"] for st in states]),
    )
    assert_matches(res, refs)
    assert np.all(np.asarray(res.solved))


def test_batched_warmstart_abort_matches_program():
    """A poisoned warmstart state must abort to identity on both paths and
    still converge (cone_program.cc:428-436)."""
    rng = np.random.default_rng(43)
    A, c, b = random_socp(rng, S=5, nc=1, n=4, m=3)
    S, nc, n1, _ = A.shape
    w_bad = np.zeros((S, nc, n1))
    w_bad[..., 0] = 1e6  # wildly scaled iterate: huge first Newton step
    cfg = SolverConfig(max_iterations=40, initialization_mode=WARMSTART,
                       warmstart_abort_threshold=2.0)
    refs = []
    for s in range(S):
        prog = program(A[s], c[s])
        prog.load_state(dict(ws=(w_bad[s],), b_scaling=1.0, c_scaling=1.0))
        refs.append((prog, prog.solve(b[s], cfg)))
    res = batched(A, c, b, cfg, init_w=w_bad)
    # the aborted first step amplifies rounding differences; both paths
    # still agree within the target duality measure mu = 1e-6
    assert_matches(res, refs, y_atol=1e-6)
    assert np.all(np.asarray(res.solved))


def test_batched_dp_mesh_matches_one_device():
    """Scenarios sharded over a 4-device "dp" mesh solve exactly as on one
    device, and the iterates really live on all four devices."""
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 devices")
    rng = np.random.default_rng(47)
    A, c, b = random_socp(rng, S=8, nc=2, n=4, m=3)
    mesh = Mesh(np.asarray(devs[:4]), ("dp",))
    res = batched(A, c, b, CFG, mesh=mesh)
    one = batched(A, c, b, CFG)
    assert len(res.ws[0].sharding.device_set) == 4
    # per-device batches reassociate the batched reductions
    np.testing.assert_allclose(np.asarray(res.y), np.asarray(one.y),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_array_equal(np.asarray(res.num_iterations),
                                  np.asarray(one.num_iterations))
