"""Lockstep trajectory parity against the actual reference solver.

Runs the reference conex C++ solver (baseline/dump_trajectory.cc, committed
as baseline/dump_trajectory_verbose) and conex_tpu
on the *same* LP instance with the same configuration, and compares the
per-iteration sqrt(1/mu) trajectory and the final solution.  For LPs the
two implementations evaluate identical closed-form arithmetic in f64, so
the trajectories must agree to near machine precision — the strongest
parity statement available (SURVEY.md §7 hard part #1).
"""

import json
import os
import subprocess

import numpy as np
import pytest

from chip_smoke import REFERENCE_BIN, write_instance
from conex_tpu import Program, SolverConfig



@pytest.fixture(scope="module", autouse=True)
def reference_binary():
    if not os.access(REFERENCE_BIN, os.X_OK):
        pytest.fail(f"reference binary {REFERENCE_BIN} is missing or not "
                    "executable")
    return REFERENCE_BIN


def run_reference(A, c, b, config: SolverConfig, tmp_path, kind="lp"):
    inst = tmp_path / "instance.txt"
    write_instance(inst, kind, A, c, b, config)
    out = subprocess.run(
        [REFERENCE_BIN, str(inst)], capture_output=True, text=True, check=True
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("line_search", [False, True])
def test_lp_trajectory_lockstep(line_search, tmp_path):
    rng = np.random.default_rng(3)
    n, m = 12, 5
    A = rng.uniform(-1, 1, (n, m))
    c = np.abs(rng.uniform(-1, 1, n)) + 0.2
    x0 = np.abs(rng.uniform(-1, 1, n))
    x0 *= 0.05 / np.linalg.norm(x0)
    b = A.T @ x0

    config = SolverConfig(
        max_iterations=20,
        enable_line_search=line_search,
        divergence_upper_bound=1.0,
        inv_sqrt_mu_max=1000.0,
        dinf_upper_bound=1.0 if not line_search else 1.35,
        final_centering_tolerance=0.01,
    )

    ref = run_reference(A, c, b, config, tmp_path)

    prog = Program(m)
    prog.add_linear_constraint(A, c)
    res = prog.solve(b, config)

    assert res.num_iterations == ref["num_iter"], (
        f"iteration count {res.num_iterations} vs reference {ref['num_iter']}"
    )
    np.testing.assert_allclose(
        res.stats_inv_sqrt_mu,
        np.asarray(ref["sqrt_inv_mu"]),
        rtol=1e-8,
        err_msg="sqrt_inv_mu trajectories diverge",
    )
    # (the reference never populates its norm_inf_d stat — always zero —
    # so only the mu trajectory is comparable)
    assert bool(res.solved) == bool(ref["solved"])
    np.testing.assert_allclose(res.y, np.asarray(ref["y"]), rtol=1e-7,
                               atol=1e-9)


def test_sdp_solution_parity(tmp_path):
    """SDP: eigenvalue estimators legitimately differ (reference uses
    truncated Lanczos, conex_tpu the exact squaring estimator), so
    trajectories may drift — but both must converge to the same solution
    within the optimality gap."""
    rng = np.random.default_rng(4)
    n, m = 8, 4
    A = np.stack([0.5 * (M + M.T) for M in rng.uniform(-1, 1, (m, n, n))])
    C = np.eye(n) * (n + 1.0)
    X0 = rng.uniform(-1, 1, (n, n))
    X0 = X0 @ X0.T + 0.1 * np.eye(n)
    b = np.einsum("vij,ij->v", A, X0)

    config = SolverConfig(max_iterations=40, inv_sqrt_mu_max=1000.0)
    ref = run_reference(A, C, b, config, tmp_path, kind="sdp")

    prog = Program(m)
    prog.add_lmi_constraint(A, C)
    res = prog.solve(b, config)

    assert bool(res.solved) and bool(ref["solved"])
    np.testing.assert_allclose(res.y, np.asarray(ref["y"]), atol=2e-5)
