"""Accuracy at speed: reference-grade (mu <= 1e-8) f64 solves on the card.

The reference is float64 end-to-end (/root/reference/conex/cone_program.cc);
BASELINE.md's parity bar is "match conex within its reported optimality gap".
Every BASELINE.json workload family is solved in float64 on the GPU, driven
to mu = 1e-8 (inv_sqrt_mu_max = 1e4), with the duality gap, primal/dual
feasibility residuals, and steady-state wall time recorded.  Prints one
JSON line per workload.  Fails when JAX's first device is not a GPU.

Usage: python benchmarks/bench_accuracy.py [workload ...]
  workloads: lp sdp socp hermitian (default: all)
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MU_TARGET = 1e-8  # reference-grade accuracy: inv_sqrt_mu_max = 1e4


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn, reps=3):
    fn()  # compile / warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def gap_stats(by, cx, b, Ax):
    """Relative duality gap and dual-feasibility residual."""
    rel_gap = abs(cx - by) / (1.0 + abs(by))
    dual_res = float(np.linalg.norm(Ax - b) / (1.0 + np.linalg.norm(b)))
    return rel_gap, dual_res


def run_lp():
    """BASELINE.json config 1: dense LP, 200 vars x 400 ineqs, 1e-8 gap."""
    import jax.numpy as jnp
    from conex_tpu import Program, SolverConfig

    rng = np.random.default_rng(0)
    m, n = 200, 400
    A = rng.uniform(-1, 1, (n, m))
    x0 = rng.uniform(0.5, 1.5, n)
    b = A.T @ x0
    c = rng.uniform(0.5, 1.5, n)

    prog = Program(m, dtype=jnp.float64)
    prog.add_linear_constraint(A, c)
    cfg = SolverConfig(
        max_iterations=100,
        inv_sqrt_mu_max=1.0 / np.sqrt(MU_TARGET),
        prepare_dual_variables=True,
    )
    res = prog.solve(b, cfg)
    assert res.solved, "LP did not solve"
    y = res.y
    x = prog.get_dual_variable(0)
    slack = c - A @ y
    by = float(b @ y)
    cx = float(c @ x)
    rel_gap, dual_res = gap_stats(by, cx, b, A.T @ x)
    t = timed(lambda: prog.solve(b, cfg))
    return dict(
        workload="dense LP 200x400 (f64)",
        solved=bool(res.solved),
        iters=int(res.num_iterations),
        mu_final=float(1.0 / res.stats_inv_sqrt_mu[-1] ** 2),
        rel_gap=rel_gap,
        primal_feas=float(slack.min()),
        dual_res=dual_res,
        wall_s=round(t, 4),
        newton_iters_per_sec=round(res.num_iterations / t, 1),
    )


def run_sdp():
    """BASELINE.json config 3: dense 100x100 LMI, m=50, 1e-8 gap."""
    import jax.numpy as jnp
    from conex_tpu import Program, SolverConfig

    rng = np.random.default_rng(1)
    n, m = 100, 50
    A = np.stack([0.5 * (M + M.T) for M in rng.uniform(-1, 1, (m, n, n))])
    C = np.eye(n) * 1.0
    X0 = rng.uniform(-1, 1, (n, n))
    X0 = X0 @ X0.T / n + 0.1 * np.eye(n)
    b = np.einsum("vij,ij->v", A, X0)

    prog = Program(m, dtype=jnp.float64)
    prog.add_lmi_constraint(A, C)
    cfg = SolverConfig(
        max_iterations=100,
        inv_sqrt_mu_max=1.0 / np.sqrt(MU_TARGET),
        prepare_dual_variables=True,
    )
    res = prog.solve(b, cfg)
    assert res.solved, "SDP did not solve"
    y = res.y
    X = prog.get_dual_variable(0)
    S = C - np.einsum("vij,v->ij", A, y)
    by = float(b @ y)
    cx = float(np.sum(C * X))
    Ax = np.einsum("vij,ij->v", A, X)
    rel_gap, dual_res = gap_stats(by, cx, b, Ax)
    t = timed(lambda: prog.solve(b, cfg))
    return dict(
        workload="dense SDP n=100 m=50 (f64)",
        solved=bool(res.solved),
        iters=int(res.num_iterations),
        mu_final=float(1.0 / res.stats_inv_sqrt_mu[-1] ** 2),
        rel_gap=rel_gap,
        primal_feas=float(np.linalg.eigvalsh(S).min()),
        dual_feas=float(np.linalg.eigvalsh(X).min()),
        dual_res=dual_res,
        wall_s=round(t, 4),
        newton_iters_per_sec=round(res.num_iterations / t, 1),
    )


def run_socp():
    """BASELINE.json config 2: 1k-scenario batched SOCP, f64, 1e-8 gap."""
    import jax
    import jax.numpy as jnp
    from conex_tpu import SolverConfig
    from conex_tpu.cones.soc import SOCCone
    from conex_tpu.parallel.sharded import solve_scenarios

    rng = np.random.default_rng(2)
    S, n, m = 1000, 20, 10
    A = rng.standard_normal((S, 1, n + 1, m))
    x = rng.standard_normal((S, 1, n + 1))
    x[..., 0] = np.linalg.norm(x[..., 1:], axis=-1) + 1.0
    b = 2.0 * np.einsum("scnv,scn->sv", A, x)
    c = rng.standard_normal((S, 1, n + 1))
    c[..., 0] = np.linalg.norm(c[..., 1:], axis=-1) + 1.0

    blk = SOCCone(A=jnp.asarray(A), c=jnp.asarray(c))
    init_ws = (jnp.zeros((S, 1, n + 1)).at[:, :, 0].set(1.0),)
    scalars = dict(
        k=jnp.zeros((S,)), b_scaling=jnp.ones((S,)), c_scaling=jnp.ones((S,))
    )
    cfg = SolverConfig(
        max_iterations=60,
        inv_sqrt_mu_max=1.0 / np.sqrt(MU_TARGET),
        prepare_dual_variables=True,
    )

    def run():
        out = solve_scenarios((blk,), (), jnp.asarray(b), init_ws, scalars, cfg)
        jax.block_until_ready(out.k)
        return out

    res = run()
    solved = np.asarray(res.solved)
    assert solved.all(), f"{(~solved).sum()} scenarios unsolved"
    y = np.asarray(res.y)
    w = np.asarray(res.ws[0])
    k = np.asarray(res.k)
    b_sc = np.asarray(res.b_scaling)
    xd = 2.0 * w / (k * b_sc)[:, None, None]
    slack = c - np.einsum("scnv,sv->scn", A, y)
    margins = slack[..., 0] - np.linalg.norm(slack[..., 1:], axis=-1)
    by = np.einsum("sv,sv->s", b, y)
    cxs = np.einsum("scn,scn->s", c, xd)
    rel_gap = float(np.max(np.abs(cxs - by) / (1.0 + np.abs(by))))
    r = np.einsum("scnv,scn->sv", A, xd) - b
    dual_res = float(
        np.max(np.linalg.norm(r, axis=-1) / (1.0 + np.linalg.norm(b, axis=-1)))
    )
    total_iters = int(np.asarray(res.num_iterations).sum())
    t = timed(run)
    mu_final = float(np.max(1.0 / np.asarray(res.k) ** 2))
    return dict(
        workload="batched SOCP S=1000 n=20 m=10 (f64)",
        solved=bool(solved.all()),
        iters=total_iters,
        mu_final=mu_final,
        rel_gap=rel_gap,
        primal_feas=float(margins.min()),
        dual_res=dual_res,
        wall_s=round(t, 4),
        newton_iters_per_sec=round(total_iters / t, 1),
    )


def run_hermitian():
    """BASELINE.json config 4: complex + quaternion Hermitian PSD cones."""
    import jax.numpy as jnp
    from conex_tpu import Program, SolverConfig

    def rand_hermitian(d, n, rng):
        x = rng.uniform(-1, 1, (d, n, n))
        x[0] = 0.5 * (x[0] + x[0].T)
        for i in range(1, d):
            x[i] = 0.5 * (x[i] - x[i].T)
        return x

    out = {}
    for dim, name in ((2, "complex"), (4, "quaternion")):
        rng = np.random.default_rng(10 + dim)
        n, m = 16, 8
        A = np.stack(
            [rand_hermitian(dim, n, rng) for _ in range(m)]
        )  # (m, d, n, n)
        C = np.zeros((dim, n, n))
        C[0] = np.eye(n)
        prog = Program(m, dtype=jnp.float64)
        prog.add_hermitian_constraint(A, C)
        b = prog.get_feasible_objective()
        cfg = SolverConfig(
            max_iterations=100, inv_sqrt_mu_max=1.0 / np.sqrt(MU_TARGET)
        )
        res = prog.solve(b, cfg)
        assert res.solved, f"hermitian[{name}] did not solve"
        t = timed(lambda: prog.solve(b, cfg))
        out[name] = dict(
            iters=int(res.num_iterations),
            mu_final=float(1.0 / res.stats_inv_sqrt_mu[-1] ** 2),
            wall_s=round(t, 4),
        )
    return dict(
        workload="Hermitian PSD n=16 m=8 complex+quaternion (f64)",
        solved=True,
        **{f"{k}_{kk}": vv for k, v in out.items() for kk, vv in v.items()},
    )


def run_sdp_batched():
    """Reference-grade accuracy at speed — a batch of B=8 independent
    n=100 m=50 SDPs, f64 on the card, driven to mu ~ 6e-10
    (inv_sqrt_mu_max=4e4), rel_gap per scenario, against the measured
    single-core CPU baseline (30.6 Newton iters/s,
    baseline/BASELINE_MEASURED.json), which cannot batch."""
    import jax
    import jax.numpy as jnp

    from conex_tpu.config import SolverConfig
    from conex_tpu.cones.psd import DenseLMICone, make_psd_state
    from conex_tpu.parallel.sharded import solve_scenarios

    n, m, B = 100, 50, 8
    rng = np.random.default_rng(1)
    A = rng.uniform(-1, 1, (B, 1, m, n, n))
    A = 0.5 * (A + np.swapaxes(A, 3, 4))
    C = np.broadcast_to(np.eye(n), (B, 1, n, n)).copy()
    X0 = rng.uniform(-1, 1, (B, 1, n, n))
    X0 = np.einsum("sbij,sbkj->sbik", X0, X0) / n + 0.1 * np.eye(n)
    b = np.einsum("sbvij,sbij->sv", A, X0)
    blk = DenseLMICone(A=jnp.asarray(A), C=jnp.asarray(C))
    ws = (make_psd_state(jnp.broadcast_to(jnp.eye(n), (B, 1, n, n))),)
    sc = dict(k=jnp.zeros((B,)), b_scaling=jnp.ones((B,)),
              c_scaling=jnp.ones((B,)))
    cfg = SolverConfig(max_iterations=120, inv_sqrt_mu_max=4e4,
                       prepare_dual_variables=True)

    def run():
        return jax.block_until_ready(
            solve_scenarios((blk,), (), jnp.asarray(b), ws, sc, cfg))

    r = run()
    assert int(np.asarray(r.solved).sum()) == B
    best = timed(run)
    X = np.asarray(r.ws[0].w)
    k = np.asarray(r.k)
    bsc = np.asarray(r.b_scaling)
    ys = np.asarray(r.y)
    gaps, pfeas, dfeas = [], [], []
    for s_ in range(B):
        Xs = X[s_, 0] / (k[s_] * bsc[s_])
        by = b[s_] @ ys[s_]
        cx = np.sum(C[s_, 0] * Xs)
        gaps.append(abs(cx - by) / (1 + abs(by)))
        Sm = C[s_, 0] - np.einsum("vij,v->ij", A[s_, 0], ys[s_])
        pfeas.append(float(np.linalg.eigvalsh(Sm).min()))
        dfeas.append(float(np.linalg.eigvalsh(Xs).min()))
    iters = np.asarray(r.num_iterations)
    tot = int(iters.sum())
    base = 30.6
    return dict(
        workload=f"dense SDP n={n} m={m} x B={B} batched (f64, "
                 "mu target 6.25e-10)",
        solved=True,
        iters_min=int(iters.min()),
        iters_max=int(iters.max()),
        max_rel_gap=float(f"{max(gaps):.3e}"),
        min_primal_slack_eig=float(f"{min(pfeas):.3e}"),
        min_dual_eig=float(f"{min(dfeas):.3e}"),
        wall_s=round(best, 3),
        newton_iters_per_sec=round(tot / best, 1),
        vs_cpu_baseline=round(tot / best / base, 2),
    )


def main():
    import jax

    from chip_smoke import card_line, require_gpu
    from conex_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    device = require_gpu(jax.devices())
    card = card_line()

    runners = dict(lp=run_lp, sdp=run_sdp, sdp_batched=run_sdp_batched,
                   socp=run_socp, hermitian=run_hermitian)
    for name in sys.argv[1:] or list(runners):
        t0 = time.time()
        r = runners[name]()
        log(f"{name}: done in {time.time() - t0:.1f}s (incl. compile)")
        print(json.dumps(dict(r, mu_target=MU_TARGET,
                              device=device.device_kind, card=card)),
              flush=True)


if __name__ == "__main__":
    main()
