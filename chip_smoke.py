"""Bring-up check: drive conex_tpu's main paths once on one NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py                # one card, phases 0-4
    python chip_smoke.py --four-cards   # only the sharded paths, on 4 cards

Phases, in order; the first failure ends the run with a non-zero exit code:

0. device: JAX's first device must be a GPU.  Prints the card, the JAX
   version, XLA_FLAGS and the compile-cache directory.
1. main path, f64 to mu = 1e-8, through ``Program``: dense SDPs, a dense LP
   and an SOC program against the reference conex solver
   (``baseline/dump_trajectory_verbose``, a CPU binary run on the same
   instance); a large dense SDP and a complex Hermitian program against an
   f64 KKT certificate; a sparse LQR chain (supernodal KKT path, native
   clique ordering) against the dense-KKT solve of the same program.
2. batched path, ``solve_scenarios``: B=256 f32 SDPs at the fixed-iteration
   throughput shape, and a B=8 f64 batch to mu = 1e-8 checked by certificate.
3. precision: every ``algebra.mm`` mode on the n=100 SDP against phase 1's
   f64 answer, and whether a default-precision f32 product runs as TF32.
4. surfaces: one known-answer solve through ``interface.Conex`` and one
   through ``sedumi.solve_sedumi``.

Every phase prints its compile and steady seconds beside the card's name
and power limit.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REFERENCE_BIN = os.path.join(ROOT, "baseline", "dump_trajectory_verbose")

# mu target 1e-8: the reference's accuracy class (inv_sqrt_mu_max = 1e4).
ACCURATE = dict(max_iterations=100, inv_sqrt_mu_max=1e4,
                prepare_dual_variables=True)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Device
# ---------------------------------------------------------------------------


def require_gpu(devices):
    """Raise unless the first device is a GPU: this script never measures
    or checks anything on another backend."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise RuntimeError(f"chip_smoke needs a GPU; JAX's first device is {found}")
    return devices[0]


def card_line():
    """`name, power.limit` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Clock:
    """Runs a callable twice: the first call compiles, the second is the
    steady wall time.  Both end on a host transfer of the result."""

    def __init__(self, card):
        self.card = card

    def run(self, phase, label, fn):
        t0 = time.perf_counter()
        out = fn()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = fn()
        steady = time.perf_counter() - t0
        log(f"[{phase}] {label}: compile {max(first - steady, 0.0):.2f} s, "
            f"steady {steady:.3f} s (first call {first:.2f} s) "
            f"on {self.card}")
        return out


def check(label, value, tol, reason):
    """Print the tolerance with its reason; raise if value exceeds it."""
    ok = bool(np.isfinite(value)) and value <= tol
    log(f"  {'PASS' if ok else 'FAIL'} {label} = {value:.3e} <= {tol:.1e}"
        f"  ({reason})")
    if not ok:
        raise AssertionError(f"{label} = {value!r} exceeds {tol!r}")


# ---------------------------------------------------------------------------
# Instances (all made from a seed)
# ---------------------------------------------------------------------------


def sdp_instance(n, m, seed):
    """Dense SDP: maximize b'y s.t. I - sum y_i A_i PSD, b = A(X0) with X0
    interior (the reference's test_sdp.cc recipe)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 1, (m, n, n))
    A = 0.5 * (A + np.swapaxes(A, 1, 2))
    X0 = rng.uniform(-1, 1, (n, n))
    X0 = X0 @ X0.T / n + 0.1 * np.eye(n)
    return A, np.eye(n), np.einsum("vij,ij->v", A, X0)


def lp_instance(m, n, seed):
    """Dense LP with m variables and n inequalities c - A y >= 0."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 1, (n, m))
    b = A.T @ rng.uniform(0.5, 1.5, n)
    return A, rng.uniform(0.5, 1.5, n), b


def soc_instance(n, m, seed):
    """One Lorentz cone of dimension n+1 over m variables."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n + 1, m))
    x = rng.standard_normal(n + 1)
    x[0] = np.linalg.norm(x[1:]) + 1.0
    c = rng.standard_normal(n + 1)
    c[0] = np.linalg.norm(c[1:]) + 1.0
    return A, c, 2.0 * A.T @ x


def hermitian_instance(n, m, seed):
    """Complex Hermitian LMI: A (m, n, n) complex Hermitian, C = I."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 1, (m, n, n)) + 1j * rng.uniform(-1, 1, (m, n, n))
    return 0.5 * (A + np.conj(np.swapaxes(A, 1, 2))), np.eye(n)


def lqr_chain(N, nc, B, seed):
    """The reference's LQR-chain benchmark shape (assembly_test.cc
    LDLT.Benchmark2): N cliques, each holding B LMIs of order nc over the
    6-variable window starting at 3i.  Returns (A (N, B, 6, nc, nc),
    b (3N+3,), windows)."""
    from benchmarks.bench_sparse import chain_program

    A, b, _ = chain_program(N, nc, B, np.random.default_rng(seed),
                            np.float64)
    windows = [list(range(3 * i, 3 * i + 6)) for i in range(N)]
    return A, b.sum(axis=0), windows


# ---------------------------------------------------------------------------
# The reference conex solver and the KKT certificate
# ---------------------------------------------------------------------------


def write_instance(path, kind, A, c, b, config):
    """Instance file of baseline/dump_trajectory.cc (format at :7-11).
    kind "lp"/"soc": A (n, m), c (n,); kind "sdp": A (m, n, n), C (n, n)."""
    n, m = (A.shape[1], A.shape[0]) if kind == "sdp" else A.shape
    reals = " ".join(format(float(v), ".17g") for v in (
        config.divergence_upper_bound, config.inv_sqrt_mu_max,
        config.dinf_upper_bound, config.final_centering_tolerance))
    with open(path, "w") as f:
        f.write(
            f"{kind} {n} {m} {config.max_iterations} "
            f"{int(config.enable_line_search)} {int(config.enable_rescaling)} "
            f"{reals}\n"
        )
        for x in (A, c, b):
            x = np.asarray(x, np.float64)
            np.savetxt(f, x.reshape(-1, x.shape[-1]), fmt="%.17g")


class Reference:
    """Runs the reference binary on instance files, in the background, so
    the CPU solves overlap the GPU phases."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="conex_ref_")
        self.procs = {}

    def start(self, name, kind, A, c, b, config):
        inst = os.path.join(self.dir, f"{name}.txt")
        write_instance(inst, kind, A, c, b, config)
        out = open(os.path.join(self.dir, f"{name}.out"), "w")
        self.procs[name] = (subprocess.Popen(
            [REFERENCE_BIN, inst], stdout=out, stderr=subprocess.DEVNULL
        ), out)

    def result(self, name):
        proc, out = self.procs.pop(name)
        rc = proc.wait()
        out.close()
        if rc != 0:
            raise RuntimeError(f"reference solve {name} exited {rc}")
        with open(out.name) as f:
            return json.loads(f.read().strip().splitlines()[-1])

    def close(self):
        for proc, out in self.procs.values():
            proc.kill()
            proc.wait()
            out.close()
        self.procs.clear()
        shutil.rmtree(self.dir, ignore_errors=True)


def compare_with_reference(label, y, b, ref, y_tol, obj_tol, reason):
    """Both solvers report solved; y and the objective b'y agree."""
    if not ref["solved"]:
        raise AssertionError(f"{label}: the reference did not solve")
    y_ref = np.asarray(ref["y"])
    log(f"  {label}: {ref['num_iter']} reference iterations")
    check(f"{label} |y - y_ref|_inf / (1 + |y_ref|_inf)",
          np.abs(y - y_ref).max() / (1.0 + np.abs(y_ref).max()), y_tol, reason)
    check(f"{label} |b'y - b'y_ref| / (1 + |b'y_ref|)",
          abs(b @ y - b @ y_ref) / (1.0 + abs(b @ y_ref)), obj_tol, reason)


def kkt_certificate(A, C, b, y, X):
    """f64 KKT certificate of maximize b'y s.t. C - sum y_i A_i PSD, with
    dual X PSD and <A_i, X> = b_i.  Real symmetric or complex Hermitian
    matrices.  Returns the relative gap, the least eigenvalues of the
    slack and the dual (relative to their largest), and ||A'X - b||
    relative to 1 + ||b||."""
    S = C - np.einsum("v,vij->ij", y, A)
    AX = np.real(np.einsum("vij,ij->v", np.conj(A), X))
    by = float(b @ y)
    cx = float(np.real(np.sum(np.conj(C) * X)))
    es, ex = np.linalg.eigvalsh(S), np.linalg.eigvalsh(X)
    return dict(
        rel_gap=abs(cx - by) / (1.0 + abs(by)),
        slack_min=es[0] / max(es[-1], 1.0),
        dual_min=ex[0] / max(ex[-1], 1.0),
        residual=float(np.linalg.norm(AX - b) / (1.0 + np.linalg.norm(b))),
    )


def check_certificate(label, cert, gap_tol, residual_tol, reason):
    check(f"{label} relative gap", cert["rel_gap"], gap_tol, reason)
    check(f"{label} -min eig(slack)", max(-cert["slack_min"], 0.0), 1e-7,
          "slack PSD to within 10 mu at mu = 1e-8")
    check(f"{label} -min eig(dual)", max(-cert["dual_min"], 0.0), 1e-7,
          "dual PSD to within 10 mu at mu = 1e-8")
    check(f"{label} |A'x - b| / (1 + |b|)", cert["residual"], residual_tol,
          "the dual is recovered from the last Newton system")


# ---------------------------------------------------------------------------
# Phase 1: the main path in f64
# ---------------------------------------------------------------------------

# Both solvers stop at mu <= 1e-8; they take different paths there (the
# reference estimates eigenvalues by Lanczos, this rebuild by power
# iteration), so their answers agree to the optimality gap, not to rounding.
REF_REASON = "both stop at mu <= 1e-8 on different central-path iterates"
Y_TOL, OBJ_TOL = 1e-4, 1e-6


def phase1(clock, ref, sdp_shapes=((100, 50), (300, 50)), lp_shape=(200, 400),
           soc_shape=(20, 10), big_sdp=(300, 300), herm_shape=(16, 8),
           chain=(100, 8)):
    from conex_tpu import Program, SolverConfig
    from conex_tpu import native

    cfg = SolverConfig(**ACCURATE)
    answers = {}

    for n, m in sdp_shapes:
        A, C, b = sdp_instance(n, m, seed=n + m)
        ref.start(f"sdp{n}_{m}", "sdp", A, C, b, cfg)
    A_lp, c_lp, b_lp = lp_instance(*lp_shape, seed=0)
    ref.start("lp", "lp", A_lp, c_lp, b_lp, cfg)
    A_soc, c_soc, b_soc = soc_instance(*soc_shape, seed=2)
    ref.start("soc", "soc", A_soc, c_soc, b_soc, cfg)

    for n, m in sdp_shapes:
        A, C, b = sdp_instance(n, m, seed=n + m)
        prog = Program(m)
        prog.add_lmi_constraint(A, C)
        res = clock.run("phase 1", f"dense SDP n={n} m={m} f64",
                        lambda: prog.solve(b, cfg))
        if not res.solved:
            raise AssertionError(f"dense SDP n={n} m={m} did not solve")
        answers[(n, m)] = res.y
        compare_with_reference(f"SDP n={n} m={m}", res.y, b,
                               ref.result(f"sdp{n}_{m}"), Y_TOL, OBJ_TOL,
                               REF_REASON)

    prog = Program(lp_shape[0])
    prog.add_linear_constraint(A_lp, c_lp)
    res = clock.run("phase 1", f"dense LP {lp_shape[0]}x{lp_shape[1]} f64",
                    lambda: prog.solve(b_lp, cfg))
    if not res.solved:
        raise AssertionError("dense LP did not solve")
    compare_with_reference("LP", res.y, b_lp, ref.result("lp"), Y_TOL,
                           OBJ_TOL, REF_REASON)

    prog = Program(soc_shape[1])
    prog.add_soc_constraint(A_soc, c_soc)
    res = clock.run("phase 1", f"SOC n={soc_shape[0]} m={soc_shape[1]} f64",
                    lambda: prog.solve(b_soc, cfg))
    if not res.solved:
        raise AssertionError("SOC program did not solve")
    compare_with_reference("SOC", res.y, b_soc, ref.result("soc"), Y_TOL,
                           OBJ_TOL, REF_REASON)

    n, m = big_sdp
    A, C, b = sdp_instance(n, m, seed=7)
    prog = Program(m)
    prog.add_lmi_constraint(A, C)
    res = clock.run("phase 1", f"dense SDP n={n} m={m} f64 (A {A.nbytes/1e6:.0f} MB)",
                    lambda: prog.solve(b, cfg))
    if not res.solved:
        raise AssertionError(f"dense SDP n={n} m={m} did not solve")
    check_certificate(f"SDP n={n} m={m}",
                      kkt_certificate(A, C, b, res.y, prog.get_dual_variable(0)),
                      1e-6, 1e-8, "gap ~ n mu at mu = 1e-8")
    del A

    n, m = herm_shape
    A, C = hermitian_instance(n, m, seed=12)
    prog = Program(m)
    prog.add_hermitian_constraint(A, C)
    b = prog.get_feasible_objective()
    res = clock.run("phase 1", f"complex Hermitian n={n} m={m} f64",
                    lambda: prog.solve(b, cfg))
    if not res.solved:
        raise AssertionError("Hermitian program did not solve")
    W = prog.get_dual_variable(0)
    check_certificate(f"Hermitian n={n} m={m}",
                      kkt_certificate(A, C, b, res.y, W[0] + 1j * W[1]),
                      1e-6, 1e-8, "gap ~ n mu at mu = 1e-8")

    N, nc = chain
    if not native.available():
        raise AssertionError("the native clique ordering did not build")
    A, b, windows = lqr_chain(N, nc, 1, seed=0)
    n_vars = b.shape[0]
    sparse = Program(n_vars)
    dense = Program(n_vars)
    A_full = np.zeros((N, n_vars, nc, nc))
    for i, win in enumerate(windows):
        sparse.add_lmi_constraint(A[i, 0], np.eye(nc), variables=win)
        A_full[i, win] = A[i, 0]
    dense.add_lmi_constraint(A_full, np.broadcast_to(np.eye(nc), (N, nc, nc)))
    kind = type(sparse._kkt_structure()).__name__
    res = clock.run("phase 1", f"LQR chain N={N} nc={nc} f64, {kind} KKT",
                    lambda: sparse.solve(b, cfg))
    res_d = clock.run("phase 1", f"LQR chain N={N} nc={nc} f64, dense KKT",
                      lambda: dense.solve(b, cfg))
    if not (res.solved and res_d.solved):
        raise AssertionError("the LQR chain did not solve on both KKT paths")
    check(f"LQR chain |y - y_dense|_inf / (1 + |y_dense|_inf)",
          np.abs(res.y - res_d.y).max() / (1.0 + np.abs(res_d.y).max()),
          1e-6, "same program to mu 1e-8; only the KKT factorization differs")
    return answers


# ---------------------------------------------------------------------------
# Phase 2: the batched path
# ---------------------------------------------------------------------------


def batched_sdp(B, n, m, dtype, seed=0):
    """bench.py's workload: B independent SDPs, one n x n LMI each."""
    import jax.numpy as jnp

    from conex_tpu.cones.psd import DenseLMICone, make_psd_state

    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 1, (B, 1, m, n, n)).astype(dtype)
    A = 0.5 * (A + np.swapaxes(A, 3, 4))
    C = np.broadcast_to(np.eye(n, dtype=dtype), (B, 1, n, n)).copy()
    X0 = rng.uniform(-1, 1, (B, 1, n, n)).astype(dtype)
    X0 = np.einsum("sbij,sbkj->sbik", X0, X0) + 0.1 * np.eye(n, dtype=dtype)
    b = np.einsum("sbvij,sbij->sv", A, X0).astype(dtype)
    blk = DenseLMICone(A=jnp.asarray(A), C=jnp.asarray(C))
    ws = (make_psd_state(jnp.broadcast_to(jnp.eye(n, dtype=dtype),
                                          (B, 1, n, n))),)
    scalars = dict(k=jnp.zeros((B,), dtype), b_scaling=jnp.ones((B,), dtype),
                   c_scaling=jnp.ones((B,), dtype))
    return (blk,), (), jnp.asarray(b), ws, scalars, (A, C, b)


# bench.py's throughput configuration: exactly `iters` Newton iterations,
# scaled mu held >= 1e-4 so the f32 Schur complement stays factorable.
def fixed_config(iters=30):
    from conex_tpu import SolverConfig

    return SolverConfig(max_iterations=iters, final_centering_steps=0,
                        inv_sqrt_mu_max=1e15, fixed_iterations=True,
                        inv_sqrt_mu_cap_scaled=100.0)


def check_fixed_run(res, B, iters):
    """bench.py's validity rule: every scenario completes exactly `iters`
    iterations with no factorization failure."""
    n_iters = np.asarray(res.num_iterations)
    fails = int(np.asarray(res.fail).sum())
    log(f"  iterations per scenario: min {n_iters.min()} max {n_iters.max()},"
        f" factorization failures {fails}/{B}")
    if fails or not (n_iters == iters).all():
        raise AssertionError("invalid fixed-iteration run")


def phase2(clock, device, big=(256, 100, 50), small=(8, 100, 50)):
    import jax

    from conex_tpu import SolverConfig
    from conex_tpu.parallel.sharded import _scenario_solver, solve_scenarios

    B, n, m = big
    blocks, eqs, b, ws, sc, _ = batched_sdp(B, n, m, np.float32)
    cfg = fixed_config()

    def run():
        res = solve_scenarios(blocks, eqs, b, ws, sc, cfg)
        float(np.asarray(res.y).sum())
        return res

    res = clock.run("phase 2", f"solve_scenarios B={B} n={n} m={m} f32, "
                    "30 fixed iterations", run)
    check_fixed_run(res, B, 30)
    stats = device.memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    # After the run, so the compile below is served by the persistent cache.
    compiled = _scenario_solver(cfg).lower(blocks, eqs, b, ws, sc).compile()
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    del blocks, ws, res, compiled

    B, n, m = small
    blocks, eqs, b, ws, sc, (A, C, b_np) = batched_sdp(B, n, m, np.float64,
                                                      seed=1)
    cfg = SolverConfig(**ACCURATE)
    res = clock.run(
        "phase 2", f"solve_scenarios B={B} n={n} m={m} f64 to mu 1e-8",
        lambda: jax.block_until_ready(
            solve_scenarios(blocks, eqs, b, ws, sc, cfg)),
    )
    if not np.asarray(res.solved).all():
        raise AssertionError("an f64 scenario did not solve")
    X = np.asarray(res.ws[0].w)
    scale = np.asarray(res.k) * np.asarray(res.b_scaling)
    worst = {}
    for s in range(B):
        cert = kkt_certificate(A[s, 0], C[s, 0], b_np[s],
                               np.asarray(res.y)[s], X[s, 0] / scale[s])
        for key, v in cert.items():
            v = -v if key in ("slack_min", "dual_min") else v
            worst[key] = max(worst.get(key, -np.inf), v)
    check_certificate(
        f"B={B} batch (worst scenario)",
        dict(rel_gap=worst["rel_gap"], slack_min=-worst["slack_min"],
             dual_min=-worst["dual_min"], residual=worst["residual"]),
        1e-6, 1e-8, "gap ~ n mu at mu = 1e-8")


# ---------------------------------------------------------------------------
# Phase 3: precision modes
# ---------------------------------------------------------------------------

# Per-mode tolerance on |b'y - b'y_f64| / (1 + |b'y_f64|) against phase 1's
# f64 answer (mu 1e-8).  The f32 modes solve f32 data with the KKT factor in
# f64 and scaled mu held >= 1e-6, so their objective error is set by that mu
# (1.2e-3 with true f32 products on this instance), not by the mode.
F32_REASON = "f32 data, scaled mu >= 1e-6 bounds the error near 1e-3; "
MODE_TOL = dict(
    default=(1e-2, F32_REASON + "products may run as TF32"),
    x3=(1e-2, F32_REASON + "bf16x3 products"),
    x6=(1e-2, F32_REASON + "bf16x6 products"),
    highest=(1e-2, F32_REASON + "full f32 products"),
    float32=(1e-2, F32_REASON + "full f32 products"),
    ozaki=(OBJ_TOL, "f64 data at mu 1e-8; exact bf16 slices summed in f64"),
)


def schur_panel_error(n=100, m=50, seed=5):
    """Relative error of the default-precision f32 Schur panel A W against
    Precision.HIGHEST on the same f32 inputs."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.uniform(-1, 1, (m, n, n)), jnp.float32)
    W = jnp.asarray(rng.uniform(-1, 1, (n, n)), jnp.float32)
    lo = jax.jit(lambda a, w: jnp.einsum("vij,jk->vik", a, w))(A, W)
    hi = jax.jit(lambda a, w: jnp.einsum(
        "vij,jk->vik", a, w, precision=jax.lax.Precision.HIGHEST))(A, W)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    return float(np.linalg.norm(lo - hi) / np.linalg.norm(hi))


def phase3(clock, answers, shape=(100, 50)):
    from conex_tpu import Program, SolverConfig
    from conex_tpu.algebra.mm import MODES

    n, m = shape
    A, C, b = sdp_instance(n, m, seed=n + m)
    y64 = answers[shape]
    for mode in MODES:
        tol, reason = MODE_TOL[mode]
        if mode == "ozaki":
            prog = Program(m)
            cfg = SolverConfig(**ACCURATE, schur_precision=mode)
        else:
            prog = Program(m, dtype=np.float32)
            cfg = SolverConfig(**ACCURATE, schur_precision=mode,
                               inv_sqrt_mu_cap_scaled=1000.0,
                               kkt_island_dtype="float64")
        prog.add_lmi_constraint(A, C)
        res = clock.run("phase 3", f"mode {mode} n={n} m={m} "
                        f"{'f64' if mode == 'ozaki' else 'f32'}",
                        lambda: prog.solve(b, cfg))
        log(f"  mode {mode}: solved={res.solved} "
            f"iterations={res.num_iterations}")
        if not np.all(np.isfinite(res.y)):
            raise AssertionError(f"mode {mode}: non-finite y")
        check(f"mode {mode} objective error",
              abs(b @ res.y - b @ y64) / (1.0 + abs(b @ y64)), tol, reason)
    err = schur_panel_error(n, m)
    kind = "TF32 class (~1e-3)" if err > 1e-5 else "f32 class (~1e-7)"
    log(f"[phase 3] default-precision f32 Schur panel vs HIGHEST: relative "
        f"error {err:.3e} -> {kind}")


# ---------------------------------------------------------------------------
# Phase 4: the user-facing surfaces
# ---------------------------------------------------------------------------


def phase4(clock):
    from conex_tpu.interface import Conex
    from conex_tpu.sedumi import solve_sedumi

    # maximize y1 + 2 y2 s.t. y1 <= 2, y2 <= 3, y1 + y2 <= 4: optimum (1, 3)
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    c = np.array([2.0, 3.0, 4.0])
    b = np.array([1.0, 2.0])

    def conex():
        prog = Conex(2)
        prog.AddLinearInequality(A, c)
        return prog.Maximize(b)

    sol = clock.run("phase 4", "interface.Conex LP", conex)
    if not sol.status:
        raise AssertionError("Conex did not solve")
    check("Conex |y - (1, 3)|_inf", np.abs(np.asarray(sol.y) - [1.0, 3.0]).max(),
          1e-5, "unique vertex optimum, default accuracy mu ~ 1e-6")

    # minimize x1 + 2 x2 s.t. x1 + x2 = 1, x >= 0: optimum x = (1, 0)
    x, y, info = clock.run(
        "phase 4", "sedumi.solve_sedumi LP",
        lambda: solve_sedumi(np.array([[1.0, 1.0]]), np.array([1.0]),
                             np.array([1.0, 2.0]), dict(l=2)),
    )
    if not info["solved"]:
        raise AssertionError("solve_sedumi did not solve")
    check("sedumi |x - (1, 0)|_inf", np.abs(x - [1.0, 0.0]).max(), 1e-5,
          "unique vertex optimum, default accuracy mu ~ 1e-6")


# ---------------------------------------------------------------------------
# --four-cards: the sharded paths against one card
# ---------------------------------------------------------------------------


def four_cards(clock, devices, big=(256, 100, 50), chain=(16, 8)):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from conex_tpu import Program, SolverConfig
    from conex_tpu.parallel.sharded import solve_cone_sharded, solve_scenarios
    from conex_tpu.supernodal.dist_compressed import (
        DistributedCompressedStructure,
    )

    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devices)}")
    devices = devices[:4]

    # Phase 2's shape in f32 with 30 fixed iterations (the throughput
    # configuration), and in f64 solved to mu 1e-8.  The fixed-iteration y
    # depends on the step sizes, which the eigenvalue sweeps estimate with
    # f32 products (TF32 on the card), and per-card kernel choices round
    # differently; so the f32 runs are compared on the first Newton step,
    # and the f64 runs on the converged y, which is unique: a misplaced
    # scenario is an O(1) error.
    B, n, m = big
    mesh = Mesh(np.asarray(devices), ("dp",))
    for dtype, label in ((np.float32, "f32"), (np.float64, "f64")):
        blocks, eqs, b, ws, sc, _ = batched_sdp(B, n, m, dtype)
        f32 = dtype == np.float32
        # Some of the 256 random instances need close to 100 iterations.
        cfg = (fixed_config() if f32
               else SolverConfig(**dict(ACCURATE, max_iterations=200)))

        def run(mesh):
            return jax.block_until_ready(
                solve_scenarios(blocks, eqs, b, ws, sc, cfg, mesh=mesh))

        what = "30 fixed iterations" if f32 else "to mu 1e-8"
        one = clock.run("4 cards", f"solve_scenarios B={B} n={n} m={m} "
                        f"{label} {what} on one card", lambda: run(None))
        dp = clock.run("4 cards", f"solve_scenarios B={B} n={n} m={m} "
                       f"{label} {what} over dp=4", lambda: run(mesh))
        if f32:
            check_fixed_run(dp, B, 30)
        placed = len(dp.ws[0].w.sharding.device_set)
        log(f"  dp result iterates live on {placed} devices")
        if placed != 4:
            raise AssertionError("the dp solve did not spread over 4 devices")
        y1, y4 = np.asarray(one.y), np.asarray(dp.y)
        log(f"  {label} final |y|_inf relative difference "
            f"{np.abs(y4 - y1).max() / (1.0 + np.abs(y1).max()):.3e}")
        s1, s4 = np.asarray(one.solved), np.asarray(dp.solved)
        log(f"  {label} solved: one card {s1.sum()}/{B}, dp=4 {s4.sum()}/{B},"
            f" both {(s1 & s4).sum()}")
        if f32:
            k1 = np.asarray(one.stats_k)[:, 0]
            k4 = np.asarray(dp.stats_k)[:, 0]
            check("dp=4 vs one card f32, first-step k relative",
                  np.abs(k4 - k1).max() / np.abs(k1).max(), 1e-3,
                  "one Newton step: f32 sums reassociate per card")
        else:
            # A random instance can stall short of mu 1e-8; the comparison
            # is over those solved on both.
            both = s1 & s4
            check("f64 share of scenarios not solved on both",
                  1.0 - both.mean(), 0.1, "some random instances stall")
            check("dp=4 vs one card f64 |y|_inf relative, solved on both",
                  np.abs(y4 - y1)[both].max()
                  / (1.0 + np.abs(y1[both]).max()), Y_TOL, REF_REASON)
        del blocks, ws, one, dp

    N, nc = chain
    A, b_chain, windows = lqr_chain(N, nc, 4, seed=3)
    prog = Program(b_chain.shape[0])
    for i, win in enumerate(windows):
        prog.add_lmi_constraint(A[i], np.broadcast_to(np.eye(nc), (4, nc, nc)),
                                variables=win)
    acc = SolverConfig(**ACCURATE)
    ref = clock.run("4 cards", f"LQR chain N={N} nc={nc} x4 LMIs f64, one "
                    "card", lambda: prog.solve(b_chain, acc))
    if not ref.solved:
        raise AssertionError("the one-card LQR chain did not solve")
    blocks = tuple(prog._blocks)
    init_ws = tuple(blk.identity_state(jnp.float64) for blk in blocks)
    scalars = dict(k=jnp.zeros((), jnp.float64),
                   b_scaling=jnp.ones((), jnp.float64),
                   c_scaling=jnp.ones((), jnp.float64))
    dstruct = DistributedCompressedStructure.from_cliques(
        windows, b_chain.shape[0], 4)
    tp = Mesh(np.asarray(devices), ("tp",))
    res = clock.run(
        "4 cards", f"LQR chain N={N} nc={nc} f64 over tp=4, distributed "
        "compressed KKT",
        lambda: jax.block_until_ready(solve_cone_sharded(
            blocks, (), jnp.asarray(b_chain), init_ws, scalars, acc, tp,
            kkt_structure=dstruct)),
    )
    placed = len(res.ws[0].w.sharding.device_set)
    log(f"  tp result iterates live on {placed} devices")
    if placed != 4:
        raise AssertionError("the tp solve did not spread over 4 devices")
    if not bool(res.solved):
        raise AssertionError("the tp=4 LQR chain did not solve")
    y = np.asarray(res.y)
    check("tp=4 vs one card |y|_inf relative",
          np.abs(y - ref.y).max() / (1.0 + np.abs(ref.y).max()), 1e-6,
          "both solve to mu 1e-8; psum reassociates the Schur sums")


# ---------------------------------------------------------------------------


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded paths on 4 cards")
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    from conex_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devices = jax.devices()
    device = require_gpu(devices)
    card = card_line()
    log(f"[phase 0] device_kind {device.device_kind}, {len(devices)} "
        f"device(s), JAX {jax.__version__}")
    log(f"[phase 0] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[phase 0] compile cache {cache}")
    log(f"[phase 0] nvidia-smi: {card}")
    clock = Clock(card)
    t0 = time.perf_counter()

    if args.four_cards:
        four_cards(clock, devices)
    else:
        ref = Reference()
        try:
            answers = phase1(clock, ref)
        finally:
            ref.close()
        phase2(clock, device)
        phase3(clock, answers)
        phase4(clock)

    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
