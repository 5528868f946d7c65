"""Sparse/supernodal benchmark on one GPU: LQR-chain-style sparse SDP.

The counterpart of the reference's sparse assembly benchmark
(/root/reference/conex/test/assembly_test.cc, LDLT.Benchmark2): a chain
of N LMI cliques of order nc, clique i over the 6-variable window
starting at 3i (overlap 3).  Solved end-to-end (assembly + supernodal
factorization + solves) through the block-compressed supernodal path,
one instance per solve, vs the reference single-core
(baseline/bench_reference sparse N nc — same generator shape, fixed 30
Newton iterations both sides).

Also records the compile times of the scan/compressed structure vs the
per-clique unrolled structure (the SURVEY §5.7 long-context analogue).

Prints one JSON row per chain length.  Run: python benchmarks/bench_sparse.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def chain_program(N, nc, B, rng, dtype):
    """B instances of the N-clique chain; returns (blocks, b, n_vars)."""
    w = 6
    n_vars = 3 * N + w - 3
    # One cone block per clique, each holding B batched LMIs of order nc
    # over its 6-variable window.
    A = rng.uniform(-1, 1, (N, B, w, nc, nc)).astype(dtype)
    A = 0.5 * (A + np.swapaxes(A, 3, 4))
    X0 = rng.uniform(-1, 1, (N, B, nc, nc)).astype(dtype)
    X0 = (np.einsum("sbij,sbkj->sbik", X0, X0) / nc
          + 0.1 * np.eye(nc, dtype=dtype))
    b = np.zeros((B, n_vars), dtype)
    for i in range(N):
        contrib = np.einsum("bvij,bij->bv", A[i], X0[i])
        b[:, 3 * i:3 * i + w] += contrib
    return A, b, n_vars


def solve_chain(N, nc, B, iters=30, scan_structure=True):
    from conex_tpu import Program, SolverConfig
    from conex_tpu import program as program_mod

    dtype = np.float32
    rng = np.random.default_rng(0)
    A, b, n_vars = chain_program(N, nc, B, rng, dtype)

    # Build one Program whose cone blocks carry the B-instance batch.
    old_thresh = program_mod.SCAN_CLIQUE_THRESHOLD
    program_mod.SCAN_CLIQUE_THRESHOLD = 0 if scan_structure else 10 ** 9
    try:
        prog = Program(n_vars, dtype=dtype)
        w = 6
        eyeC = np.broadcast_to(np.eye(nc, dtype=dtype), (B, nc, nc)).copy()
        for i in range(N):
            prog.add_lmi_constraint(
                A[i], eyeC,
                variables=list(range(3 * i, 3 * i + w)),
            )
        # One instance per solve (B=1), exactly the reference's program
        # shape — the device's parallelism comes from the batched
        # per-clique cone kernels and the supernodal scan, not scenario
        # batching.
        cfg = SolverConfig(
            max_iterations=iters, final_centering_steps=0,
            inv_sqrt_mu_max=1e15, fixed_iterations=True,
            inv_sqrt_mu_cap_scaled=100.0,
        )
        t0 = time.perf_counter()
        prog.solve(b[0], cfg)  # Program.solve returns host arrays
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            r = prog.solve(b[0], cfg)
            best = min(best, time.perf_counter() - t0)
        it = int(np.asarray(r.num_iterations))
        fail = bool(np.asarray(r._raw.fail))
        return dict(
            iters=it, fail=fail, seconds=best,
            iters_per_sec=round(it / best, 1),
            compile_seconds=round(compile_s, 1),
            structure="compressed-scan" if scan_structure else "unrolled",
        )
    finally:
        program_mod.SCAN_CLIQUE_THRESHOLD = old_thresh


def reference_rate(N, nc):
    exe = os.path.join(ROOT, "baseline", "bench_reference")
    try:
        out = subprocess.run(
            ["taskset", "-c", "0", exe, "sparse", str(N), str(nc), "3", "1"],
            capture_output=True, text=True, timeout=600,
        )
        return json.loads(out.stdout.strip().splitlines()[-1])
    except Exception as e:  # pragma: no cover
        log(f"reference run failed: {e}")
        return None


def main():
    import jax

    from chip_smoke import card_line, require_gpu
    from conex_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = require_gpu(jax.devices())
    card = card_line()
    for (N, nc) in [(40, 8), (200, 8)]:
        ref = reference_rate(N, nc)
        log(f"reference N={N}: {ref}")
        row = dict(cliques=N, order=nc, num_vars=3 * N + 3, ref=ref,
                   device=device.device_kind, card=card)
        row["compressed"] = solve_chain(N, nc, 1, scan_structure=True)
        if N <= 40:
            # The unrolled structure's compile time scales with clique
            # count; only feasible at small N (that's the point).
            row["unrolled"] = solve_chain(N, nc, 1, scan_structure=False)
        if ref and not row["compressed"]["fail"]:
            row["speedup"] = round(
                row["compressed"]["iters_per_sec"] / ref["iters_per_sec"], 2)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
