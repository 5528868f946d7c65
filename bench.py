"""Benchmark: batched dense-SDP Newton iterations/s on one GPU vs single-core conex.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...,
   "card": ...}

Workload: B=256 independent dense SDPs (n x n LMI, m variables), f32,
solved fully vectorized by the jitted geodesic-IPM loop
(``parallel.sharded.solve_scenarios``), exactly 30 Newton iterations each
(SolverConfig(fixed_iterations=True): all early-termination paths disabled).
The baseline is the reference conex solver, single core, same workload and
iteration count (baseline/BASELINE_MEASURED.json).

Validity: the run aborts (exit 1, no metric) unless EVERY scenario
completes exactly 30 iterations with zero factorization failures.  The
solve caps the scaled k = 1/sqrt(mu) at 100 (scaled mu >= 1e-4,
SolverConfig.inv_sqrt_mu_cap_scaled) so the f32 Schur complement stays
factorable; past the cap each iteration is a full-work centering step at
the capped mu.  This is a throughput figure, not an accuracy result.

``python bench.py socp|accuracy|n300`` runs benchmarks/bench_<name>.py.
The script fails when JAX's first device is not a GPU.
"""

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] in ("socp", "accuracy", "n300"):
        import importlib

        mod = importlib.import_module(f"benchmarks.bench_{sys.argv[1]}")
        sys.argv = sys.argv[:1] + sys.argv[2:]
        return mod.main()
    import jax

    from chip_smoke import (batched_sdp, card_line, check_fixed_run,
                            fixed_config, require_gpu)
    from conex_tpu.parallel.sharded import solve_scenarios
    from conex_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = require_gpu(jax.devices())
    card = card_line()
    B, n, m = 256, 100, 50
    iters = 30  # matches the baseline's fixed-30-iteration convention
    blocks, eqs, b, ws, sc, _ = batched_sdp(B, n, m, np.float32)
    config = fixed_config(iters)

    def run():
        return jax.block_until_ready(
            solve_scenarios(blocks, eqs, b, ws, sc, config))

    t0 = time.perf_counter()
    res = run()
    log(f"compile+first run: {time.perf_counter() - t0:.2f}s on {card}")
    try:
        check_fixed_run(res, B, iters)
    except AssertionError as e:
        log(f"INVALID RUN: {e}")
        sys.exit(1)
    total_iters = int(np.asarray(res.num_iterations).sum())

    best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        run()
        dt = time.perf_counter() - t0
        best = min(best, dt)
        log(f"rep {rep}: {dt:.3f}s")
    iters_per_sec = total_iters / best

    with open("baseline/BASELINE_MEASURED.json") as f:
        base = json.load(f)["workloads"]["sdp_n100_m50"]["newton_iters_per_sec"]
    print(json.dumps({
        "metric": f"batched dense-SDP Newton iterations/s (B={B}, n={n}, "
                  f"m={m}, f32, 1 card)",
        "value": round(iters_per_sec, 2),
        "unit": "newton_iters/s",
        "vs_baseline": round(iters_per_sec / base, 2),
        "device": device.device_kind,
        "card": card,
    }))


if __name__ == "__main__":
    main()
