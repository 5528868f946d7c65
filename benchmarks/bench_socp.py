"""Batched tiny-SOCP throughput through the general solve loop.

Workload matches baseline/BASELINE_MEASURED.json socp_n20_m10_batch1000:
independent single-cone SOCPs (n=20, m=10), f32, fixed Newton iterations,
solved as one vmapped program by ``parallel.sharded.solve_scenarios``.
The reference's single-core rate on the same workload is 156,760 Newton
iterations/s (baseline/BASELINE_MEASURED.json).

The headline is the MARGINAL rate S*(120-30)/(t(120) - t(30)), which
cancels the per-call dispatch and transfer overhead; the wall-clock
30-iteration rate is printed beside it.  Prints one JSON line per batch
size.

Usage: python benchmarks/bench_socp.py [batch ...]   (default 1000 10000 100000)
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_workload(S, n, m, dtype=np.float32):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((S, 1, n + 1, m)).astype(dtype)
    x = rng.standard_normal((S, 1, n + 1)).astype(dtype)
    x[..., 0] = np.linalg.norm(x[..., 1:], axis=-1) + 1.0
    b = 2.0 * np.einsum("scnv,scn->sv", A, x).astype(dtype)
    c = rng.standard_normal((S, 1, n + 1)).astype(dtype)
    c[..., 0] = np.linalg.norm(c[..., 1:], axis=-1) + 1.0
    return A, c, b


def main():
    import jax
    import jax.numpy as jnp

    from chip_smoke import card_line, require_gpu
    from conex_tpu.config import SolverConfig
    from conex_tpu.cones.soc import SOCCone
    from conex_tpu.parallel.sharded import solve_scenarios
    from conex_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = require_gpu(jax.devices())
    card = card_line()
    batches = [int(a) for a in sys.argv[1:]] or [1000, 10000, 100000]
    n, m = 20, 10
    base = 156760.0

    def cfg(iters):
        return SolverConfig(
            max_iterations=iters,
            final_centering_steps=0,
            inv_sqrt_mu_max=1e15,
            kkt_error_tolerance=1e45,
            fixed_iterations=True,
        )

    for S in batches:
        A, c, b = make_workload(S, n, m)
        blk = SOCCone(A=jnp.asarray(A), c=jnp.asarray(c))
        ws = (jnp.zeros((S, 1, n + 1), A.dtype).at[:, :, 0].set(1.0),)
        sc = dict(k=jnp.zeros((S,), A.dtype),
                  b_scaling=jnp.ones((S,), A.dtype),
                  c_scaling=jnp.ones((S,), A.dtype))
        bd = jnp.asarray(b)

        def best_time(iters, reps=5):
            jax.block_until_ready(
                solve_scenarios((blk,), (), bd, ws, sc, cfg(iters)))
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                r = jax.block_until_ready(
                    solve_scenarios((blk,), (), bd, ws, sc, cfg(iters)))
                best = min(best, time.perf_counter() - t0)
            if int(np.asarray(r.num_iterations).min()) != iters:
                raise AssertionError(f"S={S}: not every scenario ran {iters}")
            return best

        t30, t120 = best_time(30), best_time(120)
        marginal = 90 * S / max(t120 - t30, 1e-9)
        print(json.dumps({
            "metric": f"batched SOCP newton iters/s (S={S}, n={n}, m={m}, f32)",
            "value": round(marginal, 0),
            "unit": "newton_iters/s (marginal, 30 -> 120 iterations)",
            "wall_30iter_value": round(30 * S / t30, 0),
            "vs_baseline": round(marginal / base, 2),
            "device": device.device_kind,
            "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    main()
