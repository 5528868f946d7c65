"""Reference profile shape: dense SDP n=300, m=50 on one GPU.

The reference's flagship profiling workload
(/root/reference/conex/test/profile_sdp.cc:11-34) is ONE dense SDP with
n=300, m=50.  Measured here in the same fixed-30-iteration mode as the
headline bench, both single-instance (B=1, the reference's workload) and
batched (B=64, the batched operating point).  Baseline:
baseline/BASELINE_MEASURED.json sdp_n300_m50 (1.114 Newton iters/s,
single core).

Prints one JSON line.  Run: python bench.py n300
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_shape(B, n, m, iters=30):
    import jax
    import jax.numpy as jnp

    from conex_tpu.config import SolverConfig
    from conex_tpu.cones.psd import DenseLMICone, make_psd_state
    from conex_tpu.parallel.sharded import solve_scenarios

    dtype = np.float32
    rng = np.random.default_rng(0)
    A = rng.uniform(-1, 1, (B, 1, m, n, n)).astype(dtype)
    A = 0.5 * (A + np.swapaxes(A, 3, 4))
    C = np.broadcast_to(np.eye(n, dtype=dtype), (B, 1, n, n)).copy()
    X0 = rng.uniform(-1, 1, (B, 1, n, n)).astype(dtype)
    X0 = np.einsum("sbij,sbkj->sbik", X0, X0) + 0.1 * np.eye(n, dtype=dtype)
    b = np.einsum("sbvij,sbij->sv", A, X0).astype(dtype)

    blk = DenseLMICone(A=jnp.asarray(A), C=jnp.asarray(C))
    init_ws = (
        make_psd_state(jnp.broadcast_to(jnp.eye(n, dtype=dtype), (B, 1, n, n))),
    )
    scalars = dict(
        k=jnp.zeros((B,), dtype),
        b_scaling=jnp.ones((B,), dtype),
        c_scaling=jnp.ones((B,), dtype),
    )
    config = SolverConfig(
        max_iterations=iters,
        final_centering_steps=0,
        inv_sqrt_mu_max=1e15,
        fixed_iterations=True,
        inv_sqrt_mu_cap_scaled=100.0,
    )

    bv = jnp.asarray(b)

    def run():
        return jax.block_until_ready(
            solve_scenarios((blk,), (), bv, init_ws, scalars, config))

    res = run()
    n_iters = np.asarray(res.num_iterations)
    fails = int(np.asarray(res.fail).sum())
    if fails or not (n_iters == iters).all():
        log(f"INVALID RUN B={B}: fails={fails} iters={n_iters}")
        return None
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return B * iters / best


def main():
    import jax

    from chip_smoke import card_line, require_gpu
    from conex_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = require_gpu(jax.devices())
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "baseline/BASELINE_MEASURED.json")) as f:
        base = json.load(f)["workloads"]["sdp_n300_m50"]["newton_iters_per_sec"]

    results = {}
    for B in (1, 64):
        r = run_shape(B, 300, 50)
        if r is None:
            sys.exit(1)
        results[f"B{B}"] = dict(
            newton_iters_per_sec=round(r, 2),
            vs_baseline=round(r / base, 2),
        )
        log(f"B={B}: {r:.1f} it/s = {r / base:.1f}x baseline")

    payload = dict(
        metric="dense-SDP Newton iterations/s, reference profile shape "
               "(n=300, m=50, f32, fixed 30 iters, 1 card; "
               "profile_sdp.cc:11-34)",
        baseline_single_core_iters_per_sec=base,
        results=results,
        device=device.device_kind,
        card=card_line(),
    )
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
