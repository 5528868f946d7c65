"""Device time of the plain XLA paths for the Schur assembly and batched SOCP.

    python benchmarks/trace_plain_paths.py schur [--out DIR]
    python benchmarks/trace_plain_paths.py socp [--out DIR]

schur: the Schur assembly at bench.py's shape (B=256 SDPs, n=100, m=50,
   f32, 30 fixed Newton iterations through ``solve_scenarios``): device
   time of the operations under the solve loop's ``schur`` scope, per
   Newton iteration, from a profiler trace of one solve, and the kernels
   that take the most device time.  XLA's command buffers (CUDA graphs)
   are turned off in this mode, so that every kernel in the trace names
   its HLO operation; that changes launch gaps, not kernel times.
socp: batched SOCP (n=20, m=10, f32, fixed iterations) at S=1000 and
   S=100000 scenarios: wall time per Newton iteration, marginal over 30 to
   60 iterations, and the device idle share of a traced 30-iteration solve
   with XLA's default flags.

Prints one JSON line per measurement, each with the card's name and power
limit.  Traces go under ``--out`` (default ``chiprun_out/traces``).  Fails
without a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def device_events(xplane_path, plane_prefix="/device:GPU"):
    """(start_ns, duration_ns, hlo_op, kernel name) of every XLA operation
    the trace records on the planes whose name starts with
    ``plane_prefix``, and the names of those planes' lines."""
    from jax.profiler import ProfileData

    out, lines = [], set()
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            lines.add(line.name)
            for ev in line.events:
                stats = dict(ev.stats)
                if "hlo_op" in stats:
                    out.append((ev.start_ns, ev.duration_ns,
                                str(stats["hlo_op"]), ev.name))
    if not out:
        raise RuntimeError(f"no XLA operations on {plane_prefix}* planes "
                           f"(lines: {sorted(lines)})")
    return out, sorted(lines)


def busy_ns(events):
    """Length of the union of the events' intervals."""
    total, end = 0.0, -np.inf
    for start, dur, *_ in sorted(events):
        stop = start + dur
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def scope_ops(hlo_text, scope):
    """Names of the compiled HLO instructions whose op_name lies under the
    named scope ``scope``."""
    pat = re.compile(r"^\s*%?([\w.\-]+) = .*op_name=\"([^\"]*)\"")
    names = set()
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m and f"/{scope}/" in m.group(2) + "/":
            names.add(m.group(1))
    return names


def traced(fn, out_dir):
    """Run ``fn`` under the profiler; return (result, wall s, xplane path)."""
    import jax

    os.makedirs(out_dir, exist_ok=True)
    with jax.profiler.trace(out_dir):
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
    paths = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    return res, wall, paths[-1]


def window_stats(events, wall):
    span = (max(e[0] + e[1] for e in events) - min(e[0] for e in events))
    busy = busy_ns(events)
    return dict(device_busy_s=busy / 1e9, device_span_s=span / 1e9,
                idle_share_of_span=1.0 - busy / span,
                idle_share_of_wall=1.0 - busy / 1e9 / wall)


def schur(card, out_dir, B=256, n=100, m=50, iters=30):
    import jax

    from chip_smoke import batched_sdp, check_fixed_run, fixed_config
    from conex_tpu.parallel.sharded import _scenario_solver

    blocks, eqs, b, ws, sc, _ = batched_sdp(B, n, m, np.float32)
    cfg = fixed_config(iters)
    solver = _scenario_solver(cfg)
    hlo = solver.lower(blocks, eqs, b, ws, sc).compile().as_text()

    def run():
        return jax.block_until_ready(solver(blocks, eqs, b, ws, sc))

    check_fixed_run(run(), B, iters)
    res, wall, path = traced(run, os.path.join(out_dir, "schur"))
    events, lines = device_events(path)
    names = scope_ops(hlo, "schur")
    in_scope = [e for e in events if e[2] in names]
    per_kernel = {}
    for _, dur, op, kernel in events:
        key = (kernel[:60], op, op in names)
        per_kernel[key] = per_kernel.get(key, 0.0) + dur
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    row = dict(
        measurement=f"Schur assembly, solve_scenarios B={B} n={n} m={m} f32",
        card=card, wall_s=wall, newton_iterations=iters,
        schur_ops_in_hlo=len(names), schur_events=len(in_scope),
        device_events=len(events), trace_lines=lines,
        **window_stats(events, wall),
        top_kernels_ms_per_iteration=[
            dict(kernel=k, hlo_op=op, schur=sch, ms=ns / 1e6 / iters)
            for (k, op, sch), ns in top],
    )
    if in_scope:
        row["schur_device_s"] = busy_ns(in_scope) / 1e9
        row["schur_device_ms_per_iteration"] = busy_ns(in_scope) / 1e6 / iters
        row["schur_share_of_busy"] = busy_ns(in_scope) / busy_ns(events)
    print(json.dumps(row), flush=True)


def socp(card, out_dir, S, n=20, m=10):
    import jax
    import jax.numpy as jnp

    from benchmarks.bench_socp import make_workload
    from chip_smoke import fixed_config
    from conex_tpu.cones.soc import SOCCone
    from conex_tpu.parallel.sharded import solve_scenarios

    A, c, b = make_workload(S, n, m)
    blk = SOCCone(A=jnp.asarray(A), c=jnp.asarray(c))
    ws = (jnp.zeros((S, 1, n + 1), A.dtype).at[:, :, 0].set(1.0),)
    sc = dict(k=jnp.zeros((S,), A.dtype), b_scaling=jnp.ones((S,), A.dtype),
              c_scaling=jnp.ones((S,), A.dtype))
    bd = jnp.asarray(b)

    def run(iters):
        return jax.block_until_ready(
            solve_scenarios((blk,), (), bd, ws, sc, fixed_config(iters)))

    walls = {}
    for iters in (30, 60):
        run(iters)
        best = np.inf
        for _ in range(5):
            t0 = time.perf_counter()
            res = run(iters)
            best = min(best, time.perf_counter() - t0)
        if int(np.asarray(res.num_iterations).min()) != iters:
            raise AssertionError(f"S={S}: not every scenario ran {iters}")
        walls[iters] = best
    _, wall, path = traced(lambda: run(30), os.path.join(out_dir, f"socp{S}"))
    events, _ = device_events(path)
    print(json.dumps(dict(
        measurement=f"batched SOCP solve_scenarios S={S} n={n} m={m} f32",
        card=card, wall_30_s=walls[30], wall_60_s=walls[60],
        ms_per_iteration_marginal=(walls[60] - walls[30]) / 30 * 1e3,
        traced_wall_s=wall, device_events=len(events),
        **window_stats(events, wall),
    )), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("schur", "socp"))
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                      "traces"))
    args = parser.parse_args()
    if args.what == "schur":
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

    import jax

    jax.config.update("jax_enable_x64", True)
    from chip_smoke import card_line, require_gpu
    from conex_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    require_gpu(jax.devices())
    card = card_line()
    if args.what == "schur":
        schur(card, args.out)
    else:
        for S in (1000, 100000):
            socp(card, args.out, S)


if __name__ == "__main__":
    main()
