"""Smoke tests for ``bench.py`` and ``__graft_entry__.py``.

A state refactor once broke ``bench.py`` and ``dryrun_multichip`` without
any test noticing.  These tests trace the exact call paths of both on tiny
shapes on the CPU mesh so that class of breakage fails here, in pytest.
"""

import numpy as np
import pytest

import jax

from conex_tpu.parallel.sharded import solve_scenarios


def test_bench_call_path_smoke():
    """bench.py's exact construction + solve path (tiny shapes, f32)."""
    from chip_smoke import batched_sdp, check_fixed_run, fixed_config

    B, iters = 4, 8
    blocks, eqs, b, ws, sc, _ = batched_sdp(B, 8, 4, np.float32)
    res = jax.block_until_ready(
        solve_scenarios(blocks, eqs, b, ws, sc, fixed_config(iters)))
    check_fixed_run(res, B, iters)
    assert np.asarray(res.y).dtype == np.float32


def test_graft_entry_and_dryrun_multichip():
    """__graft_entry__.entry() jits and dryrun_multichip(8) runs on the
    8-device virtual CPU mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert np.all(np.isfinite(np.asarray(out)))
    g.dryrun_multichip(8)
