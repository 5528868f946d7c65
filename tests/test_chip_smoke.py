"""CPU tests of the bring-up script's checks and of the scripts' helpers.

``chip_smoke.py`` itself refuses to run without a GPU; these tests drive
its device check, KKT certificate and reference-solver comparison at tiny
sizes, the compile-cache helper, and the trace reduction of
``benchmarks/trace_plain_paths.py``.  The one ``gpu`` test runs a solve on
a card and skips here.
"""

import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import chip_smoke as cs
from conex_tpu import Program, SolverConfig
from conex_tpu.utils import compile_cache

ACC = SolverConfig(**cs.ACCURATE)


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cs.require_gpu(jax.devices())
    with pytest.raises(RuntimeError):
        cs.require_gpu([])


def test_require_gpu_returns_a_gpu_device():
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    assert cs.require_gpu([dev]) is dev


def _sdp_solution(n=10, m=4):
    A, C, b = cs.sdp_instance(n, m, seed=1)
    prog = Program(m)
    prog.add_lmi_constraint(A, C)
    res = prog.solve(b, ACC)
    assert res.solved
    return A, C, b, res.y, prog.get_dual_variable(0)


def test_kkt_certificate_accepts_a_solution_and_flags_a_bad_dual():
    A, C, b, y, X = _sdp_solution()
    cert = cs.kkt_certificate(A, C, b, y, X)
    assert cert["rel_gap"] < 1e-6 and cert["residual"] < 1e-8
    assert cert["slack_min"] > -1e-8 and cert["dual_min"] > -1e-8
    cs.check_certificate("tiny SDP", cert, 1e-6, 1e-8, "test")
    bad = cs.kkt_certificate(A, C, b, y, X + 1e-3 * np.eye(len(X)))
    assert bad["residual"] > 1e-5
    with pytest.raises(AssertionError):
        cs.check_certificate("perturbed", bad, 1e-6, 1e-8, "test")
    not_psd = cs.kkt_certificate(A, C, b, y, X - 1e-2 * np.eye(len(X)))
    assert not_psd["dual_min"] < -1e-4


def test_kkt_certificate_hermitian():
    n, m = 6, 3
    A, C = cs.hermitian_instance(n, m, seed=3)
    prog = Program(m)
    prog.add_hermitian_constraint(A, C)
    b = prog.get_feasible_objective()
    res = prog.solve(b, ACC)
    assert res.solved
    W = prog.get_dual_variable(0)
    cert = cs.kkt_certificate(A, C, b, res.y, W[0] + 1j * W[1])
    assert cert["rel_gap"] < 1e-6 and cert["residual"] < 1e-8
    assert cert["dual_min"] > -1e-8


@pytest.mark.parametrize("kind", ["lp", "sdp", "soc"])
def test_reference_comparison(kind):
    """The reference binary, run on the instance file chip_smoke writes,
    agrees with Program.solve on the same tiny program."""
    if kind == "lp":
        A, c, b = cs.lp_instance(5, 12, seed=4)
    elif kind == "sdp":
        A, c, b = cs.sdp_instance(8, 4, seed=4)
    else:
        A, c, b = cs.soc_instance(6, 3, seed=4)
    prog = Program(len(b))
    {"lp": prog.add_linear_constraint, "sdp": prog.add_lmi_constraint,
     "soc": prog.add_soc_constraint}[kind](A, c)
    res = prog.solve(b, ACC)
    assert res.solved
    ref = cs.Reference()
    try:
        ref.start(kind, kind, A, c, b, ACC)
        out = ref.result(kind)
    finally:
        ref.close()
    assert not os.path.exists(ref.dir)
    cs.compare_with_reference(kind, res.y, b, out, cs.Y_TOL, cs.OBJ_TOL,
                              "test")
    with pytest.raises(AssertionError):
        cs.compare_with_reference(kind, res.y + 1e-2, b, out, cs.Y_TOL,
                                  cs.OBJ_TOL, "test")


def test_write_instance_header(tmp_path):
    A = np.arange(6.0).reshape(3, 2)
    path = tmp_path / "i.txt"
    cs.write_instance(path, "lp", A, np.ones(3), np.ones(2),
                      SolverConfig(inv_sqrt_mu_max=np.float64(1e4)))
    head, *rest = path.read_text().splitlines()
    assert head.split() == ["lp", "3", "2", "25", "0", "1", "1", "10000",
                            "1", "0.01"]
    values = [float(v) for line in rest for v in line.split()]
    assert values == list(A.ravel()) + [1.0] * 5


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable_compile_cache()
            root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert path == os.path.join(root, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_trace_reduction_attributes_scope_time(tmp_path):
    """The reduction of benchmarks/trace_plain_paths.py finds the ops of a
    named scope in a recorded trace (here the CPU's, whose XLA operations
    carry the same hlo_op stats as a GPU's)."""
    from benchmarks import trace_plain_paths as tp

    @jax.jit
    def f(x):
        with jax.named_scope("schur"):
            y = x @ x
        return jnp.sin(y).sum()

    x = jnp.ones((128, 128))
    names = tp.scope_ops(f.lower(x).compile().as_text(), "schur")
    assert names
    f(x).block_until_ready()
    _, wall, path = tp.traced(lambda: f(x).block_until_ready(), str(tmp_path))
    events, _ = tp.device_events(path, plane_prefix="/host:CPU")
    assert any(e[2] in names for e in events)
    assert 0 < tp.busy_ns(events) <= sum(e[1] for e in events)
    assert tp.busy_ns([(0, 10, "a"), (5, 10, "b"), (30, 5, "c")]) == 20


@pytest.fixture
def gpu():
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (run: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/)")
    return devices[0]


@pytest.mark.gpu
def test_sdp_on_gpu_matches_reference(gpu):
    A, C, b = cs.sdp_instance(30, 10, seed=40)
    prog = Program(10)
    prog.add_lmi_constraint(A, C)
    res = prog.solve(b, ACC)
    assert res.solved
    ref = cs.Reference()
    try:
        ref.start("sdp", "sdp", A, C, b, ACC)
        out = ref.result("sdp")
    finally:
        ref.close()
    cs.compare_with_reference("gpu sdp", res.y, b, out, cs.Y_TOL, cs.OBJ_TOL,
                              cs.REF_REASON)
