"""Dense SDP (LMI) integration tests.

Mirrors /root/reference/conex/test/test_sdp.cc recipes: random feasible
instances checked against KKT conditions, diagonal-SDP == LP equivalence,
and the SOC == LMI arrow-embedding agreement from test_socp.cc.
Also unit tests for the Pade exponential and Lanczos kernels against
scipy/numpy oracles (reference: exponential_map_pade_test.cc,
approximate_eigenvalues.cc tests).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conex_tpu import Program, SolverConfig
from conex_tpu.algebra import sym


def randsym(n, rng, scale=1.0):
    M = rng.uniform(-1, 1, (n, n)) * scale
    return 0.5 * (M + M.T)


# ---------------------------------------------------------------------------
# Kernel unit tests
# ---------------------------------------------------------------------------


def test_expm_pade_matches_scipy():
    from scipy.linalg import expm

    rng = np.random.default_rng(0)
    for n in [1, 2, 5, 8]:
        A = randsym(n, rng, scale=0.3)  # Pade(3,3) is accurate for small norms
        got = np.asarray(sym.expm_pade(jnp.asarray(A)))
        np.testing.assert_allclose(got, expm(A), atol=1e-6)


def test_expm_pade_batched():
    rng = np.random.default_rng(1)
    A = np.stack([randsym(4, rng, 0.2) for _ in range(3)])
    got = np.asarray(sym.expm_pade(jnp.asarray(A)))
    for b in range(3):
        np.testing.assert_allclose(
            got[b], np.asarray(sym.expm_pade(jnp.asarray(A[b]))), atol=1e-12
        )


def test_lanczos_extreme_eigenvalues():
    """Lanczos estimates of WS = W S bracket and approach the true spectrum
    of the symmetric similarity W^{1/2} S W^{1/2}."""
    rng = np.random.default_rng(2)
    n = 12
    M = rng.uniform(-1, 1, (n, n))
    W = M @ M.T + n * np.eye(n)
    S = randsym(n, rng)
    WS = W @ S
    r = rng.uniform(-1, 1, n)
    eigs_true = np.linalg.eigvalsh(
        np.linalg.cholesky(W).T @ S @ np.linalg.cholesky(W)
    )
    got = np.asarray(
        sym.asymmetric_lanczos(jnp.asarray(WS), jnp.asarray(W), jnp.asarray(r), n)
    )
    assert got.max() == pytest.approx(eigs_true.max(), rel=1e-6)
    assert got.min() == pytest.approx(eigs_true.min(), rel=1e-6)
    # Truncated estimates interlace: max under-estimates, min over-estimates.
    got6 = np.asarray(
        sym.asymmetric_lanczos(jnp.asarray(WS), jnp.asarray(W), jnp.asarray(r), 6)
    )
    assert got6.max() <= eigs_true.max() + 1e-9
    assert got6.min() >= eigs_true.min() - 1e-9


def test_lanczos_early_exit_masking():
    """Low-rank WS triggers the beta < 1e-6 break; masked padding must not
    corrupt the extreme eigenvalues."""
    n = 8
    W = np.eye(n)
    S = np.zeros((n, n))
    S[0, 0] = 3.0
    S[1, 1] = -2.0  # rank 2: Lanczos converges in ~2 steps
    r = np.ones(n)
    got = np.asarray(
        sym.asymmetric_lanczos(
            jnp.asarray(W @ S), jnp.asarray(W), jnp.asarray(r), n // 2
        )
    )
    assert got.max() == pytest.approx(3.0, abs=1e-8)
    assert got.min() == pytest.approx(-2.0, abs=1e-8)


# ---------------------------------------------------------------------------
# SDP solve tests
# ---------------------------------------------------------------------------


def feasible_sdp(n, m, rng):
    A = np.stack([randsym(n, rng) for _ in range(m)])
    C = randsym(n, rng)
    C += (abs(np.linalg.eigvalsh(C).min()) + 1.0) * np.eye(n)  # interior at y=0
    X0 = rng.uniform(-1, 1, (n, n))
    X0 = X0 @ X0.T + 0.1 * np.eye(n)
    b = np.einsum("vij,ij->v", A, X0)
    return A, C, b


def check_sdp_kkt(A, C, b, y, X, tol=1e-5):
    S = C - np.einsum("v,vij->ij", y, A)
    assert np.linalg.eigvalsh(S).min() >= -tol
    assert np.linalg.eigvalsh(X).min() >= -tol
    assert np.linalg.norm(np.einsum("vij,ij->v", A, X) - b) <= tol * max(
        1.0, np.linalg.norm(b)
    )
    assert np.trace(S @ X) <= 1e-3


def test_sdp_random_kkt():
    config = SolverConfig(
        inv_sqrt_mu_max=1000.0, prepare_dual_variables=True, max_iterations=50
    )
    rng = np.random.default_rng(3)
    for n, m in [(3, 2), (6, 4), (10, 5)]:
        A, C, b = feasible_sdp(n, m, rng)
        prog = Program(m)
        prog.add_lmi_constraint(A, C)
        res = prog.solve(b, config)
        assert res.solved, f"(n={n}, m={m}) unsolved at {res.num_iterations}"
        X = prog.get_dual_variable(0)
        check_sdp_kkt(A, C, b, res.y, X)


def test_diagonal_sdp_equals_lp():
    """reference: test_sdp.cc diagonal-SDP == LP equivalence."""
    rng = np.random.default_rng(4)
    n, m = 6, 3
    Alp = rng.uniform(-1, 1, (n, m))
    clp = np.abs(rng.uniform(-1, 1, n)) + 0.5
    x0 = np.abs(rng.uniform(-1, 1, n))
    b = Alp.T @ x0

    lp = Program(m)
    lp.add_linear_constraint(Alp, clp)
    res_lp = lp.solve(b, SolverConfig(max_iterations=50))

    A_sdp = np.stack([np.diag(Alp[:, i]) for i in range(m)])
    C_sdp = np.diag(clp)
    sdp = Program(m)
    sdp.add_lmi_constraint(A_sdp, C_sdp)
    res_sdp = sdp.solve(b, SolverConfig(max_iterations=50))

    assert res_lp.solved and res_sdp.solved
    np.testing.assert_allclose(res_lp.y, res_sdp.y, atol=1e-5)


def test_soc_equals_lmi_embedding():
    """reference: test_socp.cc:15-75 — the SOC ball constraint and its
    arrow-matrix LMI embedding give the same solution."""
    rng = np.random.default_rng(5)
    n = 3
    config = SolverConfig(inv_sqrt_mu_max=10000.0, max_iterations=50)
    Wsqrt = rng.uniform(-1, 1, (n, n))
    b = rng.uniform(-1, 1, n)

    As = np.zeros((n + 1, n))
    As[1:, :] = Wsqrt
    Cs = np.zeros(n + 1)
    Cs[0] = 1.0
    p1 = Program(n)
    p1.add_soc_constraint(As, Cs)
    r1 = p1.solve(b, config)

    # Arrow embedding: C = I, A_i has W column i in first row/col.
    A_lmi = np.zeros((n, n + 1, n + 1))
    for i in range(n):
        A_lmi[i, 1:, 0] = Wsqrt[:, i]
        A_lmi[i, 0, 1:] = Wsqrt[:, i]
    C_lmi = np.eye(n + 1)
    p2 = Program(n)
    p2.add_lmi_constraint(A_lmi, C_lmi)
    r2 = p2.solve(b, config)

    assert r1.solved and r2.solved
    np.testing.assert_allclose(r1.y, r2.y, atol=1e-4)


def test_sdp_batched_matches_separate():
    rng = np.random.default_rng(6)
    n, m, B = 4, 3, 2
    As, Cs, bs = [], [], np.zeros(m)
    for _ in range(B):
        A, C, b = feasible_sdp(n, m, rng)
        As.append(A)
        Cs.append(C)
        bs += b
    batched = Program(m)
    batched.add_lmi_constraint(np.stack(As), np.stack(Cs))
    res_b = batched.solve(bs, SolverConfig(max_iterations=50))

    separate = Program(m)
    for k in range(B):
        separate.add_lmi_constraint(As[k], Cs[k])
    res_s = separate.solve(bs, SolverConfig(max_iterations=50))

    assert res_b.solved and res_s.solved
    np.testing.assert_allclose(res_b.y, res_s.y, atol=1e-9)


def test_sdp_profile_sweep():
    """reference: SDP.ProfileSDP (test_sdp.cc:202-208) — small sweep, all
    must solve and satisfy KKT."""
    rng = np.random.default_rng(7)
    config = SolverConfig(
        inv_sqrt_mu_max=1000.0, prepare_dual_variables=True, max_iterations=60
    )
    for n in [1, 2, 4, 7]:
        for m in [1, 3]:
            if m > n * (n + 1) // 2:
                continue  # Schur complement structurally singular
            A, C, b = feasible_sdp(n, m, rng)
            prog = Program(m)
            prog.add_lmi_constraint(A, C)
            res = prog.solve(b, config)
            assert res.solved, f"(n={n}, m={m})"
            X = prog.get_dual_variable(0)
            check_sdp_kkt(A, C, b, res.y, X, tol=1e-4)


def test_sdp_mixed_with_lp_and_soc():
    rng = np.random.default_rng(8)
    m = 3
    A_sdp, C_sdp, b1 = feasible_sdp(4, m, rng)
    A_lp = rng.uniform(-1, 1, (5, m))
    c_lp = np.abs(rng.uniform(-1, 1, 5)) + 0.2
    x_lp = np.abs(rng.uniform(0, 1, 5))
    A_soc = rng.uniform(-1, 1, (4, m))
    c_soc = rng.uniform(-1, 1, 4)
    c_soc[0] = np.linalg.norm(c_soc[1:]) + 1.0
    x_soc = rng.uniform(-1, 1, 4)
    x_soc[0] = np.linalg.norm(x_soc[1:]) + 0.5
    b = b1 + A_lp.T @ x_lp + A_soc.T @ x_soc
    prog = Program(m)
    prog.add_lmi_constraint(A_sdp, C_sdp)
    prog.add_linear_constraint(A_lp, c_lp)
    prog.add_soc_constraint(A_soc, c_soc)
    res = prog.solve(b, SolverConfig(max_iterations=60))
    assert res.solved
    S = C_sdp - np.einsum("v,vij->ij", res.y, A_sdp)
    assert np.linalg.eigvalsh(S).min() >= -1e-8
    assert (c_lp - A_lp @ res.y).min() >= -1e-8
    s_soc = c_soc - A_soc @ res.y
    assert s_soc[0] >= np.linalg.norm(s_soc[1:]) - 1e-8


def test_expm_taylor_matches_scipy():
    from scipy.linalg import expm

    rng = np.random.default_rng(10)
    for n in [2, 6, 12]:
        # Arguments in the geodesic-step regime: spectral norm <= sqrt(2).
        A = randsym(n, rng)
        A = A / np.linalg.norm(A, 2) * 1.4
        got = np.asarray(sym.expm_taylor(jnp.asarray(A)))
        np.testing.assert_allclose(got, expm(A), atol=1e-11)


def test_precision_guard_caps_scaled_k():
    """inv_sqrt_mu_cap_scaled bounds the scaled duality measure: with the
    cap set and fixed_iterations, every iteration runs (full work) and the
    final scaled k sits exactly at the cap — the f32 validity guard used by
    bench.py (the f32 Schur complement loses PSD-ness below scaled mu~2e-6,
    so the headline bench pins scaled mu >= 1e-4)."""
    rng = np.random.default_rng(11)
    A, C, b = feasible_sdp(8, 4, rng)
    prog = Program(4)
    prog.add_lmi_constraint(A, C)
    cap = 50.0
    config = SolverConfig(
        max_iterations=20,
        final_centering_steps=0,
        inv_sqrt_mu_max=1e15,
        fixed_iterations=True,
        inv_sqrt_mu_cap_scaled=cap,
    )
    res = prog.solve(b, config)
    assert int(res.num_iterations) == 20
    assert not bool(res._raw.fail)
    assert float(res._raw.k) == pytest.approx(cap)


def test_extreme_eigenvalues_clustered():
    """Adversarial stress for the squaring estimator (VERDICT r2 #6): the
    extreme eigenvalues must stay accurate when the top of the spectrum is
    nearly degenerate (lam1/lam2 - 1 in {1e-3, 1e-6}) and interior
    eigenvalues crowd the extremes.  The original Frobenius-norm shift
    deflated the power-iteration dominance ratio by ~sqrt(n), leaving ~50%
    relative error on lam_min at n=64 (interior-eigenvector contamination
    after 512 effective power steps); the two-stage tight shift decays the
    same contamination below 5e-4 absolute on every case here.  An estimate
    landing anywhere inside a cluster counts as exact (error < gap).
    """
    from conex_tpu.algebra.sym import extreme_eigenvalues

    rng = np.random.default_rng(0)

    def make(n, eigs):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        return Q @ np.diag(eigs) @ Q.T

    for n in (32, 64, 128):
        for gap in (1e-3, 1e-6):
            eigs = np.concatenate(
                [[1.0, 1.0 - gap], rng.uniform(0.0, 0.99, n - 2)]
            )
            M = make(n, eigs)
            lo, hi = extreme_eigenvalues(jnp.asarray(M))
            hi_err = abs(float(hi) - 1.0)
            lo_err = abs(float(lo) - eigs.min())
            assert hi_err <= max(5e-4, gap), (n, gap, hi_err)
            assert lo_err <= 5e-4, (n, gap, lo_err)

    # Indefinite spectrum with a clustered top.
    eigs = np.concatenate([[1.0, 1.0 - 1e-6], rng.uniform(-0.95, 0.95, 62)])
    M = make(64, eigs)
    lo, hi = extreme_eigenvalues(jnp.asarray(M))
    assert abs(float(hi) - 1.0) <= 1e-5
    assert abs(float(lo) - eigs.min()) <= 1e-5

    # The actual consumer: a WS = W S product near convergence, where the
    # whole spectrum clusters at mu (psd_constraint.cc:63-77 consumer).
    n = 64
    W = make(n, rng.uniform(0.5, 2.0, n))
    mu = 1e-6
    S = mu * np.linalg.inv(W) + 1e-9 * make(n, rng.uniform(0, 1, n))
    WS = W @ S
    true = np.sort(np.linalg.eigvals(WS).real)
    lo, hi = extreme_eigenvalues(jnp.asarray(WS))
    assert abs(float(hi) - true[-1]) / true[-1] <= 1e-2
    assert abs(float(lo) - true[0]) / true[0] <= 1e-2


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5), (np.float64, 1e-12)])
def test_schur_einsum_matches_f64_oracle(dtype, tol):
    """The Schur assembly (DenseLMICone.schur) against an f64 numpy oracle
    at the benchmark order n=100.  The f32 tolerance is f32 rounding over
    contractions of length n^2; the f64 one is f64 rounding."""
    from conex_tpu.cones.psd import DenseLMICone, make_psd_state

    rng = np.random.default_rng(3)
    B, m, n = 2, 8, 100
    A = rng.uniform(-1, 1, (B, m, n, n))
    A = 0.5 * (A + np.swapaxes(A, 2, 3))
    w = rng.uniform(-1, 1, (B, n, n))
    w = np.einsum("bij,bkj->bik", w, w) / n + 0.1 * np.eye(n)
    C = np.stack([np.eye(n) + 0.1 * randsym(n, rng) for _ in range(B)])
    A, w, C = (x.astype(dtype) for x in (A, w, C))

    blk = DenseLMICone(A=jnp.asarray(A), C=jnp.asarray(C))
    got = blk.schur(make_psd_state(jnp.asarray(w)))

    A64, w64, C64 = (x.astype(np.float64) for x in (A, w, C))
    P = np.einsum("bvij,bjk->bvik", A64, w64, optimize=True)
    CW = np.einsum("bij,bjk->bik", C64, w64)
    want = dict(
        G=np.einsum("bvik,buki->vu", P, P, optimize=True),
        AW=np.einsum("bvii->v", P),
        AQc=np.einsum("bik,bvki->v", CW, P, optimize=True),
        w_dot_c=np.einsum("bii->", CW),
        c_dot_Qc=np.einsum("bik,bki->", CW, CW),
    )
    for name, ref in want.items():
        val = np.asarray(getattr(got, name), np.float64)
        err = np.linalg.norm(val - ref) / np.linalg.norm(ref)
        assert err < tol, (name, err)
