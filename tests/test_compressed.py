"""Block-compressed supernodal storage tests (conex_tpu/supernodal/compressed.py).

The compressed path must reproduce the dense-backed supernodal results
exactly (same block algorithm, different storage) while allocating only
O(sum of block sizes) memory — the counterpart of the
reference's contiguous per-clique factor buffer + pointer scatter
(/root/reference/conex/triangular_matrix_workspace.cc:123-159,
block_triangular_operations.cc:184-219, supernodal_assembler.cc:72-141).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from conex_tpu.supernodal.compressed import (
    CompressedSupernodalStructure,
    assembly_map,
    compress_dense,
    densify,
    empty_buffer,
    factor_ldlt,
    factor_llt,
    matvec,
    solve_ldlt,
    solve_llt,
)

PATTERNS = [
    ([[0, 1, 2], [2, 3, 4], [4, 5, 6]], 7),
    ([[0, 1], [1, 2], [2, 3], [0, 3]], 4),  # cycle: forces fill-in
    ([[0, 1, 2, 3, 4]], 5),  # single clique (dense)
    ([[0, 1, 4], [1, 2, 4], [2, 3, 4], [0, 5]], 6),
    ([[0, 1, 2, 6], [2, 3, 6], [3, 4, 5, 6]], 7),  # ragged supernodes
]


def random_clique_spd(cliques, n, rng, delta=1.0):
    G = np.zeros((n, n))
    for c in cliques:
        k = len(c)
        M = rng.normal(size=(k, k))
        idx = np.asarray(c)
        G[idx[:, None], idx[None, :]] += M @ M.T
    G += delta * np.eye(n)
    return G


@pytest.mark.parametrize("cliques,n", PATTERNS)
def test_compress_densify_roundtrip(cliques, n):
    """compress_dense -> densify must recover every pattern entry."""
    rng = np.random.default_rng(0)
    G = random_clique_spd(cliques, n, rng)
    s = CompressedSupernodalStructure.from_cliques(cliques, n)
    buf = compress_dense(jnp.asarray(G), s)
    K = np.asarray(densify(buf, s))
    np.testing.assert_allclose(K, G, atol=1e-12)


@pytest.mark.parametrize("cliques,n", PATTERNS)
def test_matvec_matches_dense(cliques, n):
    rng = np.random.default_rng(1)
    G = random_clique_spd(cliques, n, rng)
    s = CompressedSupernodalStructure.from_cliques(cliques, n)
    buf = compress_dense(jnp.asarray(G), s)
    x = rng.normal(size=n)
    np.testing.assert_allclose(
        np.asarray(matvec(buf, s, jnp.asarray(x))), G @ x, atol=1e-10
    )


@pytest.mark.parametrize("cliques,n", PATTERNS)
def test_compressed_llt_matches_dense(cliques, n):
    rng = np.random.default_rng(2)
    G = random_clique_spd(cliques, n, rng)
    b = rng.normal(size=n)
    s = CompressedSupernodalStructure.from_cliques(cliques, n)
    buf = compress_dense(jnp.asarray(G), s)
    fac, fail = factor_llt(buf, s)
    assert not bool(fail)
    x = np.asarray(solve_llt(fac, s, jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(G, b), atol=1e-9)


@pytest.mark.parametrize("cliques,n", PATTERNS)
def test_compressed_ldlt_matches_dense(cliques, n):
    rng = np.random.default_rng(3)
    G = random_clique_spd(cliques, n, rng)
    b = rng.normal(size=n)
    s = CompressedSupernodalStructure.from_cliques(cliques, n)
    buf = compress_dense(jnp.asarray(G), s)
    fac, fail = factor_ldlt(buf, s)
    assert not bool(fail)
    x = np.asarray(solve_ldlt(fac, s, jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(G, b), atol=1e-8)


def test_compressed_ldlt_indefinite():
    """KKT-style saddle system with an equality block (reference forces
    LDLT for these, kkt_solver.cc:180-187)."""
    rng = np.random.default_rng(4)
    cliques = [[0, 1, 2, 6], [2, 3, 6], [3, 4, 5, 6]]
    n = 7
    G = random_clique_spd(cliques, n, rng)
    G[6, 6] = -G[6, 6]
    s = CompressedSupernodalStructure.from_cliques(cliques, n)
    buf = compress_dense(jnp.asarray(G), s)
    fac, fail = factor_ldlt(buf, s)
    assert not bool(fail)
    b = rng.normal(size=n)
    x = np.asarray(solve_ldlt(fac, s, jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(G, b), atol=1e-7)


def test_llt_reports_failure_on_indefinite():
    n = 4
    s = CompressedSupernodalStructure.from_cliques([[0, 1, 2, 3]], n)
    buf = compress_dense(jnp.asarray(-np.eye(n)), s)
    _, fail = factor_llt(buf, s)
    assert bool(fail)


def test_big_chain_o_sum_block_memory():
    """10^4-variable chain factored+solved with O(sum of block sizes)
    storage — the dense (N, N) matrix (~0.8 GB f64) is never built.
    VERDICT round-1 item #3's done-condition."""
    K = 5000
    n = 2 * K + 1
    cliques = [[2 * i, 2 * i + 1, 2 * i + 2] for i in range(K)]
    s = CompressedSupernodalStructure.from_cliques(cliques, n)
    # O(sum of blocks): ~6 floats per clique, not N^2 = 1e8.
    assert s.buf_size < 20 * K

    # Host-side assembly through the same index maps the device scatter
    # uses: per-clique random SPD contribution + diagonal shift.
    rng = np.random.default_rng(5)
    buf = np.zeros(s.buf_size)
    contribs = []
    for c in cliques:
        M = rng.normal(size=(3, 3))
        M = M @ M.T + 2.0 * np.eye(3)
        contribs.append(M)
        idx = np.asarray(assembly_map(s, tuple(c), tuple(c)))
        np.add.at(buf, idx.ravel(), M.ravel())
    buf[s.dump] = 0.0
    buf = jnp.asarray(buf)

    b = rng.normal(size=n)
    fac, fail = factor_llt(buf, s)
    assert not bool(fail)
    x = solve_llt(fac, s, jnp.asarray(b))
    # Verify through the independently-tested compressed matvec.
    r = np.asarray(matvec(buf, s, x)) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10


def test_program_end_to_end_compressed_vs_dense():
    """Chain LP above the clique threshold runs the compressed path and
    must agree with the dense solve (reference recipe: LP.Sparse,
    test_lp.cc:253-311)."""
    from conex_tpu import Program
    from conex_tpu.program import SCAN_CLIQUE_THRESHOLD

    rng = np.random.default_rng(6)
    n_blocks = SCAN_CLIQUE_THRESHOLD + 8
    num_vars = n_blocks + 1
    rows = 3

    Af = np.zeros((rows * n_blocks, num_vars))
    cf = np.zeros(rows * n_blocks)
    sparse = Program(num_vars)
    for i in range(n_blocks):
        Ai = rng.uniform(-1, 1, (rows, 2))
        ci = np.abs(rng.uniform(-1, 1, rows)) + 0.1
        sparse.add_linear_constraint(Ai, ci, variables=[i, i + 1])
        Af[rows * i:rows * (i + 1), i:i + 2] = Ai
        cf[rows * i:rows * (i + 1)] = ci

    assert isinstance(
        sparse._kkt_structure(), CompressedSupernodalStructure
    )

    x0 = np.abs(rng.uniform(-1, 1, rows * n_blocks))
    x0 *= 0.1 / np.linalg.norm(x0)
    b = Af.T @ x0

    res_sparse = sparse.solve(b)
    dense = Program(num_vars)
    dense.add_linear_constraint(Af, cf)
    res_dense = dense.solve(b)

    assert res_dense.solved and res_sparse.solved
    np.testing.assert_allclose(res_dense.y, res_sparse.y, atol=1e-6)


def test_program_compressed_with_equality():
    """Compressed path through the LDLT branch: chain LP + equality
    constraint (duals appended to the KKT system,
    constraint_manager.h:71-86)."""
    from conex_tpu import Program
    from conex_tpu.program import SCAN_CLIQUE_THRESHOLD

    rng = np.random.default_rng(7)
    n_blocks = SCAN_CLIQUE_THRESHOLD + 4
    num_vars = n_blocks + 1
    rows = 3

    Af = np.zeros((rows * n_blocks, num_vars))
    cf = np.zeros(rows * n_blocks)
    sparse = Program(num_vars)
    dense = Program(num_vars)
    for i in range(n_blocks):
        Ai = rng.uniform(-1, 1, (rows, 2))
        ci = np.abs(rng.uniform(-1, 1, rows)) + 0.1
        sparse.add_linear_constraint(Ai, ci, variables=[i, i + 1])
        Af[rows * i:rows * (i + 1), i:i + 2] = Ai
        cf[rows * i:rows * (i + 1)] = ci
    dense.add_linear_constraint(Af, cf)

    Aeq = rng.uniform(-1, 1, (2, 3))
    x0 = np.abs(rng.uniform(-1, 1, rows * n_blocks))
    x0 *= 0.1 / np.linalg.norm(x0)
    b = Af.T @ x0
    beq = Aeq @ b[:3]
    sparse.add_equality_constraint(Aeq, beq, variables=[0, 1, 2])
    dense.add_equality_constraint(Aeq, beq, variables=[0, 1, 2])

    res_sparse = sparse.solve(b)
    res_dense = dense.solve(b)
    assert res_dense.solved and res_sparse.solved
    np.testing.assert_allclose(res_dense.y, res_sparse.y, atol=1e-6)
