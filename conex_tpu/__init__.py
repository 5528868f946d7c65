"""conex_tpu: a JAX geodesic interior-point solver for symmetric cones.

A from-scratch JAX/XLA re-implementation of the capabilities of
ToyotaResearchInstitute/conex: linear programs, second-order cone programs,
semidefinite programs (real and hypercomplex Hermitian PSD cones), affine
equality constraints, and quadratic costs, solved with the geodesic
interior-point method of Permenter ("A geodesic interior-point method for
linear optimization over symmetric cones").

The compute path is batched, functional, and compiled end-to-end: the whole
Newton iteration is a single ``lax.while_loop`` under ``jit``, independent
programs batch with ``vmap``, and the additively-structured Schur-complement
assembly shards across devices with XLA collectives.
"""

from .config import (
    COLDSTART,
    DEFAULT_CONFIG,
    KKT_SOLVER_LDLT,
    KKT_SOLVER_LLT,
    KKT_SOLVER_QR,
    WARMSTART,
    SolverConfig,
)
from .program import Program, Result


def __getattr__(name):
    # Lazy exports that would otherwise import heavier modules at package
    # import time.
    if name == "Conex":
        from .interface import Conex

        return Conex
    if name == "solve_sedumi":
        from .sedumi import solve_sedumi

        return solve_sedumi
    raise AttributeError(name)


__all__ = [
    "Program",
    "Result",
    "Conex",
    "solve_sedumi",
    "SolverConfig",
    "DEFAULT_CONFIG",
    "COLDSTART",
    "WARMSTART",
    "KKT_SOLVER_LLT",
    "KKT_SOLVER_LDLT",
    "KKT_SOLVER_QR",
]

__version__ = "0.1.0"
