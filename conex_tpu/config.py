"""Solver configuration.

Mirrors the reference's ``SolverConfiguration`` struct
(/root/reference/conex/cone_program.h:17-38) field-for-field, with the same
defaults, plus this rebuild's additions (dtype selection, precision).

Fields that alter the *structure* of the compiled program (line search on/off,
kkt solver mode, max_iterations, centering step counts) are static — changing
them triggers recompilation.  Purely numeric tolerances are carried as traced
scalars so they can be changed without recompiling.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

COLDSTART = 0
WARMSTART = 1

# KKT solver modes (reference: conex/kkt_solver.h:10-14).
KKT_SOLVER_LLT = 0
KKT_SOLVER_LDLT = 1
KKT_SOLVER_QR = 2


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Configuration for the geodesic interior-point solver.

    Defaults match reference /root/reference/conex/cone_program.h:17-38.
    """

    prepare_dual_variables: bool = False
    initialization_mode: int = COLDSTART
    # inv_sqrt_mu_max = 1/sqrt(mu_final): the target accuracy.
    inv_sqrt_mu_max: float = 1000.0
    minimum_mu: float = 1e-15
    maximum_mu: float = 1e4
    divergence_upper_bound: float = 1.0
    enable_line_search: bool = False
    dinf_upper_bound: float = 1.0
    final_centering_steps: int = 5
    final_centering_tolerance: float = 0.01
    initial_centering_steps_warmstart: int = 0
    initial_centering_steps_coldstart: int = 0
    warmstart_abort_threshold: float = 2.0
    max_iterations: int = 25
    infeasibility_threshold: float = 1e5
    kkt_error_tolerance: float = 1e10
    kkt_solver: int = KKT_SOLVER_LLT
    enable_rescaling: bool = True
    iterative_refinement_iterations: int = 0

    # --- Additions (not in the reference) ---
    # Solve dtype.  None => inherit from problem data.
    dtype: Optional[str] = None
    # Fixed-iteration throughput mode: run exactly ``max_iterations`` Newton
    # iterations with no early termination of any kind (no final-centering
    # exit, no mu-target stop, no stall exit).  Benchmark-only; matches the
    # baseline convention in baseline/BASELINE_MEASURED.json.
    fixed_iterations: bool = False
    # Precision guard: absolute cap on the *scaled* k = 1/sqrt(mu) carried
    # by the loop (the reference's inv_sqrt_mu_max is a cap on the
    # *unscaled* target, adjusted by the first-iteration rescaling,
    # cone_program.cc:343-357).  The scaled mu is what governs the KKT
    # matrix conditioning, so this is the knob that keeps the Schur
    # complement factorable at a given arithmetic precision: with f32 or
    # coarser products the Cholesky factor breaks down once cond(G) ~
    # 1/mu_scaled outgrows the precision.  inf disables (default).
    inv_sqrt_mu_cap_scaled: float = float("inf")
    # Mu-stall detection: when the mu update makes less than
    # mu_stall_tolerance relative progress on k = 1/sqrt(mu) for
    # mu_stall_iterations consecutive non-centering iterations, exit
    # gracefully (Result.mu_stalled=True, solved=False) instead of
    # oscillating until max_iterations.  The geodesic IPM — reference
    # included — oscillates near non-unique optima; the reference has no
    # detector and burns the full iteration budget.  0 disables.
    mu_stall_iterations: int = 0
    mu_stall_tolerance: float = 1e-4
    # Numerical-floor latch: in divergence mode, a mu update that *collapses*
    # k (k_new < mu_floor_drop_ratio * k_old) while already within
    # mu_floor_kmax_fraction of the target k_max means the slack-eigenvalue
    # arithmetic has hit the f64 floor — further "progress" is noise.  The
    # reference escapes this regime only when its own roundoff happens to
    # overshoot the k_max clamp, which latches final centering and the
    # centering-budget exit (cone_program.cc:331-336, 405-407); when its
    # update undershoots instead, it burns the full iteration budget
    # unsolved on the same instance.  The latch reproduces the clamp-latch
    # semantics deterministically: hold k at its high-water mark, enter
    # final centering, exit solved after the centering budget.  Set
    # mu_floor_drop_ratio = 0 to disable.
    mu_floor_drop_ratio: float = 0.5
    mu_floor_kmax_fraction: float = 0.1
    # Matmul precision mode for the cone hot paths (Schur panels, WS
    # products, geodesic exponential) — see algebra/mm.py.  "default" is
    # XLA's default precision (a GPU may run f32 products as TF32);
    # "highest"/"float32" force full f32 products; "x3"/"x6" run the bf16
    # split-precision ladder (~2^-16 / ~f32 rel err); these are ignored
    # for f64 problem data.  "ozaki" applies to f64 data: the heavy
    # matmuls run as exact bf16 passes combined in f64 (~2^-56-class entry
    # error at ~21-36 bf16 passes) instead of native f64 products.
    schur_precision: str = "default"
    # Precision island for the dense KKT factor+solve: "float64" casts the
    # assembled Schur complement to f64 for factorization and the
    # triangular solves (a small (m+dual)^2 matrix), casting solutions
    # back to the solve dtype.
    # None = factor in the solve dtype.  Dense path only.
    kkt_island_dtype: Optional[str] = None

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SolverConfig()
