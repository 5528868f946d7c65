"""Host-side program builder.

The analogue of the reference's ``Program``
(/root/reference/conex/cone_program.h:99-243): collects constraints, then
stages them as a static tuple of cone blocks + arrays and invokes the single
jitted solve loop.  Unlike the reference there is no mutable arena — solver
state is a pytree threaded through the compiled iteration, and warmstarting
is explicit state passing (the pytree of final cone iterates is the
checkpoint; reference cone_program.h:106-109, test_warmstart.cc).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .config import COLDSTART, WARMSTART, KKT_SOLVER_LDLT, SolverConfig
from .cones.equality import EqualityBlock
from .cones.lp import LinearCone
from .cones.hermitian import HermitianCone
from .cones.psd import DenseLMICone
from .cones.qcost import QuadraticCost
from .cones.quadratic import QuadraticCone, epigraph_cone_data
from .cones.soc import SOCCone
from .solver.loop import SolveResult, solve_compiled

# Above this many cliques the solve uses the block-compressed supernodal
# path (supernodal/compressed.py: flat padded per-clique factor buffer,
# scan-compiled factorization) instead of unrolling per clique.
SCAN_CLIQUE_THRESHOLD = 24


def _as_tuple_or_none(variables, num_vars_total, v):
    if variables is None:
        return None
    t = tuple(int(x) for x in variables)
    if len(set(t)) != len(t):
        raise ValueError("duplicate variables in constraint")
    if t == tuple(range(v)):
        return None  # dense fast path
    return t


@dataclasses.dataclass
class Result:
    """Solve outcome; mirrors ConexStatus (cone_program.h:40-45) + solution."""

    solved: bool
    y: np.ndarray
    num_iterations: int
    primal_infeasible: bool
    dual_infeasible: bool
    stats_inv_sqrt_mu: np.ndarray
    stats_norminf_d: np.ndarray
    mu_stalled: bool = False  # not in the reference: mu made no progress (see
    # SolverConfig.mu_stall_iterations); iterate is returned as-is
    _raw: SolveResult = dataclasses.field(repr=False, default=None)

    def report(self) -> str:
        """Per-iteration metric table, mirroring the reference's REPORT
        output under CONEX_VERBOSE (cone_program.cc:460-468)."""
        raw = self._raw
        n = self.num_iterations
        lines = ["  i         mu        d_2      d_inf         by         cx   kkt_err"]
        mu = 1.0 / np.asarray(raw.stats_k)[:n] ** 2
        for i in range(n):
            lines.append(
                f"{i:3d} {mu[i]:10.2e} {float(raw.stats_d2[i]):10.2e} "
                f"{float(raw.stats_dinf[i]):10.2e} {float(raw.stats_by[i]):10.2e} "
                f"{float(raw.stats_cx[i]):10.2e} {float(raw.stats_err[i]):9.2e}"
            )
        return "\n".join(lines)


class Program:
    """A conic program: maximize b'y  s.t.  c - A y in K, A_eq y = b_eq."""

    def __init__(self, num_vars: int, dtype=jnp.float64):
        self.num_vars = int(num_vars)
        # Guard a silent footgun: without jax_enable_x64, JAX truncates
        # requested float64 arrays to float32 with only a UserWarning —
        # which here would silently change the solver's accuracy class.
        if (jnp.dtype(dtype) == jnp.float64
                and not jax.config.read("jax_enable_x64")):
            raise ValueError(
                "Program(dtype=float64) requires jax_enable_x64 "
                '(jax.config.update("jax_enable_x64", True) before any '
                "jax usage), otherwise JAX silently truncates to "
                "float32.  Pass dtype=jnp.float32 explicitly for an f32 "
                "solve (see PRECISION.md for the precision modes)."
            )
        self.dtype = dtype
        self._blocks: List = []
        self._eq_blocks: List[EqualityBlock] = []
        self._dual_size = 0
        self._has_quadratic_cost = False
        self._ws = None  # warmstart state (final cone iterates)
        self._scalings = None  # (b_scaling, c_scaling) from last solve
        self._last_result: Optional[SolveResult] = None

    # -- construction ------------------------------------------------------

    def add_linear_constraint(self, A, c, variables=None):
        """c - A y >= 0 elementwise (reference LinearConstraint)."""
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        c = np.asarray(c, dtype=np.float64).reshape(-1)
        if A.shape[0] != c.shape[0]:
            raise ValueError("A rows must match c length")
        vars_ = _as_tuple_or_none(variables, self.num_vars, A.shape[1])
        self._blocks.append(
            LinearCone(
                A=jnp.asarray(A, self.dtype),
                c=jnp.asarray(c, self.dtype),
                vars_=vars_,
            )
        )
        return len(self._blocks) - 1

    def add_soc_constraint(self, A, c, variables=None):
        """c - A y in the Lorentz cone (reference SOCConstraint).

        A: (n+1, v), c: (n+1,) for a single cone; or batched
        A: (B, n+1, v), c: (B, n+1) for B same-shape cones on the same
        variable subset (solved fully vectorized).
        """
        A = np.asarray(A, dtype=np.float64)
        c = np.asarray(c, dtype=np.float64)
        if A.ndim == 2:
            A = A[None]
            c = c[None]
        if A.shape[:2] != c.shape:
            raise ValueError("A and c batch/cone dimensions must match")
        vars_ = _as_tuple_or_none(variables, self.num_vars, A.shape[2])
        self._blocks.append(
            SOCCone(
                A=jnp.asarray(A, self.dtype),
                c=jnp.asarray(c, self.dtype),
                vars_=vars_,
            )
        )
        return len(self._blocks) - 1

    def add_lmi_constraint(self, A, C, variables=None):
        """C - sum_i y_i A_i PSD (reference DenseLMIConstraint).

        A: (v, n, n) stack of symmetric matrices, C: (n, n) for a single
        LMI; or batched A: (B, v, n, n), C: (B, n, n) for B same-shape LMIs
        over the same variable subset.
        """
        A = np.asarray(A, dtype=np.float64)
        C = np.asarray(C, dtype=np.float64)
        if A.ndim == 3:
            A = A[None]
            C = C[None]
        if A.shape[2] != A.shape[3] or A.shape[0] != C.shape[0] or C.shape[1:] != A.shape[2:]:
            raise ValueError("LMI shapes must be A:(B,v,n,n), C:(B,n,n)")
        if not np.allclose(A, np.swapaxes(A, 2, 3)) or not np.allclose(
            C, np.swapaxes(C, 1, 2)
        ):
            raise ValueError("LMI matrices must be symmetric")
        vars_ = _as_tuple_or_none(variables, self.num_vars, A.shape[1])
        self._blocks.append(
            DenseLMICone(
                A=jnp.asarray(A, self.dtype),
                C=jnp.asarray(C, self.dtype),
                vars_=vars_,
            )
        )
        return len(self._blocks) - 1

    def add_quadratic_cone_constraint(self, A, c, Q=None, variables=None):
        """c - A y in the Q-weighted Lorentz cone (reference
        QuadraticConstraint): slack (s0, s1) with s0 >= sqrt(s1' Q s1).

        A: (n+1, v), c: (n+1,), Q: (n, n) PSD or None (identity); or the
        batched forms with a leading B axis.
        """
        A = np.asarray(A, dtype=np.float64)
        c = np.asarray(c, dtype=np.float64)
        if A.ndim == 2:
            A = A[None]
            c = c[None]
            if Q is not None:
                Q = np.asarray(Q, dtype=np.float64)[None]
        if A.shape[:2] != c.shape:
            raise ValueError("A and c batch/cone dimensions must match")
        if Q is not None:
            Q = np.asarray(Q, dtype=np.float64)
            if Q.shape != (A.shape[0], A.shape[1] - 1, A.shape[1] - 1):
                raise ValueError("Q must be (B, n, n) matching A")
        vars_ = _as_tuple_or_none(variables, self.num_vars, A.shape[2])
        self._blocks.append(
            QuadraticCone.build(
                jnp.asarray(A, self.dtype),
                jnp.asarray(c, self.dtype),
                None if Q is None else jnp.asarray(Q, self.dtype),
                vars_=vars_,
            )
        )
        return len(self._blocks) - 1

    def add_quadratic_cost_epigraph(self, Qi, variables, epigraph_variable):
        """Adds the constraint t >= 1/2 x'Qi x via a Q-weighted Lorentz cone,
        where x = variables and t = epigraph_variable.

        reference: AddQuadraticCostEpigraph
        (quadratic_cone_constraint.h:91-118).  Add -1 * t to the objective
        to minimize the quadratic cost.
        """
        Qi = np.atleast_2d(np.asarray(Qi, dtype=np.float64))
        variables = list(variables)
        if len(variables) != Qi.shape[0]:
            raise ValueError("Qi order must match number of variables")
        Q, A, b = epigraph_cone_data(jnp.asarray(Qi, self.dtype))
        return self.add_quadratic_cone_constraint(
            np.asarray(A),
            np.asarray(b),
            Q=np.asarray(Q),
            variables=variables + [int(epigraph_variable)],
        )

    def add_hermitian_constraint(self, A, C, variables=None):
        """C - sum_i y_i A_i PSD in a hypercomplex Hermitian algebra.

        reference: HermitianPsdConstraint<T> (hermitian_psd.h).  Formats:
        - complex dtype A: (v, n, n), C: (n, n) -> complex algebra (d = 2)
        - real stacked A: (v, d, n, n), C: (d, n, n), d in {1, 2, 4, 8}
        - batched real stacked A: (B, v, d, n, n), C: (B, d, n, n)
        Component 0 must be symmetric, components >= 1 skew-symmetric.
        Octonions (d = 8) require n <= 3 (the Albert algebra).
        """
        A = np.asarray(A)
        C = np.asarray(C)
        if np.iscomplexobj(A):
            A = np.stack([A.real, A.imag], axis=-3)
            C = np.stack([np.asarray(C).real, np.asarray(C).imag], axis=-3)
        A = A.astype(np.float64)
        C = C.astype(np.float64)
        if A.ndim == 4:
            A = A[None]
            C = C[None]
        if A.ndim != 5 or C.ndim != 4 or A.shape[2:] != C.shape[1:] or A.shape[0] != C.shape[0]:
            raise ValueError(
                "Hermitian LMI shapes must be A:(B,v,d,n,n), C:(B,d,n,n)"
            )
        d = A.shape[2]
        if d not in (1, 2, 4, 8):
            raise ValueError("algebra dimension must be 1, 2, 4, or 8")
        if d == 8 and A.shape[-1] > 3:
            raise ValueError("octonion Hermitian cones require order <= 3")
        for M in (A.reshape(-1, d, *A.shape[-2:]), C.reshape(-1, d, *C.shape[-2:])):
            if not np.allclose(M[:, 0], np.swapaxes(M[:, 0], -1, -2)):
                raise ValueError("component 0 must be symmetric")
            if d > 1 and not np.allclose(
                M[:, 1:], -np.swapaxes(M[:, 1:], -1, -2)
            ):
                raise ValueError("components >= 1 must be skew-symmetric")
        vars_ = _as_tuple_or_none(variables, self.num_vars, A.shape[1])
        self._blocks.append(
            HermitianCone(
                A=jnp.asarray(A, self.dtype),
                C=jnp.asarray(C, self.dtype),
                vars_=vars_,
            )
        )
        return len(self._blocks) - 1

    def add_quadratic_cost(self, Q, variables=None):
        """Adds -1/2 y'Q y to the (maximized) objective.

        reference: Program::AddQuadraticCost (cone_program.cc:554-570).
        Requires enable_line_search and no rescaling at solve time
        (reference guard cone_program.cc:237-240, enforced in solve()).
        """
        Q = np.atleast_2d(np.asarray(Q, dtype=np.float64))
        if Q.shape[0] != Q.shape[1] or not np.allclose(Q, Q.T):
            raise ValueError("quadratic cost must be square symmetric")
        vars_ = _as_tuple_or_none(variables, self.num_vars, Q.shape[0])
        self._has_quadratic_cost = True
        self._blocks.append(
            QuadraticCost(Q=jnp.asarray(Q, self.dtype), vars_=vars_)
        )
        return len(self._blocks) - 1

    def add_equality_constraint(self, A, b, variables=None):
        """A y = b (reference EqualityConstraints)."""
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        vars_ = _as_tuple_or_none(variables, self.num_vars, A.shape[1])
        blk = EqualityBlock(
            A=jnp.asarray(A, self.dtype),
            b=jnp.asarray(b, self.dtype),
            vars_=vars_,
            dual_offset=self._dual_size,
        )
        self._dual_size += A.shape[0]
        self._eq_blocks.append(blk)
        return len(self._eq_blocks) - 1

    def _add_block(self, blk):
        self._blocks.append(blk)
        return len(self._blocks) - 1

    # -- incremental updates ----------------------------------------------

    def update_linear_operator(self, i, value, variable, row, col=0,
                               hyper_complex_dim=0):
        """Update one entry of constraint i's linear operator in place
        (functionally: the staged array is rebuilt, structure unchanged so
        compiled solvers and warmstart state stay valid).

        reference: Program::UpdateLinearOperatorOfConstraint
        (cone_program.h:147-159) with per-cone semantics of
        UpdateLinearOperator (linear_constraint.cc:207-216,
        soc_constraint.cc:314-324, hermitian_psd.cc:248-283).
        """
        blk = self._blocks[i]
        v = float(value)
        if isinstance(blk, LinearCone):
            if hyper_complex_dim != 0 or col != 0:
                raise ValueError("linear constraints are real vector valued")
            A = blk.A.at[row, variable].set(v)
            self._blocks[i] = dataclasses.replace(blk, A=A)
        elif isinstance(blk, SOCCone):
            if hyper_complex_dim != 0 or col != 0:
                raise ValueError("SOC constraints are real vector valued")
            A = blk.A.at[0, row, variable].set(v)
            self._blocks[i] = dataclasses.replace(blk, A=A)
        elif isinstance(blk, DenseLMICone):
            if hyper_complex_dim != 0:
                raise ValueError("use a Hermitian constraint for d > 1")
            A = blk.A.at[0, variable, row, col].set(v)
            A = A.at[0, variable, col, row].set(v)
            self._blocks[i] = dataclasses.replace(blk, A=A)
        elif isinstance(blk, HermitianCone):
            d = hyper_complex_dim
            if value != 0 and row == col and d > 0:
                raise ValueError("imaginary diagonal must be zero")
            A = blk.A.at[0, variable, d, row, col].set(v)
            A = A.at[0, variable, d, col, row].set(v if d == 0 else -v)
            self._blocks[i] = dataclasses.replace(blk, A=A)
        else:
            raise ValueError("constraint does not support operator updates")

    def update_affine_term(self, i, value, row, col=0, hyper_complex_dim=0):
        """Update one entry of constraint i's affine term.

        reference: Program::UpdateAffineTermOfConstraint
        (cone_program.h:161-172).
        """
        blk = self._blocks[i]
        v = float(value)
        if isinstance(blk, LinearCone):
            self._blocks[i] = dataclasses.replace(blk, c=blk.c.at[row].set(v))
        elif isinstance(blk, SOCCone):
            self._blocks[i] = dataclasses.replace(
                blk, c=blk.c.at[0, row].set(v)
            )
        elif isinstance(blk, DenseLMICone):
            C = blk.C.at[0, row, col].set(v).at[0, col, row].set(v)
            self._blocks[i] = dataclasses.replace(blk, C=C)
        elif isinstance(blk, HermitianCone):
            d = hyper_complex_dim
            C = blk.C.at[0, d, row, col].set(v)
            C = C.at[0, d, col, row].set(v if d == 0 else -v)
            self._blocks[i] = dataclasses.replace(blk, C=C)
        else:
            raise ValueError("constraint does not support affine updates")

    # -- solving -----------------------------------------------------------

    def _kkt_structure(self):
        """Supernodal clique-tree structure when the program is sparse.

        Cliques are per-block variable sets, with equality dual indices
        appended to their constraint's clique (reference
        constraint_manager.h:71-86).  Dense programs (every block spanning
        all variables) use the dense factorization.  reference: kkt_solver.cc
        104-116 (GetData on cliques + dual vars); valid_leaf weighting
        forces dual-bearing cliques inward (clique_ordering.cc:99-107).
        """
        if not any(blk.vars_ is not None for blk in self._blocks) and not any(
            eq.vars_ is not None for eq in self._eq_blocks
        ):
            return None
        from .supernodal.solver import SupernodalStructure

        n_kkt = self.num_vars + self._dual_size
        cliques = []
        valid_leaf = []
        for blk in self._blocks:
            c = list(blk.vars_) if blk.vars_ is not None else list(
                range(blk.num_vars)
            )
            cliques.append(c)
            valid_leaf.append(1)
        for eq in self._eq_blocks:
            c = list(eq.vars_) if eq.vars_ is not None else list(
                range(eq.num_vars)
            )
            c = c + [self.num_vars + eq.dual_offset + i for i in range(eq.p)]
            cliques.append(c)
            valid_leaf.append(0)
        struct = SupernodalStructure.from_cliques(
            cliques, n_kkt, valid_leaf=valid_leaf
        )
        # Many-clique programs: switch to the block-compressed scan
        # factorization — compile time O(1) in clique count AND memory
        # O(sum of block sizes) instead of O(N^2); assembly scatters each
        # cone contribution directly into the per-clique blocks (see
        # supernodal/compressed.py).  The unrolled path stays for
        # few-clique programs where per-clique shapes beat padding
        # overhead.
        if len(struct.blocks) > SCAN_CLIQUE_THRESHOLD:
            from .supernodal.compressed import CompressedSupernodalStructure

            return CompressedSupernodalStructure.from_structure(struct)
        return struct

    def _default_config(self, config: Optional[SolverConfig]) -> SolverConfig:
        if config is None:
            config = SolverConfig()
        if self._eq_blocks and config.kkt_solver == 0:
            # Equality duals make the KKT matrix indefinite; the reference
            # forces the LDLT path (kkt_solver.cc:180-187).
            config = config.replace(kkt_solver=KKT_SOLVER_LDLT)
        return config

    def solve(self, b, config: Optional[SolverConfig] = None) -> Result:
        """Maximize b'y over the constraints.  reference: Solve(b, prog, ...)."""
        config = self._default_config(config)
        if self._has_quadratic_cost and not (
            config.enable_line_search and not config.enable_rescaling
        ):
            # reference guard: cone_program.cc:237-240.
            raise ValueError(
                "quadratic costs require enable_line_search=True and "
                "enable_rescaling=False"
            )
        b = jnp.asarray(np.asarray(b, dtype=np.float64).reshape(-1), self.dtype)
        if b.shape[0] != self.num_vars:
            raise ValueError("objective dimension mismatch")
        if not self._blocks:
            raise ValueError("empty program: add at least one cone constraint")

        blocks = tuple(self._blocks)
        eq_blocks = tuple(self._eq_blocks)
        kkt_structure = self._kkt_structure()

        warm = (
            config.initialization_mode == WARMSTART
            and self._ws is not None
        )
        if config.initialization_mode == WARMSTART and self._ws is None:
            config = config.replace(initialization_mode=COLDSTART)
            warm = False

        if warm:
            init_ws = self._ws
            b_scaling, c_scaling = self._scalings
        else:
            init_ws = tuple(blk.identity_state(self.dtype) for blk in blocks)
            b_scaling = jnp.ones((), self.dtype)
            c_scaling = jnp.ones((), self.dtype)

        init_scalars = dict(
            k=jnp.zeros((), self.dtype),
            b_scaling=b_scaling,
            c_scaling=c_scaling,
        )

        raw = solve_compiled(
            blocks, eq_blocks, b, init_ws, init_scalars, config,
            kkt_structure=kkt_structure,
        )
        raw = jax.tree.map(lambda x: np.asarray(x) if hasattr(x, "shape") else x, raw)

        self._ws = jax.tree.map(jnp.asarray, raw.ws)
        self._scalings = (
            jnp.asarray(raw.b_scaling),
            jnp.asarray(raw.c_scaling),
        )
        self._last_result = raw
        return Result(
            solved=bool(raw.solved),
            y=np.asarray(raw.y),
            num_iterations=int(raw.num_iterations),
            primal_infeasible=bool(raw.primal_infeasible),
            dual_infeasible=bool(raw.dual_infeasible),
            stats_inv_sqrt_mu=np.asarray(raw.stats_k)[: int(raw.num_iterations)],
            stats_norminf_d=np.asarray(raw.stats_dinf)[: int(raw.num_iterations)],
            mu_stalled=bool(raw.mu_stalled),
            _raw=raw,
        )

    # -- readback ----------------------------------------------------------

    def get_dual_variable(self, i: int) -> np.ndarray:
        """Dual (primal-cone) variable of constraint i.

        reference: Program::GetDualVariable (cone_program.h:120-134) — the
        cone iterate divided by (inv_sqrt_mu * b_scaling).  Requires the last
        solve to have used prepare_dual_variables=True for exact duals.
        """
        raw = self._last_result
        if raw is None:
            raise RuntimeError("no solve yet")
        blk = self._blocks[i]
        w = np.asarray(blk.dual_variable(raw.ws[i])) * getattr(
            blk, "dual_scale", 1.0
        )
        if not bool(raw.primal_infeasible):
            w = w / (float(raw.k) * float(raw.b_scaling))
        if w.ndim >= 2 and w.shape[0] == 1:
            w = w[0]  # single-cone batch: return the cone element itself
        return w

    def get_equality_dual(self, i: int) -> np.ndarray:
        """lambda of equality block i, from the KKT solution tail.

        reference: equality_constraint.cc:30-35 (lambda = y tail).  Scaled
        by 1/(inv_sqrt_mu * b_scaling) like the cone duals so that the
        stationarity condition b = A_cone' x + A_eq' lambda holds.
        """
        raw = self._last_result
        if raw is None:
            raise RuntimeError("no solve yet")
        eq = self._eq_blocks[i]
        off = self.num_vars + eq.dual_offset
        lam = np.asarray(raw.y_kkt)[off : off + eq.p]
        if not bool(raw.primal_infeasible):
            lam = lam / (float(raw.k) * float(raw.b_scaling))
        return lam

    # -- checkpoint / resume ----------------------------------------------

    def save_state(self) -> dict:
        """Serializable warmstart checkpoint: the cone iterates + scalings.

        The reference's checkpoint is its caller-owned arena buffer
        (cone_program.h:106-109); here the pytree of final iterates is the
        checkpoint — plain numpy arrays, storable with np.savez/orbax.
        """
        if self._ws is None:
            raise RuntimeError("no state yet: solve first")
        return dict(
            ws=jax.tree.map(np.asarray, self._ws),
            b_scaling=float(self._scalings[0]),
            c_scaling=float(self._scalings[1]),
        )

    def load_state(self, state: dict) -> None:
        """Restore a checkpoint produced by save_state; the next solve with
        initialization_mode=WARMSTART resumes from it exactly
        (reference test_warmstart.cc:47-79 semantics)."""
        self._ws = jax.tree.map(
            lambda w: jnp.asarray(w, self.dtype), tuple(state["ws"])
        )
        self._scalings = (
            jnp.asarray(state["b_scaling"], self.dtype),
            jnp.asarray(state["c_scaling"], self.dtype),
        )

    def get_feasible_objective(self) -> np.ndarray:
        """b = 0.5 * A(w) at w = identity — a feasible objective generator.

        reference: GetFeasibleObjective (cone_program.cc:535-545).
        """
        from .solver.loop import assemble

        blocks = tuple(self._blocks)
        eq_blocks = tuple(self._eq_blocks)
        ws = tuple(blk.identity_state(self.dtype) for blk in blocks)
        n_kkt = self.num_vars + self._dual_size
        _, AW, _, _, _ = assemble(
            blocks, eq_blocks, ws, n_kkt, self.num_vars, self.dtype
        )
        return 0.5 * np.asarray(AW)[: self.num_vars]
