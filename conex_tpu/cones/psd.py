"""Real PSD cone via dense linear matrix inequalities (LMIs), batched.

A JAX re-implementation of the reference's PsdConstraint /
DenseLMIConstraint (/root/reference/conex/psd_constraint.{h,cc},
dense_lmi_constraint.{h,cc}).  One block holds B same-shape LMIs
``C_b - sum_i y_i A_{b,i} >= 0`` (PSD) over the same variable subset.

The reference's hot O(m^2 n^2) Schur panel (the SCHUR_COMPLEMENT_FUNCTION
macro, dense_lmi_constraint.cc:72-88) becomes two einsums:
    P = A @ W                      (B, m, n, n)  — m batched matmuls
    G = einsum('bmik,bnki->mn', P, P)
using tr(A_m W A_n W) = tr((A_m W)(A_n W)), which avoids materializing the
W A_m W panel.  The eigenvalue estimates use the asymmetric-Lanczos scan and
the geodesic step uses the Pade exponential (algebra/sym.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..algebra import mm, sym
from .base import SchurOut, SlackStats


class PSDState(NamedTuple):
    """PSD cone state: the iterate W plus warm-start eigenvector seeds.

    The reference's workspace holds only W (psd_constraint.h); this
    rebuild carries the extreme-eigenvector estimates of the WS product
    across iterations so the per-iteration eigenvalue estimation is a
    handful of warm power-iteration matvecs instead of ~28 cold batched
    matmuls (algebra/sym.py::extreme_eigenvalues_warm).  lam == 0 is the
    cold-start sentinel (identity initialization / warmstart aborts).
    """

    w: jnp.ndarray  # (B, n, n)
    vhi: jnp.ndarray  # (B, n) right eigenvector seed, max end
    uhi: jnp.ndarray  # (B, n) left eigenvector seed, max end
    vlo: jnp.ndarray  # (B, n) right eigenvector seed, min end
    ulo: jnp.ndarray  # (B, n) left eigenvector seed, min end
    lam: jnp.ndarray  # (B, 2) previous (lo, hi) estimates; zeros = cold


def make_psd_state(w) -> PSDState:
    """Build a PSDState around an iterate array of shape (..., n, n)."""
    n = w.shape[-1]
    ones = jnp.full(w.shape[:-1], 1.0 / (n ** 0.5), w.dtype)
    lam = jnp.zeros(w.shape[:-2] + (2,), w.dtype)
    return PSDState(w=w, vhi=ones, uhi=ones, vlo=ones, ulo=ones, lam=lam)


class PSDStepCache(NamedTuple):
    WS: jnp.ndarray  # (B, n, n) the product W * minus_s
    seeds: tuple  # updated (vhi, uhi, vlo, ulo)
    lam: jnp.ndarray  # (B, 2) updated estimates


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseLMICone:
    """A batch of B LMIs: C_b - sum_i y_i A_{b,i} PSD, over v variables."""

    A: jnp.ndarray  # (B, v, n, n) symmetric constraint matrices
    C: jnp.ndarray  # (B, n, n) symmetric affine term
    vars_: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    # Pre-sliced Ozaki operands of A (mm.ozaki_prepare) for the f64
    # accuracy path: (slices, mu, t, s) for the Schur panel pattern and
    # the slack contraction pattern respectively.  A is loop-invariant;
    # slicing it is ~s elementwise passes over the biggest tensor in the
    # problem and must not run per Newton iteration.
    A_ozp: Optional[tuple] = None
    A_ozs: Optional[tuple] = None

    supports_line_search = False
    dual_scale = 1.0

    @property
    def batch(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[2]

    @property
    def num_vars(self) -> int:
        return self.A.shape[1]

    def rank(self) -> int:
        return self.n * self.batch

    def identity_state(self, dtype) -> PSDState:
        # reference: SetIdentity (psd_constraint.cc:92-95)
        return make_psd_state(
            jnp.broadcast_to(
                jnp.eye(self.n, dtype=dtype), (self.batch, self.n, self.n)
            )
        )

    def prepare(self):
        """Precompute solve-loop invariants (called by _solve_impl before
        entering the Newton loop): in ozaki mode, the pre-sliced f64
        operands of A."""
        if (
            mm.get_mode() != "ozaki"
            or self.A.dtype != jnp.float64
            or self.A_ozp is not None
        ):
            return self
        B, v, n, _ = self.A.shape
        return dataclasses.replace(
            self,
            A_ozp=mm.ozaki_prepare(
                "bvij,bjk->bvik", self.A.shape, (B, n, n), self.A, "x"
            ),
            A_ozs=mm.ozaki_prepare(
                "v,bvij->bij", (v,), self.A.shape, self.A, "y"
            ),
        )

    def _minus_s(self, y, k):
        # reference: ComputeNegativeSlack (dense_lmi_constraint.cc:24-27):
        # minus_s = sum_i y_i A_i - k C
        return (
            mm.einsum("v,bvij->bij", y, self.A, y_prep=self.A_ozs)
            - k * self.C
        )

    def schur(self, state: PSDState) -> SchurOut:
        # reference: SCHUR_COMPLEMENT_FUNCTION (dense_lmi_constraint.cc:72-103)
        w = state.w
        P = mm.einsum("bvij,bjk->bvik", self.A, w,
                      x_prep=self.A_ozp)  # A_i W panel
        CW = mm.matmul(self.C, w)
        if mm.get_mode() == "ozaki" and P.dtype == jnp.float64:
            # P is both operands of the G contraction — slice it once per
            # index role (the roles contract different axes of P).
            P_px = mm.ozaki_prepare(
                "bvik,buki->vu", P.shape, P.shape, P, which="x"
            )
            P_py = mm.ozaki_prepare(
                "bvik,buki->vu", P.shape, P.shape, P, which="y"
            )
        else:
            P_px = P_py = None
        G = mm.einsum("bvik,buki->vu", P, P,
                      x_prep=P_px, y_prep=P_py)  # tr(A_v W A_u W)
        AW = jnp.einsum("bvii->v", P)  # tr(A_v W)
        if P_px is not None:
            P_pa = mm.ozaki_prepare(
                "bik,bvki->v", CW.shape, P.shape, P, which="y"
            )
        else:
            P_pa = None
        AQc = mm.einsum("bik,bvki->v", CW, P,
                        y_prep=P_pa)  # tr(C W A_v W)
        w_dot_c = jnp.einsum("bii->", CW)
        c_dot_Qc = mm.einsum("bik,bki->", CW, CW)  # tr(C W C W)
        return SchurOut(G=G, AW=AW, AQc=AQc, w_dot_c=w_dot_c, c_dot_Qc=c_dot_Qc)

    def _extreme_eigs(self, WS, state: PSDState):
        """(lam_lo, lam_hi, seeds, lam) of WS per batch element.

        The reference estimates these with heuristically-seeded asymmetric
        Lanczos + a tridiagonal eigensolver (psd_constraint.cc:63-77).  A
        tridiagonal eigensolver is bisection — branchy sequential control
        flow that cripples XLA both at compile and run time inside the
        jitted loop — so we use matmul-only estimators: the squaring
        estimator on cold starts (lam == 0 sentinel) and warm power
        iteration from the carried eigenvector seeds otherwise.
        """
        is_cold = jnp.max(jnp.abs(state.lam)) == 0.0

        def cold(_):
            return sym.extreme_eigenvalues_seeded(WS)

        def warm(_):
            # Step count scales with the order: 16 steps stall the mu
            # progression at n=300 (clustered spectra need deeper power
            # iteration; the reference runs n/2 Lanczos iterations,
            # psd_constraint.cc:63-77).  Measured: n=300 instances that
            # oscillated unsolved for 250 iterations at 16 steps solve in
            # ~45 iterations at 48.
            steps = max(16, min(64, self.n // 6))
            return sym.extreme_eigenvalues_warm(
                WS, state.vhi, state.uhi, state.vlo, state.ulo, state.lam,
                num_steps=steps,
            )

        return jax.lax.cond(is_cold, cold, warm, None)

    def prepare_step(self, state: PSDState, y, c_weight, e_weight):
        # reference: PrepareStep (psd_constraint.cc:45-84)
        w = state.w
        minus_s = self._minus_s(y, c_weight)
        WS = mm.matmul(w, minus_s)
        lo, hi, seeds, lam = self._extreme_eigs(WS, state)
        norminf = jnp.max(
            jnp.maximum(jnp.abs(e_weight + lo), jnp.abs(e_weight + hi))
        )
        # norm2 = tr(WS WS) + 2 tr(WS) + rank (psd_constraint.cc:79-80;
        # the reference assumes e_weight = 1 here).
        normsq = (
            mm.einsum("bik,bki->", WS, WS)
            + 2.0 * jnp.einsum("bii->", WS)
            + self.rank()
        )
        return PSDStepCache(WS=WS, seeds=seeds, lam=lam), norminf, normsq

    def take_step(self, state: PSDState, cache: PSDStepCache, step_size):
        # reference: GeodesicUpdate (psd_constraint.cc:13-28): with
        # d = WS + e I (e_weight folded in by TakeStep), compute
        # W <- expm(step * d) W, then re-symmetrize.
        w = state.w
        n = self.n
        d = cache.WS + jnp.eye(n, dtype=w.dtype)
        d = d * step_size
        # ||d * step|| <= sqrt(2) by the step-size rule, so Taylor+squaring
        # reaches ~1e-12 — and unlike the reference's Pade solve
        # (exponential_map_pade.cc:23-32) it is matmul-only, so it batches
        # without an LU factorization.
        expd = sym.expm_taylor(d)
        w_new = mm.matmul(expd, w)
        w_new = 0.5 * (w_new + jnp.swapaxes(w_new, 1, 2))
        vhi, uhi, vlo, ulo = cache.seeds
        return PSDState(
            w=w_new, vhi=vhi, uhi=uhi, vlo=vlo, ulo=ulo, lam=cache.lam
        )

    def affine_step(self, state: PSDState, y, e_weight):
        # reference: PrepareStep(affine) + AffineUpdate
        # (psd_constraint.cc:30-43, 53-57): W <- (1 + e) W + W S W.
        w = state.w
        minus_s = self._minus_s(y, 0.0)
        WSW = mm.matmul(mm.matmul(w, minus_s), w)
        return state._replace(w=(1.0 + e_weight) * w + WSW)

    def slack_stats(self, state: PSDState, y, c_weight) -> SlackStats:
        # reference: GetWeightedSlackEigenvalues (psd_constraint.cc:97-128)
        w = state.w
        minus_s = self._minus_s(y, c_weight)
        WS = mm.matmul(w, minus_s)
        lo, hi, _, _ = self._extreme_eigs(WS, state)
        lam_max = -lo
        lam_min = -hi
        return SlackStats(
            lam_min=jnp.min(lam_min),
            lam_max=jnp.max(lam_max),
            frob_sq=mm.einsum("bik,bki->", WS, WS),
            trace=-jnp.einsum("bii->", WS),
        )

    def dual_variable(self, state: PSDState):
        return state.w
