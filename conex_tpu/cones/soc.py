"""Second-order (Lorentz) cone blocks, batched.

A JAX re-implementation of the reference's SOCConstraint
(/root/reference/conex/soc_constraint.{h,cc}).  One block holds a *batch* of
B same-dimension cones over the same variable subset; all spin-factor math is
closed-form in the two eigenvalues and vectorizes across the batch, replacing
the reference's per-constraint virtual-dispatch loop with a handful of
einsums (reference design note: SURVEY.md §7).

The reference mutates its workspace so that W holds w^{1/2} between
PrepareStep and TakeStep (soc_constraint.cc:251-270); here the iterate stays
w and w^{1/2} travels in the step cache.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..algebra import spin
from .base import SchurOut, SlackStats


class SOCStepCache(NamedTuple):
    d: jnp.ndarray  # (B, n+1) Newton direction in the algebra
    wsqrt: jnp.ndarray  # (B, n+1) cached square root of the iterate


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SOCCone:
    """A batch of B Lorentz-cone constraints: c_b - A_b y in Q^{n+1}."""

    A: jnp.ndarray  # (B, n+1, v)
    c: jnp.ndarray  # (B, n+1)
    vars_: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    supports_line_search = False
    # The spin-factor trace inner product is 2 u.v; scaling the stored
    # iterate by 2 makes the user-facing dual satisfy the *euclidean*
    # conditions A'x = b, <slack, x> ~ 0 (the reference never fixes a SOC
    # dual convention — its SOC kernel lacks the affine recovery path).
    dual_scale = 2.0

    @property
    def batch(self) -> int:
        return self.A.shape[0]

    @property
    def num_vars(self) -> int:
        return self.A.shape[2]

    def rank(self) -> int:
        # Each Lorentz cone has rank 2 (soc_constraint.h:24).
        return 2 * self.batch

    def identity_state(self, dtype) -> jnp.ndarray:
        e = jnp.zeros((self.batch, self.A.shape[1]), dtype=dtype)
        return e.at[:, 0].set(1.0)

    def _minus_s(self, y, k):
        # reference: ComputeNegativeSlack (soc_constraint.cc:193-197)
        return jnp.einsum("bnv,v->bn", self.A, y) - k * self.c

    def schur(self, w: jnp.ndarray) -> SchurOut:
        # reference: ConstructSchurComplementSystem (soc_constraint.cc:272-303)
        wsqrt = spin.sqrt(w)
        # WA[:, :, i] = Q(wsqrt) A[:, :, i]; Q is linear in its argument, so
        # apply it to all columns at once via broadcasting.
        WA = spin.quadratic_representation(
            wsqrt[:, None, :], jnp.swapaxes(self.A, 1, 2)
        )  # (B, v, n+1): row b,i holds Q(wsqrt_b) A_b[:, i]
        WsqrtC = spin.quadratic_representation(wsqrt, self.c)  # (B, n+1)
        G = 2.0 * jnp.einsum("bvn,bun->vu", WA, WA)
        AW = 2.0 * jnp.einsum("bnv,bn->v", self.A, w)
        AQc = 2.0 * jnp.einsum("bvn,bn->v", WA, WsqrtC)
        return SchurOut(
            G=G,
            AW=AW,
            AQc=AQc,
            w_dot_c=2.0 * jnp.sum(WsqrtC[:, 0]),
            c_dot_Qc=2.0 * jnp.sum(WsqrtC * WsqrtC),
        )

    def prepare_step(self, w, y, c_weight, e_weight):
        # reference: PrepareStep (soc_constraint.cc:251-270)
        minus_s = self._minus_s(y, c_weight)
        wsqrt = spin.sqrt(w)
        d = spin.quadratic_representation(wsqrt, minus_s)
        d = d.at[:, 0].add(e_weight)
        norminf = jnp.max(spin.norm_inf(d))
        normsq = 2.0 * jnp.sum(d * d)
        return SOCStepCache(d=d, wsqrt=wsqrt), norminf, normsq

    def take_step(self, w, cache: SOCStepCache, step_size):
        # reference: TakeStep (soc_constraint.cc:225-249)
        expd = spin.exp(step_size * cache.d)
        return spin.quadratic_representation(cache.wsqrt, expd)

    def affine_step(self, w, y, e_weight):
        # Dual recovery: first-order update W += Q(w) s with s = A y.
        # The reference SOC kernel has no affine branch (its PrepareStep
        # ignores opt.affine, soc_constraint.cc:251); this implements the
        # linearization used by the LP/PSD cones (psd_constraint.cc:30-43)
        # specialized to the spin factor.
        minus_s = self._minus_s(y, 0.0)
        return w * (1.0 + e_weight) + spin.quadratic_representation(w, minus_s)

    def slack_stats(self, w, y, c_weight) -> SlackStats:
        # reference: GetWeightedSlackEigenvalues (soc_constraint.cc:200-223)
        minus_s = self._minus_s(y, c_weight)
        wsqrt = spin.sqrt(w)
        ws = spin.quadratic_representation(wsqrt, minus_s)
        ev = spin.eigenvalues(ws)  # (B, 2)
        lam_max = -jnp.min(ev, axis=-1)
        lam_min = -jnp.max(ev, axis=-1)
        return SlackStats(
            lam_min=jnp.min(lam_min),
            lam_max=jnp.max(lam_max),
            frob_sq=jnp.sum(lam_max**2 + lam_min**2),
            trace=jnp.sum(lam_max + lam_min),
        )

    def dual_variable(self, w):
        return w
