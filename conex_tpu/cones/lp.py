"""Linear (nonnegative-orthant) cone block.

A JAX re-implementation of the reference's LinearConstraint
(/root/reference/conex/linear_constraint.{h,cc}).  The cone is
``c - A^T y >= 0`` elementwise; the iterate ``w`` is a positive vector.
Everything is elementwise work plus two matmuls in the Schur assembly,
so no hand-written kernel is needed: XLA fuses the elementwise chains.

Key formulas (reference file:line cited per method):
  minus_s = A y - k c                        (linear_constraint.cc:164-168)
  d = e_weight + w * minus_s                 (linear_constraint.cc:108-128)
  take_step: w <- w * exp(step * d)          (linear_constraint.cc:130-144)
  schur: G += (WA)^T (WA), AW += A^T w, ...  (linear_constraint.cc:177-205)
  exact line search by interval intersection (linear_constraint.cc:47-103)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .base import SchurOut, SlackStats, StepCache


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LinearCone:
    """A block of n linear inequalities over v variables."""

    A: jnp.ndarray  # (n, v)
    c: jnp.ndarray  # (n,)
    vars_: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    supports_line_search = True

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def num_vars(self) -> int:
        return self.A.shape[1]

    def rank(self) -> int:
        # reference: linear_constraint.h:51
        return self.n

    def identity_state(self, dtype) -> jnp.ndarray:
        # reference: SetIdentity, linear_constraint.cc:105
        return jnp.ones((self.n,), dtype=dtype)

    def _minus_s(self, y: jnp.ndarray, k) -> jnp.ndarray:
        # reference: ComputeNegativeSlack, linear_constraint.cc:164-168
        return self.A @ y - k * self.c

    def schur(self, w: jnp.ndarray) -> SchurOut:
        # reference: ConstructSchurComplementSystem,
        # linear_constraint.cc:177-205
        WA = w[:, None] * self.A
        WC = w * self.c
        G = WA.T @ WA
        AW = self.A.T @ w
        AQc = WA.T @ WC
        return SchurOut(
            G=G,
            AW=AW,
            AQc=AQc,
            w_dot_c=jnp.sum(WC),
            c_dot_Qc=jnp.sum(WC * WC),
        )

    def prepare_step(self, w, y, c_weight, e_weight):
        # reference: PrepareStep, linear_constraint.cc:108-128
        d = w * self._minus_s(y, c_weight) + e_weight
        norminf = jnp.max(jnp.abs(d))
        normsq = jnp.sum(d * d)
        return StepCache(d=d), norminf, normsq

    def take_step(self, w, cache: StepCache, step_size):
        # reference: TakeStep, linear_constraint.cc:130-144
        return w * jnp.exp(step_size * cache.d)

    def affine_step(self, w, y, e_weight):
        # reference: PrepareStep(affine) + AffineUpdate,
        # linear_constraint.cc:124-127, 170-175.  Used for dual recovery:
        # W += W * (minus_s * W), with minus_s = A y (c_weight = 0).
        sw = self._minus_s(y, 0.0) * w
        return w * (1.0 + e_weight) + w * sw

    def slack_stats(self, w, y, c_weight) -> SlackStats:
        # reference: GetWeightedSlackEigenvalues, linear_constraint.cc:147-162
        ws = w * self._minus_s(y, c_weight)
        return SlackStats(
            lam_min=-jnp.max(ws),
            lam_max=-jnp.min(ws),
            frob_sq=jnp.sum(ws * ws),
            trace=-jnp.sum(ws),
        )

    def line_search(self, w, y0, y1, c0_weight, c1_weight, dinf_max):
        # reference: PerformLineSearch + FindMinimumMu,
        # linear_constraint.cc:47-103.  d(mu) is affine in mu along the
        # segment (y0,c0) -> (y1,c1); each coordinate gives an interval of
        # admissible mu; intersect them all.
        d0 = w * self._minus_s(y0, c0_weight) + 1.0
        d1 = w * self._minus_s(y1, c1_weight) + 1.0
        delta = d1 - d0
        bound_a = (dinf_max - d0) / delta
        bound_b = (-dinf_max - d0) / delta
        hi = jnp.maximum(bound_a, bound_b)
        lo = jnp.minimum(bound_a, bound_b)
        upper = jnp.min(hi)
        lower = jnp.max(lo)
        fail = lower > upper
        return lower, upper, fail

    def dual_variable(self, w):
        # reference: constraint.h:159-166 (dual variable == workspace W)
        return w
