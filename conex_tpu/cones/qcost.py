"""Quadratic cost block: adds Q to the KKT matrix (a cost, not a cone).

A JAX re-implementation of the reference's QuadraticFunction
(/root/reference/conex/quadratic_cost.cc).  Solves
    maximize  b'y - 1/2 y'Q y   subject to cones
by contributing Q to the top-left KKT block (quadratic_cost.cc:46-57).
Requires line-search mu selection and no rescaling
(reference guard, cone_program.cc:237-240).  Rank 0; every cone-sweep
method is the neutral element.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .base import SchurOut, SlackStats, StepCache


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuadraticCost:
    Q: jnp.ndarray  # (v, v) symmetric PSD cost matrix
    vars_: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    supports_line_search = True  # no-op success (quadratic_cost.cc:59-66)
    dual_scale = 1.0
    is_cost = True

    @property
    def num_vars(self) -> int:
        return self.Q.shape[1]

    def rank(self) -> int:
        return 0

    def identity_state(self, dtype) -> jnp.ndarray:
        return jnp.zeros((0,), dtype=dtype)

    def schur(self, w) -> SchurOut:
        v = self.num_vars
        zero = jnp.zeros((), dtype=self.Q.dtype)
        return SchurOut(
            G=self.Q,
            AW=jnp.zeros((v,), self.Q.dtype),
            AQc=jnp.zeros((v,), self.Q.dtype),
            w_dot_c=zero,
            c_dot_Qc=zero,
        )

    def prepare_step(self, w, y, c_weight, e_weight):
        zero = jnp.zeros((), dtype=self.Q.dtype)
        return StepCache(d=w), zero, zero

    def take_step(self, w, cache, step_size):
        return w

    def affine_step(self, w, y, e_weight):
        return w

    def slack_stats(self, w, y, c_weight) -> SlackStats:
        dt = self.Q.dtype
        return SlackStats(
            lam_min=jnp.asarray(jnp.inf, dt),
            lam_max=jnp.asarray(-jnp.inf, dt),
            frob_sq=jnp.zeros((), dt),
            trace=jnp.zeros((), dt),
        )

    def line_search(self, w, y0, y1, c0_weight, c1_weight, dinf_max):
        dt = self.Q.dtype
        return (
            jnp.asarray(-jnp.inf, dt),
            jnp.asarray(jnp.inf, dt),
            jnp.asarray(False),
        )

    def dual_variable(self, w):
        return w
