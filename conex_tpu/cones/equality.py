"""Affine equality constraints A y = b.

The equivalent of the reference's EqualityConstraints
(/root/reference/conex/equality_constraint.{h,cc}).  An equality block has no
cone iterate; it contributes the off-diagonal blocks [0 A^T; A 0] to the KKT
matrix and b to the residual AQc (equality_constraint.cc:13-28), and its dual
variable lambda is read back from the tail of the KKT solution
(equality_constraint.cc:30-35).  Its presence forces the LDLT KKT path
(reference kkt_solver.cc:180-187).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EqualityBlock:
    A: jnp.ndarray  # (p, v)
    b: jnp.ndarray  # (p,)
    vars_: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    # Row offset of this block's dual variables within the KKT system,
    # counted from the start of the dual-variable segment (i.e. the block's
    # duals occupy KKT rows [m + dual_offset, m + dual_offset + p)).
    # reference: constraint_manager.h:71-86 (duals appended after primals).
    dual_offset: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def p(self) -> int:
        return self.A.shape[0]

    @property
    def num_vars(self) -> int:
        return self.A.shape[1]

    def rank(self) -> int:
        # reference: equality_constraint.h:30
        return 0

    def dual_variable(self, y_full: jnp.ndarray, m: int) -> jnp.ndarray:
        """lambda = tail of KKT solution (equality_constraint.cc:30-35)."""
        off = m + self.dual_offset
        return jax.lax.dynamic_slice(y_full, (off,), (self.p,))
