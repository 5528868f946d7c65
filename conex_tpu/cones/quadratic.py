"""Q-weighted second-order cones and the quadratic epigraph, batched.

A JAX re-implementation of the reference's QuadraticConstraintBase
(/root/reference/conex/quadratic_cone_constraint.{h,cc}): the Lorentz cone
under the inner product <x, y> = x0 y0 + x1' Q y1 (Q PSD; Q = None means
identity, recovering the plain SOC).  All spin-factor spectral machinery is
closed-form in the two Q-weighted eigenvalues x0 +/- |x1|_Q, and the Schur
complement uses the reference's rank-structured closed form

    A' Q(w) A = A'(w w' + det(w) R) A
              = -det(w) (A0 A0' - A1' Q A1) + 2 (A1'Q w1 + A0 w0)(...)'

with A1' Q A1 precomputed once at construction (cached A_gram,
quadratic_cone_constraint.cc:210-213), so each iteration costs one matvec
and rank-1 outer products instead of per-column cone transforms.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .base import SchurOut, SlackStats


class QuadStepCache(NamedTuple):
    d0: jnp.ndarray  # (B,)
    d1: jnp.ndarray  # (B, n)
    w0s: jnp.ndarray  # (B,) sqrt(w) scalar part
    w1s: jnp.ndarray  # (B, n) sqrt(w) vector part


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuadraticCone:
    """A batch of B Q-weighted Lorentz cones: c - A y in K_Q."""

    A: jnp.ndarray  # (B, n+1, v)
    c: jnp.ndarray  # (B, n+1)
    Q: Optional[jnp.ndarray]  # (B, n, n) or None for identity
    A_gram: jnp.ndarray  # (B, v, v) = A1' Q A1 (precomputed)
    vars_: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    supports_line_search = False
    dual_scale = 2.0

    @staticmethod
    def build(A, c, Q=None, vars_=None):
        A = jnp.asarray(A)
        c = jnp.asarray(c)
        A1 = A[:, 1:, :]
        if Q is None:
            A_gram = jnp.einsum("bnv,bnu->bvu", A1, A1)
        else:
            Q = jnp.asarray(Q)
            A_gram = jnp.einsum("bnv,bnm,bmu->bvu", A1, Q, A1)
        return QuadraticCone(A=A, c=c, Q=Q, A_gram=A_gram, vars_=vars_)

    @property
    def batch(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[1] - 1

    @property
    def num_vars(self) -> int:
        return self.A.shape[2]

    def rank(self) -> int:
        return 2 * self.batch

    def identity_state(self, dtype) -> jnp.ndarray:
        e = jnp.zeros((self.batch, self.n + 1), dtype=dtype)
        return e.at[:, 0].set(1.0)

    # -- Q-metric helpers --------------------------------------------------

    def _qx(self, x1):
        """Q x1 (batched); identity if Q is None."""
        if self.Q is None:
            return x1
        return jnp.einsum("bnm,bm->bn", self.Q, x1)

    def _qnorm2(self, x1):
        return jnp.sum(x1 * self._qx(x1), axis=-1)

    def _qip(self, x1, y1):
        return jnp.sum(x1 * self._qx(y1), axis=-1)

    def _spectral(self, f, x0, x1):
        """f applied on the spectrum: parts of f(lam+)P+ + f(lam-)P-.

        reference: Exp/Sqrt (quadratic_cone_constraint.cc:57-74).
        """
        k = jnp.sqrt(jnp.abs(self._qnorm2(x1)))
        fp = f(x0 + k)
        fm = f(x0 - k)
        safe_k = jnp.where(k > 0, k, 1.0)
        y1 = x1 * jnp.where(k > 0, 0.5 * (fp - fm) / safe_k, 0.0)[..., None]
        y0 = 0.5 * (fp + fm)
        return y0, y1

    def _quad_rep(self, x0, x1, y0, y1):
        """Q(x) y in the Q-metric (quadratic_cone_constraint.cc:39-55)."""
        det_x = x0 * x0 - self._qnorm2(x1)
        scale = 2.0 * (x0 * y0 + self._qip(x1, y1))
        z0 = scale * x0 - det_x * y0
        z1 = scale[..., None] * x1 + det_x[..., None] * y1
        return z0, z1

    def _minus_s(self, y, k):
        ms = jnp.einsum("bnv,v->bn", self.A, y) - k * self.c
        return ms[:, 0], ms[:, 1:]

    # -- kernel interface --------------------------------------------------

    def schur(self, w: jnp.ndarray) -> SchurOut:
        # reference: ConstructSchurComplementSystem
        # (quadratic_cone_constraint.cc:239-290); everything x2 at the end
        # for the Jordan trace inner product.
        w0, w1 = w[:, 0], w[:, 1:]
        A0 = self.A[:, 0, :]  # (B, v)
        A1 = self.A[:, 1:, :]  # (B, n, v)
        C0, C1 = self.c[:, 0], self.c[:, 1:]
        Qw1 = self._qx(w1)
        det_w = w0 * w0 - jnp.sum(w1 * Qw1, axis=-1)
        A_dot_x = jnp.einsum("bnv,bn->bv", A1, Qw1)  # A1' Q w1
        r = A_dot_x + A0 * w0[:, None]  # (B, v)
        G = jnp.einsum(
            "b,bvu->vu", det_w, self.A_gram - jnp.einsum("bv,bu->bvu", A0, A0)
        ) + 2.0 * jnp.einsum("bv,bu->vu", r, r)
        AW = jnp.sum(r, axis=0)
        AQC1 = jnp.einsum("bnv,bn->bv", A1, self._qx(C1))
        scale = jnp.sum(w1 * self._qx(C1), axis=-1) + C0 * w0
        AQc = jnp.einsum("b,bv->v", det_w, AQC1 - A0 * C0[:, None]) + \
            2.0 * jnp.einsum("b,bv->v", scale, r)
        c_dot_x = jnp.sum(C1 * Qw1, axis=-1)
        c_dot_Qc = jnp.sum(
            det_w * (jnp.sum(C1 * self._qx(C1), axis=-1) - C0 * C0)
            + 2.0 * (c_dot_x + C0 * w0) * scale
        )
        w_dot_c = jnp.sum(scale)
        return SchurOut(
            G=2.0 * G,
            AW=2.0 * AW,
            AQc=2.0 * AQc,
            w_dot_c=2.0 * w_dot_c,
            c_dot_Qc=2.0 * c_dot_Qc,
        )

    def prepare_step(self, w, y, c_weight, e_weight):
        # reference: PrepareStep (quadratic_cone_constraint.cc:175-207)
        ms0, ms1 = self._minus_s(y, c_weight)
        w0s, w1s = self._spectral(jnp.sqrt, w[:, 0], w[:, 1:])
        d0, d1 = self._quad_rep(w0s, w1s, ms0, ms1)
        d0 = d0 + e_weight
        k = jnp.sqrt(jnp.abs(self._qnorm2(d1)))
        ev_hi, ev_lo = d0 + k, d0 - k
        norminf = jnp.max(jnp.maximum(jnp.abs(ev_hi), jnp.abs(ev_lo)))
        normsq = jnp.sum(ev_hi**2 + ev_lo**2)
        return QuadStepCache(d0=d0, d1=d1, w0s=w0s, w1s=w1s), norminf, normsq

    def take_step(self, w, cache: QuadStepCache, step_size):
        # reference: TakeStep (quadratic_cone_constraint.cc:117-137)
        d0 = step_size * cache.d0
        d1 = step_size * cache.d1
        e0, e1 = self._spectral(jnp.exp, d0, d1)
        z0, z1 = self._quad_rep(cache.w0s, cache.w1s, e0, e1)
        return jnp.concatenate([z0[:, None], z1], axis=1)

    def affine_step(self, w, y, e_weight):
        # First-order W += Q(w) s linearization (dual recovery); the
        # reference quadratic cone has no affine branch.
        ms0, ms1 = self._minus_s(y, 0.0)
        z0, z1 = self._quad_rep(w[:, 0], w[:, 1:], ms0, ms1)
        z = jnp.concatenate([z0[:, None], z1], axis=1)
        return (1.0 + e_weight) * w + z

    def slack_stats(self, w, y, c_weight) -> SlackStats:
        # reference: GetWeightedSlackEigenvalues
        # (quadratic_cone_constraint.cc:138-173)
        ms0, ms1 = self._minus_s(y, c_weight)
        w0s, w1s = self._spectral(jnp.sqrt, w[:, 0], w[:, 1:])
        z0, z1 = self._quad_rep(w0s, w1s, ms0, ms1)
        k = jnp.sqrt(jnp.abs(self._qnorm2(z1)))
        lam_max = -(z0 - k)
        lam_min = -(z0 + k)
        return SlackStats(
            lam_min=jnp.min(lam_min),
            lam_max=jnp.max(lam_max),
            frob_sq=jnp.sum(lam_max**2 + lam_min**2),
            trace=jnp.sum(lam_max + lam_min),
        )

    def dual_variable(self, w):
        return w


def epigraph_cone_data(Qi: jnp.ndarray):
    """(Q, A, b) of the Lorentz-cone encoding of t >= 1/2 x'Qi x.

    reference: AddQuadraticCostEpigraph (quadratic_cone_constraint.h:91-118):
    with z the cost variables and t the epigraph variable,
    (0.5 t + 1)^2 >= (0.5 t - 1)^2 + x'Qi x  <=>  2 t >= x'Qi x.
    """
    nz = Qi.shape[0]
    Q = jnp.zeros((nz + 1, nz + 1), Qi.dtype)
    Q = Q.at[0, 0].set(1.0).at[1:, 1:].set(Qi)
    A = jnp.zeros((nz + 2, nz + 1), Qi.dtype)
    A = A.at[0, nz].set(-0.5).at[1, nz].set(-0.5)
    A = A.at[2:, :nz].set(jnp.eye(nz, dtype=Qi.dtype))
    b = jnp.zeros((nz + 2,), Qi.dtype)
    b = b.at[0].set(1.0).at[1].set(-1.0)
    return Q, A, b
