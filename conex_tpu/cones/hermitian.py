"""Hermitian PSD cones over hypercomplex algebras, batched.

A JAX re-implementation of the reference's HermitianPsdConstraint<T>
for T in {Real, Complex, Quaternions, Octonions}
(/root/reference/conex/hermitian_psd.{h,cc}).  A block holds B same-shape
Hermitian LMIs ``C_b - sum_i y_i A_{b,i} >= 0`` in the algebra of dimension
``d`` (a static field; d = 8 selects the octonion specializations:
non-associativity forces Q-representation products, the closed-form scaled
geodesic update, and the reference's heuristic norm estimates,
hermitian_psd.cc:116-168).

Spectral estimates for d <= 4 go through the faithful real representation
(eigenvalues with multiplicity d) and the matmul-only squaring estimator —
replacing the reference's randomly-seeded hypercomplex Lanczos
(hermitian_psd.cc:59) with a deterministic, more accurate kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..algebra import hypercomplex as hc
from ..algebra import sym
from .base import SchurOut, SlackStats

# Trace-time benchmark switch: force the cold squaring estimator on every
# iteration (see bench_hermitian.py).
FORCE_COLD = False


class HermState(NamedTuple):
    """Hermitian cone state for d <= 4: the iterate plus warm eigenvector
    seeds on the real representation R(WS) (dn x dn), mirroring PSDState
    (psd.py:29-53).  Carrying the seeds turns the per-iteration spectral
    estimation into ~16 warm power-iteration matvecs on R(WS) instead of
    the ~28 cold batched matmuls of the squaring estimator — on a matrix
    d times larger than the algebra order, this dominates the hermitian
    hot path.  lam == 0 is the cold-start sentinel.  Octonions (d = 8)
    never compute spectra (heuristic norms, hermitian_psd.cc:147-168) and
    keep a bare-array state."""

    w: jnp.ndarray  # (B, d, n, n)
    vhi: jnp.ndarray  # (B, dn) right eigenvector seed, max end
    uhi: jnp.ndarray  # (B, dn) left eigenvector seed, max end
    vlo: jnp.ndarray  # (B, dn)
    ulo: jnp.ndarray  # (B, dn)
    lam: jnp.ndarray  # (B, 2) previous (lo, hi) estimates; zeros = cold


def make_herm_state(w) -> HermState:
    """Build a HermState around an iterate array of shape (B, d, n, n)."""
    B = w.shape[0]
    dn = w.shape[1] * w.shape[-1]
    ones = jnp.full((B, dn), 1.0 / (dn ** 0.5), w.dtype)
    lam = jnp.zeros((B, 2), w.dtype)
    return HermState(w=w, vhi=ones, uhi=ones, vlo=ones, ulo=ones, lam=lam)


class HermStepCache(NamedTuple):
    WS: jnp.ndarray  # (B, d, n, n): W * minus_s (d<=4) or minus_s (d=8)
    seeds: tuple = ()  # updated (vhi, uhi, vlo, ulo) for d <= 4
    lam: Optional[jnp.ndarray] = None  # (B, 2) updated estimates


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HermitianCone:
    """A batch of B Hermitian-PSD LMIs over a d-dimensional algebra."""

    A: jnp.ndarray  # (B, v, d, n, n)
    C: jnp.ndarray  # (B, d, n, n)
    vars_: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    supports_line_search = False
    dual_scale = 1.0

    @property
    def batch(self) -> int:
        return self.A.shape[0]

    @property
    def d(self) -> int:
        return self.A.shape[2]

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def num_vars(self) -> int:
        return self.A.shape[1]

    @property
    def octonion(self) -> bool:
        return self.d == 8

    def rank(self) -> int:
        # reference: hermitian_psd.h:57 (rank = matrix order n)
        return self.n * self.batch

    def identity_state(self, dtype):
        e = jnp.zeros((self.batch, self.d, self.n, self.n), dtype=dtype)
        e = e.at[:, 0].set(jnp.eye(self.n, dtype=dtype))
        if self.octonion:
            return e
        return make_herm_state(e)

    def _w(self, state):
        return state if self.octonion else state.w

    def _minus_s(self, y, k):
        # reference: ComputeNegativeSlack (hermitian_psd.h:104-109)
        return jnp.einsum("v,bvdij->bdij", y, self.A) - k * self.C

    def _waw(self, w, x):
        """W x W for associative algebras, Q(W)x for octonions
        (hermitian_psd.cc:182-187)."""
        if self.octonion:
            return hc.quadratic_representation(w, x)
        return hc.multiply(w, hc.multiply(x, w))

    def schur(self, state) -> SchurOut:
        # reference: ConstructSchurComplementSystem (hermitian_psd.cc:170-230)
        w = self._w(state)
        WAW = jax.vmap(self._waw, in_axes=(None, 1), out_axes=1)(w, self.A)
        G = jnp.einsum("budij,bvdij->uv", self.A, WAW)
        AW = jnp.einsum("bvdij,bdij->v", self.A, w)
        AQc = jnp.einsum("bdij,bvdij->v", self.C, WAW)
        WCW = self._waw(w, self.C)
        return SchurOut(
            G=G,
            AW=AW,
            AQc=AQc,
            w_dot_c=jnp.einsum("bdij,bdij->", self.C, w),
            c_dot_Qc=jnp.einsum("bdij,bdij->", self.C, WCW),
        )

    def _extreme_eigs(self, WS, state: HermState):
        """(lo, hi, seeds, lam) spectrum extremes of WS via the real
        representation R(WS) (eigenvalues appear with multiplicity d).

        The reference uses hypercomplex Lanczos with a random seed and
        n/2 + 1 iterations (hermitian_psd.cc:59); here the cold squaring
        estimator runs only when the carried lam == 0 sentinel says so, and
        every later iteration warm-starts power iteration from the carried
        eigenvector seeds — the same warm-seed design as the real PSD cone
        (psd.py::PSDState)."""
        R = hc.real_representation(WS)
        if FORCE_COLD:
            # Benchmark-only escape hatch (benchmarks/bench_hermitian.py):
            # run the cold squaring estimator every iteration to measure
            # what the warm seeds buy.
            return sym.extreme_eigenvalues_seeded(R)
        is_cold = jnp.max(jnp.abs(state.lam)) == 0.0

        def cold(_):
            return sym.extreme_eigenvalues_seeded(R)

        def warm(_):
            # Step count scales with the real-representation order (see
            # psd.py::_extreme_eigs — clustered spectra at large order
            # stall the mu progression at the fixed 16 steps).
            steps = max(16, min(64, R.shape[-1] // 6))
            return sym.extreme_eigenvalues_warm(
                R, state.vhi, state.uhi, state.vlo, state.ulo, state.lam,
                num_steps=steps,
            )

        return jax.lax.cond(is_cold, cold, warm, None)

    def prepare_step(self, state, y, c_weight, e_weight):
        w = self._w(state)
        minus_s = self._minus_s(y, c_weight)
        if self.octonion:
            # reference: PrepareStep<Octonions> (hermitian_psd.cc:130-145)
            trace_ws = hc.trace_inner_product(w, minus_s)  # (B,)
            qws = hc.quadratic_representation(w, minus_s)
            normsq = jnp.sum(
                hc.trace_inner_product(qws, minus_s)
                + 2.0 * trace_ws
            ) + self.rank()
            norminf = jnp.max((trace_ws + self.n) / 3.0)
            return HermStepCache(WS=minus_s), norminf, normsq

        # reference: PrepareStep<T> (hermitian_psd.cc:33-71)
        WS = hc.multiply(w, minus_s)
        lo, hi, seeds, lam = self._extreme_eigs(WS, state)
        norminf = jnp.max(
            jnp.maximum(jnp.abs(e_weight + lo), jnp.abs(e_weight + hi))
        )
        WSWS = hc.multiply(WS, WS)
        normsq = (
            jnp.einsum("bii->", WSWS[:, 0])
            + 2.0 * jnp.einsum("bii->", WS[:, 0])
            + self.rank()
        )
        return HermStepCache(WS=WS, seeds=seeds, lam=lam), norminf, normsq

    def take_step(self, state, cache: HermStepCache, step_size):
        w = self._w(state)
        if self.octonion:
            # reference: TakeStep<Octonions> (hermitian_psd.cc:116-128)
            return hc.geodesic_update_scaled(w, step_size * cache.WS)
        # reference: TakeStep<T> (hermitian_psd.cc:9-31)
        d_alg = cache.WS + hc.identity(self.d, self.n, w.dtype)
        expd = hc.exponential_map(step_size * d_alg)
        w_new = hc.make_hermitian(hc.multiply(expd, w))
        vhi, uhi, vlo, ulo = cache.seeds
        return HermState(
            w=w_new, vhi=vhi, uhi=uhi, vlo=vlo, ulo=ulo, lam=cache.lam
        )

    def affine_step(self, state, y, e_weight):
        # reference: PrepareStep affine branch (hermitian_psd.cc:43-57);
        # octonions use the Q-representation linearization.
        w = self._w(state)
        minus_s = self._minus_s(y, 0.0)
        if self.octonion:
            return (1.0 + e_weight) * w + hc.quadratic_representation(
                w, minus_s
            )
        WS = hc.multiply(w, minus_s)
        return state._replace(w=(1.0 + e_weight) * w + hc.multiply(WS, w))

    def slack_stats(self, state, y, c_weight) -> SlackStats:
        w = self._w(state)
        minus_s = self._minus_s(y, c_weight)
        if self.octonion:
            # reference heuristics: GetWeightedSlackEigenvalues<Octonions>
            # (hermitian_psd.cc:147-168)
            qws = hc.quadratic_representation(w, minus_s)
            frob = hc.trace_inner_product(qws, minus_s)  # (B,)
            tr_ws = hc.trace_inner_product(w, minus_s)
            lam_max = jnp.abs(frob) / (1e-15 + jnp.abs(tr_ws))
            lam_min = 0.01 * lam_max
            return SlackStats(
                lam_min=jnp.min(lam_min),
                lam_max=jnp.max(lam_max),
                frob_sq=jnp.sum(frob),
                trace=-jnp.sum(tr_ws),
            )
        WS = hc.multiply(w, minus_s)
        lo, hi, _, _ = self._extreme_eigs(WS, state)
        WSWS = hc.multiply(WS, WS)
        return SlackStats(
            lam_min=jnp.min(-hi),
            lam_max=jnp.max(-lo),
            frob_sq=jnp.einsum("bii->", WSWS[:, 0]),
            trace=-jnp.einsum("bii->", WS[:, 0]),
        )

    def dual_variable(self, state):
        return self._w(state)
