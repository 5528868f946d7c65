"""Spin-factor (Lorentz cone) Jordan algebra, batched.

Vectorized re-implementation of the spectral machinery in
/root/reference/conex/soc_constraint.cc:14-191.  Elements are vectors
x = (x0, x1) in R^{1+n}; every op below is closed-form in the two
eigenvalues lam_pm = x0 +/- ||x1|| and vectorizes over an arbitrary batch of
cones — no per-cone loops, just VPU-friendly elementwise math and reductions
along the trailing axis.

Conventions: arrays have shape (..., 1+n); index 0 is the scalar part.
"""

from __future__ import annotations

import jax.numpy as jnp


def eigenvalues(x):
    """Both spin-factor eigenvalues, shape (..., 2): (x0+|x1|, x0-|x1|).

    reference: SpectralDecompSpinFactor::Compute (soc_constraint.cc:42-51).
    """
    x0 = x[..., 0]
    nq = jnp.linalg.norm(x[..., 1:], axis=-1)
    return jnp.stack([x0 + nq, x0 - nq], axis=-1)


def _spectral_apply(x, fn):
    """y = fn(lam1) P1 + fn(lam2) P2 with idempotents P_i = (1, +/-q)/2.

    reference: Idempotents (soc_constraint.cc:57-69); q = x1/|x1| with the
    |x1| = 0 convention that the essential part vanishes.
    """
    x0 = x[..., 0]
    x1 = x[..., 1:]
    nq = jnp.linalg.norm(x1, axis=-1)
    qhat = jnp.where(nq[..., None] > 0, x1 / jnp.where(nq == 0, 1.0, nq)[..., None], 0.0)
    f1 = fn(x0 + nq)
    f2 = fn(x0 - nq)
    head = 0.5 * (f1 + f2)
    tail = (0.5 * (f1 - f2))[..., None] * qhat
    return jnp.concatenate([head[..., None], tail], axis=-1)


def sqrt(x):
    """Jordan square root (soc_constraint.cc:145-163)."""
    return _spectral_apply(x, jnp.sqrt)


def exp(x):
    """Jordan exponential (soc_constraint.cc:165-176)."""
    return _spectral_apply(x, jnp.exp)


def det(x):
    """det x = x0^2 - |x1|^2."""
    return x[..., 0] ** 2 - jnp.sum(x[..., 1:] ** 2, axis=-1)


def quadratic_representation(x, y):
    """Q(x) y = 2 <x,y> x - det(x) R y with R = diag(1,-1,...,-1).

    reference: QuadraticRepresentation (soc_constraint.cc:130-143).
    Broadcasts over leading batch axes.
    """
    dot = jnp.sum(x * y, axis=-1, keepdims=True)
    minus_ry = jnp.concatenate([-y[..., :1], y[..., 1:]], axis=-1)
    return 2.0 * dot * x + det(x)[..., None] * minus_ry


def norm_inf(x):
    """max |lam| (soc_constraint.cc:178-191)."""
    ev = eigenvalues(x)
    return jnp.max(jnp.abs(ev), axis=-1)
