"""Matmul precision modes for the cone hot paths.

The reference is f64 end-to-end on CPU (cone_program.cc).  The Schur
panels, WS products and the geodesic exponential here run in the mode set
by ``SolverConfig.schur_precision``:

    default:          XLA's default precision.  On a GPU, f32 products may
                      run as TF32 (10-bit mantissa); f64 products are f64.
    highest, float32: ``Precision.HIGHEST``, full f32 products.
    x3: (xh + xl)(yh + yl) ~ xh yh + xh yl + xl yh, bf16 pieces — ~2^-16
    x6: 3-way bf16 split, 6 products                          — ~f32
    ozaki: f64 data as exact bf16 slices, products summed in f64 (below).

The split ladder writes x = hi + lo (+ lo2) with each term a bf16, expands
the product and drops the smallest cross terms; each pass is a bf16 matmul
with f32 accumulation.  Every partial product is wrapped in
``jax.lax.optimization_barrier`` so XLA's algebraic simplifier cannot
re-associate the split back into a single truncated dot (without barriers
the three x3 dots fold into one bf16 dot).  Which mode, if any, beats the
native f32 or f64 product on a given card is a measurement
(chip_smoke.py phase 3 runs them all).

The active mode is a trace-time setting (set it before/while tracing a
jitted function; it is baked into the trace, which is correct because the
solver retraces per static SolverConfig).

reference role: this ladder answers SURVEY.md §7's "f32 + compensated
accumulation for Schur panels" risk item.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

import jax
import jax.numpy as jnp
import numpy as np

MODES = ("default", "x3", "x6", "highest", "float32", "ozaki")

_mode: ContextVar[str] = ContextVar("conex_tpu_mm_mode", default="default")


def get_mode() -> str:
    return _mode.get()


def set_mode(m: str) -> None:
    if m not in MODES:
        raise ValueError(f"unknown mm mode {m!r}; valid: {MODES}")
    _mode.set(m)


@contextlib.contextmanager
def mode(m: str):
    if m not in MODES:
        raise ValueError(f"unknown mm mode {m!r}; valid: {MODES}")
    tok = _mode.set(m)
    try:
        yield
    finally:
        _mode.reset(tok)


# ---------------------------------------------------------------------------
# Ozaki-scheme f64 einsum from bf16 products
# ---------------------------------------------------------------------------
#
# The x3/x6 ladder below bottoms out at ~2^-24 relative error: every pass
# output passes through an f32 accumulator, and the hi*hi pass's own
# f32 rounding is ~1 ulp of the result no matter how many splits are added.
# To go below that floor the high passes must be EXACT, which is the Ozaki
# error-free-transformation scheme: scale each operand by a power of two,
# slice it into t-bit pieces aligned to absolute bit positions (so every
# slice is an integer times 2^-qt, exactly representable in bf16 for
# t <= 8), and bound the contraction length K so each pass's integer
# accumulation stays below 2^24 — then every pass result is *exactly*
# representable in f32, and the f64 combination of passes is limited only
# by the slice coverage (~2^-48 with the defaults).  Contractions too long
# for exactness are split by promoting contracted axes to batch axes and
# finishing the reduction in f64.
#
# Cost: ~21-28 bf16 passes with f32 accumulation per product — the engine
# behind SolverConfig.schur_precision="ozaki".  Whether it beats the
# card's native f64 matmul is a measurement, not an assumption.

# Slice coverage per operand (and kept pass depth).  48 bits leaves
# ~1e-13-class G-entry errors, which is exactly the Cholesky breakdown
# edge at the solver's endgame (cond(G) ~ 1/mu_scaled reaches 1e12+ at
# the reference's accuracy targets): 48 bits lost scenarios to
# factorization failures that 56 bits solved.  56 bits = s=7 slices at
# t=8 (28 passes), ~2^-56 entry error — genuine f64-class.
OZAKI_MIN_BITS = 56


# Pass arithmetic: "bf16" slices accumulate in f32 (exact up to
# K*2^(2t) <= 2^24, forcing axis promotion on large contractions) —
# the default.  "int8" slices with int32 accumulation lift the
# exactness bound to K ~ 2^17 at half the slice bytes, but only where the
# backend accumulates int8 products exactly in int32 (exact on CPU; an
# accelerator may lower it through an f32-class accumulator).  Select it
# with CONEX_TPU_OZAKI_IMPL=int8.
import os as _os

# "hybrid" (default): double-float slicing, 2 f64 elementwise ops per
# element — see _ozaki_slices_hybrid.  "bf16": pure-f64 slicing loop
# (portable oracle).  "int8": see the int8 note above.
OZAKI_IMPL = _os.environ.get("CONEX_TPU_OZAKI_IMPL", "hybrid")


def _ozaki_slices(x, term: str, contracted: str, t: int, s: int,
                  impl: str = "bf16"):
    """Split f64 ``x`` into ``s`` slices of ``t`` bits, power-of-two
    scaled PER ROW — i.e. per slice of the non-contracted dims, with the
    max taken over the pass-contracted dims only.  Row scaling (the real
    Ozaki scheme) keeps every output entry accurate relative to its own
    row/column scales, which matters enormously here: near convergence
    the iterate's spectrum spans ~1/mu (1e9+), and a per-tensor scale
    would truncate the small rows that become the KKT factor's small
    pivots (observed: per-tensor scaling capped duality gaps at ~1e-5;
    row scaling restores 1e-8-class gaps).

    bf16 impl: slice q holds round(r * 2^qt) / 2^qt (the magnitude is in
    the float).  int8 impl: slice q holds the bare integer round(r * 2^qt)
    (|int| <= 2^(t-1) + 1 — mu is doubled so r in (-1/2, 1/2]); the
    2^-(q+r)t pass magnitude is applied at combine time.

    Returns (slices, mu_free, free_letters): x ~ mu * sum(slices * unit_q)
    with mu broadcast over the contracted axes; mu_free is mu with the
    contracted axes squeezed out, indexed by free_letters (term order)."""
    if impl == "hybrid":
        return _ozaki_slices_hybrid(x, term, contracted, t, s)
    axes = tuple(i for i, ch in enumerate(term) if ch in contracted)
    free = "".join(ch for ch in term if ch not in contracted)
    amax = jnp.max(jnp.abs(x), axis=axes, keepdims=True) if axes else jnp.abs(x)
    e = jnp.ceil(jnp.log2(jnp.maximum(amax, 1e-300)))
    if impl == "int8":
        e = e + 1.0  # r in (-1/2, 1/2]: first-slice ints fit int8
    mu = jnp.where(amax > 0, jnp.exp2(e), 1.0).astype(x.dtype)
    r = x / mu
    slices = []
    for q in range(1, s + 1):
        f = float(2.0 ** (q * t))
        # Barrier before the subtraction: see _ozaki_slices_hybrid.
        xq = jax.lax.optimization_barrier(jnp.round(r * f))
        if impl == "int8":
            slices.append(xq.astype(jnp.int8))
        else:
            slices.append((xq / f).astype(jnp.bfloat16))
        r = r - xq / f
    mu_free = jnp.squeeze(mu, axis=axes) if axes else mu
    return slices, mu_free, free


def _hybrid_layout(t: int):
    """(n_h, pass list) for exact-slice width t: n_h t-bit exact slices
    covering the f32 head's 24 bits, plus 3 bf16 ladder pieces; passes
    kept down to ~2^-50 of the row-scale product."""
    n_h = -(-24 // t)
    passes = [(a, b) for a in range(n_h) for b in range(n_h)]  # exact

    def mag_h(q):
        return 2.0 ** (-t * q)

    def mag_l(j):
        return 2.0 ** (-25 - 8 * j)

    floor = 2.0 ** -50
    for a in range(n_h):
        for j in range(3):
            if mag_h(a) * mag_l(j) >= floor:
                passes.append((a, n_h + j))
                passes.append((n_h + j, a))
    for i_ in range(3):
        for j in range(3):
            if mag_l(i_) * mag_l(j) >= floor:
                passes.append((n_h + i_, n_h + j))
    return n_h, passes


def _ozaki_slices_hybrid(x, term: str, contracted: str, t: int, s: int):
    """Double-float hybrid slicing ("hybrid" impl): the top 24 bits as 3
    exact t=8 slices extracted with f32 arithmetic, the remainder as 3
    bf16 ladder pieces.

    Rationale: the pure-f64 slicing loop costs ~30 f64 ops per element
    per slice.  This path touches f64 only twice per element (x/mu and
    y - f32(y)); everything else is f32/bf16 elementwise work.

    Error: the ladder pieces have magnitude <= 2^-25 of the row scale, so
    their passes' f32-accumulator rounding (2^-24 relative to the pass) is
    <= 2^-49 ABSOLUTE — below the exact-pass depth — and only the 3x3
    exact-slice passes need the integer-exactness contraction bound.

    Returns (slices, mu_free, free): slices[0:n_h] exact t-bit slices
    (bf16 values, integer multiples of 2^-tq), slices[n_h:] ladder pieces
    (plain bf16 values).  ``t`` is the plan's exact-slice width (8, 7 or
    6 — narrower widths raise the exact-accumulation contraction bound to
    2^(24-2t), avoiding axis promotion on n=300-class panels); ``s`` is
    ignored (the layout fixes the slice count).
    """
    del s
    n_h = -(-24 // t)
    axes = tuple(i for i, ch in enumerate(term) if ch in contracted)
    free = "".join(ch for ch in term if ch not in contracted)
    amax = jnp.max(jnp.abs(x), axis=axes, keepdims=True) if axes else jnp.abs(x)
    e = jnp.ceil(jnp.log2(jnp.maximum(amax, 1e-300)))
    mu = jnp.where(amax > 0, jnp.exp2(e), 1.0).astype(x.dtype)
    y = x / mu  # f64 elementwise op 1
    # Every extracted piece is wrapped in optimization_barrier BEFORE the
    # following subtraction: without it XLA's algebraic simplifier folds
    # the cancel-and-subtract patterns (x - f32(x) -> 0 etc.) exactly as
    # documented for the x3/x6 ladder, and the low pieces come back
    # all-zero.
    c = jax.lax.optimization_barrier(y.astype(jnp.float32))
    # Exact absolute-position t-bit slices of c, f32 arithmetic (the
    # round-and-subtract extraction is exact in round-to-nearest).
    r = c
    slices = []
    for q in range(1, n_h + 1):
        f = float(2.0 ** (t * q))
        hq = jax.lax.optimization_barrier(jnp.round(r * f) / f)
        slices.append(hq.astype(jnp.bfloat16))
        r = r - hq
    # Remainder: (y - c) in f64 once, plus c's own sub-2^-24 tail r;
    # |l| <= ~2^-24, carried as 3 bf16 pieces (plain values, not
    # integer-aligned — their passes are small enough not to need it).
    l = (y - c).astype(jnp.float32) + r  # f64 elementwise op 2
    l1 = jax.lax.optimization_barrier(l.astype(jnp.bfloat16))
    rl = l - l1.astype(jnp.float32)
    l2 = jax.lax.optimization_barrier(rl.astype(jnp.bfloat16))
    l3 = (rl - l2.astype(jnp.float32)).astype(jnp.bfloat16)
    slices += [l1, l2, l3]
    mu_free = jnp.squeeze(mu, axis=axes) if axes else mu
    # Stacked (6, ...) layout: the stacked-pass path contracts all slice
    # pairs in one einsum; the per-pass path indexes the leading axis.
    return jnp.stack(slices), mu_free, free


# Stacked-pass execution for the hybrid impl: contract ALL slice pairs in
# one (or two) einsums with the slice axes as batch dims, then combine
# with small masked reductions.  The per-pass path issues ~26 einsums per
# call site (~600 XLA ops per Newton iteration across the cone kernels);
# the stacked path issues ~2.
OZAKI_STACKED = _os.environ.get("CONEX_TPU_OZAKI_STACKED", "0") == "1"


def _fresh_letters(used: str, count: int) -> str:
    import string

    out = []
    for ch in string.ascii_letters:
        if ch not in used:
            out.append(ch)
            if len(out) == count:
                return "".join(out)
    raise ValueError("no letters left")


def _ozaki_combine_stacked(plan, Xs, Ys, mux, muy, free_x, free_y, dtype,
                           exact_stacked=True):
    """All hybrid passes via stacked einsums.

    One 6x6 direct einsum covers every kept pass; the 3x3 exact-slice
    block additionally runs through the promoted pattern when the
    contraction is too long for exact f32 accumulation, replacing the
    direct block's (inexact) values.  Combination is a masked (P, Q)
    reduction in f64 — output-sized, two ops."""
    used = plan.a + plan.b + plan.out + plan.promoted
    P, Q = _fresh_letters(used, 2)
    s, n_h = plan.s, plan.n_h
    keep = np.zeros((s, s))
    for a, b_ in plan.hybrid_passes:
        keep[a, b_] = 1.0
    pd = jnp.einsum(
        f"{P}{plan.a},{Q}{plan.b}->{P}{Q}{plan.out}", Xs, Ys,
        preferred_element_type=jnp.float32,
    )
    pd = jax.lax.optimization_barrier(pd).astype(dtype)
    if plan.promoted:
        # The direct exact-slice block is f32-truncated on long
        # contractions; recompute it exactly through the promoted pattern.
        mask_h = jnp.asarray(keep[:n_h, :n_h], dtype)
        head = np.zeros((s, s))
        head[:n_h, :n_h] = 1.0
        mask_d = jnp.asarray(keep * (1.0 - head), dtype)
        if exact_stacked:
            ph = jnp.einsum(
                f"{P}{plan.a},{Q}{plan.b}->{P}{Q}{plan.promoted}{plan.out}",
                Xs[:n_h], Ys[:n_h], preferred_element_type=jnp.float32,
            )
            ph = jax.lax.optimization_barrier(ph).astype(dtype)
            ph = jnp.sum(ph, axis=tuple(range(2, 2 + len(plan.promoted))))
            hsum = jnp.einsum(
                f"{P}{Q},{P}{Q}{plan.out}->{plan.out}", mask_h, ph)
        else:
            # Promoted-exact block per pass: its stacked form would
            # materialize (n_h^2, promoted, out) at once.
            hsum = None
            for a in range(n_h):
                for b2 in range(n_h):
                    p = jnp.einsum(
                        f"{plan.a},{plan.b}->{plan.promoted}{plan.out}",
                        Xs[a], Ys[b2], preferred_element_type=jnp.float32,
                    )
                    p = jax.lax.optimization_barrier(p).astype(dtype)
                    p = jnp.sum(p, axis=tuple(range(len(plan.promoted))))
                    hsum = p if hsum is None else hsum + p
        out = (
            jnp.einsum(f"{P}{Q},{P}{Q}{plan.out}->{plan.out}", mask_d, pd)
            + hsum
        )
    else:
        mask = jnp.asarray(keep, dtype)
        out = jnp.einsum(f"{P}{Q},{P}{Q}{plan.out}->{plan.out}", mask, pd)
    scale = jnp.einsum(f"{free_x},{free_y}->{plan.out}", mux, muy)
    return out * scale


class _OzakiPlan:
    """Static einsum plan: pass pattern, slice widths, scale patterns."""

    def __init__(self, pattern: str, x_shape, y_shape, min_bits: int,
                 impl: str = "bf16"):
        import math

        a, rest = pattern.split(",")
        b, out = rest.split("->")
        sizes = {}
        for term, shape in ((a, x_shape), (b, y_shape)):
            if len(term) != len(shape):
                raise ValueError(
                    f"pattern {pattern!r} vs shapes {x_shape}, {y_shape} "
                    "(no ellipsis support)"
                )
            for ch, d in zip(term, shape):
                sizes[ch] = d
        contracted = sorted(
            {c for c in a if c in b and c not in out},
            key=lambda c: (-sizes[c], c),
        )
        promoted = []

        def K():
            out_ = 1
            for c in contracted:
                out_ *= sizes[c]
            return out_

        if impl == "int8":
            # Exactness: K * (2^(t-1) + 1)^2 < 2^31 in the int32
            # accumulator; t = 7 keeps products <= 65^2 < 2^13, so
            # contractions up to 2^17 run promotion-free.
            t = 7
            while K() > 2 ** 17 and contracted:
                promoted.append(contracted.pop(0))  # largest remaining
        elif impl == "hybrid":
            # Only the exact-slice passes need the integer-exactness
            # bound K <= 2^(24-2t); narrow the slice width (more slices,
            # same 24-bit coverage) before resorting to axis promotion —
            # a promoted pass output carries the promoted axis, which
            # multiplies the memory of n=300-class panels.
            while K() > 4096 and contracted:
                promoted.append(contracted.pop(0))
            Kv = K()
            t = 8 if Kv <= 256 else (7 if Kv <= 1024 else 6)
        else:
            def width():
                return (24 - max(0, math.ceil(math.log2(max(K(), 1))))) // 2

            t = width()
            while t < 6 and contracted:
                promoted.append(contracted.pop(0))
                t = width()
            t = min(8, t)
        self.impl = impl
        self.t = t
        if impl == "hybrid":
            self.n_h, self.hybrid_passes = _hybrid_layout(t)
            self.s = self.n_h + 3
        else:
            self.s = max(1, -(-min_bits // self.t))
        self.a, self.b, self.out = a, b, out
        self.contracted = "".join(contracted)  # pass-contracted letters
        self.promoted = "".join(promoted)
        self.pass_pattern = f"{a},{b}->{self.promoted}{out}"
        # Row scales are constant over contracted AND promoted axes: the
        # promoted-axis reduction can then run per pass in f64 (before the
        # scale multiply), so no (promoted + out)-shaped accumulator or
        # scale tensor is ever materialized — the scale is output-sized.
        self.reduce = self.contracted + self.promoted

    def key(self):
        return (self.impl, self.t, self.s, self.reduce)


def ozaki_prepare(pattern: str, x_shape, y_shape, operand,
                  which: str = "x", min_bits=None):
    """Pre-slice a loop-invariant operand for _ozaki_einsum.

    Slicing costs ~s elementwise passes over the (often large) f64
    operand; XLA does not reliably hoist it out of a while_loop, so
    loop-invariant operands (the LMI operator A) are sliced once up front
    (same motivation as DenseLMICone.prepare's At).  Returns
    (slices, mu, free_letters, plan_key) — valid only for the
    (pattern, shapes) plan it was built with; _ozaki_einsum checks."""
    if min_bits is None:
        min_bits = OZAKI_MIN_BITS
    plan = _OzakiPlan(pattern, x_shape, y_shape, min_bits, OZAKI_IMPL)
    term = plan.a if which == "x" else plan.b
    slices, mu, free = _ozaki_slices(
        operand, term, plan.reduce, plan.t, plan.s, plan.impl
    )
    # The term is part of the key: the same tensor used in a different
    # index role (e.g. P as both operands of the G contraction) has
    # different contracted AXES, hence different row scales and slices.
    return (slices, mu, free, plan.key(), term)


def _ozaki_einsum(pattern: str, x, y, min_bits=None,
                  x_prep=None, y_prep=None):
    """f64 two-operand einsum via exact bf16 passes (see module section
    comment).  Output error ~ sqrt(K) * 2^-min_bits relative to each
    entry's own row/column scales — far below the f32-accumulator floor."""
    if min_bits is None:
        min_bits = OZAKI_MIN_BITS
    plan = _OzakiPlan(pattern, x.shape, y.shape, min_bits, OZAKI_IMPL)
    if (x_prep is not None and x_prep[3] == plan.key()
            and x_prep[4] == plan.a):
        xs, mux, free_x = x_prep[0], x_prep[1], x_prep[2]
    else:
        xs, mux, free_x = _ozaki_slices(
            x, plan.a, plan.reduce, plan.t, plan.s, plan.impl
        )
    if (y_prep is not None and y_prep[3] == plan.key()
            and y_prep[4] == plan.b):
        ys, muy, free_y = y_prep[0], y_prep[1], y_prep[2]
    else:
        ys, muy, free_y = _ozaki_slices(
            y, plan.b, plan.reduce, plan.t, plan.s, plan.impl
        )
    s = plan.s
    n_promoted = len(plan.promoted)
    int8 = plan.impl == "int8"
    acc_t = jnp.int32 if int8 else jnp.float32
    if plan.impl == "hybrid":
        pass_list = [(a + 1, b + 1) for a, b in plan.hybrid_passes]
    else:
        pass_list = [
            (q, r)
            for q in range(1, s + 1)
            for r in range(1, s + 1)
            if q + r <= s + 1  # below that: under the coverage floor
        ]
    direct_pattern = f"{plan.a},{plan.b}->{plan.out}"
    if plan.impl == "hybrid" and OZAKI_STACKED:
        # Stacking materializes (s, s, out) before the masked reduce —
        # only worth it (and only SAFE) when the output is small relative
        # to the operands (G/AQc-class contractions, not the panel
        # einsums whose output IS the big tensor: stacking multiplies
        # the panel's memory by s^2 = 36).
        sizes = {}
        for term, shape in ((plan.a, x.shape), (plan.b, y.shape)):
            for ch, d in zip(term, shape):
                sizes[ch] = d
        out_elems = 1
        for ch in plan.out:
            out_elems *= sizes[ch]
        prom_elems = 1
        for ch in plan.promoted:
            prom_elems *= sizes[ch]
        if plan.s ** 2 * out_elems <= 10_000_000:
            return _ozaki_combine_stacked(
                plan, xs, ys, mux, muy, free_x, free_y, x.dtype,
                exact_stacked=(plan.n_h ** 2 * prom_elems * out_elems
                               <= 20_000_000),
            )
    out = None
    for q, r in pass_list:
        # Hybrid remainder-ladder passes (either operand a bf16 l-piece,
        # magnitude <= 2^-25 of the row scale) don't need exact
        # accumulation: their fused full-contraction f32 error is
        # <= 2^-24 * pass magnitude <= 2^-49 absolute.  Running them
        # unpromoted avoids materializing the (promoted + out)-shaped
        # pass outputs — the dominant memory traffic of promoted
        # contractions.
        fused_ok = plan.impl == "hybrid" and (q > plan.n_h or r > plan.n_h)
        if n_promoted and fused_ok:
            p = jnp.einsum(direct_pattern, xs[q - 1], ys[r - 1],
                           preferred_element_type=acc_t)
            p = jax.lax.optimization_barrier(p).astype(x.dtype)
        else:
            p = jnp.einsum(plan.pass_pattern, xs[q - 1], ys[r - 1],
                           preferred_element_type=acc_t)
            p = jax.lax.optimization_barrier(p).astype(x.dtype)
            if n_promoted:
                p = jnp.sum(p, axis=tuple(range(n_promoted)))
        if int8:
            # int8 slices are bare integers: apply the pass magnitude.
            p = p * float(2.0 ** (-(q + r) * plan.t))
        out = p if out is None else out + p
    # Element scales: outer product of the per-row scales, output-sized
    # (scales are constant over promoted axes by construction).
    scale = jnp.einsum(f"{free_x},{free_y}->{plan.out}", mux, muy)
    return out * scale


def _ozaki_applies(m, x, y):
    return (
        m == "ozaki"
        and x.dtype == jnp.float64
        and y.dtype == jnp.float64
    )


def _split2(x):
    # The barrier on hi must come BEFORE the subtraction: XLA's algebraic
    # simplifier may push the outer bf16 convert through the subtract,
    # folding bf16(x - f32(bf16(x))) to bf16(x) - bf16(x) == 0.
    hi = jax.lax.optimization_barrier(x.astype(jnp.bfloat16))
    lo = (x - hi.astype(x.dtype)).astype(jnp.bfloat16)
    return hi, lo


def _split3(x):
    hi = jax.lax.optimization_barrier(x.astype(jnp.bfloat16))
    r = x - hi.astype(x.dtype)
    mid = jax.lax.optimization_barrier(r.astype(jnp.bfloat16))
    lo = (r - mid.astype(x.dtype)).astype(jnp.bfloat16)
    return hi, mid, lo


def einsum(pattern: str, x, y, mode: str | None = None,
           x_prep=None, y_prep=None):
    """Two-operand einsum with the active split-precision mode.

    x3/x6 apply when both operands are f32; "ozaki" applies when both are
    f64 (otherwise f64 inputs use the native path).  ``x_prep``/``y_prep``:
    optional pre-sliced operands from ozaki_prepare (ignored outside
    ozaki mode).
    """
    m = mode if mode is not None else _mode.get()
    if _ozaki_applies(m, x, y):
        return _ozaki_einsum(pattern, x, y, x_prep=x_prep, y_prep=y_prep)
    f32 = x.dtype == jnp.float32 and y.dtype == jnp.float32
    if m == "ozaki" and f32:
        m = "x6"  # the f32-class ladder already saturates f32 operands
    if m == "default" or not f32:
        return jnp.einsum(pattern, x, y)
    if m == "highest":
        return jnp.einsum(pattern, x, y, precision=jax.lax.Precision.HIGHEST)
    if m == "float32":
        # Full f32 products (never TF32).
        return jnp.einsum(pattern, x, y, precision=jax.lax.Precision.HIGHEST)

    acc = jnp.float32

    def d(a, b):
        return jax.lax.optimization_barrier(
            jnp.einsum(pattern, a, b, preferred_element_type=acc)
        )

    if m == "x3":
        xh, xl = _split2(x)
        yh, yl = _split2(y)
        xh, xl, yh, yl = jax.lax.optimization_barrier((xh, xl, yh, yl))
        return d(xh, yh) + (d(xh, yl) + d(xl, yh))
    if m == "x6":
        xh, xm, xl = _split3(x)
        yh, ym, yl = _split3(y)
        parts = jax.lax.optimization_barrier((xh, xm, xl, yh, ym, yl))
        xh, xm, xl, yh, ym, yl = parts
        return (
            d(xh, yh)
            + (d(xh, ym) + d(xm, yh))
            + (d(xh, yl) + d(xm, ym) + d(xl, yh))
        )
    raise ValueError(f"unknown mm mode {m!r}")


def matmul_pattern(ndim: int) -> str:
    """The einsum pattern matmul() uses for same-ndim batched operands —
    for building ozaki_prepare preps reusable across matmul calls."""
    letters = "abcdefgh"[: ndim - 2]
    return f"{letters}ij,{letters}jk->{letters}ik"


def matmul(x, y, mode: str | None = None, x_prep=None, y_prep=None):
    """Batched matrix product (..., i, j) @ (..., j, k) with the active
    split-precision mode.  ``x_prep``/``y_prep``: optional pre-sliced
    operands (ozaki_prepare with matmul_pattern) for loop-invariant
    factors — e.g. the Horner argument of the matrix exponential."""
    m = mode if mode is not None else _mode.get()
    if _ozaki_applies(m, x, y) and x.ndim == y.ndim and x.ndim >= 2:
        return _ozaki_einsum(matmul_pattern(x.ndim), x, y,
                             x_prep=x_prep, y_prep=y_prep)
    f32 = x.dtype == jnp.float32 and y.dtype == jnp.float32
    if m == "ozaki" and f32:
        m = "x6"
    if m == "default" or not f32:
        return x @ y
    if m in ("highest", "float32"):
        return jnp.matmul(x, y, precision=jax.lax.Precision.HIGHEST)

    def d(a, b):
        return jax.lax.optimization_barrier(
            jnp.matmul(a, b, preferred_element_type=jnp.float32)
        )

    if m == "x3":
        xh, xl = _split2(x)
        yh, yl = _split2(y)
        xh, xl, yh, yl = jax.lax.optimization_barrier((xh, xl, yh, yl))
        return d(xh, yh) + (d(xh, yl) + d(xl, yh))
    if m == "x6":
        xh, xm, xl = _split3(x)
        yh, ym, yl = _split3(y)
        parts = jax.lax.optimization_barrier((xh, xm, xl, yh, ym, yl))
        xh, xm, xl, yh, ym, yl = parts
        return (
            d(xh, yh)
            + (d(xh, ym) + d(xm, yh))
            + (d(xh, yl) + d(xm, ym) + d(xl, yh))
        )
    raise ValueError(f"unknown mm mode {m!r}")
