"""Vectorized double-single (f32x2) arithmetic for the solver recursions.

The reference runs its whole recursion in float64 on CPU
(/root/reference/cpp/include/celerite/solver/cholesky.h:41-210,
templated scalar ``T=double``).  This module provides that precision
from float32 hardware alone (devices without a fast float64 path): every number is an unevaluated sum
``x = hi + lo`` of two float32s (a "double-single"), giving an effective
~48-bit significand.  All operations are branch-free elementwise jnp
expressions, so they vmap/scan/jit like plain arithmetic and AD traces
straight through them (the error-compensation chains are linear or
bilinear, so their derivatives are exact to f32 roundoff).

Used by :mod:`celerite_tpu.ops.dsblocked` — the ``precision="ds"`` solver
backend that removes the f32 gradient-noise floor measured in round 3
(ROADMAP "float32 accuracy"; 20-30% gradient deviation on adversarially
mis-fitted N=1e6 configs drops to the f64-class level).

References: Dekker (1971), Knuth TAOCP 4.2.2, Hida/Li/Bailey QD library
(2000) — classical published algorithms; the reference repo contains no
analogous code (it has hardware float64).

Representation invariant: ``hi = fl(hi + lo)`` (``|lo| <= ulp(hi)/2``),
maintained by a quick_two_sum renormalization at the end of each op.
The "sloppy" variants used here carry error O(eps^2) per op — accurate
to ~1e-14 relative, far below the ~1e-9 this application needs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "DS", "DD", "dd_lift", "dd_seed", "dd_ntan",
    "ds", "from_f32", "to_f32", "from_f64",
    "add", "sub", "neg", "mul", "div", "add_f", "mul_f",
    "sum_axis", "matvec", "vecmat", "matmul", "outer",
    "refine_inv", "log_ds", "where", "exp_ds", "sincos_ds", "const_ds",
]


class DS(NamedTuple):
    """A double-single number/array: value = hi + lo, both float32."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype

    def astuple(self):
        return (self.hi, self.lo)


def ds(hi, lo=None) -> DS:
    hi = jnp.asarray(hi)
    if lo is None:
        lo = jnp.zeros_like(hi)
    return DS(hi, jnp.asarray(lo))


def from_f32(x) -> DS:
    x = jnp.asarray(x)
    return DS(x, jnp.zeros_like(x))


def to_f32(x: DS):
    return x.hi + x.lo


def _quick_two_sum(a, b):
    """a + b as (s, e), requires |a| >= |b| (guaranteed post-op here)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _two_sum(a, b):
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _split(a):
    # 2^ceil(p/2) + 1 splits a p-bit significand in half exactly
    # (4097 for f32; 134217729 for f64 so CPU x64 tests stay correct).
    f = 4097.0 if jnp.dtype(a.dtype) == jnp.float32 else 134217729.0
    c = jnp.asarray(f, a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def neg(x):
    if isinstance(x, DD):
        return _dd_neg(x)
    return DS(-x.hi, -x.lo)


def add(x, y):
    if _is_dd(x, y):
        return _dd_add(x, y)
    s, e = _two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return DS(*_quick_two_sum(s, e))


def sub(x, y):
    return add(x, neg(y))


def add_f(x, b):
    """ds + f32 (or full add when either side carries tangents)."""
    if isinstance(b, (DS, DD)):
        return add(x, b)
    if isinstance(x, DD):
        return _dd_add_f(x, b)
    s, e = _two_sum(x.hi, b)
    e = e + x.lo
    return DS(*_quick_two_sum(s, e))


def mul(x, y):
    if _is_dd(x, y):
        return _dd_mul(x, y)
    p, e = _two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DS(*_quick_two_sum(p, e))


def mul_f(x, b):
    """ds * f32 (or full mul when either side carries tangents)."""
    if isinstance(b, DS):
        return mul(x, b)
    if _is_dd(x, b):
        if not isinstance(x, (DS, DD)):
            raise TypeError("mul_f: plain first arg with DD second")
        if isinstance(x, DS):
            x = dd_lift(x, dd_ntan(b))
        return _dd_mul_f(x, b)
    p, e = _two_prod(x.hi, b)
    e = e + x.lo * b
    return DS(*_quick_two_sum(p, e))


def div(x, y):
    """ds / ds by one long-division correction step."""
    if _is_dd(x, y):
        return _dd_div(x, y)
    q1 = x.hi / y.hi
    r = add(x, neg(mul_f(y, q1)))
    q2 = (r.hi + r.lo) / y.hi
    return DS(*_quick_two_sum(q1, q2))


def where(c, x, y):
    if _is_dd(x, y):
        return _dd_where(c, x, y)
    return DS(jnp.where(c, x.hi, y.hi), jnp.where(c, x.lo, y.lo))


def log_ds(x):
    """log of a positive ds value to ds-class relative accuracy.

    log(hi + lo) = log(hi) + log1p(lo/hi); the hardware f32 log carries a
    few-ulp error on the hi part — adequate here because the *sum* of logs
    (the logdet) is compensated downstream and the per-term error is
    random, not the systematic exp-style bias that motivated
    ops/ds.accurate_exp.
    """
    if isinstance(x, DD):
        return _dd_log(x)
    h = jnp.log(x.hi)
    l_ = x.lo / x.hi  # log1p(z) ~ z for |z| <= eps32
    return DS(*_quick_two_sum(h, l_))


# -- reductions and small linear algebra -------------------------------------


def sum_axis(x, axis: int):
    """Compensated sum along ``axis`` via pairwise ds folding.

    Exact ds adds at every tree level: the result carries the full ds
    accuracy regardless of the axis length (pad-to-pow2 with zeros).
    """
    if isinstance(x, DD):
        return _dd_linear(sum_axis, x, axis)
    hi = jnp.moveaxis(x.hi, axis, 0)
    lo = jnp.moveaxis(x.lo, axis, 0)
    n = hi.shape[0]
    # pad to a power of two
    m = 1 << max(0, (n - 1).bit_length())
    if m != n:
        pad = [(0, m - n)] + [(0, 0)] * (hi.ndim - 1)
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    cur = DS(hi, lo)
    while cur.hi.shape[0] > 1:
        half = cur.hi.shape[0] // 2
        cur = add(
            DS(cur.hi[:half], cur.lo[:half]),
            DS(cur.hi[half:], cur.lo[half:]),
        )
    return DS(cur.hi[0], cur.lo[0])


def matvec(M, v):
    """(..., p, p) ds @ (..., p) ds -> (..., p) ds."""
    if _is_dd(M, v):
        return _dd_matvec(M, v)
    prod = mul(DS(M.hi, M.lo), DS(v.hi[..., None, :], v.lo[..., None, :]))
    return sum_axis(prod, -1)


def vecmat(v, M):
    """(..., p) ds @ (..., p, p) ds -> (..., p) ds."""
    if _is_dd(v, M):
        return _dd_matmul(
            DD(DS(v.val.hi[..., None, :], v.val.lo[..., None, :]),
               tuple(DS(t.hi[..., None, :], t.lo[..., None, :])
                     for t in v.tan))
            if isinstance(v, DD)
            else DS(v.hi[..., None, :], v.lo[..., None, :]),
            M,
        )
    prod = mul(DS(v.hi[..., :, None], v.lo[..., :, None]), M)
    return sum_axis(prod, -2)


def matmul(A, B):
    """(..., p, q) ds @ (..., q, r) ds -> (..., p, r) ds."""
    if _is_dd(A, B):
        return _dd_matmul(A, B)
    a = DS(A.hi[..., :, :, None], A.lo[..., :, :, None])
    b = DS(B.hi[..., None, :, :], B.lo[..., None, :, :])
    return sum_axis(mul(a, b), -2)


def outer(x, y):
    if _is_dd(x, y):
        return _dd_outer(x, y)
    return mul(
        DS(x.hi[..., :, None], x.lo[..., :, None]),
        DS(y.hi[..., None, :], y.lo[..., None, :]),
    )


def from_f64(x64, dtype=jnp.float32) -> DS:
    """Host-side split of float64 data into an exact ds pair."""
    import numpy as np

    hi = np.asarray(x64, dtype)
    lo = np.asarray(np.asarray(x64, np.float64) - hi, dtype)
    return DS(jnp.asarray(hi), jnp.asarray(lo))


def const_ds(value, dtype=jnp.float32) -> DS:
    """A Python-float constant as an exact ds pair."""
    import numpy as np

    hi = np.asarray(value, dtype)
    lo = np.asarray(np.float64(value) - np.float64(hi), dtype)
    return DS(jnp.asarray(hi), jnp.asarray(lo))


# -- ds transcendentals (for the ds lowering) --------------------------------
#
# The ill-conditioned acceptance cases (summed term variance >> diagonal)
# need the lowered (U, V, phi, A) streams accurate to ~1e-12 absolute:
# per-point f32 rounding of exp/cos/sin is an *incoherent* perturbation of
# the semiseparable representation (unlike coefficient-level rounding,
# which just evaluates a nearby valid kernel), so it can push the matrix
# indefinite when the PD margin is below ~N_terms * eps32.  These kernels
# compute exp/sin/cos of ds arguments to ds accuracy with exact argument
# reduction + ds Horner polynomials.


def exp_ds(x):
    """exp of a ds value to ~1e-13 relative (f32 pairs).

    Same construction as ops/ds.accurate_exp but with the 2^r kernel
    evaluated in ds: exact reduction x = (k + r) ln 2, 2^k by exponent
    bitcast (exact), exp(r ln 2) by a ds Horner Taylor on |q| <= 0.347.
    """
    if isinstance(x, DD):
        return _dd_exp(x)
    dtype = x.hi.dtype
    if jnp.dtype(dtype) != jnp.float32:
        # f64 arrays (CPU x64 tests): hardware exp is exact enough.
        v = x.hi + x.lo
        return DS(jnp.exp(v), jnp.zeros_like(v))
    log2e = 1.4426950408889634
    l2e = const_ds(log2e, dtype)
    p = add(mul_f(l2e, x.hi), mul_f(l2e, x.lo))
    k = jnp.round(p.hi)
    # p.hi - k is exact (Sterbenz range after round)
    r = DS(*_quick_two_sum(p.hi - k, p.lo))
    ln2 = const_ds(0.6931471805599453, dtype)
    q = add(mul_f(ln2, r.hi), mul_f(ln2, r.lo))  # |q| <= 0.347
    # exp(q): ds Horner, degree 11 (truncation < 3e-14 at |q|=0.347).
    e = from_f32(jnp.ones_like(q.hi))
    for nn in range(11, 0, -1):
        inv_n = const_ds(1.0 / nn, dtype)
        e = add_f(mul(mul(q, inv_n), e), jnp.ones_like(q.hi))
    ki = jnp.clip(k, -126.0, 127.0).astype(jnp.int32)
    scale = jax.lax.bitcast_convert_type(
        (ki + 127) << 23, jnp.float32
    ).astype(dtype)
    out = DS(e.hi * scale, e.lo * scale)  # power-of-two scale is exact
    tiny = x.hi < -87.0
    return DS(
        jnp.where(tiny, jnp.zeros_like(out.hi), out.hi),
        jnp.where(tiny, jnp.zeros_like(out.lo), out.lo),
    )


def sincos_ds(r):
    """(sin, cos) of a ds angle with |r| <= ~pi, to ~1e-13 absolute.

    Quadrant reduction by ds pi/2 (the incoming angle is already reduced
    mod 2 pi by ops/ds.reduced_angle), then ds Horner Taylor kernels on
    |r2| <= pi/4.
    """
    if isinstance(r, DD):
        return _dd_sincos(r)
    import math as _math

    dtype = r.hi.dtype
    if jnp.dtype(dtype) != jnp.float32:
        # f64 arrays (CPU x64 tests): hardware sin/cos is already exact
        # to 1e-16; no ds kernel needed.
        v = r.hi + r.lo
        z = jnp.zeros_like(v)
        return DS(jnp.sin(v), z), DS(jnp.cos(v), z)
    pi_half = const_ds(1.5707963267948966, dtype)
    two_over_pi = 0.6366197723675814
    k = jnp.round(r.hi * jnp.asarray(two_over_pi, dtype))
    r2 = sub(r, mul_f(pi_half, k))
    q = jnp.mod(k.astype(jnp.int32), 4)

    x2 = mul(r2, r2)
    # sin kernel: Horner in x2, sum_{j>=1} (-1)^j x2^j/(2j+1)! then
    # sin = r2 * (1 + s); degree 13 -> truncation < 1e-14 at |r2|<=pi/4.
    s = from_f32(jnp.zeros_like(r2.hi))
    for j in range(6, 0, -1):
        coef = const_ds(
            (-1.0) ** j / _math.factorial(2 * j + 1), dtype
        )
        s = mul(add(s, coef), x2)
    sin2 = mul(r2, add_f(s, jnp.ones_like(s.hi)))

    c = from_f32(jnp.zeros_like(r2.hi))
    for j in range(7, 0, -1):  # degree 14
        coef = const_ds((-1.0) ** j / _math.factorial(2 * j), dtype)
        c = mul(add(c, coef), x2)
    cos2 = add_f(c, jnp.ones_like(c.hi))

    def pick(a: DS, b: DS, cond):
        return DS(jnp.where(cond, a.hi, b.hi), jnp.where(cond, a.lo, b.lo))

    # quadrant rotation: q=0 (s, c); 1 (c, -s); 2 (-s, -c); 3 (-c, s)
    swap = (q % 2) == 1
    sin_o = pick(cos2, sin2, swap)
    cos_o = pick(sin2, cos2, swap)
    neg_sin = (q == 2) | (q == 3)
    neg_cos = (q == 1) | (q == 2)
    sin_o = DS(jnp.where(neg_sin, -sin_o.hi, sin_o.hi),
               jnp.where(neg_sin, -sin_o.lo, sin_o.lo))
    cos_o = DS(jnp.where(neg_cos, -cos_o.hi, cos_o.hi),
               jnp.where(neg_cos, -cos_o.lo, cos_o.lo))
    return sin_o, cos_o


def refine_inv(M, X0):
    """ds-accurate inverse of a ds matrix from an f32 seed inverse.

    One Newton step X1 = X0 + X0 (I - M X0) performed in ds doubles the
    correct digits of the f32 seed: residual O(eps32) -> O(eps32^2),
    i.e. full ds accuracy for the well-scaled (I + C J) matrices the
    Riccati composition inverts.
    """
    if isinstance(M, DD):
        return _dd_refine_inv(M, X0)
    X0d = from_f32(X0)
    R = matmul(M, X0d)  # ~ I
    p = M.hi.shape[-1]
    eye = jnp.broadcast_to(
        jnp.eye(p, dtype=M.hi.dtype), R.hi.shape
    )
    E = add(from_f32(eye), neg(R))  # I - M X0, computed in ds
    return add(X0d, matmul(X0d, E))


# -- dual double-single: forward-mode tangents in ds precision ---------------
#
# DD carries a ds value plus T tangent components, each itself a ds
# number of the same shape.  Every public op above dispatches on DD (the
# `isinstance` checks are trace-time only), applying the standard
# forward-mode rule with the tangent arithmetic ALSO in ds — this is the
# piece plain jax AD cannot give us: jax's tangents of compensated code
# are plain f32 chains, whose eps32-level noise re-enters the gradient
# through the solver's cancelling reductions (measured: stream
# cotangents from f32 AD are ~8e-7 relative, which the N-point
# contraction amplifies ~3000x to ~2e-3 gradient error).  With ds
# tangents the gradient tracks the f64 gradient to the same ~1e-8-class
# limit as the value.
#
# Tangents are a tuple of DS (not a stacked axis) so DD stays a plain
# pytree whose every leaf has the VALUE's shape: lax.scan, vmap,
# reshape/concat tree_maps, and the blocked solver's structural code
# work unchanged over DD.


class DD(NamedTuple):
    """Dual ds number: value + T ds tangent components."""

    val: DS
    tan: tuple  # tuple[DS, ...], each leaf shaped like val

    @property
    def shape(self):
        return self.val.hi.shape

    @property
    def dtype(self):
        return self.val.hi.dtype


def _is_dd(*xs):
    return any(isinstance(x, DD) for x in xs)


def dd_ntan(*xs):
    for x in xs:
        if isinstance(x, DD):
            return len(x.tan)
    raise ValueError("no DD argument")


def dd_lift(x: DS, T: int) -> DD:
    """Promote a DS (constant w.r.t. the tangent directions) to DD."""
    z = DS(jnp.zeros_like(x.hi), jnp.zeros_like(x.lo))
    return DD(x, (z,) * T)


def dd_seed(x: DS, tangents) -> DD:
    """Attach explicit ds tangents (an iterable of DS) to a value."""
    return DD(x, tuple(tangents))


def _dd2(x, T):
    return x if isinstance(x, DD) else dd_lift(x, T)


def dd_tree_map(f, *xs):
    """Apply an array->array fn to every hi/lo leaf (value + tangents)."""
    import jax.tree_util as jtu

    return jtu.tree_map(f, *xs)


def _dd_neg(x: DD) -> DD:
    return DD(neg(x.val), tuple(neg(t) for t in x.tan))


def _dd_add(x, y) -> DD:
    T = dd_ntan(x, y)
    x, y = _dd2(x, T), _dd2(y, T)
    return DD(add(x.val, y.val),
              tuple(add(a, b) for a, b in zip(x.tan, y.tan)))


def _dd_add_f(x: DD, b) -> DD:
    return DD(add_f(x.val, b), x.tan)


def _dd_mul(x, y) -> DD:
    T = dd_ntan(x, y)
    x, y = _dd2(x, T), _dd2(y, T)
    v = mul(x.val, y.val)
    t = tuple(
        add(mul(a, y.val), mul(x.val, b))
        for a, b in zip(x.tan, y.tan)
    )
    return DD(v, t)


def _dd_mul_f(x, b) -> DD:
    if isinstance(b, DD):  # ds-aware scalar with tangents: full rule
        return _dd_mul(x, b)
    return DD(mul_f(x.val, b), tuple(mul_f(t, b) for t in x.tan))


def _dd_div(x, y) -> DD:
    T = dd_ntan(x, y)
    x, y = _dd2(x, T), _dd2(y, T)
    q = div(x.val, y.val)
    t = tuple(
        div(add(a, neg(mul(q, b))), y.val)
        for a, b in zip(x.tan, y.tan)
    )
    return DD(q, t)


def _dd_where(c, x, y) -> DD:
    T = dd_ntan(x, y)
    x, y = _dd2(x, T), _dd2(y, T)
    return DD(where(c, x.val, y.val),
              tuple(where(c, a, b) for a, b in zip(x.tan, y.tan)))


def _dd_log(x: DD) -> DD:
    return DD(log_ds(x.val), tuple(div(t, x.val) for t in x.tan))


def _dd_exp(x: DD) -> DD:
    e = exp_ds(x.val)
    return DD(e, tuple(mul(e, t) for t in x.tan))


def _dd_sincos(x: DD):
    s, c = sincos_ds(x.val)
    ts = tuple(mul(c, t) for t in x.tan)
    tc = tuple(neg(mul(s, t)) for t in x.tan)
    return DD(s, ts), DD(c, tc)


def _dd_linear(op, x: DD, *args) -> DD:
    return DD(op(x.val, *args), tuple(op(t, *args) for t in x.tan))


def _dd_matmul(A, B) -> DD:
    T = dd_ntan(A, B)
    A, B = _dd2(A, T), _dd2(B, T)
    v = matmul(A.val, B.val)
    t = tuple(
        add(matmul(a, B.val), matmul(A.val, b))
        for a, b in zip(A.tan, B.tan)
    )
    return DD(v, t)


def _dd_matvec(M, x) -> DD:
    T = dd_ntan(M, x)
    M, x = _dd2(M, T), _dd2(x, T)
    v = matvec(M.val, x.val)
    t = tuple(
        add(matvec(a, x.val), matvec(M.val, b))
        for a, b in zip(M.tan, x.tan)
    )
    return DD(v, t)


def _dd_outer(x, y) -> DD:
    T = dd_ntan(x, y)
    x, y = _dd2(x, T), _dd2(y, T)
    v = outer(x.val, y.val)
    t = tuple(
        add(outer(a, y.val), outer(x.val, b))
        for a, b in zip(x.tan, y.tan)
    )
    return DD(v, t)


def _dd_refine_inv(M: DD, X0) -> DD:
    # d(M^-1) = -M^-1 dM M^-1, all in ds
    X = refine_inv(M.val, X0)
    t = tuple(
        neg(matmul(X, matmul(dm, X))) for dm in M.tan
    )
    return DD(X, t)
