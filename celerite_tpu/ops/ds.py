"""Double-single (two-float) arithmetic helpers for accurate lowering.

The f32 error budget of the N=1e6 log-likelihood is dominated not by the
solver recursions (~2e-5 relative) but by the *lowering* of the kernel to
semiseparable form when ``t`` is stored in f32 (measured 8e-3 relative on
chip, benchmarks/sweep_fused.py):

1. ``dt = diff(f32(t))``: rounding t (~1e3) before differencing puts an
   absolute error ~eps32*|t| ~ 6e-5 on a spacing of ~1e-3 — up to percent-
   level relative error in every decay factor exp(-c dt).
2. ``cos(d * t)``: the f32 product d*t (~1e4 rad) carries an absolute
   argument error ~6e-4 rad, which becomes a phase error of the same size.

Both are fixed with a double-single representation of the *static* time
grid (t_hi, t_lo) computed once on the host: exact Dekker/Knuth two-float
products and sums reduce d*t modulo 2 pi to a small angle before the
hardware cos/sin, and dt is differenced in ds.  The theta-dependent extra
cost is ~40 elementwise flops per (n, j) — negligible next to the
transcendentals already present.

References: Dekker (1971), Knuth TAOCP 4.2.2.  (These are published
classical algorithms; no reference-repo analog exists — the reference
computes everything in f64 on CPU, cholesky.h:129-152.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "two_sum", "split", "two_prod", "host_ds", "reduced_angle",
    "ds_cos_sin", "accurate_exp",
]


def two_sum(a, b):
    """Exact addition: s + e == a + b with s = fl(a + b)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _split_factor(dtype):
    # 2^ceil(p/2) + 1 for p-bit significands.
    return jnp.asarray(
        4097.0 if jnp.dtype(dtype) == jnp.float32 else 134217729.0,
        dtype,
    )


def split(a):
    """Dekker split: a == hi + lo with hi, lo half-width significands."""
    c = _split_factor(a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Exact product: p + e == a * b with p = fl(a * b)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def host_ds(x64, dtype=np.float32):
    """Host-side split of a float64 array into (hi, lo) pairs."""
    hi = np.asarray(x64, dtype)
    lo = np.asarray(np.asarray(x64, np.float64) - hi, dtype)
    return hi, lo


@jax.custom_jvp
def reduced_angle(d, t_hi, t_lo):
    """(d * t) mod 2 pi as a ds pair with |r_hi| <= ~pi.

    ``d`` broadcasts against ``t_hi``/``t_lo`` (typically (J,) x (N, 1)).
    Valid while the reduction integer k = round(d t / 2 pi) stays exactly
    representable (k < 2^23 in f32, i.e. d * t < ~5e7 rad).

    Custom JVP: the reduction integer is locally constant, so
    d(r)/d(d) = t exactly — the tangent skips the whole two-float chain
    (tangents do not need phase-exact precision, only values do).
    """
    dtype = np.dtype(t_hi.dtype)
    pi2 = 2.0 * np.pi
    pi2_hi_np = np.asarray(pi2, dtype)
    pi2_hi = jnp.asarray(pi2_hi_np)
    pi2_lo = jnp.asarray(np.asarray(pi2 - np.float64(pi2_hi_np), dtype))

    p_hi, p_lo = two_prod(d, t_hi)
    p_lo = p_lo + d * t_lo
    k = jnp.round(p_hi / pi2_hi)
    q_hi, q_lo = two_prod(k, pi2_hi)
    r_hi, r_e = two_sum(p_hi, -q_hi)
    r_lo = r_e + p_lo - q_lo - k * pi2_lo
    return two_sum(r_hi, r_lo)


@reduced_angle.defjvp
def _reduced_angle_jvp(primals, tangents):
    d, t_hi, t_lo = primals
    dd, dth, dtl = tangents
    out = reduced_angle(d, t_hi, t_lo)
    t = t_hi + t_lo
    dr = dd * t + d * (dth + dtl)
    return out, (dr, jnp.zeros_like(out[1]))


def ds_cos_sin(r_hi, r_lo):
    """cos/sin of a ds angle: first-order correction on the lo part."""
    c = jnp.cos(r_hi)
    s = jnp.sin(r_hi)
    return c - r_lo * s, s + r_lo * c


@jax.custom_jvp
def accurate_exp(x):
    """f32 exp accurate to ~2-3 ulp, whatever the hardware exp does.

    A hardware exp with tens of ulp of *systematic* error, repeated
    across the million decay factors phi = exp(-c dt), amplifies into a
    percent-class log-likelihood error at N=1e6.  Standard exp
    construction: ds-exact reduction
    x = (k + r) ln 2 with k integer, 2^k by exponent-field bitcast
    (exact), 2^r via an f32 Taylor series of exp(r ln 2), |r| <= 0.5.

    f32 only; pass f64 straight through (already correctly rounded on
    CPU).
    """
    if x.dtype != jnp.float32:
        return jnp.exp(x)
    log2e = 1.4426950408889634
    l2e_hi = np.float32(log2e)
    l2e_lo = np.float32(log2e - np.float64(l2e_hi))
    p_hi, p_err = two_prod(x, jnp.asarray(l2e_hi))
    k = jnp.round(p_hi)
    # p_hi - k is exact (Sterbenz); fold in the exact product error and
    # the lo half of log2(e).
    r = (p_hi - k) + (p_err + x * l2e_lo)
    q = r * np.float32(np.log(2.0))
    # exp(q), |q| <= 0.347: degree-8 Taylor, truncation < 1e-10.
    e = jnp.float32(1.0)
    for n in (8.0, 7.0, 6.0, 5.0, 4.0, 3.0, 2.0, 1.0):
        e = 1.0 + (q / np.float32(n)) * e
    # 2^k for integer k in [-126, 127]: build the float directly.
    ki = jnp.clip(k, -126.0, 127.0).astype(jnp.int32)
    scale = jax.lax.bitcast_convert_type(
        (ki + 127) << 23, jnp.float32
    )
    out = e * scale
    # Flush the clipped deep-underflow tail to 0 (exp(-88) ~ f32 tiny).
    return jnp.where(x < -87.0, 0.0, out)


@accurate_exp.defjvp
def _accurate_exp_jvp(primals, tangents):
    # Tangent = exp(x) dx in one multiply instead of linearizing the
    # whole reduction/Taylor chain (tangents need f32, not ds, accuracy).
    (x,), (dx,) = primals, tangents
    e = accurate_exp(x)
    return e, e * dx
