"""Lowering: coefficient arrays -> semiseparable (U, V, phi, A) arrays.

The reference builds these row-by-row inside the factorization loop
(/root/reference/cpp/include/celerite/solver/cholesky.h:103-152).  On an
accelerator the build is embarrassingly parallel, so it is a single fused jnp expression over
the whole time axis; the solver scans then consume dense (N, P) arrays.

Conventions (matching the reference recursion):

- ``P = J_real + 2 * J_complex + J_general`` semiseparable rank.
- ``U[n]`` is the row vector that multiplies into row ``n`` of the matrix
  (the reference's ``u_(., n-1)``):
  real j: ``a_r[j]``; complex pair: ``(a cos(d t_n) + b sin(d t_n),
  a sin(d t_n) - b cos(d t_n))``; general j: ``U_gen[j, n]``.
- ``V[n]``: real: 1; complex pair: ``(cos(d t_n), sin(d t_n))``;
  general: ``V_gen[j, n]``.
- ``phi[n]`` decays state from ``t_{n-1}`` to ``t_n``; ``phi[0] = 1``:
  real: ``exp(-c dt)``; complex pair: the same value twice; general: 1.
- ``A[n] = diag[n] + sum(a_r) + sum(a_c) + jitter (+ A_gen[n])``.

The symmetric matrix represented is
``K = diag(A) + tril(U~ V~^T, -1) + triu(V~ U~^T, 1)`` where the tilde denotes
the decay products accumulated through ``phi``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

__all__ = ["SSM", "Coefficients", "lower", "lower_np"]


class Coefficients(NamedTuple):
    """The 6 coefficient arrays + scalar jitter (terms lowering contract)."""

    a_real: jnp.ndarray
    c_real: jnp.ndarray
    a_comp: jnp.ndarray
    b_comp: jnp.ndarray
    c_comp: jnp.ndarray
    d_comp: jnp.ndarray
    jitter: jnp.ndarray


class SSM(NamedTuple):
    """Semiseparable representation consumed by the solver scans."""

    U: jnp.ndarray  # (N, P)
    V: jnp.ndarray  # (N, P)
    phi: jnp.ndarray  # (N, P), phi[0] == 1
    A: jnp.ndarray  # (N,)


def lower(
    coeffs: Coefficients,
    t: jnp.ndarray,
    diag: jnp.ndarray,
    A_gen: Optional[jnp.ndarray] = None,
    U_gen: Optional[jnp.ndarray] = None,
    V_gen: Optional[jnp.ndarray] = None,
    dt: Optional[jnp.ndarray] = None,
    t_lo: Optional[jnp.ndarray] = None,
) -> SSM:
    """Build the (U, V, phi, A) arrays for sorted input coordinates ``t``.

    ``diag`` is the per-point variance added to the diagonal (yerr**2).
    Optional general semiseparable blocks follow the reference convention:
    ``A_gen`` is (N,), ``U_gen``/``V_gen`` are (J_general, N).

    Accuracy options for f32 (both static per dataset, see ops/ds.py):
    ``dt``: precomputed spacings (dt[0] == 0) — differencing a rounded f32
    ``t`` loses up to percent-level relative accuracy on the spacings;
    ``t_lo``: the low part of a double-single split of ``t``, enabling
    exact-mod-2pi phase reduction for the oscillatory terms.
    """
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, jitter = coeffs
    t = jnp.asarray(t)
    n = t.shape[0]
    dtype = jnp.result_type(t.dtype, a_real.dtype, jnp.float32)
    t = t.astype(dtype)

    if dt is None:
        dt = jnp.concatenate([jnp.zeros((1,), dtype), jnp.diff(t)])
    else:
        dt = jnp.asarray(dt, dtype)

    # f32 decay factors go through the compensated exp: the hardware
    # f32 exp's ~30-ulp systematic error dominates the N=1e6 ll error
    # budget (ops/ds.accurate_exp; no-op in f64).
    from .ds import accurate_exp

    # Real block.
    u_r = jnp.broadcast_to(a_real.astype(dtype), (n, a_real.shape[0]))
    v_r = jnp.ones((n, a_real.shape[0]), dtype)
    p_r = accurate_exp(-c_real.astype(dtype) * dt[:, None])

    # Complex block: interleave the (cos, sin) channel pair per term so the
    # layout matches the reference ordering (real, then complex pairs).
    if t_lo is not None:
        from . import ds

        r_hi, r_lo = ds.reduced_angle(
            d_comp.astype(dtype), t[:, None], t_lo.astype(dtype)[:, None]
        )
        cos, sin = ds.ds_cos_sin(r_hi, r_lo)
    else:
        arg = d_comp.astype(dtype) * t[:, None]
        cos, sin = jnp.cos(arg), jnp.sin(arg)
    a_c = a_comp.astype(dtype)
    b_c = b_comp.astype(dtype)
    u_c = jnp.stack([a_c * cos + b_c * sin, a_c * sin - b_c * cos], -1)
    v_c = jnp.stack([cos, sin], -1)
    p_half = accurate_exp(-c_comp.astype(dtype) * dt[:, None])
    p_c = jnp.stack([p_half, p_half], -1)
    jc = a_comp.shape[0]
    u_c = u_c.reshape(n, 2 * jc)
    v_c = v_c.reshape(n, 2 * jc)
    p_c = p_c.reshape(n, 2 * jc)

    parts_u = [u_r, u_c]
    parts_v = [v_r, v_c]
    parts_p = [p_r, p_c]

    a = (
        diag.astype(dtype)
        + jnp.sum(a_real)
        + jnp.sum(a_comp)
        + jnp.asarray(jitter, dtype)
    )

    if U_gen is not None and U_gen.shape[0] > 0:
        parts_u.append(U_gen.T.astype(dtype))
        parts_v.append(V_gen.T.astype(dtype))
        parts_p.append(jnp.ones((n, U_gen.shape[0]), dtype))
        a = a + A_gen.astype(dtype)

    return SSM(
        U=jnp.concatenate(parts_u, axis=1),
        V=jnp.concatenate(parts_v, axis=1),
        phi=jnp.concatenate(parts_p, axis=1),
        A=a,
    )


def lower_np(coeffs, t, diag, A_gen=None, U_gen=None, V_gen=None):
    """Pure-NumPy float64 twin of :func:`lower` for the eager host path.

    The jnp lowering pays one XLA dispatch per expression, which swamps
    small-N eager calls (the
    reference's N=200 single eval is 0.26 ms, example-stats.tex).  This
    twin feeds the native C++ core (celerite_tpu.native) with zero
    device traffic.  f64 exp/sin/cos need no compensated variants.
    """
    import numpy as np

    a_real, c_real, a_comp, b_comp, c_comp, d_comp, jitter = (
        np.atleast_1d(np.asarray(v, np.float64)) for v in coeffs
    )
    t = np.asarray(t, np.float64)
    diag = np.asarray(diag, np.float64)
    n = t.shape[0]
    dt = np.empty(n)
    dt[0] = 0.0
    np.subtract(t[1:], t[:-1], out=dt[1:])

    jr = a_real.shape[0]
    jc = a_comp.shape[0]
    parts_u, parts_v, parts_p = [], [], []
    if jr:
        parts_u.append(np.broadcast_to(a_real, (n, jr)))
        parts_v.append(np.ones((n, jr)))
        parts_p.append(np.exp(-c_real * dt[:, None]))
    if jc:
        arg = d_comp * t[:, None]
        cos, sin = np.cos(arg), np.sin(arg)
        u_c = np.empty((n, 2 * jc))
        u_c[:, 0::2] = a_comp * cos + b_comp * sin
        u_c[:, 1::2] = a_comp * sin - b_comp * cos
        v_c = np.empty((n, 2 * jc))
        v_c[:, 0::2] = cos
        v_c[:, 1::2] = sin
        p_half = np.exp(-c_comp * dt[:, None])
        p_c = np.empty((n, 2 * jc))
        p_c[:, 0::2] = p_half
        p_c[:, 1::2] = p_half
        parts_u.append(u_c)
        parts_v.append(v_c)
        parts_p.append(p_c)
    a = diag + (np.sum(a_real) + np.sum(a_comp) + float(jitter))

    if U_gen is not None and np.asarray(U_gen).shape[0] > 0:
        U_gen = np.asarray(U_gen, np.float64)
        V_gen = np.asarray(V_gen, np.float64)
        parts_u.append(U_gen.T)
        parts_v.append(V_gen.T)
        parts_p.append(np.ones((n, U_gen.shape[0])))
        a = a + np.asarray(A_gen, np.float64)

    if not parts_u:  # jitter-only kernel: P = 0
        z = np.zeros((n, 0))
        return SSM(U=z, V=z, phi=z, A=a)
    if len(parts_u) == 1:
        return SSM(U=parts_u[0], V=parts_v[0], phi=parts_p[0], A=a)
    return SSM(
        U=np.concatenate(parts_u, axis=1),
        V=np.concatenate(parts_v, axis=1),
        phi=np.concatenate(parts_p, axis=1),
        A=a,
    )
