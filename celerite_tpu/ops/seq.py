"""Sequential ``lax.scan`` semiseparable solver.

JAX replacement for the reference's C++ Cholesky recursion
(/root/reference/cpp/include/celerite/solver/cholesky.h:41-698).  Every op is
a pure function of dense (N, P) arrays: jit-able, vmap-able, and
differentiable with ``jax.grad`` (scan's built-in reverse-mode).  The
block-parallel path lives in ``blocked.py`` and reuses the per-step math
defined here; this module is the always-correct baseline and the within-block
kernel.

Factorization: K = L D L^T with L = I + tril(U W~^T, -1):

    S_n = diag(phi_n) (S_{n-1} + D_{n-1} W_{n-1} W_{n-1}^T) diag(phi_n)
    D_n = A_n - U_n^T S_n U_n
    W_n = (V_n - S_n U_n) / D_n

Non-positive pivots become a boolean ``ok`` output instead of an exception
(XLA cannot throw); downstream converts to -inf log-likelihoods, which is the
reference's ``quiet=True`` semantics made total.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .lower import SSM
from .precision import f32_matmuls

__all__ = [
    "FactorResult",
    "factor",
    "gp_log_likelihood",
    "solve_lower",
    "solve",
    "dot_solve",
    "dot_L",
    "matmul",
    "predict_mean",
]


class FactorResult(NamedTuple):
    D: jnp.ndarray  # (N,) Cholesky pivots
    W: jnp.ndarray  # (N, P) scaled V rows
    ok: jnp.ndarray  # scalar bool: all pivots positive and finite


def _factor_step(S, d_prev, w_prev, u, v, phi, a):
    """One step of the Cholesky recursion; shared with blocked.py."""
    S = (phi[:, None] * phi[None, :]) * (
        S + d_prev * (w_prev[:, None] * w_prev[None, :])
    )
    su = S @ u
    d = a - u @ su
    w = (v - su) / d
    return S, d, w


@f32_matmuls
def factor(ssm: SSM) -> FactorResult:
    """Factor K = L D L^T; O(N P^2) sequential scan."""

    def step(carry, inp):
        S, d_prev, w_prev = carry
        u, v, phi, a = inp
        S, d, w = _factor_step(S, d_prev, w_prev, u, v, phi, a)
        return (S, d, w), (d, w)

    n, p = ssm.U.shape
    dtype = ssm.U.dtype
    init = (
        jnp.zeros((p, p), dtype),
        jnp.zeros((), dtype),
        jnp.zeros((p,), dtype),
    )
    _, (D, W) = lax.scan(step, init, (ssm.U, ssm.V, ssm.phi, ssm.A))
    ok = jnp.all(D > 0) & jnp.all(jnp.isfinite(D))
    return FactorResult(D=D, W=W, ok=ok)


def _ll_scan(ssm: SSM, resid: jnp.ndarray):
    """factor + dot_solve + logdet + min-pivot in one scan.

    Returns (quad, logdet, min_d).
    """

    def step(carry, inp):
        S, d_prev, w_prev, f, z_prev, quad, logdet, min_d = carry
        u, v, phi, a, y = inp
        S, d, w = _factor_step(S, d_prev, w_prev, u, v, phi, a)
        f = phi * (f + w_prev * z_prev)
        z = y - u @ f
        quad = quad + z * z / d
        logdet = logdet + jnp.log(d)
        min_d = jnp.minimum(min_d, d)
        return (S, d, w, f, z, quad, logdet, min_d), None

    n, p = ssm.U.shape
    dtype = ssm.U.dtype
    zero = jnp.zeros((), dtype)
    init = (
        jnp.zeros((p, p), dtype),
        zero,
        jnp.zeros((p,), dtype),
        jnp.zeros((p,), dtype),
        zero,
        zero,
        zero,
        jnp.array(jnp.inf, dtype),
    )
    carry, _ = lax.scan(step, init, (ssm.U, ssm.V, ssm.phi, ssm.A, resid))
    quad, logdet, min_d = carry[5], carry[6], carry[7]
    return quad, logdet, min_d


@f32_matmuls
def gp_log_likelihood(ssm: SSM, resid: jnp.ndarray):
    """Total GP log-likelihood with (ll, ok) semantics.

    ok is False when any pivot D_n <= 0 or non-finite; in that case ll is
    forced to -inf (the reference's ``quiet=True`` behavior,
    celerite.py:204-219).
    """
    quad, logdet, min_d = _ll_scan(ssm, resid)
    n = resid.shape[0]
    dtype = resid.dtype
    ll = -0.5 * (quad + logdet + n * jnp.log(2.0 * jnp.pi).astype(dtype))
    ok = (min_d > 0) & jnp.isfinite(ll)
    ll = jnp.where(ok, ll, -jnp.inf)
    return ll, ok


@f32_matmuls
def gp_log_likelihood_masked(ssm: SSM, resid, mask, n_valid):
    """(ll, ok) over a padded series: masked samples are made inert.

    ``mask``: (N,) 1/0 validity; ``n_valid``: true sample count.  Padded
    rows get U = V = 0, phi = 1, A = 1, resid = 0 — exactly zero
    contribution to the quadratic form and log-determinant (the fleet
    container path, data.batched_gp_log_likelihood; reusable for
    vmapped ragged batches).
    """
    m = mask[:, None]
    ssm = SSM(
        U=jnp.where(m > 0, ssm.U, 0.0),
        V=jnp.where(m > 0, ssm.V, 0.0),
        phi=jnp.where(m > 0, ssm.phi, 1.0),
        A=jnp.where(mask > 0, ssm.A, 1.0),
    )
    resid = jnp.where(mask > 0, resid, 0.0)
    quad, logdet, min_d = _ll_scan(ssm, resid)
    dtype = resid.dtype
    ll = -0.5 * (
        quad + logdet
        + jnp.asarray(n_valid, dtype) * jnp.log(2.0 * jnp.pi).astype(dtype)
    )
    ok = (min_d > 0) & jnp.isfinite(ll)
    return jnp.where(ok, ll, -jnp.inf), ok


def _shift_down(x):
    """x[n] -> x[n+1] with zero fill at the end (for backward passes)."""
    return jnp.concatenate([x[1:], jnp.zeros_like(x[:1])])


@f32_matmuls
def solve_lower(ssm: SSM, fact: FactorResult, y: jnp.ndarray):
    """Solve L z = y (forward substitution).  y: (N,)."""

    def step(carry, inp):
        f, z_prev = carry
        u, phi, w_prev, yn = inp
        f = phi * (f + w_prev * z_prev)
        z = yn - u @ f
        return (f, z), z

    p = ssm.U.shape[1]
    w_prev = jnp.concatenate(
        [jnp.zeros_like(fact.W[:1]), fact.W[:-1]], axis=0
    )
    init = (jnp.zeros((p,), ssm.U.dtype), jnp.zeros((), y.dtype))
    _, z = lax.scan(step, init, (ssm.U, ssm.phi, w_prev, y))
    return z


@f32_matmuls
def solve(ssm: SSM, fact: FactorResult, y: jnp.ndarray):
    """Solve K x = y.  y may be (N,) or (N, K)."""
    if y.ndim == 2:
        return jax.vmap(
            lambda col: solve(ssm, fact, col), in_axes=1, out_axes=1
        )(y)

    z = solve_lower(ssm, fact, y) / fact.D

    # Backward: L^T x = z, scanned in reverse.  At step n the carry g
    # absorbs (U_{n+1} x_{n+1}) and decays by phi_{n+1}.
    def step(carry, inp):
        g, x_next = carry
        w, phi_next, u_next, zn = inp
        g = phi_next * (g + u_next * x_next)
        x = zn - w @ g
        return (g, x), x

    phi_next = _shift_down(ssm.phi)
    u_next = _shift_down(ssm.U)
    p = ssm.U.shape[1]
    init = (jnp.zeros((p,), ssm.U.dtype), jnp.zeros((), z.dtype))
    _, x = lax.scan(
        step, init, (fact.W, phi_next, u_next, z), reverse=True
    )
    return x


@f32_matmuls
def dot_solve(ssm: SSM, fact: FactorResult, y: jnp.ndarray):
    """y^T K^-1 y via the forward pass only (cholesky.h:326-401 analog)."""
    z = solve_lower(ssm, fact, y)
    return jnp.sum(z * z / fact.D)


@f32_matmuls
def dot_L(ssm: SSM, fact: FactorResult, z: jnp.ndarray):
    """Compute y = L sqrt(D) z (prior sampling; cholesky.h:409-431 analog).

    z may be (N,) or (N, K).
    """
    if z.ndim == 2:
        return jax.vmap(
            lambda col: dot_L(ssm, fact, col), in_axes=1, out_axes=1
        )(z)

    sd = jnp.sqrt(fact.D)

    def step(carry, inp):
        f, t_prev = carry
        u, phi, w_prev, tn = inp
        f = phi * (f + w_prev * t_prev)
        y = tn + u @ f
        return (f, tn), y

    w_prev = jnp.concatenate(
        [jnp.zeros_like(fact.W[:1]), fact.W[:-1]], axis=0
    )
    p = ssm.U.shape[1]
    init = (jnp.zeros((p,), ssm.U.dtype), jnp.zeros((), z.dtype))
    _, y = lax.scan(step, init, (ssm.U, ssm.phi, w_prev, sd * z))
    return y


@f32_matmuls
def matmul(ssm: SSM, z: jnp.ndarray):
    """K @ z without factorizing (cholesky.h:444-590 analog).

    ``ssm.A`` must hold the intended diagonal (for the reference ``dot``
    semantics that is kernel diagonal + jitter + A_gen, with no yerr).
    z may be (N,) or (N, K).
    """
    if z.ndim == 2:
        return jax.vmap(
            lambda col: matmul(ssm, col), in_axes=1, out_axes=1
        )(z)

    # Lower triangle: y_n += U_n . g_n, g_n = phi_n (g_{n-1} + V_{n-1} z_{n-1})
    def fwd(carry, inp):
        g, = carry
        u, phi, v_prev, z_prev = inp
        g = phi * (g + v_prev * z_prev)
        return (g,), u @ g

    p = ssm.U.shape[1]
    v_prev = jnp.concatenate([jnp.zeros_like(ssm.V[:1]), ssm.V[:-1]], 0)
    z_prev = jnp.concatenate([jnp.zeros_like(z[:1]), z[:-1]])
    _, y_low = lax.scan(
        fwd,
        (jnp.zeros((p,), ssm.U.dtype),),
        (ssm.U, ssm.phi, v_prev, z_prev),
    )

    # Upper triangle: y_n += V_n . h_n, h_n = phi_{n+1}(h_{n+1} + U_{n+1} z_{n+1})
    def bwd(carry, inp):
        h, = carry
        v, phi_next, u_next, z_next = inp
        h = phi_next * (h + u_next * z_next)
        return (h,), v @ h

    phi_next = _shift_down(ssm.phi)
    u_next = _shift_down(ssm.U)
    z_next = _shift_down(z)
    _, y_up = lax.scan(
        bwd,
        (jnp.zeros((p,), ssm.U.dtype),),
        (ssm.V, phi_next, u_next, z_next),
        reverse=True,
    )

    return ssm.A * z + y_low + y_up


@f32_matmuls
def predict_mean(coeffs, t, alpha, x, parallel=False):
    """Conditional mean K_*(x, t) @ alpha in O((N + M) J).

    With ``parallel=True`` the two lag-state recursions run as
    associative scans (their transitions are diagonal decays), turning
    the O(N) sequential walk into O(log N) vectorized passes — use on
    accelerators for large N.

    Reference analog: cholesky.h:599-698 (forward/backward lag-state
    accumulators).  Instead of the reference's merge-over-sorted-points loop,
    this computes per-data-point states with two scans and gathers the state
    at each test point with ``searchsorted`` — the same O(N J + M J) work in
    vectorized form.  ``alpha`` must be K^{-1} resid.  General semiseparable
    blocks are (as in the reference) not part of this path.

    Data points with ``t_k < x`` enter through the forward state; points with
    ``t_k >= x`` through the backward state (ties resolved like the
    reference's boundary conditions).
    """
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, _ = coeffs
    t = jnp.asarray(t)
    x = jnp.asarray(x)
    dtype = alpha.dtype
    jr = a_real.shape[0]

    dt_next = jnp.concatenate([jnp.diff(t), jnp.zeros((1,), t.dtype)])
    dt_prev = jnp.concatenate([jnp.zeros((1,), t.dtype), jnp.diff(t)])

    c_all = jnp.concatenate([c_real, jnp.repeat(c_comp, 2)])

    # V-side basis at data points (forward carries V_k alpha_k):
    arg_t = d_comp * t[:, None]
    v_data = jnp.concatenate(
        [
            jnp.ones((t.shape[0], jr), dtype),
            jnp.stack([jnp.cos(arg_t), jnp.sin(arg_t)], -1).reshape(
                t.shape[0], -1
            ),
        ],
        axis=1,
    )
    # U-side basis at data points (backward carries U_k alpha_k):
    u_data = jnp.concatenate(
        [
            jnp.broadcast_to(a_real, (t.shape[0], jr)),
            jnp.stack(
                [
                    a_comp * jnp.cos(arg_t) + b_comp * jnp.sin(arg_t),
                    a_comp * jnp.sin(arg_t) - b_comp * jnp.cos(arg_t),
                ],
                -1,
            ).reshape(t.shape[0], -1),
        ],
        axis=1,
    )

    if parallel:
        from .blocked import _diag_affine_scan

        q_fwd = _diag_affine_scan(
            jnp.exp(-c_all * dt_prev[:, None]), v_data * alpha[:, None]
        )
        r_bwd = _diag_affine_scan(
            jnp.exp(-c_all * dt_next[:, None]),
            u_data * alpha[:, None],
            reverse=True,
        )
    else:
        # Forward states: q_k = state at t_k including alpha_k.
        def fwd(q, inp):
            v, a, dtp = inp
            q = q * jnp.exp(-c_all * dtp) + v * a
            return q, q

        _, q_fwd = lax.scan(
            fwd,
            jnp.zeros((c_all.shape[0],), dtype),
            (v_data, alpha, dt_prev),
        )

        # Backward states: r_k = state at t_k including alpha_k.
        def bwd(r, inp):
            u, a, dtn = inp
            r = r * jnp.exp(-c_all * dtn) + u * a
            return r, r

        _, r_bwd = lax.scan(
            bwd,
            jnp.zeros((c_all.shape[0],), dtype),
            (u_data, alpha, dt_next),
            reverse=True,
        )

    # Gather at test points: i = first data index with t >= x.
    i = jnp.searchsorted(t, x, side="left")
    has_prev = i > 0
    has_next = i < t.shape[0]
    i_prev = jnp.clip(i - 1, 0, t.shape[0] - 1)
    i_next = jnp.clip(i, 0, t.shape[0] - 1)

    dxf = (x - t[i_prev])[:, None]
    dxb = (t[i_next] - x)[:, None]

    qf = jnp.where(
        has_prev[:, None], q_fwd[i_prev] * jnp.exp(-c_all * dxf), 0.0
    )
    rb = jnp.where(
        has_next[:, None], r_bwd[i_next] * jnp.exp(-c_all * dxb), 0.0
    )

    # U-basis at test points contracts the forward state; V-basis at test
    # points contracts the backward state.
    arg_x = d_comp * x[:, None]
    u_test = jnp.concatenate(
        [
            jnp.broadcast_to(a_real, (x.shape[0], jr)),
            jnp.stack(
                [
                    a_comp * jnp.cos(arg_x) + b_comp * jnp.sin(arg_x),
                    a_comp * jnp.sin(arg_x) - b_comp * jnp.cos(arg_x),
                ],
                -1,
            ).reshape(x.shape[0], -1),
        ],
        axis=1,
    )
    v_test = jnp.concatenate(
        [
            jnp.ones((x.shape[0], jr), dtype),
            jnp.stack([jnp.cos(arg_x), jnp.sin(arg_x)], -1).reshape(
                x.shape[0], -1
            ),
        ],
        axis=1,
    )

    return jnp.sum(u_test * qf, axis=1) + jnp.sum(v_test * rb, axis=1)
