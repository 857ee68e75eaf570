"""Pallas (Triton) kernels for the GP log-likelihood on NVIDIA GPUs.

The block-parallel solver of :mod:`ops.blocked` runs each block's
recursion as a ``lax.scan``: every one of its L steps is a handful of
(P, P) operations that XLA launches as separate small kernels, so at
N = 1e6 the primal is bound by launch latency, not by the bytes it
reads.  This module runs the same algebra with the time loop *inside*
the kernel:

- The time axis is cut into ``B`` lanes of ``L`` consecutive steps and
  laid out as (steps, lanes), so one step's loads across neighbouring
  lanes are coalesced.  Each Triton program owns ``lanes`` lanes (one
  per thread) and walks their L steps in a ``fori_loop``; the per-lane
  Riccati state lives in registers as unrolled (P, P) entries.
- Sweep 1 builds each lane's zero-seeded (A, J, C) element exactly as
  ``blocked._block_elements`` does (the trajectory formulation).
- The cross-lane prefix is plain ``lax.associative_scan`` with
  ``blocked``'s composition, giving every lane its incoming state.
- Sweep 2 runs the seeded factorization and accumulates the
  log-determinant, the smallest pivot and the lane's affine solve map
  (M, m) for h_n = M_n h_{n-1} + m_n.  A second associative scan gives
  each lane its incoming solve state h_in.
- Sweep 3 re-runs the seeded factorization (cheaper than storing D and
  W) with the forward substitution from h_in and sums z^2 / d.  (The
  closed form z_n = z0_n - g_n . h_in would save this sweep, but its
  quadratic form q0 - 2 qv.h + h^T Qm h cancels catastrophically in
  float32 when the state decays slowly across a lane.)

The lowering stays in XLA (:func:`ops.lower.lower`, one fusion with the
layout change); the kernel reads (U, V, phi, A, y).  The gradient is
reverse-mode AD through ``blocked.gp_log_likelihood`` (custom VJP).

The kernels compile only for a GPU through Triton; ``interpret=True``
runs them on the CPU for tests.  Agreement with ``ops.seq`` and the
dense oracle is tested in tests/test_fused.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import blocked
from .lower import SSM
from .precision import f32_matmuls

__all__ = [
    "gp_log_likelihood",
    "default_steps",
    "require_gpu",
    "MAX_WIDTH",
    "supports_width",
]

# Widest semiseparable rank P routed to the kernels.  On an H100 at
# N = 1e6 they beat the blocked solver at P = 2, 4 and 8 (12x, 9.7x and
# 6.8x); wider models are not measured and keep the blocked path.
MAX_WIDTH = 8


def supports_width(p):
    """True if the kernel handles a model of semiseparable rank ``p``."""
    return 0 < p <= MAX_WIDTH


def require_gpu():
    """Raise ValueError unless JAX's default backend is a GPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise ValueError(
            "solver='fused' runs Triton kernels, which need a GPU; the "
            "JAX backend is {0!r}.  Use solver='blocked' or "
            "'auto'.".format(backend)
        )


def default_steps(n):
    """Steps per lane L (a power of two, 16 to 64).

    Short lanes mean more lanes (fill the card) but a longer cross-lane
    prefix.  On an H100 at N = 1e6, L = 64 was fastest at P = 2 and 4
    (L = 32..256 swept; PERF.md).
    """
    steps = 16
    while steps < 64 and steps * 16384 < n:
        steps *= 2
    return steps


def _pow2(x):
    return 1 << max(0, int(x) - 1).bit_length()


# -- per-step algebra on unrolled (lanes,) vectors ----------------------------


def _sym_get(m, i, j):
    return m[(i, j) if i <= j else (j, i)]


def _factor_step(Sh, u, v, ph, a, p):
    """One seeded step of the Cholesky recursion (see ops.seq).

    ``Sh`` is the symmetric post-update state as {(i, j): vec, i <= j}.
    Returns the new state, the pivot d and the factor vector w.
    """
    S = {k: ph[k[0]] * ph[k[1]] * Sh[k] for k in Sh}
    su = [sum(_sym_get(S, i, j) * u[j] for j in range(p)) for i in range(p)]
    d = a - sum(u[i] * su[i] for i in range(p))
    w = [(v[i] - su[i]) / d for i in range(p)]
    Sh = {(i, j): S[(i, j)] + d * w[i] * w[j] for (i, j) in S}
    return Sh, d, w


def _sym_keys(p):
    return [(i, j) for i in range(p) for j in range(i, p)]


def _load_step(u_ref, v_ref, ph_ref, a_ref, y_ref, l, p):
    u = [u_ref[k, l, :] for k in range(p)]
    v = [v_ref[k, l, :] for k in range(p)]
    ph = [ph_ref[k, l, :] for k in range(p)]
    return u, v, ph, a_ref[l, :], y_ref[l, :]


def _elements_kernel(u_ref, v_ref, ph_ref, a_ref, y_ref, out_ref):
    """Sweep 1: each lane's zero-seeded (A, J, C) element."""
    p, L, nl = u_ref.shape
    dtype = out_ref.dtype
    keys = _sym_keys(p)
    zero = jnp.zeros((nl,), dtype)
    one = jnp.ones((nl,), dtype)

    def body(l, carry):
        Ac, Jc, Sh = carry
        u, v, ph, a, _ = _load_step(u_ref, v_ref, ph_ref, a_ref, y_ref, l, p)
        Sh, d, w = _factor_step(Sh, u, v, ph, a, p)
        ut = [ph[i] * u[i] for i in range(p)]
        uA = [sum(Ac[i][j] * ut[i] for i in range(p)) for j in range(p)]
        Ac = [[ph[i] * Ac[i][j] - w[i] * uA[j] for j in range(p)]
              for i in range(p)]
        Jc = {(i, j): Jc[(i, j)] - uA[i] * uA[j] / d for (i, j) in keys}
        return Ac, Jc, Sh

    init = (
        [[one if i == j else zero for j in range(p)] for i in range(p)],
        {k: zero for k in keys},
        {k: zero for k in keys},
    )
    Ac, Jc, Sh = lax.fori_loop(0, L, body, init)
    for i in range(p):
        for j in range(p):
            out_ref[0, i, j, :] = Ac[i][j]
            out_ref[1, i, j, :] = _sym_get(Jc, i, j)
            out_ref[2, i, j, :] = _sym_get(Sh, i, j)


def _factor_kernel(u_ref, v_ref, ph_ref, a_ref, y_ref, sh_ref,
                   mat_ref, vec_ref, stat_ref):
    """Sweep 2: seeded factorization, the lane's affine solve map
    (M, m), the log-determinant and the smallest pivot."""
    p, L, nl = u_ref.shape
    dtype = mat_ref.dtype
    keys = _sym_keys(p)
    zero = jnp.zeros((nl,), dtype)
    one = jnp.ones((nl,), dtype)

    def body(l, carry):
        Sh, M, m, ld, cl, mind = carry
        u, v, ph, a, y = _load_step(u_ref, v_ref, ph_ref, a_ref, y_ref, l, p)
        Sh, d, w = _factor_step(Sh, u, v, ph, a, p)
        PhM = [[ph[i] * M[i][j] for j in range(p)] for i in range(p)]
        g = [sum(u[i] * PhM[i][j] for i in range(p)) for j in range(p)]
        M = [[PhM[i][j] - w[i] * g[j] for j in range(p)] for i in range(p)]
        mh = [ph[i] * m[i] for i in range(p)]
        z = y - sum(u[i] * mh[i] for i in range(p))
        m = [mh[i] + w[i] * z for i in range(p)]
        ld, cl = blocked._kahan_add(ld, cl, jnp.log(d))
        return Sh, M, m, ld, cl, jnp.minimum(mind, d)

    init = (
        {(i, j): sh_ref[i, j, :] for (i, j) in keys},
        [[one if i == j else zero for j in range(p)] for i in range(p)],
        [zero] * p,
        zero, zero,
        jnp.full((nl,), jnp.inf, dtype),
    )
    _, M, m, ld, cl, mind = lax.fori_loop(0, L, body, init)
    for i in range(p):
        for j in range(p):
            mat_ref[i, j, :] = M[i][j]
        vec_ref[i, :] = m[i]
    stat_ref[0, :] = ld + cl
    stat_ref[1, :] = mind


def _solve_kernel(u_ref, v_ref, ph_ref, a_ref, y_ref, sh_ref, h_ref,
                  quad_ref):
    """Sweep 3: seeded factorization again, with the forward
    substitution from the lane's true incoming state; sum z^2 / d."""
    p, L, nl = u_ref.shape
    dtype = quad_ref.dtype
    zero = jnp.zeros((nl,), dtype)

    def body(l, carry):
        Sh, h, q, cq = carry
        u, v, ph, a, y = _load_step(u_ref, v_ref, ph_ref, a_ref, y_ref, l, p)
        Sh, d, w = _factor_step(Sh, u, v, ph, a, p)
        f = [ph[i] * h[i] for i in range(p)]
        z = y - sum(u[i] * f[i] for i in range(p))
        h = [f[i] + w[i] * z for i in range(p)]
        q, cq = blocked._kahan_add(q, cq, z * z / d)
        return Sh, h, q, cq

    init = (
        {(i, j): sh_ref[i, j, :] for (i, j) in _sym_keys(p)},
        [h_ref[i, :] for i in range(p)],
        zero, zero,
    )
    _, _, q, cq = lax.fori_loop(0, L, body, init)
    quad_ref[0, :] = q + cq


# -- wrapper -----------------------------------------------------------------


def _to_lanes(ssm: SSM, resid, L, nl):
    """Pad to (P2, L, B) lane layout: B a multiple of ``nl`` lanes, the
    rank padded to a power of two.  Padding rows and channels are inert
    (A=1, U=V=0, phi=1, y=0)."""
    n, p = ssm.U.shape
    p2 = _pow2(p)
    b = -(-(-(-n // L)) // nl) * nl
    pad = b * L - n
    dtype = ssm.U.dtype

    def chans(x, fill):
        x = jnp.pad(x, ((0, pad), (0, p2 - p)), constant_values=fill)
        return x.reshape(b, L, p2).transpose(2, 1, 0)

    def rows(x, fill):
        return jnp.pad(x, (0, pad), constant_values=fill).reshape(b, L).T

    return (
        chans(ssm.U, 0), chans(ssm.V, 0), chans(ssm.phi, 1),
        rows(ssm.A, 1), rows(resid.astype(dtype), 0), b,
    )


def _call(kernel, ins, out_shapes, nl, interpret):
    """One kernel sweep: a program per ``nl`` lanes (one lane per
    thread), every operand blocked along its last (lane) axis."""
    b = ins[0].shape[-1]

    def spec(shape):
        lead = len(shape) - 1
        return pl.BlockSpec(
            shape[:-1] + (nl,), lambda i: (0,) * lead + (i,)
        )

    return pl.pallas_call(
        kernel,
        grid=(b // nl,),
        in_specs=[spec(x.shape) for x in ins],
        out_specs=[spec(s.shape) for s in out_shapes],
        out_shape=out_shapes,
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(8, nl // 32))
        ),
        backend="triton",
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(*ins)


@f32_matmuls
def _impl(ssm: SSM, resid, steps, lanes, interpret):
    if not interpret:
        require_gpu()
    n, p = ssm.U.shape
    dtype = ssm.U.dtype
    L = _pow2(steps or default_steps(n))
    nl = _pow2(lanes)
    u, v, ph, a, y, b = _to_lanes(ssm, resid, L, nl)
    p2 = u.shape[0]
    data = (u, v, ph, a, y)

    (el,) = _call(
        _elements_kernel, data,
        [jax.ShapeDtypeStruct((4, p2, p2, b), dtype)],
        nl, interpret,
    )
    # (P2, P2, B) planes -> (B, P2, P2) elements for the prefix scans.
    A_el, J_el, C_el = (jnp.moveaxis(el[k], -1, 0) for k in range(3))
    sh_in = blocked._exclusive_prefix_elements((A_el, J_el, C_el))[2]

    sh_lanes = jnp.moveaxis(sh_in, 0, -1)
    M, m, stat = _call(
        _factor_kernel, data + (sh_lanes,),
        [
            jax.ShapeDtypeStruct((p2, p2, b), dtype),
            jax.ShapeDtypeStruct((p2, b), dtype),
            jax.ShapeDtypeStruct((2, b), dtype),
        ],
        nl, interpret,
    )
    _, h = blocked._exclusive_prefix_affine(jnp.moveaxis(M, -1, 0), m.T)

    (quad,) = _call(
        _solve_kernel, data + (sh_lanes, h.T),
        [jax.ShapeDtypeStruct((2, b), dtype)],
        nl, interpret,
    )
    ll = -0.5 * (
        jnp.sum(quad[0])
        + jnp.sum(stat[0])
        + n * jnp.log(2.0 * jnp.pi).astype(dtype)
    )
    ok = (jnp.min(stat[1]) > 0) & jnp.isfinite(ll)
    return jnp.where(ok, ll, -jnp.inf), ok


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def gp_log_likelihood(ssm: SSM, resid, steps=None, lanes=128,
                      interpret=False):
    """GP log-likelihood (ll, ok) through the Triton kernels.

    Same semantics as :func:`ops.blocked.gp_log_likelihood`.  ``steps``
    is the number of time steps per lane (default
    :func:`default_steps`), ``lanes`` the lanes per Triton program (one
    per thread).  The gradient is reverse-mode AD through the blocked
    solver.
    """
    return _impl(ssm, resid, steps, lanes, interpret)


def _fwd(ssm, resid, steps, lanes, interpret):
    return _impl(ssm, resid, steps, lanes, interpret), (ssm, resid)


def _bwd(steps, lanes, interpret, res, g):
    ssm, resid = res
    _, vjp = jax.vjp(
        lambda s, r: blocked.gp_log_likelihood(s, r)[0], ssm, resid
    )
    return vjp(g[0])


gp_log_likelihood.defvjp(_fwd, _bwd)
