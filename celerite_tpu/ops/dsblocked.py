"""Block-parallel semiseparable solver with double-single arithmetic.

The ``precision="ds"`` backend of :meth:`GP.build_loglik`.  Identical
algorithm to :mod:`celerite_tpu.ops.blocked` (two-level Riccati-element
blocking; see that module's derivation), but BOTH the input streams and
every recursion carry — the S-hat state, the cumulative (A, J) element,
the affine solve maps (M, m), the forward-substitution state h, and the
quad/logdet accumulators — are double-single (f32+f32, ~48-bit) values
from :mod:`celerite_tpu.ops.dsa` / :mod:`celerite_tpu.ops.dslower`.

Why: round-3 measurements (ROADMAP "float32 accuracy") showed the f32
recursion + f32 lowering are the error floor — on adversarially
mis-fitted N=1e6 configs the f32 gradient deviates from f64 by 20-30%
of its norm on near-cancelling components, and ill-conditioned rank>=64
stacks (summed variance >> diag) flip pivots in f32 on *both* the
sequential and blocked backends.  A compose-only ds carry was refuted in
round 3; measurements this round showed a ds *carry* alone is also not
enough (the f32 lowering's per-point rounding incoherently perturbs the
represented matrix), hence ds end-to-end.

The reference bar is hardware float64
(/root/reference/cpp/include/celerite/solver/cholesky.h:41-210); this
double-single path is its float32-hardware equivalent.  Gradients come from
jax AD straight through the ds arithmetic (the compensation chains are
bilinear, so AD is exact through them), with scan residual saves.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax

import jax.tree_util as jtu

from . import dsa
from .dsa import DD, DS
from .blocked import _small_inv, default_block_size
from .dslower import SSMDS, promote_ssm
from .lower import SSM

__all__ = [
    "gp_log_likelihood", "gp_log_likelihood_grad", "default_block_size",
]


def _eye(p, dtype):
    return jnp.eye(p, dtype=dtype)


# Structural helpers are jax-pytree maps so they apply unchanged to both
# DS values and DD (dual) values — every DD leaf has the value's shape.


def _col(x):
    return jtu.tree_map(lambda a: a[..., :, None], x)


def _row(x):
    return jtu.tree_map(lambda a: a[..., None, :], x)


def _bcast(x, shape):
    return jtu.tree_map(lambda a: jnp.broadcast_to(a, shape), x)


def _hi(x):
    """The f32 hi word of the VALUE (DS, DD, or plain array)."""
    if isinstance(x, DD):
        return x.val.hi
    return x.hi if isinstance(x, DS) else x


def _f32val(x):
    v = x.val if isinstance(x, DD) else x
    return v.hi + v.lo


def _lift_like(x, template):
    """Promote a DS to DD with zero tangents when template is dual."""
    if isinstance(template, DD) and not isinstance(x, DD):
        return dsa.dd_lift(x, len(template.tan))
    return x


def _pad_blocks_ds(ssm: SSMDS, resid, L):
    """Pad to a multiple of L with inert rows (A=1, U=V=0, phi=1, y=0).

    The inert-row constants live only in the VALUE hi word; every other
    leaf (lo words, all tangent words) pads with zeros — which is the
    exact ds/dual representation of those constants.
    """
    n, p = _hi(ssm.U).shape
    b = -(-n // L)
    pad = b * L - n
    dtype = _hi(ssm.U).dtype

    def padx(x, const):
        if not pad:
            return x
        hi_leaf = _hi(x)

        def padf(a, c):
            z = jnp.full((pad,) + a.shape[1:], c, dtype)
            return jnp.concatenate([a, z], axis=0)

        return jtu.tree_map(
            lambda a: padf(a, const if a is hi_leaf else 0), x
        )

    ssm = SSMDS(
        U=padx(ssm.U, 0), V=padx(ssm.V, 0),
        phi=padx(ssm.phi, 1), A=padx(ssm.A, 1),
    )
    if resid is not None:
        resid = padx(resid, 0)

    def blkify(x, *shape):
        return jtu.tree_map(lambda a: a.reshape(*shape), x)

    blk = SSMDS(
        U=blkify(ssm.U, b, L, p),
        V=blkify(ssm.V, b, L, p),
        phi=blkify(ssm.phi, b, L, p),
        A=blkify(ssm.A, b, L),
    )
    if resid is not None:
        resid = blkify(resid, b, L)
    return blk, resid, b, pad


def _compose_full_ds(e1, e2):
    """ds Riccati (A, J, C) composition; e1 acts first.

    The (I + C1 J2) inverse is seeded by the f32 unrolled Gauss-Jordan
    and Newton-refined once in ds (dsa.refine_inv) — full ds accuracy at
    ~3 ds-matmuls instead of a ds elimination chain.
    """
    A1, J1, C1 = e1
    A2, J2, C2 = e2
    p = _hi(A1).shape[-1]
    eyeb = jnp.broadcast_to(_eye(p, _hi(A1).dtype), _hi(A1).shape)
    M = dsa.add_f(dsa.matmul(C1, J2), eyeb)
    E = dsa.refine_inv(M, _small_inv(_f32val(M)))
    A12 = dsa.matmul(A2, dsa.matmul(E, A1))
    tr = lambda x: jtu.tree_map(
        lambda a: jnp.swapaxes(a, -1, -2), x
    )
    C12 = dsa.add(
        dsa.matmul(dsa.matmul(A2, E), dsa.matmul(C1, tr(A2))), C2
    )
    J12 = dsa.add(J1, dsa.matmul(tr(A1), dsa.matmul(dsa.matmul(J2, E), A1)))
    return (A12, J12, C12)


def _step_factor_ds(Sh: DS, u: DS, v: DS, ph: DS, a: DS):
    """One ds factor step: returns (Sh_new, S, su, d, w); all ds."""
    # S = Phi Sh Phi (diagonal Phi: row and column scale)
    S = dsa.mul(dsa.mul(Sh, _col(ph)), _row(ph))
    # su = S u
    su = dsa.sum_axis(dsa.mul(S, _row(u)), -1)
    # d = a - u . su
    d = dsa.add(dsa.neg(dsa.sum_axis(dsa.mul(su, u), -1)), a)
    # w = (v - su) / d
    w = dsa.div(dsa.add(dsa.neg(su), v), _bcast(d, _hi(su).shape))
    # Sh' = S + d w w^T
    dww = dsa.mul(dsa.outer(w, w), _bcast(d, _hi(S).shape))
    return dsa.add(S, dww), S, su, d, w


def _block_elements_ds(blk: SSMDS):
    """Per-block cumulative (A, J, C) ds elements (trajectory form).

    Mirrors blocked._block_elements: C is the zero-seeded S-hat carry,
    A accumulates closed-loop transitions (I - w u^T) Phi, J a sum of
    stable rank-1 terms — all in ds.
    """
    p = _hi(blk.U).shape[-1]
    dtype = _hi(blk.U).dtype

    def one_block(U, V, phi, A):
        def step(carry, inp):
            Ac, Jc, Sh = carry
            u, v, ph, a = inp
            Sh_new, S, su, d, w = _step_factor_ds(Sh, u, v, ph, a)

            ut = dsa.mul(ph, u)
            # uAc = Ac^T ut (sum over the row axis)
            uAc = dsa.sum_axis(dsa.mul(Ac, _col(ut)), 0)
            Anew = dsa.add(
                dsa.mul(Ac, _col(ph)), dsa.neg(dsa.outer(w, uAc))
            )
            Jnew = dsa.add(
                Jc,
                dsa.neg(
                    dsa.div(
                        dsa.outer(uAc, uAc),
                        _bcast(d, (p, p)),
                    )
                ),
            )
            return (Anew, Jnew, Sh_new), None

        zero = _lift_like(dsa.from_f32(jnp.zeros((p, p), dtype)), U)
        init = (
            _lift_like(dsa.from_f32(_eye(p, dtype)), U), zero, zero,
        )
        (Ab, Jb, Cb), _ = lax.scan(step, init, (U, V, phi, A))
        return Ab, Jb, Cb

    return jax.vmap(one_block)(blk.U, blk.V, blk.phi, blk.A)


def _exclusive_prefix_elements_ds(elems):
    A, J, C = elems
    p = _hi(A).shape[-1]
    incl = lax.associative_scan(_compose_full_ds, (A, J, C), axis=0)
    dtype = _hi(A).dtype
    eye = _lift_like(
        dsa.from_f32(jnp.broadcast_to(_eye(p, dtype), (1, p, p))), A
    )
    zero = _lift_like(dsa.from_f32(jnp.zeros((1, p, p), dtype)), A)

    def shift(init, inc):
        return jtu.tree_map(
            lambda i, a: jnp.concatenate([i, a[:-1]], axis=0), init, inc
        )

    return tuple(
        shift(init, inc) for init, inc in zip((eye, zero, zero), incl)
    )


def _affine_compose_ds(e1, e2):
    M1, m1 = e1
    M2, m2 = e2
    return (
        dsa.matmul(M2, M1),
        dsa.add(dsa.matvec(M2, m1), m2),
    )


def _exclusive_prefix_affine_ds(M, m):
    p = _hi(M).shape[-1]
    incl = lax.associative_scan(_affine_compose_ds, (M, m), axis=0)
    dtype = _hi(M).dtype
    eye = _lift_like(
        dsa.from_f32(jnp.broadcast_to(_eye(p, dtype), (1, p, p))), M
    )
    zero = _lift_like(dsa.from_f32(jnp.zeros((1, p), dtype)), m)
    Mi, mi = incl

    def shift(init, inc):
        return jtu.tree_map(
            lambda i, a: jnp.concatenate([i, a[:-1]], axis=0), init, inc
        )

    return shift(eye, Mi), shift(zero, mi)


def gp_log_likelihood(ssm, resid, block_size=None):
    """(ll, ok) with ds streams and carries; same semantics as blocked.

    ``ssm`` may be a plain f32 :class:`SSM` (promoted with zero lo
    parts) or an :class:`SSMDS` from :func:`dslower.lower_ds`.
    Differentiable by plain jax AD (scan residuals); the compensation
    chains are exact under AD, so the returned gradient is the exact
    gradient of the ds-computed value.
    """
    total, min_d, n, dtype = _total_ds(ssm, resid, block_size)
    const = n * math.log(2.0 * math.pi)
    ll = -0.5 * (dsa.to_f32(total) + jnp.asarray(const, dtype))
    ok = (jnp.min(min_d) > 0) & jnp.isfinite(lax.stop_gradient(ll))
    ll = jnp.where(ok, ll, -jnp.inf)
    return ll, ok


def gp_log_likelihood_grad(ssm, resid, block_size=None):
    """(ll, ok, grad) with the T gradient components carried as ds
    tangents through the ENTIRE recursion (dual-ds forward mode).

    ``ssm`` is an :class:`SSMDS` whose streams are :class:`dsa.DD`
    values seeded with ds tangents (see dslower.lower_ds with
    ``coeff_tangents``); ``resid`` may be a plain f32 array, a DS, or a
    DD (tangents flow for active mean parameters).  Unlike plain jax AD
    over :func:`gp_log_likelihood` — whose cotangent chains run in f32
    and re-introduce eps32-level noise that the solver's cancelling
    reductions amplify ~1000x — the returned gradient tracks the f64
    gradient at the same ds-class accuracy as the value.  Cost is
    ~(1 + 2 T) ds forward passes, single sweep, no residual saves.

    The reference computes this gradient in hardware f64 forward-mode
    (solver.cpp:347, grad templates of cholesky.h); this is the
    double-single equivalent.
    """
    total, min_d, n, dtype = _total_ds(ssm, resid, block_size)
    if not isinstance(total, DD):
        raise TypeError(
            "gp_log_likelihood_grad needs DD-seeded streams; use "
            "gp_log_likelihood for plain ds values"
        )
    const = n * math.log(2.0 * math.pi)
    ll = -0.5 * (dsa.to_f32(total.val) + jnp.asarray(const, dtype))
    grad = jnp.stack([
        -0.5 * (t.hi.astype(dtype) + t.lo.astype(dtype))
        for t in total.tan
    ])
    ok = (jnp.min(min_d) > 0) & jnp.isfinite(lax.stop_gradient(ll))
    ll = jnp.where(ok, ll, -jnp.inf)
    grad = jnp.where(ok, grad, jnp.zeros_like(grad))
    return ll, ok, grad


def _total_ds(ssm, resid, block_size):
    """quad + logdet as a DS (or DD) total, plus per-block min d."""
    if isinstance(ssm, SSM):
        ssm = promote_ssm(ssm)
    n, p = _hi(ssm.U).shape
    L = block_size or default_block_size(n)
    blk, y_blk, b, pad = _pad_blocks_ds(ssm, resid, L)
    dtype = _hi(ssm.U).dtype

    # Pass 1: ds block elements + ds cross-block prefix -> incoming S-hat.
    elems = _block_elements_ds(blk)
    pref = _exclusive_prefix_elements_ds(elems)
    S_hat_in = pref[2]

    # Pass 2: factor + affine solve maps per block, all carries ds.
    def pass2(U, V, phi, A, y, Sh):
        def step(carry, inp):
            Sh, Mc, mc = carry
            u, v, ph, a, yn = inp
            Sh_new, S, su, d, w = _step_factor_ds(Sh, u, v, ph, a)
            # M' = (I - w u^T) Phi M ; m' = (I - w u^T) Phi m + w y
            PhM = dsa.mul(Mc, _col(ph))
            uPhM = dsa.sum_axis(dsa.mul(PhM, _col(u)), 0)
            Mc = dsa.add(PhM, dsa.neg(dsa.outer(w, uPhM)))
            mh = dsa.mul(mc, ph)
            umh = dsa.sum_axis(dsa.mul(mh, u), -1)
            z = dsa.add_f(dsa.neg(umh), yn)
            mc = dsa.add(mh, dsa.mul(w, z))  # scalar z broadcasts
            return (Sh_new, Mc, mc), (d, w)

        init = (
            Sh,
            _lift_like(dsa.from_f32(_eye(p, dtype)), Sh),
            _lift_like(dsa.from_f32(jnp.zeros((p,), dtype)), Sh),
        )
        (_, Mb, mb), (D, W) = lax.scan(step, init, (U, V, phi, A, y))
        return Mb, mb, D, W

    M, m, D, W = jax.vmap(pass2)(
        blk.U, blk.V, blk.phi, blk.A, y_blk, S_hat_in
    )

    # Cross-block ds prefix of the affine maps -> incoming h per block.
    _, h_in = _exclusive_prefix_affine_ds(M, m)

    # Pass 3: z + ds-compensated reductions.
    def pass3(U, phi, W, y, D, h):
        def step(carry, inp):
            h, quad, logdet, min_d = carry
            u, ph, w, yn, d = inp
            f = dsa.mul(h, ph)
            uf = dsa.sum_axis(dsa.mul(f, u), -1)
            z = dsa.add_f(dsa.neg(uf), yn)
            h = dsa.add(f, dsa.mul(w, z))  # scalar z broadcasts
            quad = dsa.add(quad, dsa.div(dsa.mul(z, z), d))
            logdet = dsa.add(logdet, dsa.log_ds(d))
            min_d = jnp.minimum(min_d, _hi(d))
            return (h, quad, logdet, min_d), None

        zero = _lift_like(dsa.from_f32(jnp.zeros((), dtype)), h)
        init = (h, zero, zero, jnp.asarray(jnp.inf, dtype))
        (h, quad, logdet, min_d), _ = lax.scan(
            step, init, (U, phi, W, y, D)
        )
        return quad, logdet, min_d

    quad_b, logdet_b, min_d = jax.vmap(pass3)(
        blk.U, blk.phi, W, y_blk, D, h_in
    )

    # Cross-block ds reduction of the scalars.
    total = dsa.add(
        dsa.sum_axis(quad_b, 0), dsa.sum_axis(logdet_b, 0)
    )
    return total, min_d, n, dtype
