"""Double-single lowering: coefficients -> ds (U, V, phi, A) streams.

Companion to :mod:`celerite_tpu.ops.dsblocked` (the ``precision="ds"``
backend).  The f32 lowering of :func:`celerite_tpu.ops.lower.lower`
rounds every exp/cos/sin to eps32; those per-point roundings are an
*incoherent* perturbation of the semiseparable representation — unlike
coefficient-level rounding (which evaluates a nearby valid kernel), they
can push the represented matrix indefinite whenever the PD margin is
below ~N_terms*eps32 (the rank>=64 summed-variance>>diag stacks of
ROADMAP known-issue 2), and their theta-jitter is the gradient-noise
floor measured in round 3.  Here every stream is a double-single pair
built from exact argument reduction + ds transcendental kernels
(:mod:`celerite_tpu.ops.dsa`), accurate to ~1e-13.

With ``coeff_tangents`` the coefficient scalars become dual-ds numbers
(:class:`dsa.DD`) and the streams carry T ds-accurate tangent
components, feeding :func:`dsblocked.gp_log_likelihood_grad` — the
forward-mode gradient whose tangent arithmetic itself runs in ds (the
reference's f64 forward-mode coefficient AD, solver.cpp:347, done in
double-single).

The reference needs none of this: its lowering runs inside the f64
factor loop (/root/reference/cpp/include/celerite/solver/cholesky.h:
129-152).  This module is the f32-hardware equivalent.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax.numpy as jnp
import jax.tree_util as jtu

from . import dsa
from .dsa import DD, DS
from . import ds as _ds
from .lower import Coefficients

__all__ = ["SSMDS", "lower_ds", "promote_ssm"]


class SSMDS(NamedTuple):
    """Semiseparable representation with double-single streams."""

    U: DS  # (N, P)
    V: DS  # (N, P)
    phi: DS  # (N, P), phi[0] == 1
    A: DS  # (N,)


def promote_ssm(ssm) -> SSMDS:
    """Promote a plain f32 SSM to SSMDS with zero lo parts."""
    return SSMDS(
        U=dsa.from_f32(ssm.U),
        V=dsa.from_f32(ssm.V),
        phi=dsa.from_f32(ssm.phi),
        A=dsa.from_f32(ssm.A),
    )


def _col(x):
    return jtu.tree_map(lambda a: a[:, None], x)


def lower_ds(
    coeffs: Coefficients,
    t: DS,
    dt: DS,
    diag,
    coeff_tangents: Optional[Sequence[Coefficients]] = None,
    A_gen=None,
    U_gen=None,
    V_gen=None,
) -> SSMDS:
    """Build ds (U, V, phi, A) for sorted coordinates.

    ``t``/``dt`` are static ds pairs of the time grid and spacings
    (split host-side from float64 via :func:`dsa.from_f64`; ``dt`` has
    dt[0] == 0).  ``diag`` is the f32 per-point variance (or a DS).
    The coefficient arrays are traced f32 values — their own rounding
    is a coefficient-level perturbation (a nearby valid kernel) and is
    kept coherent here by computing A from the same stored values with
    compensated sums.

    ``coeff_tangents``: optional sequence of T Coefficients trees (f32
    arrays shaped like ``coeffs``) holding d(coeff)/d(theta_j); the
    returned streams are then :class:`dsa.DD` duals whose tangents are
    computed in ds arithmetic throughout.

    ``A_gen``/``U_gen``/``V_gen``: optional general semiseparable
    blocks in the reference convention (A_gen: (N,), U/V_gen:
    (J_general, N); cholesky.h:148-152).  General columns are phi=1
    lanes of the same SSM, so they join the ds streams directly: pass
    each as a :class:`DS` pair (exact f64 split, since they are static
    data) or a plain f32 array.  They carry no coefficient tangents
    (the blocks are data, not functions of theta).
    """
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, jitter = coeffs
    n = t.hi.shape[0]
    jr = a_real.shape[0]
    jc = a_comp.shape[0]
    dtype = t.hi.dtype
    dual = coeff_tangents is not None

    def cnum(field):
        """A coefficient array as a DS (or DD with its seeded tangents)."""
        v = dsa.from_f32(getattr(coeffs, field).astype(dtype))
        if not dual:
            return v
        return dsa.dd_seed(v, (
            dsa.from_f32(getattr(ct, field).astype(dtype))
            for ct in coeff_tangents
        ))

    def lift(x):
        """A tangent-free DS, promoted to DD in dual mode."""
        if not dual:
            return x
        return dsa.dd_lift(x, len(coeff_tangents))

    dt_col = _col(dt)

    parts_u, parts_v, parts_p = [], [], []

    if jr:
        ones = dsa.from_f32(jnp.ones((n, jr), dtype))
        u_r = dsa.mul_f(lift(ones), cnum("a_real"))
        v_r = lift(ones)
        p_r = dsa.exp_ds(dsa.mul_f(lift(dsa.neg(dt_col)), cnum("c_real")))
        parts_u.append(u_r)
        parts_v.append(v_r)
        parts_p.append(p_r)

    if jc:
        r_hi, r_lo = _ds.reduced_angle(
            d_comp.astype(dtype), t.hi[:, None], t.lo[:, None]
        )
        r = DS(r_hi, r_lo)
        if dual:
            # d(angle)/d(d_comp_tangent) = t * dd; the mod-2pi shift of
            # reduced_angle is locally constant so it does not touch
            # the tangent.  Computed in ds from the exact t pair.
            d_dd = cnum("d_comp")
            t_colds = DS(t.hi[:, None], t.lo[:, None])
            r = dsa.dd_seed(r, (
                dsa.mul(t_colds, dt_) for dt_ in d_dd.tan
            ))
        sin, cos = dsa.sincos_ds(r)
        a_c = cnum("a_comp")
        b_c = cnum("b_comp")
        u0 = dsa.add(dsa.mul_f(cos, a_c), dsa.mul_f(sin, b_c))
        u1 = dsa.sub(dsa.mul_f(sin, a_c), dsa.mul_f(cos, b_c))
        p_half = dsa.exp_ds(
            dsa.mul_f(lift(dsa.neg(dt_col)), cnum("c_comp"))
        )

        def interleave(x0, x1):
            return jtu.tree_map(
                lambda a, b: jnp.stack([a, b], axis=-1).reshape(
                    n, 2 * jc
                ),
                x0, x1,
            )

        parts_u.append(interleave(u0, u1))
        parts_v.append(interleave(cos, sin))
        parts_p.append(interleave(p_half, p_half))

    def _as_ds(x):
        """Accept a precomputed DS split or a plain array (-> zero lo)."""
        if isinstance(x, DS):
            return jtu.tree_map(lambda a: a.astype(dtype), x)
        return dsa.from_f32(jnp.asarray(x, dtype))

    has_general = U_gen is not None and (
        (U_gen.hi if isinstance(U_gen, DS) else jnp.asarray(U_gen)).shape[0]
        > 0
    )
    if has_general:
        # General columns: phi = 1 exactly (DS one has zero lo word),
        # U/V transposed from the reference (J_general, N) layout.
        tr = lambda x: jtu.tree_map(lambda a: a.T, x)
        parts_u.append(lift(tr(_as_ds(U_gen))))
        parts_v.append(lift(tr(_as_ds(V_gen))))
        jg = (
            U_gen.hi if isinstance(U_gen, DS) else jnp.asarray(U_gen)
        ).shape[0]
        parts_p.append(lift(dsa.from_f32(jnp.ones((n, jg), dtype))))

    if parts_u:
        def cat(parts):
            return jtu.tree_map(
                lambda *xs: jnp.concatenate(xs, axis=1), *parts
            )

        U, V, phi = cat(parts_u), cat(parts_v), cat(parts_p)
    else:  # jitter-only kernel (P = 0)
        z = jnp.zeros((n, 0), dtype)
        U = V = phi = lift(DS(z, z))

    # A = diag + sum(a_real) + sum(a_comp) + jitter, compensated so a
    # tiny diagonal survives next to a large summed variance.
    asum = lift(dsa.from_f32(jnp.zeros((), dtype)))
    if jr:
        asum = dsa.add(asum, dsa.sum_axis(cnum("a_real"), 0))
    if jc:
        asum = dsa.add(asum, dsa.sum_axis(cnum("a_comp"), 0))
    jit_num = dsa.from_f32(jnp.asarray(jitter, dtype))
    if dual:
        jit_num = dsa.dd_seed(jit_num, (
            dsa.from_f32(jnp.asarray(ct.jitter, dtype))
            for ct in coeff_tangents
        ))
    asum = dsa.add(asum, jit_num)
    bcast_n = jtu.tree_map(lambda a: jnp.broadcast_to(a, (n,)), asum)
    if isinstance(diag, (DS, DD)):
        A = dsa.add(bcast_n, diag)
    else:
        A = dsa.add_f(bcast_n, jnp.asarray(diag, dtype))
    if has_general and A_gen is not None:
        A = dsa.add(A, lift(_as_ds(A_gen)))
    return SSMDS(U=U, V=V, phi=phi, A=A)
