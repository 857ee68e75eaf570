"""Two-level block-parallel semiseparable solver.

This is the accelerator reformulation of the reference's strictly sequential
O(N) Cholesky recursion (cholesky.h:126-179): the time axis is split into B
blocks of length L; each block runs the cheap sequential recursion locally
(vmapped across blocks, so every step is one wide vector op), and the tiny
cross-block coupling — a P-dimensional state — is composed exactly with a
``jax.lax.associative_scan``.  Wall-clock drops from O(N) sequential steps
to O(L) steps + O(log B) vectorized passes, with ~3x the FLOPs (nearly
free on an accelerator: the sequential scan is latency-bound, not
compute-bound).  On a GPU each of the L steps still launches a few small
kernels; ops/fused.py runs the same passes with the step loop inside
Triton kernels.

Mathematical basis.  Write the post-update state S-hat_n = S_n + D_n W_n
W_n^T.  A single step of the factorization is exactly the Riccati-class map

    S-hat_n = A_n S-hat_{n-1} (I + J_n S-hat_{n-1})^{-1} A_n^T + C_n

with  A_n = (I - V_n U_n^T / A_n) Phi_n,
      J_n = - (Phi_n U_n)(Phi_n U_n)^T / A_n,
      C_n = V_n V_n^T / A_n            (diagonal Phi, scalar prior pivot A_n),

and maps of this (A, J, C) class are **closed under composition**:

    E   = (I + C1 J2)^{-1}
    A12 = A2 E A1
    C12 = A2 E C1 A2^T + C2
    J12 = J1 + A1^T J2 E' A1      (J2 E' = J2 (I + C1 J2)^{-1})

(the same algebra as the parallel-Kalman-filter elements of Sarkka &
Garcia-Fernandez 2021 — celerite kernels are state-space models).  Within a
block the per-step compositions are rank-one (Sherman-Morrison), costing
O(P^2) per step; across blocks the full O(P^3) composition runs in an
associative scan over only B elements.

The forward substitution (L z = y) is an affine recursion
``h_n = M_n h_{n-1} + m_n`` with ``M_n = (I - W_n U_n^T) Phi_n`` and
``m_n = W_n y_n``; it is blocked the same way.

Everything here is validated against the sequential scan in
tests/test_blocked.py (bitwise-class agreement in f64).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .lower import SSM
from .seq import FactorResult
from .precision import f32_matmuls

__all__ = [
    "gp_log_likelihood",
    "factor",
    "solve_lower",
    "solve",
    "dot_L",
    "matmul",
    "default_block_size",
    "apply_elem",
]


@f32_matmuls
def apply_elem(elem, S):
    """Apply a Riccati (A, J, C) element to a state: A S (I+JS)^-1 A^T + C."""
    A, J, C = elem
    p = A.shape[-1]
    eye = jnp.eye(p, dtype=A.dtype)
    return A @ S @ _small_inv(eye + J @ S) @ jnp.swapaxes(A, -1, -2) + C


def _kahan_add(s, c, x):
    """One compensated-summation step; returns (new_sum, new_compensation)."""
    y = x - c
    t = s + y
    c = (t - s) - y
    return t, c


def default_block_size(n):
    """Pick L ~ sqrt-ish balance: enough blocks to give each step a
    wide vector op, short sequential depth.  Clamped to [16, 256]."""
    if n <= 4096:
        return max(16, n // 16)
    return 256


def _pad_blocks(ssm: SSM, resid, L):
    """Pad to a multiple of L with inert rows (A=1, U=V=0, phi=1, y=0)."""
    n, p = ssm.U.shape
    b = -(-n // L)
    pad = b * L - n
    if pad:
        zU = jnp.zeros((pad, p), ssm.U.dtype)
        ssm = SSM(
            U=jnp.concatenate([ssm.U, zU]),
            V=jnp.concatenate([ssm.V, zU]),
            phi=jnp.concatenate([ssm.phi, jnp.ones((pad, p), ssm.U.dtype)]),
            A=jnp.concatenate([ssm.A, jnp.ones((pad,), ssm.A.dtype)]),
        )
        if resid is not None:
            resid = jnp.concatenate(
                [resid, jnp.zeros((pad,), resid.dtype)]
            )
    blk = SSM(
        U=ssm.U.reshape(b, L, p),
        V=ssm.V.reshape(b, L, p),
        phi=ssm.phi.reshape(b, L, p),
        A=ssm.A.reshape(b, L),
    )
    if resid is not None:
        resid = resid.reshape(b, L)
    return blk, resid, b, pad


# -- Riccati (A, J, C) element algebra --------------------------------------


@jax.custom_jvp
def _small_inv(M):
    """Batched inverse of small (..., p, p) matrices, unrolled.

    Gauss-Jordan without pivoting, fully vectorized over the batch.  The
    matrices here are I + C J products with O(1) pivots, far from the
    pivoting-pathological regime, and LAPACK-style batched LU of tiny
    matrices lowers to sequential loops; this unrolled form is pure
    elementwise arithmetic.  The derivative is supplied analytically
    (d(M^-1) = -M^-1 dM M^-1) so AD never traces the elimination chain.
    """
    p = M.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(p, dtype=M.dtype), M.shape)
    aug = jnp.concatenate([M, eye], axis=-1)  # (..., p, 2p)
    for k in range(p):
        row = aug[..., k, :] / aug[..., k, k:k + 1]
        elim = aug - aug[..., :, k:k + 1] * row[..., None, :]
        aug = elim.at[..., k, :].set(row)
    return aug[..., :, p:]


@_small_inv.defjvp
def _small_inv_jvp(primals, tangents):
    (M,) = primals
    (dM,) = tangents
    inv = _small_inv(M)
    hi = jax.lax.Precision.HIGHEST
    return inv, -jnp.matmul(jnp.matmul(inv, dM, precision=hi), inv,
                            precision=hi)


@f32_matmuls
def _compose_full(e1, e2):
    """Full composition of two (A, J, C) elements (used across blocks).

    e1 acts first.  O(P^3) with one unrolled P x P inverse.
    """
    A1, J1, C1 = e1
    A2, J2, C2 = e2
    p = A1.shape[-1]
    eye = jnp.eye(p, dtype=A1.dtype)
    tr = lambda x: jnp.swapaxes(x, -1, -2)  # batch-safe transpose
    # E = (I + C1 J2)^{-1}; invert once, reuse for all three outputs.
    E = _small_inv(eye + C1 @ J2)
    A12 = A2 @ E @ A1
    C12 = A2 @ E @ C1 @ tr(A2) + C2
    J12 = J1 + tr(A1) @ (J2 @ E) @ A1
    return (A12, J12, C12)


@f32_matmuls
def _block_elements(blk: SSM):
    """Per-block cumulative (A, J, C) elements, trajectory ("closed-loop")
    formulation.

    vmapped over the block axis; the scan is over the L within-block steps.
    Cost per step is O(P^2) via rank-1 structure.

    Numerical design (important): a naive composition chain for the
    elements is exponentially unstable in f32 — the cumulative A is the
    *open-loop* influence operator, whose true decay happens through
    cancellation, so roundoff injected mid-chain grows.  Instead:

    - C is carried by the plain zero-seeded factor recursion
      (S-hat = Phi S-hat Phi + d w w^T), which is self-stabilizing — the
      same recursion the sequential solver runs;
    - A is accumulated as a product of per-step *closed-loop* transitions
      F_n = (I - v u^T/a)(Phi + (S u) u~^T / d) — the Jacobian of the
      composed map along the zero-seeded trajectory — which contract
      multiplicatively;
    - J is a sum of stable rank-1 terms -(A_prev^T u~)(.)^T / d.

    These are algebraically identical to composing per-step (A, J, C)
    elements (the map class is closed), but each carried quantity is
    computed through a numerically self-correcting recursion.
    """
    p = blk.U.shape[-1]
    dtype = blk.U.dtype
    eye = jnp.eye(p, dtype=dtype)

    def one_block(U, V, phi, A):
        def step(carry, inp):
            Ac, Jc, Sh = carry
            u, v, ph, a = inp
            # Stable factor recursion: C carry is the zero-seeded S-hat.
            S = (ph[:, None] * ph[None, :]) * Sh
            su = S @ u
            d = a - u @ su
            w = (v - su) / d
            Sh_new = S + d * jnp.outer(w, w)

            # Closed-loop transition F = (I - v u^T/a)(Phi + su ut^T/d),
            # applied to Ac in rank-1 form.  F simplifies exactly to
            # (I - w u^T) Phi — the forward-substitution transition:
            # u^T G = (a/d) ph*u, so the v-column is v (ut^T Ac)/d and
            # Phi Ac + (su - v)(ut^T Ac)/d = Phi Ac - w (ut^T Ac)^T.
            ut = ph * u
            uAc = jnp.sum(Ac * ut[:, None], axis=0)  # ut^T Ac
            Anew = ph[:, None] * Ac - jnp.outer(w, uAc)

            # Information accumulation: J -= (Ac^T ut)(Ac^T ut)^T / d.
            Jnew = Jc - jnp.outer(uAc, uAc) / d

            return (Anew, Jnew, Sh_new), None

        init = (eye, jnp.zeros((p, p), dtype), jnp.zeros((p, p), dtype))
        (Ab, Jb, Cb), _ = lax.scan(step, init, (U, V, phi, A))
        return Ab, Jb, Cb

    return jax.vmap(one_block)(blk.U, blk.V, blk.phi, blk.A)


@f32_matmuls
def _exclusive_prefix_elements(elems):
    """Exclusive prefix composition across the block axis."""
    A, J, C = elems
    b, p, _ = A.shape
    incl = lax.associative_scan(_compose_full, (A, J, C), axis=0)
    eye = jnp.broadcast_to(jnp.eye(p, dtype=A.dtype), (1, p, p))
    zero = jnp.zeros((1, p, p), A.dtype)
    return tuple(
        jnp.concatenate([init, inc[:-1]], axis=0)
        for init, inc in zip((eye, zero, zero), incl)
    )


@f32_matmuls
def _block_factor_pass(blk: SSM, S_hat_in):
    """Run the raw factor recursion per block given incoming S-hat.

    Returns (D, W, M_cum, m0_basis...) — also accumulates the block's
    affine map for the forward substitution: (Mb, and W for pass 3).
    """

    def one_block(U, V, phi, A, Sh):
        def step(Sh, inp):
            u, v, ph, a = inp
            S = (ph[:, None] * ph[None, :]) * Sh
            su = S @ u
            d = a - u @ su
            w = (v - su) / d
            Sh = S + d * jnp.outer(w, w)
            return Sh, (d, w)

        Sh, (D, W) = lax.scan(step, Sh, (U, V, phi, A))
        return D, W

    return jax.vmap(one_block)(blk.U, blk.V, blk.phi, blk.A, S_hat_in)


@f32_matmuls
def factor(ssm: SSM, block_size=None) -> FactorResult:
    """Block-parallel K = L D L^T; exact (matches seq.factor)."""
    n = ssm.U.shape[0]
    L = block_size or default_block_size(n)
    blk, _, b, pad = _pad_blocks(ssm, None, L)

    elems = _block_elements(blk)
    pref = _exclusive_prefix_elements(elems)
    S_hat_in = pref[2]  # applying the prefix map to S-hat = 0 yields C
    D, W = _block_factor_pass(blk, S_hat_in)

    p = ssm.U.shape[1]
    D = D.reshape(b * L)[:n]
    W = W.reshape(b * L, p)[:n]
    ok = jnp.all(D > 0) & jnp.all(jnp.isfinite(D))
    return FactorResult(D=D, W=W, ok=ok)


@f32_matmuls
def _block_solve_maps(blk: SSM, W_blk, y_blk):
    """Per-block affine map (M, m) for h_n = M_n h_{n-1} + m_n."""

    def one_block(U, phi, W, y):
        def step(carry, inp):
            Mc, mc = carry
            u, ph, w, yn = inp
            # M_n X = (I - w u^T) (Phi X); M_n h + w y_n
            PhM = ph[:, None] * Mc
            Mc = PhM - jnp.outer(w, u @ PhM)
            mh = ph * mc
            mc = mh - w * (u @ mh) + w * yn
            return (Mc, mc), None

        p = U.shape[-1]
        init = (
            jnp.eye(p, dtype=U.dtype),
            jnp.zeros((p,), U.dtype),
        )
        (Mb, mb), _ = lax.scan(step, init, (U, phi, W, y))
        return Mb, mb

    return jax.vmap(one_block)(blk.U, blk.phi, W_blk, y_blk)


def _affine_compose(e1, e2):
    M1, m1 = e1
    M2, m2 = e2
    # einsum: m1 is a batch of vectors; plain matmul would read it as one
    # matrix under associative_scan's leading batch axis.
    return (M2 @ M1, jnp.einsum("...ij,...j->...i", M2, m1) + m2)


@f32_matmuls
def _exclusive_prefix_affine(M, m):
    b, p, _ = M.shape
    incl = lax.associative_scan(_affine_compose, (M, m), axis=0)
    eye = jnp.broadcast_to(jnp.eye(p, dtype=M.dtype), (1, p, p))
    zero = jnp.zeros((1, p), M.dtype)
    Mp = jnp.concatenate([eye, incl[0][:-1]], axis=0)
    mp = jnp.concatenate([zero, incl[1][:-1]], axis=0)
    return Mp, mp


@f32_matmuls
def _block_forward_pass(blk: SSM, W_blk, y_blk, h_in):
    """Recompute z_n per block given incoming h state; emit z."""

    def one_block(U, phi, W, y, h):
        def step(h, inp):
            u, ph, w, yn = inp
            f = ph * h
            z = yn - u @ f
            h = f + w * z
            return h, z

        _, z = lax.scan(step, h, (U, phi, W, y))
        return z

    return jax.vmap(one_block)(blk.U, blk.phi, W_blk, y_blk, h_in)


@f32_matmuls
def solve_lower(ssm: SSM, fact: FactorResult, y, block_size=None):
    """Solve L z = y, block-parallel."""
    n, p = ssm.U.shape
    L = block_size or default_block_size(n)
    blk, y_blk, b, pad = _pad_blocks(ssm, y, L)
    W_blk = jnp.concatenate(
        [fact.W, jnp.zeros((b * L - n, p), fact.W.dtype)]
    ).reshape(b, L, p)
    M, m = _block_solve_maps(blk, W_blk, y_blk)
    Mp, mp = _exclusive_prefix_affine(M, m)
    z = _block_forward_pass(blk, W_blk, y_blk, mp)
    return z.reshape(b * L)[:n]


@f32_matmuls
def gp_log_likelihood(ssm: SSM, resid, block_size=None):
    """Fused block-parallel factor + forward solve + reductions.

    Single entry point for the hot path: returns (ll, ok) with the same
    semantics as seq.gp_log_likelihood.
    """
    n, p = ssm.U.shape
    L = block_size or default_block_size(n)
    blk, y_blk, b, pad = _pad_blocks(ssm, resid, L)

    # Pass 1: block Riccati elements + cross-block prefix -> incoming S-hat.
    elems = _block_elements(blk)
    pref = _exclusive_prefix_elements(elems)
    S_hat_in = pref[2]

    # Pass 2: factor per block AND the block affine solve maps in one scan.
    def pass2(U, V, phi, A, y, Sh):
        def step(carry, inp):
            Sh, Mc, mc = carry
            u, v, ph, a, yn = inp
            S = (ph[:, None] * ph[None, :]) * Sh
            su = S @ u
            d = a - u @ su
            w = (v - su) / d
            Sh = S + d * jnp.outer(w, w)
            PhM = ph[:, None] * Mc
            Mc = PhM - jnp.outer(w, u @ PhM)
            mh = ph * mc
            mc = mh - w * (u @ mh) + w * yn
            return (Sh, Mc, mc), (d, w)

        init = (Sh, jnp.eye(p, dtype=U.dtype), jnp.zeros((p,), U.dtype))
        (_, Mb, mb), (D, W) = lax.scan(step, init, (U, V, phi, A, y))
        return D, W, Mb, mb

    D, W, M, m = jax.vmap(pass2)(
        blk.U, blk.V, blk.phi, blk.A, y_blk, S_hat_in
    )

    # Cross-block prefix of the affine solve maps -> incoming h per block.
    _, h_in = _exclusive_prefix_affine(M, m)

    # Pass 3: z + per-block reductions.  The two scalar accumulators use
    # Kahan compensation: at N ~ 1e6 the naive f32 running sums alone cost
    # ~2e-5 relative accuracy (tens of nats), an order of magnitude more
    # than the recursion's own error floor.
    def pass3(U, phi, W, y, D, h):
        def step(carry, inp):
            h, quad, cq, logdet, cl, min_d = carry
            u, ph, w, yn, d = inp
            f = ph * h
            z = yn - u @ f
            h = f + w * z
            quad, cq = _kahan_add(quad, cq, z * z / d)
            logdet, cl = _kahan_add(logdet, cl, jnp.log(d))
            min_d = jnp.minimum(min_d, d)
            return (h, quad, cq, logdet, cl, min_d), None

        dtype = U.dtype
        zero = jnp.zeros((), dtype)
        init = (h, zero, zero, zero, zero, jnp.array(jnp.inf, dtype))
        (h, quad, cq, logdet, cl, min_d), _ = lax.scan(
            step, init, (U, phi, W, y, D)
        )
        return quad + cq, logdet + cl, min_d

    quad, logdet, min_d = jax.vmap(pass3)(
        blk.U, blk.phi, W, y_blk, D, h_in
    )

    dtype = resid.dtype
    ll = -0.5 * (
        jnp.sum(quad)
        + jnp.sum(logdet)
        + n * jnp.log(2.0 * jnp.pi).astype(dtype)
    )
    ok = (jnp.min(min_d) > 0) & jnp.isfinite(ll)
    ll = jnp.where(ok, ll, -jnp.inf)
    return ll, ok


def _diag_affine_scan(phi, b, reverse=False):
    """Parallel solve of f_n = phi_n * f_{n-1} + b_n (diagonal transition).

    A pure associative scan over (N, P) pairs — O(log N) vectorized
    passes, no blocking needed.  ``reverse`` runs the recursion from the
    other end.
    """

    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return (a2 * a1, a2 * b1 + b2)

    a, out = lax.associative_scan(
        combine, (phi, b), axis=0, reverse=reverse
    )
    return out


@f32_matmuls
def solve(ssm: SSM, fact, y, block_size=None):
    """Solve K x = y, block-parallel (seq.solve analog).

    Forward substitution uses the blocked affine machinery; the backward
    substitution is the same recursion run on index-reversed arrays.
    """
    import jax

    if y.ndim == 2:
        return jax.vmap(
            lambda col: solve(ssm, fact, col, block_size), 1, 1
        )(y)

    z = solve_lower(ssm, fact, y, block_size=block_size) / fact.D

    # Backward: x_n = z_n - W_n^T g_n, g_n = Phi_{n+1}(g_{n+1} +
    # U_{n+1} x_{n+1}).  Reverse index order and reuse the forward-shaped
    # blocked affine solve: with r = reversed, the recursion becomes
    # x_r = z_r - W_r^T g_r, g_r = Phi_prev(g_prev + U_prev x_prev) —
    # i.e. the same "state + rank-1 output feedback" pattern with (U, W)
    # swapped and phi shifted by one.
    # Index-reversal bookkeeping: with r = N-1-n the recursion becomes
    #   x~_r = z~_r - W[rev][r] . g~_r,
    #   g~_r = phi[rev_next][r] (g~_{r-1} + U[rev][r-1] . x~_{r-1})
    # which is solve_lower's shape with U' = W[rev], W' = U[rev], and
    # phi' = (phi shifted down one)[rev].
    n, p = ssm.U.shape
    rev = slice(None, None, -1)
    phi_next = jnp.concatenate(
        [ssm.phi[1:], jnp.ones((1, p), ssm.phi.dtype)], axis=0
    )
    ssm_rev = SSM(
        U=fact.W[rev],
        V=ssm.V[rev],  # unused by the affine solve
        phi=phi_next[rev],
        A=ssm.A[rev],  # unused
    )
    fact_rev = fact._replace(W=ssm.U[rev], D=fact.D[rev])
    x_rev = solve_lower(ssm_rev, fact_rev, z[rev], block_size=block_size)
    return x_rev[rev]


@f32_matmuls
def dot_L(ssm: SSM, fact, z, block_size=None):
    """L sqrt(D) z, parallel (seq.dot_L analog).

    The carry has a *diagonal* transition (no output feedback), so this
    is a single associative scan — no block structure required.
    """
    import jax

    if z.ndim == 2:
        return jax.vmap(
            lambda col: dot_L(ssm, fact, col, block_size), 1, 1
        )(z)

    t = jnp.sqrt(fact.D) * z
    w_prev = jnp.concatenate(
        [jnp.zeros_like(fact.W[:1]), fact.W[:-1]], axis=0
    )
    t_prev = jnp.concatenate([jnp.zeros_like(t[:1]), t[:-1]])
    # f_n = phi_n (f_{n-1} + W_{n-1} t_{n-1})
    f = _diag_affine_scan(ssm.phi, ssm.phi * w_prev * t_prev[:, None])
    return t + jnp.sum(ssm.U * f, axis=1)


@f32_matmuls
def matmul(ssm: SSM, z, block_size=None):
    """K @ z, parallel (seq.matmul analog): two associative scans."""
    import jax

    if z.ndim == 2:
        return jax.vmap(
            lambda col: matmul(ssm, col, block_size), 1, 1
        )(z)

    n, p = ssm.U.shape
    v_prev = jnp.concatenate([jnp.zeros_like(ssm.V[:1]), ssm.V[:-1]], 0)
    z_prev = jnp.concatenate([jnp.zeros_like(z[:1]), z[:-1]])
    g = _diag_affine_scan(ssm.phi, ssm.phi * v_prev * z_prev[:, None])
    y_low = jnp.sum(ssm.U * g, axis=1)

    phi_next = jnp.concatenate(
        [ssm.phi[1:], jnp.ones((1, p), ssm.phi.dtype)], 0
    )
    u_next = jnp.concatenate([ssm.U[1:], jnp.zeros((1, p), ssm.U.dtype)], 0)
    z_next = jnp.concatenate([z[1:], jnp.zeros_like(z[:1])])
    h = _diag_affine_scan(
        phi_next, phi_next * u_next * z_next[:, None], reverse=True
    )
    y_up = jnp.sum(ssm.V * h, axis=1)

    return ssm.A * z + y_low + y_up
