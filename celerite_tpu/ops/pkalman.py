"""Temporal-parallel Kalman filter + RTS smoother (associative scans).

The sequential smoother (ops/smoother.py) is exact but latency-bound on
an accelerator: two ``lax.scan`` sweeps of tiny (p, p) matrix algebra
pay kernel-launch latency at every step.  Filtering
and smoothing are, however, *associative* over per-step elements
(Sarkka & Garcia-Fernandez 2020, "Temporal parallelization of Bayesian
smoothers"), so both sweeps become ``jax.lax.associative_scan`` —
log-depth, with every level a wide batched elementwise op.  This is the same algebraic move the blocked
semiseparable solver makes for the factorization (ops/blocked.py
Riccati elements); here it is applied to the Gauss-Markov realization
powering ``GP.predict(return_var=True)`` (reference analog: the dense
O(N M) variance path, celerite.py:460-474).

Layout: every element array carries the time axis LAST — matrices are
``(p, p, n)``, vectors ``(p, n)`` — so each unrolled (p, p) index pair
is a full-width elementwise op over n lanes (a ``(n, p, p)`` layout
puts the tiny (p, p) dims on the minor, vectorized axis).

Compile-time note: the flat ``associative_scan`` variant
(``parallel_filter_smoother``) instantiates the unrolled (p, p)
composition at ~2 log2(N) scan levels, so its first compile at
N >= 16384 is slow.  The default
engine is therefore the two-level ``blocked_filter_smoother``: the
within-block sequential scans compile their bodies ONCE and only the
~2 log2(B) cross-block levels instantiate the composition — first
compiles in seconds, identical results.  The flat variant stays for
comparison; ``celerite_tpu.utils.enable_persistent_cache()`` (or
``JAX_COMPILATION_CACHE_DIR``) still helps any cold start.

Filtering element per step k (model x_k = F_k x_{k-1} + q_k,
q_k ~ N(0, Q_k); observation y_k = H x_k + r_k, r_k ~ N(0, R_k)):

    S_k = H Q_k H^T + R_k          K_k = Q_k H^T / S_k
    A_k = (I - K_k H) F_k          b_k = K_k y_k
    C_k = (I - K_k H) Q_k
    eta_k = F_k^T H^T y_k / S_k    J_k = F_k^T H^T H F_k / S_k

(no-observation steps: A = F, b = 0, C = Q, eta = 0, J = 0), with the
prior as a leading element (A=0, b=m0, C=P0, eta=0, J=0).  Composition
of e_i followed by e_j:

    D = (I + C_i J_j)^-1
    A_ij = A_j D A_i               b_ij = A_j D (b_i + C_i eta_j) + b_j
    C_ij = A_j D C_i A_j^T + C_j
    eta_ij = A_i^T (I + J_j C_i)^-1 (eta_j - J_j b_i) + eta_i
    J_ij = A_i^T (I + J_j C_i)^-1 J_j A_i + J_i

An inclusive prefix scan then yields the filtered moments directly:
m_k = b, P_k = C of the k-th prefix.  Predicted moments (needed for the
smoother gains and the marginal likelihood) follow vectorized from the
shifted filtered moments, with no further scan.

Smoothing element (x_k | x_{k+1} ~ N(E_k x_{k+1} + g_k, L_k)):

    G_k = P_k F_{k+1}^T (P^-_{k+1})^-1
    E_k = G_k    g_k = m_k - G_k m^-_{k+1}    L_k = P_k - G_k P^-_{k+1} G_k^T

(last element: E = 0, g = m_n, L = P_n), composed right-to-left as

    (E_i, g_i, L_i) * (E_j, g_j, L_j)
        = (E_i E_j,  E_i g_j + g_i,  E_i L_j E_i^T + L_i)

so a reverse inclusive scan gives the smoothed moments m^s = g, P^s = L.

Exactness: both scans reproduce the sequential filter/smoother to
floating-point roundoff (validated against ops/smoother._filter_smoother
in float64, tests/test_pkalman.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .precision import f32_matmuls
from .smoother import realize, _transitions

__all__ = [
    "parallel_filter_smoother",
    "blocked_filter_smoother",
    "predict_var_parallel",
]


def _mm(x, y):
    """(p, p, n) matmul over the leading dims, unrolled."""
    p = x.shape[0]
    acc = x[:, 0:1] * y[0:1, :]
    for k in range(1, p):
        acc = acc + x[:, k : k + 1] * y[k : k + 1, :]
    return acc


def _mv(x, v):
    """(p, p, n) @ (p, n) -> (p, n)."""
    return jnp.sum(x * v[None, :, :], axis=1)


def _tr(x):
    return jnp.swapaxes(x, 0, 1)


def _solve(M, X):
    """(p, p, n)-batched M^-1 X via unrolled Gauss-Jordan.

    Unrolled Gauss-Jordan: no pivoting — M is I + (PSD)(PSD) or a
    regularized covariance, diagonally dominant enough in practice.
    """
    p = M.shape[0]
    aug = jnp.concatenate([M, X], axis=1)  # (p, p + q, n)
    rows = lax.broadcasted_iota(jnp.int32, aug.shape, 0)
    for k in range(p):
        piv = aug[k : k + 1] / aug[k : k + 1, k : k + 1]
        elim = aug - aug[:, k : k + 1] * piv
        aug = jnp.where(rows == k, piv, elim)
    return aug[:, p:]


def _eye_bcast(p, n, dtype):
    ii = lax.broadcasted_iota(jnp.int32, (p, p, n), 0)
    jj = lax.broadcasted_iota(jnp.int32, (p, p, n), 1)
    return jnp.where(ii == jj, jnp.ones((), dtype), jnp.zeros((), dtype))


def _compose(e1, e2):
    """Associative filtering composition: e1 earlier, e2 later.

    Vector members (b, eta) ride as (p, 1, n) so every pytree leaf has
    the same rank (associative_scan applies one axis index to all).
    """
    A1, b1, C1, n1, J1 = e1
    A2, b2, C2, n2, J2 = e2
    b1, n1 = b1[:, 0], n1[:, 0]
    b2, n2 = b2[:, 0], n2[:, 0]
    p, _, n = A1.shape
    eye = _eye_bcast(p, n, A1.dtype)
    # Left-apply D = (I + C1 J2)^-1 to [A1 | C1 | b1 + C1 eta2] in one
    # Gauss-Jordan pass.
    bn = b1 + _mv(C1, n2)
    sol = _solve(
        eye + _mm(C1, J2),
        jnp.concatenate([A1, C1, bn[:, None, :]], axis=1),
    )
    D_A1, D_C1, D_bn = sol[:, :p], sol[:, p : 2 * p], sol[:, 2 * p]
    A12 = _mm(A2, D_A1)
    b12 = _mv(A2, D_bn) + b2
    C12 = _mm(_mm(A2, D_C1), _tr(A2)) + C2
    # Right block: (I + J2 C1)^-1 applied to [J2 | eta2 - J2 b1].
    er = n2 - _mv(J2, b1)
    sol2 = _solve(
        eye + _mm(J2, C1),
        jnp.concatenate([J2, er[:, None, :]], axis=1),
    )
    E_J2, E_r = sol2[:, :p], sol2[:, p]
    A1T = _tr(A1)
    n12 = _mv(A1T, E_r) + n1
    J12 = _mm(_mm(A1T, E_J2), A1) + J1
    return A12, b12[:, None, :], C12, n12[:, None, :], J12


def _compose_smooth(e1, e2):
    """Associative smoothing composition: e1 earlier, e2 later.

    ``g`` rides as (p, 1, n) for rank uniformity (see _compose).
    """
    E1, g1, L1 = e1
    E2, g2, L2 = e2
    g = _mv(E1, g2[:, 0]) + g1[:, 0]
    return _mm(E1, E2), g[:, None, :], _mm(_mm(E1, L2), _tr(E1)) + L1


def _transitions_lanes(real_, dt):
    """Block-diagonal transitions A(dt) in (p, p, n) lane layout."""
    n = dt.shape[0]
    p = real_.p
    jr, jc = real_.jr, real_.jc
    rows = []
    for i in range(p):
        cols = []
        for j in range(p):
            if i < jr:
                cols.append(
                    jnp.exp(-real_.c_real[i] * dt)
                    if i == j
                    else jnp.zeros((n,), dt.dtype)
                )
            else:
                blk = (i - jr) // 2
                k = jr + 2 * blk
                if j not in (k, k + 1):
                    cols.append(jnp.zeros((n,), dt.dtype))
                else:
                    e = jnp.exp(-real_.c_comp[blk] * dt)
                    cs = jnp.cos(real_.d_comp[blk] * dt)
                    sn = jnp.sin(real_.d_comp[blk] * dt)
                    if (i - k, j - k) in ((0, 0), (1, 1)):
                        cols.append(e * cs)
                    elif (i - k, j - k) == (0, 1):
                        cols.append(-e * sn)
                    else:
                        cols.append(e * sn)
        rows.append(jnp.stack(cols))
    return jnp.stack(rows)  # (p, p, n)


@f32_matmuls
def parallel_filter_smoother(real_, dt, yv, rv, obs):
    """Associative-scan twin of ops/smoother._filter_smoother.

    Same contract: ``dt`` spacings (first 0), ``yv`` observed values
    (0 where missing), ``rv`` observation variances, ``obs`` 1/0
    flags.  Returns (smoothed latent mean, smoothed latent var, data
    log-likelihood over observed points).
    """
    dtype = yv.dtype
    n = dt.shape[0]
    p = real_.p
    Pinf = jnp.asarray(real_.Pinf, dtype)  # (p, p)
    H = jnp.asarray(real_.H, dtype)  # (p,)
    eye3 = _eye_bcast(p, n, dtype)
    Pinf3 = jnp.broadcast_to(Pinf[:, :, None], (p, p, n))

    F = _transitions_lanes(real_, jnp.asarray(dt, dtype))  # (p, p, n)
    Q = Pinf3 - _mm(_mm(F, Pinf3), _tr(F))

    # --- filtering elements (lane layout) ----------------------------------
    QH = _mv(Q, jnp.broadcast_to(H[:, None], (p, n)))  # (p, n) = Q H
    S = jnp.sum(QH * H[:, None], axis=0) + rv  # (n,)
    K = QH / S[None, :]
    ImKH = eye3 - K[:, None, :] * H[None, :, None]
    FTH = _mv(_tr(F), jnp.broadcast_to(H[:, None], (p, n)))  # F^T H

    o1 = obs[None, :]
    o2 = obs[None, None, :]
    A = jnp.where(o2 > 0, _mm(ImKH, F), F)
    b = jnp.where(o1 > 0, K * yv[None, :], jnp.zeros((p, n), dtype))
    C = jnp.where(o2 > 0, _mm(ImKH, Q), Q)
    eta = jnp.where(o1 > 0, FTH * (yv / S)[None, :], jnp.zeros_like(b))
    J = jnp.where(
        o2 > 0, FTH[:, None, :] * (FTH / S[None, :])[None, :, :],
        jnp.zeros((p, p, n), dtype),
    )

    # Prior element (A=0, b=0, C=Pinf) prepended so every data step uses
    # the generic formulas (the dt=0 first grid step has Q=0 and the
    # composition recovers the standard P^- = Pinf update).
    cat = lambda z, e: jnp.concatenate([z, e], axis=-1)
    elems = (
        cat(jnp.zeros((p, p, 1), dtype), A),
        cat(jnp.zeros((p, 1, 1), dtype), b[:, None, :]),
        cat(Pinf[:, :, None], C),
        cat(jnp.zeros((p, 1, 1), dtype), eta[:, None, :]),
        cat(jnp.zeros((p, p, 1), dtype), J),
    )
    pref = lax.associative_scan(_compose, elems, axis=2)
    mf = pref[1][:, 0, 1:]  # filtered means (p, n)
    Pf = pref[2][..., 1:]   # filtered covs (p, p, n)

    # --- predicted moments + marginal likelihood (vectorized) --------------
    m_prev = jnp.concatenate([jnp.zeros((p, 1), dtype), mf[:, :-1]],
                             axis=-1)
    P_prev = jnp.concatenate([Pinf[:, :, None], Pf[..., :-1]], axis=-1)
    mp = _mv(F, m_prev)
    Pp = _mm(_mm(F, P_prev), _tr(F)) + Q
    Sp = jnp.sum(_mv(Pp, jnp.broadcast_to(H[:, None], (p, n)))
                 * H[:, None], axis=0) + rv
    innov = yv - jnp.sum(mp * H[:, None], axis=0)
    lls = -0.5 * (
        innov**2 / Sp + jnp.log(Sp) + jnp.log(2 * jnp.pi).astype(dtype)
    )
    ll = jnp.sum(jnp.where(obs > 0, lls, 0.0))

    # --- smoothing elements -------------------------------------------------
    F_next = jnp.concatenate([F[..., 1:], eye3[..., :1]], axis=-1)
    mp_next = jnp.concatenate([mp[:, 1:], mp[:, -1:]], axis=-1)
    Pp_next = jnp.concatenate([Pp[..., 1:], Pp[..., -1:]], axis=-1)
    # Regularized gain solve, matching the sequential smoother.
    tr_pp = jnp.sum(
        jnp.where(
            lax.broadcasted_iota(jnp.int32, (p, p, n), 0)
            == lax.broadcasted_iota(jnp.int32, (p, p, n), 1),
            Pp_next,
            jnp.zeros((), dtype),
        ),
        axis=(0, 1),
    )
    Pp_r = Pp_next + 1e-12 * tr_pp[None, None, :] * eye3
    # G_k = Pf_k F_{k+1}^T Pp_r^-1  ->  G^T = Pp_r^-T (F Pf^T)^T.
    PfFT = _mm(Pf, _tr(F_next))
    G = _tr(_solve(_tr(Pp_r), _tr(PfFT)))
    g = mf - _mv(G, mp_next)
    L = Pf - _mm(_mm(G, Pp_next), _tr(G))
    last1 = jnp.zeros((1, n), dtype).at[:, -1].set(1.0)
    last2 = last1[None, :, :]
    E_s = jnp.where(last2 > 0, jnp.zeros_like(G), G)
    g_s = jnp.where(last1 > 0, mf, g)
    L_s = jnp.where(last2 > 0, Pf, L)

    # associative_scan(reverse=True) runs the forward algorithm on the
    # reversed sequence, so the callback's FIRST argument is the
    # later-index element; flip it back into "earlier-then-later".
    sm = lax.associative_scan(
        lambda x, y: _compose_smooth(y, x),
        (E_s, g_s[:, None, :], L_s),
        reverse=True, axis=2,
    )
    ms = sm[1][:, 0]
    Ps = sm[2]

    mean = jnp.sum(ms * H[:, None], axis=0)
    var = jnp.sum(Ps * H[:, None, None] * H[None, :, None], axis=(0, 1))
    return mean, var, ll


def _default_kalman_block(n):
    """Within-block sequential length L: short enough that the L-step
    scans stay cheap, long enough that B = n/L fills the vector lanes."""
    if n <= 4096:
        return max(16, n // 16)
    return 256


def blocked_filter_smoother(real_, dt, yv, rv, obs, block_size=None):
    """Two-level (blocked) Kalman filter + RTS smoother.

    Same contract and results as :func:`parallel_filter_smoother`, but
    instead of one associative scan over all N steps (~2 log2(N) levels,
    each instantiating the unrolled (p, p) composition — the minutes-
    scale first compile noted above), the N axis splits into B blocks of
    L steps:

    1. a within-block sequential scan accumulates each block's
       cumulative filtering element (the scan BODY compiles once;
       per-step cost is O(p^2) — the step's information matrix is
       rank-1, so every (I + C J)^-1 is a Sherman-Morrison update);
    2. an associative scan composes the B block elements (log2(B)
       levels of the full composition);
    3. a second within-block scan runs the plain Kalman recursion from
       each block's incoming filtered moments;
    4-6. the same three-pass structure, mirrored, for the RTS smoother
       (per-step smoothing gains are computed vectorized over all N).

    This is the ops/blocked.py move applied to the Gauss-Markov
    realization.  Exact: agrees with the sequential filter/smoother to
    roundoff (tests/test_pkalman.py).

    The whole thing runs as ONE jitted program (static: realization
    widths and block size), so repeated calls at the same shapes reuse
    the compiled executable instead of paying eager per-op dispatch.
    """
    n0 = dt.shape[0]
    L = int(block_size or _default_kalman_block(n0))
    return _blocked_fs_jit(
        jnp.asarray(real_.c_real), jnp.asarray(real_.c_comp),
        jnp.asarray(real_.d_comp), jnp.asarray(real_.Pinf),
        jnp.asarray(real_.H),
        jnp.asarray(dt), jnp.asarray(yv), jnp.asarray(rv),
        jnp.asarray(obs),
        jr=int(real_.jr), jc=int(real_.jc), L=L,
    )


from functools import partial as _partial
from types import SimpleNamespace as _NS


@_partial(jax.jit, static_argnames=("jr", "jc", "L"))
def _blocked_fs_jit(c_real, c_comp, d_comp, Pinf, H, dt, yv, rv, obs,
                    *, jr, jc, L):
    real_ = _NS(p=jr + 2 * jc, jr=jr, jc=jc, c_real=c_real,
                c_comp=c_comp, d_comp=d_comp, Pinf=Pinf, H=H)
    return _blocked_fs_impl(real_, dt, yv, rv, obs, L)


@f32_matmuls
def _blocked_fs_impl(real_, dt, yv, rv, obs, L):
    """Lane-layout (p, p, B) implementation — every per-step op inside
    the within-block scans is a full-width vector op over the B block
    lanes (a (B, p, p) layout puts the tiny (p, p) dims on the minor,
    vectorized axis)."""
    dtype = yv.dtype
    n0 = dt.shape[0]
    p = real_.p
    b = -(-n0 // L)
    padn = b * L - n0
    if padn:
        # Inert steps: dt=0 (F=I, Q=0), unobserved.
        dt = jnp.concatenate([dt, jnp.zeros((padn,), dt.dtype)])
        yv = jnp.concatenate([yv, jnp.zeros((padn,), dtype)])
        rv = jnp.concatenate([rv, jnp.ones((padn,), dtype)])
        obs = jnp.concatenate([obs, jnp.zeros((padn,), obs.dtype)])
    n = b * L

    Pinf = jnp.asarray(real_.Pinf, dtype)  # (p, p)
    Hv = jnp.asarray(real_.H, dtype)  # (p,)
    eye3 = _eye_bcast(p, n, dtype)
    Pinf3 = jnp.broadcast_to(Pinf[:, :, None], (p, p, n))

    # Per-step quantities, lane layout (time axis LAST).
    F = _transitions_lanes(real_, jnp.asarray(dt, dtype))  # (p, p, n)
    Q = Pinf3 - _mm(_mm(F, Pinf3), _tr(F))
    Hn = jnp.broadcast_to(Hv[:, None], (p, n))
    u = _mv(_tr(F), Hn)  # F^T H, (p, n)
    qh = _mv(Q, Hn)  # Q H, (p, n)
    s = jnp.sum(qh * Hn, axis=0) + rv  # (n,)
    K = qh / s[None, :]
    o = jnp.asarray(obs, dtype)

    # (.., n) -> (L, .., B): step j of block k lives at index k*L + j.
    def blkT(x):
        x = x.reshape(x.shape[:-1] + (b, L))
        return jnp.moveaxis(x, -1, 0)  # (L, .., B)

    FL, QL, uL, qhL, sL, KL, yL, rL, oL = map(
        blkT, (F, Q, u, qh, s, K, yv, rv, o)
    )

    eyeB = _eye_bcast(p, b, dtype)
    zvB = jnp.zeros((p, b), dtype)
    zmB = jnp.zeros((p, p, b), dtype)

    # ---- pass 1: per-block cumulative filtering elements -------------------
    # Carry (A, b, C, eta, J) over the B lanes; each step composes one
    # rank-1-information element via Sherman-Morrison (O(p^2) lane ops
    # plus three unrolled (p, p) products).
    def p1_step(carry, inp):
        Ac, bc, Cc, ec, Jc = carry
        Fn, un, qhn, sn, Kn, yn, on, Qn = inp
        Cu = _mv(Cc, un)  # (p, B)
        f = on / (sn + on * jnp.sum(un * Cu, axis=0))  # (B,)
        uA = jnp.sum(un[:, None, :] * Ac, axis=0)  # u^T A, (p, B)
        A_mid = Ac - Cu[:, None, :] * (uA * f)[None, :, :]
        bz = bc + Cu * (on * yn / sn)
        b_mid = bz - Cu * (jnp.sum(un * bz, axis=0) * f)
        C_mid = Cc - Cu[:, None, :] * (Cu * f)[None, :, :]
        # A_n X = F X - o K (u^T X)   (A_n = (I - o K H) F).
        FA = _mm(Fn, A_mid)
        uAm = jnp.sum(un[:, None, :] * A_mid, axis=0)
        Anew = FA - Kn[:, None, :] * (on * uAm)[None, :, :]
        Fb_ = _mv(Fn, b_mid)
        bnew = Fb_ - Kn * (on * jnp.sum(un * b_mid, axis=0)) \
            + Kn * (on * yn)
        Y = _mm(Fn, C_mid)
        uCm = jnp.sum(un[:, None, :] * C_mid, axis=0)
        Y = Y - Kn[:, None, :] * (on * uCm)[None, :, :]
        Yt = _tr(Y)
        Z = _mm(Fn, Yt)
        uYt = jnp.sum(un[:, None, :] * Yt, axis=0)
        Z = Z - Kn[:, None, :] * (on * uYt)[None, :, :]
        Cnew = _tr(Z) + Qn - Kn[:, None, :] * (on * qhn)[None, :, :]
        Au = jnp.sum(Ac * un[:, None, :], axis=0)  # A^T u, (p, B)
        enew = ec + Au * ((yn - jnp.sum(un * bc, axis=0)) * f)
        Jnew = Jc + Au[:, None, :] * (Au * f)[None, :, :]
        return (Anew, bnew, Cnew, enew, Jnew), None

    init1 = (eyeB, zvB, zmB, zvB, zmB)
    (Ae, be, Ce, ee, Je), _ = lax.scan(
        p1_step, init1, (FL, uL, qhL, sL, KL, yL, oL, QL)
    )

    # ---- cross-block prefix (prior prepended) -------------------------------
    elems = (
        jnp.concatenate([jnp.zeros((p, p, 1), dtype), Ae], axis=-1),
        jnp.concatenate(
            [jnp.zeros((p, 1, 1), dtype), be[:, None, :]], axis=-1
        ),
        jnp.concatenate([Pinf[:, :, None], Ce], axis=-1),
        jnp.concatenate(
            [jnp.zeros((p, 1, 1), dtype), ee[:, None, :]], axis=-1
        ),
        jnp.concatenate([jnp.zeros((p, p, 1), dtype), Je], axis=-1),
    )
    pref = lax.associative_scan(_compose, elems, axis=2)
    # Incoming filtered moments for block k = prefix over [prior,
    # blocks 0..k-1] = inclusive prefix at index k.
    m0 = pref[1][:, 0, :b]  # (p, B)
    P0 = pref[2][..., :b]  # (p, p, B)

    # ---- pass 2: plain Kalman recursion from each block's incoming ---------
    def p2_step(carry, inp):
        m, P = carry
        Fn, Qn, yn, rn, on = inp
        mp = _mv(Fn, m)
        Pp = _mm(_mm(Fn, P), _tr(Fn)) + Qn
        HB = jnp.broadcast_to(Hv[:, None], (p, b))
        Ph = _mv(Pp, HB)
        sn = jnp.sum(HB * Ph, axis=0) + rn
        k = Ph / sn[None, :]
        innov = yn - jnp.sum(HB * mp, axis=0)
        m_new = mp + k * (on * innov)
        P_new = Pp - k[:, None, :] * (on * sn * k)[None, :, :]
        ll = -0.5 * (
            innov**2 / sn + jnp.log(sn)
            + jnp.log(2 * jnp.pi).astype(dtype)
        )
        return (m_new, P_new), (m_new, P_new, mp, Pp, on * ll)

    _, (mfL, PfL, mpL, PpL, llL) = lax.scan(
        p2_step, (m0, P0), (FL, QL, yL, rL, oL)
    )
    ll = jnp.sum(llL)

    # (L, .., B) -> (.., n)
    def unblkT(x):
        x = jnp.moveaxis(x, 0, -1)  # (.., B, L)
        return x.reshape(x.shape[:-2] + (n,))

    mf, Pf, mp, Pp = map(unblkT, (mfL, PfL, mpL, PpL))

    # ---- smoothing elements, vectorized over all n (lane layout) -----------
    F_next = jnp.concatenate([F[..., 1:], eye3[..., :1]], axis=-1)
    mp_next = jnp.concatenate([mp[:, 1:], mp[:, -1:]], axis=-1)
    Pp_next = jnp.concatenate([Pp[..., 1:], Pp[..., -1:]], axis=-1)
    tr_pp = jnp.sum(
        jnp.where(
            lax.broadcasted_iota(jnp.int32, (p, p, n), 0)
            == lax.broadcasted_iota(jnp.int32, (p, p, n), 1),
            Pp_next,
            jnp.zeros((), dtype),
        ),
        axis=(0, 1),
    )
    Pp_r = Pp_next + 1e-12 * tr_pp[None, None, :] * eye3
    PfFT = _mm(Pf, _tr(F_next))
    G = _tr(_solve(_tr(Pp_r), _tr(PfFT)))
    g = mf - _mv(G, mp_next)
    Lm = Pf - _mm(_mm(G, Pp_next), _tr(G))
    # Absorbing element at the last REAL index (E=0, g=mf, L=Pf);
    # padded steps beyond it are inert (their output is discarded).
    last1 = jnp.zeros((1, n), dtype).at[:, n0 - 1].set(1.0)
    last2 = last1[None, :, :]
    E_s = jnp.where(last2 > 0, jnp.zeros_like(G), G)
    g_s = jnp.where(last1 > 0, mf, g)
    L_s = jnp.where(last2 > 0, Pf, Lm)

    EL, gL, LL = map(blkT, (E_s, g_s, L_s))

    # ---- pass S1: per-block cumulative smoothing elements -------------------
    def s1_step(carry, inp):
        Ec, gc, Lc = carry
        En, gn, Ln = inp
        return (
            _mm(En, Ec),
            _mv(En, gc) + gn,
            _mm(_mm(En, Lc), _tr(En)) + Ln,
        ), None

    (Se, Sg, Sl), _ = lax.scan(
        s1_step, (eyeB, zvB, zmB), (EL, gL, LL), reverse=True
    )

    # ---- cross-block reverse scan -> incoming right states ------------------
    sm = lax.associative_scan(
        lambda x, y: _compose_smooth(y, x),
        (Se, Sg[:, None, :], Sl),
        reverse=True, axis=2,
    )
    # Incoming for block k = (g, L) of the suffix over blocks k+1..;
    # zeros for the last block (its absorbing element ignores them).
    ms_in = jnp.concatenate(
        [sm[1][:, 0, 1:], jnp.zeros((p, 1), dtype)], axis=-1
    )
    Ps_in = jnp.concatenate(
        [sm[2][..., 1:], jnp.zeros((p, p, 1), dtype)], axis=-1
    )

    # ---- pass S2: apply per-step elements from the right ---------------------
    def s2_step(carry, inp):
        msn, Psn = carry
        En, gn, Ln = inp
        ms = _mv(En, msn) + gn
        Ps = _mm(_mm(En, Psn), _tr(En)) + Ln
        return (ms, Ps), (ms, Ps)

    _, (msL, PsL) = lax.scan(
        s2_step, (ms_in, Ps_in), (EL, gL, LL), reverse=True
    )
    ms = unblkT(msL)[:, :n0]
    Ps = unblkT(PsL)[..., :n0]

    mean = jnp.sum(ms * Hv[:, None], axis=0)
    var = jnp.sum(
        Ps * Hv[:, None, None] * Hv[None, :, None], axis=(0, 1)
    )
    return mean, var, ll


@_partial(jax.jit, static_argnames=("jr", "jc", "L", "sorted_test"))
def _predict_var_device_jit(c_real, c_comp, d_comp, Pinf, H,
                            t_train, diag, resid, t_test, jitter,
                            *, jr, jc, L, sorted_test=False):
    """Device-side merged-grid predict: merge + scatter + smoother +
    gather in ONE jitted program.

    The host-side numpy merge of the (n + m)-point train/test grid used
    to dominate end-to-end predict at N = 1e6 by ~200x (the smoother
    engine itself is ~10 ms).  With ``sorted_test`` (the common case —
    checked host-side) the merge is two vectorized ``searchsorted``
    binary searches + scatters, O((n+m) log) with no device sort; ties
    place the train point first, matching the stable-argsort semantics.
    Unsorted test grids fall back to a stable device argsort.  All
    static-shaped (reference analog: cholesky.h:599-698 merges
    train/test in-loop).
    """
    real_ = _NS(p=jr + 2 * jc, jr=jr, jc=jc, c_real=c_real,
                c_comp=c_comp, d_comp=d_comp, Pinf=Pinf, H=H)
    n = t_train.shape[0]
    m = t_test.shape[0]
    dtype = t_train.dtype
    if sorted_test:
        # Global position of train[i]: i + #{test < train[i]} (test
        # ties go after train); of test[j]: j + #{train <= test[j]}.
        pos_train = jnp.arange(n) + jnp.searchsorted(
            t_test, t_train, side="left"
        )
        test_pos = jnp.arange(m) + jnp.searchsorted(
            t_train, t_test, side="right"
        )
        nm = n + m
        t_s = jnp.zeros((nm,), dtype).at[pos_train].set(t_train)
        t_s = t_s.at[test_pos].set(t_test)
        yv = jnp.zeros((nm,), resid.dtype).at[pos_train].set(resid)
        rv = jnp.ones((nm,), dtype).at[pos_train].set(diag + jitter)
        obs = jnp.zeros((nm,), dtype).at[pos_train].set(1.0)
    else:
        t_all = jnp.concatenate([t_train, t_test])
        order = jnp.argsort(t_all, stable=True)
        t_s = t_all[order]
        is_train = order < n
        src = jnp.where(is_train, order, 0)
        yv = jnp.where(is_train, resid[src], 0.0)
        rv = jnp.where(is_train, diag[src] + jitter, 1.0)
        obs = is_train.astype(t_s.dtype)
        inv = jnp.argsort(order, stable=True)
        test_pos = inv[n:]
    dt = jnp.concatenate([jnp.zeros((1,), t_s.dtype), jnp.diff(t_s)])
    mean_s, var_s, _ = _blocked_fs_impl(real_, dt, yv, rv, obs, L)
    return mean_s[test_pos], var_s[test_pos]


def predict_var_parallel(coeffs, t_train, diag, resid, t_test,
                         block_size=None):
    """Parallel twin of ops/smoother.predict_var (same contract).

    Uses the two-level blocked filter/smoother — identical results to
    the sequential path, log-depth cross-block composition, and scan
    bodies that compile once (the flat associative-scan variant's first
    compile was minutes-scale; see blocked_filter_smoother).  The grid
    merge runs on device inside the same jitted program
    (:func:`_predict_var_device_jit`), so warm calls cost engine time
    plus transfers, not a host sort of n + m points.
    """
    import numpy as np

    real_ = realize(coeffs)
    if real_ is None:
        raise ValueError("kernel is not independently realizable")

    n = len(np.asarray(t_train))
    m = len(np.asarray(t_test))
    L = int(block_size or _default_kalman_block(n + m))
    # Pre-cast large arrays with numpy before device_put, so the upload
    # moves the target dtype instead of converting f64 on the device.
    dtype = np.dtype(jnp.result_type(float))

    def put(x):
        return jnp.asarray(np.asarray(x, dtype))

    # sorted_test=False (stable device argsort) is the default path;
    # the searchsorted+scatter variant is algebraically cheaper and
    # gives bit-identical results.  Which is faster on this card is
    # not measured yet.
    mean, var = _predict_var_device_jit(
        put(real_.c_real), put(real_.c_comp),
        put(real_.d_comp), put(real_.Pinf), put(real_.H),
        put(t_train), put(diag), put(resid),
        put(t_test), put(coeffs.jitter),
        jr=int(real_.jr), jc=int(real_.jc), L=L,
        sorted_test=False,
    )
    return np.asarray(mean), np.asarray(var)
