"""State-space (Kalman/RTS) predictive variance in O((N+M) p^2).

The reference computes predictive *variances* densely — an O(N M) matrix
build plus solves (celerite.py:460-474) — which is the one remaining
super-linear path at N=1e6.  celerite kernels are exactly the covariances
of low-dimensional Gauss-Markov processes, so the GP posterior mean AND
variance at any set of points fall out of one Kalman filter + RTS
smoother sweep over the merged (train + test) grid: O((N+M) p^2) with
p = J_real + 2 J_complex.

Realization (host-side, per parameter set):

- real term ``a e^{-c tau}``: 1-D block, transition ``e^{-c dt}``,
  stationary variance ``a`` (requires a >= 0).
- complex term ``e^{-c tau} (a cos d tau + b sin d tau)``: 2-D block
  with F = [[-c, -d], [d, -c]] (transition = decay x rotation), output
  H = [1, 0], and stationary covariance Pinf = [[a, -b], [-b, p22]].
  The Lyapunov equation fixes the continuous noise covariance
  Qc = 2 c Pinf - d [[2 b, a - p22], [a - p22, -2 b]]; a valid process
  needs Qc >= 0 for some p22 — maximizing det(Qc) over p22 (a concave
  quadratic) and checking positivity reduces to the celerite single-term
  validity condition a c >= b d (reference terms.py:446-451).  Terms
  that are only *jointly* positive definite (a c < b d individually)
  have no independent realization; callers fall back to the dense path.

Per-step discrete noise needs no integral: Q(dt) = Pinf - A Pinf A^T.

The filter also yields the log-likelihood — cross-checked against the
semiseparable solver in tests (the same identity the CARMA tests use).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .lower import Coefficients
from .precision import f32_matmuls

__all__ = ["realize", "predict_var", "kalman_log_likelihood", "sample_prior"]


class _Realization:
    """Static realization data: per-block structure + stationary cov.

    Real states have diagonal decay transitions e^{-c dt} but may carry
    a *coupled* stationary covariance P_real (negative-coefficient terms
    are realized jointly with a positive partner); complex pairs are
    2-D rotation-decay blocks.
    """

    def __init__(self, c_real, P_real, c_comp, d_comp, P_comp):
        self.c_real = np.asarray(c_real, float)
        self.P_real = np.atleast_2d(np.asarray(P_real, float))
        self.c_comp = np.asarray(c_comp, float)
        self.d_comp = np.asarray(d_comp, float)
        self.P_comp = np.asarray(P_comp, float)  # (Jc, 2, 2)
        self.jr = len(self.c_real)
        self.jc = len(self.c_comp)
        self.p = self.jr + 2 * self.jc

    @property
    def Pinf(self):
        P = np.zeros((self.p, self.p))
        if self.jr:
            P[: self.jr, : self.jr] = self.P_real
        for j in range(self.jc):
            k = self.jr + 2 * j
            P[k:k + 2, k:k + 2] = self.P_comp[j]
        return P

    @property
    def H(self):
        h = np.zeros(self.p)
        h[: self.jr] = 1.0
        h[self.jr::2] = 1.0
        return h


def _pair_coupling(a1, c1, a2, c2, tol):
    """Coupling s realizing a1 e^{-c1 t} + a2 e^{-c2 t}, a2 < 0 <= a1.

    With unit output weights and diagonal decay, the stationary cov
    Sigma = [[a1 - s, s], [s, a2 - s]] reproduces the pair for any s;
    validity needs Sigma >= 0 (s <= a2 and det: a1 a2 - (a1 + a2) s >=
    0) and the Lyapunov noise [[2 c1 (a1-s), (c1+c2) s], [., 2 c2
    (a2-s)]] >= 0 — a concave quadratic in s.  Returns s or None.
    """
    qa = -((c1 - c2) ** 2)
    qb = -4.0 * c1 * c2 * (a1 + a2)
    qc = 4.0 * c1 * c2 * a1 * a2
    disc = qb * qb - 4.0 * qa * qc
    if abs(qa) > tol:
        if disc < 0:
            return None
        r1 = (-qb - np.sqrt(disc)) / (2.0 * qa)
        r2 = (-qb + np.sqrt(disc)) / (2.0 * qa)
        lo, hi = min(r1, r2), max(r1, r2)
    else:
        if qb > tol:
            lo, hi = -qc / qb, np.inf
        elif qb < -tol:
            lo, hi = -np.inf, -qc / qb
        else:
            lo, hi = (-np.inf, np.inf) if qc >= -tol else (None, None)
            if lo is None:
                return None
    # Sigma PSD: s <= a2 (< 0) and s <= a1 a2 / (a1 + a2) when the
    # linear det bound binds.
    ub = a2
    if a1 + a2 > tol:
        ub = min(ub, a1 * a2 / (a1 + a2))
    s = min(hi, ub)
    if s < lo - tol:
        return None
    s = min(s, ub)
    # Verify numerically.
    Sig = np.array([[a1 - s, s], [s, a2 - s]])
    Qc = np.array([
        [2 * c1 * (a1 - s), (c1 + c2) * s],
        [(c1 + c2) * s, 2 * c2 * (a2 - s)],
    ])
    for M in (Sig, Qc):
        w = np.linalg.eigvalsh(M)
        if w[0] < -tol * max(1.0, abs(w[-1])):
            return None
    return s


def realize(coeffs: Coefficients, tol=1e-12):
    """Build the Gauss-Markov realization, or None if not realizable."""
    a_r = np.atleast_1d(np.asarray(coeffs.a_real, float))
    c_r = np.atleast_1d(np.asarray(coeffs.c_real, float))
    a_c = np.atleast_1d(np.asarray(coeffs.a_comp, float))
    b_c = np.atleast_1d(np.asarray(coeffs.b_comp, float))
    c_c = np.atleast_1d(np.asarray(coeffs.c_comp, float))
    d_c = np.atleast_1d(np.asarray(coeffs.d_comp, float))

    # Drop zero-amplitude padding channels.
    keep_r = np.abs(a_r) > tol
    a_r, c_r = a_r[keep_r], c_r[keep_r]
    keep_c = (np.abs(a_c) > tol) | (np.abs(b_c) > tol)
    a_c, b_c = a_c[keep_c], b_c[keep_c]
    c_c, d_c = c_c[keep_c], d_c[keep_c]

    if np.any(c_r <= 0):
        return None

    # Real block: positives are independent OU states; each negative
    # coefficient must pair with a positive partner (e.g. the overdamped
    # SHO lowering) through a coupled stationary covariance.
    neg = list(np.flatnonzero(a_r < -tol))
    pos = list(np.flatnonzero(a_r >= -tol))
    order = []
    blocks = []  # (indices, Sigma) chunks of P_real
    used = set()
    ok = True
    for i in neg:
        found = None
        for j in pos:
            if j in used:
                continue
            s = _pair_coupling(a_r[j], c_r[j], a_r[i], c_r[i], tol)
            if s is not None:
                found = (j, s)
                break
        if found is None:
            ok = False
            break
        j, s = found
        used.add(j)
        order += [j, i]
        blocks.append(np.array([
            [a_r[j] - s, s], [s, a_r[i] - s]
        ]))
    if not ok:
        return None
    for j in pos:
        if j not in used:
            order.append(j)
            blocks.append(np.array([[max(a_r[j], 0.0)]]))

    jr = len(order)
    P_real = np.zeros((jr, jr))
    c_states = np.zeros(jr)
    k = 0
    for blk in blocks:
        m = blk.shape[0]
        P_real[k:k + m, k:k + m] = blk
        k += m
    c_states = c_r[np.asarray(order, int)] if jr else np.zeros(0)

    P_blocks = []
    for a, b, c, d in zip(a_c, b_c, c_c, d_c):
        if c <= 0 or a <= 0:
            return None
        if abs(d) < tol:
            # Degenerate oscillation: behaves like a real pair; require
            # the plain decay condition.
            if abs(b) > tol:
                return None
            P_blocks.append(np.array([[a, 0.0], [0.0, a]]))
            continue
        # The SHOTerm sits exactly ON the a c = b d feasibility boundary,
        # so float32-rounded coefficients land an epsilon outside it —
        # use a relative margin and project onto the boundary.
        margin = tol + 1e-5 * (abs(c * a) + abs(d * b))
        if c * a < d * b - margin:
            return None  # individually non-PSD term
        # det Qc(p22) = (2ca - 2db)(2c p22 + 2db) - (2cb + d(a - p22))^2
        # is concave in p22; take its maximizer.
        alpha = max(2.0 * (c * a - d * b), 0.0)
        p22 = (alpha * c + d * (2.0 * c * b + d * a)) / (d * d)
        off = 2.0 * c * b + d * (a - p22)
        detq = alpha * (2.0 * c * p22 + 2.0 * d * b) - off * off
        q22 = 2.0 * c * p22 + 2.0 * d * b
        if (
            detq < -margin * max(1.0, 2.0 * c * p22 + 2.0 * d * b)
            or q22 < -margin
            or p22 <= 0
        ):
            return None
        P = np.array([[a, -b], [-b, p22]])
        if np.linalg.det(P) < -tol or np.trace(P) <= 0:
            return None
        P_blocks.append(P)

    P_comp = (
        np.asarray(P_blocks)
        if P_blocks else np.zeros((0, 2, 2))
    )
    return _Realization(c_states, P_real, c_c, d_c, P_comp)


@f32_matmuls
def _transitions(real_, dt):
    """Per-step block-diagonal transition matrices A(dt): (n, p, p)."""
    n = dt.shape[0]
    p = real_.p
    jr, jc = real_.jr, real_.jc
    A = jnp.zeros((n, p, p), dt.dtype)
    if jr:
        er = jnp.exp(-jnp.asarray(real_.c_real, dt.dtype) * dt[:, None])
        idx = jnp.arange(jr)
        A = A.at[:, idx, idx].set(er)
    for j in range(jc):
        k = jr + 2 * j
        e = jnp.exp(-real_.c_comp[j] * dt)
        cs = jnp.cos(real_.d_comp[j] * dt)
        sn = jnp.sin(real_.d_comp[j] * dt)
        A = A.at[:, k, k].set(e * cs)
        A = A.at[:, k, k + 1].set(-e * sn)
        A = A.at[:, k + 1, k].set(e * sn)
        A = A.at[:, k + 1, k + 1].set(e * cs)
    return A


@f32_matmuls
def _filter_smoother(real_, dt, yv, rv, obs):
    """Kalman filter + RTS smoother over one merged grid.

    Args: dt spacings (first 0), yv observed values (0 where missing),
    rv observation variances, obs 1/0 flags.  Returns (mean, var, ll)
    of the *latent* process at every grid point, and the marginal data
    log-likelihood over observed points.
    """
    dtype = yv.dtype
    Pinf = jnp.asarray(real_.Pinf, dtype)
    H = jnp.asarray(real_.H, dtype)
    A = _transitions(real_, dt)
    Q = Pinf - A @ Pinf @ jnp.swapaxes(A, 1, 2)

    def fstep(carry, inp):
        m, P = carry
        An, Qn, y, r, o = inp
        mp = An @ m
        Pp = An @ P @ An.T + Qn
        s = H @ Pp @ H + r
        k = (Pp @ H) / s
        innov = y - H @ mp
        m_new = mp + o * k * innov
        P_new = Pp - o * jnp.outer(k, k) * s
        ll = -0.5 * (innov**2 / s + jnp.log(s) + jnp.log(2 * jnp.pi))
        return (m_new, P_new), (m_new, P_new, mp, Pp, o * ll)

    init = (jnp.zeros((real_.p,), dtype), Pinf)
    _, (mf, Pf, mp, Pp, lls) = lax.scan(
        fstep, init, (A, Q, yv, rv, obs)
    )

    # RTS backward: state n uses A_{n+1}, P_pred_{n+1}.
    eye = jnp.eye(real_.p, dtype=dtype)
    A_next = jnp.concatenate([A[1:], eye[None]], axis=0)
    mp_next = jnp.concatenate([mp[1:], mp[-1:]], axis=0)
    Pp_next = jnp.concatenate([Pp[1:], Pp[-1:]], axis=0)

    def bstep(carry, inp):
        ms_next, Ps_next = carry
        mfn, Pfn, Ann, mpn, Ppn, last = inp
        # Regularized solve keeps the gain finite when P_pred is
        # near-singular (tiny dt steps).
        Ppn_r = Ppn + 1e-12 * jnp.trace(Ppn) * eye
        G = jnp.linalg.solve(Ppn_r, Ann @ Pfn).T
        ms = mfn + G @ (ms_next - mpn)
        Ps = Pfn + G @ (Ps_next - Ppn) @ G.T
        ms = jnp.where(last, mfn, ms)
        Ps = jnp.where(last, Pfn, Ps)
        return (ms, Ps), (ms, Ps)

    last_flag = jnp.zeros(dt.shape[0], bool).at[-1].set(True)
    init_b = (mf[-1], Pf[-1])
    _, (ms, Ps) = lax.scan(
        bstep,
        init_b,
        (mf, Pf, A_next, mp_next, Pp_next, last_flag),
        reverse=True,
    )

    mean = ms @ H
    var = jnp.einsum("i,nij,j->n", H, Ps, H)
    return mean, var, jnp.sum(lls)


@functools.partial(jax.jit, static_argnames=("jr", "jc"))
def _filter_smoother_jit(c_real, c_comp, d_comp, Pinf, H, dt, yv, rv, obs,
                         *, jr, jc):
    """:func:`_filter_smoother` as one compiled program per (jr, jc, n)."""
    real_ = SimpleNamespace(p=jr + 2 * jc, jr=jr, jc=jc, c_real=c_real,
                            c_comp=c_comp, d_comp=d_comp, Pinf=Pinf, H=H)
    return _filter_smoother(real_, dt, yv, rv, obs)


def _run(real_, dt, yv, rv, obs):
    """Run the compiled filter/smoother on a host realization."""
    dtype = jnp.result_type(float)
    return _filter_smoother_jit(
        *[jnp.asarray(x, dtype) for x in (
            real_.c_real, real_.c_comp, real_.d_comp, real_.Pinf, real_.H,
            dt, yv, rv, obs,
        )],
        jr=int(real_.jr), jc=int(real_.jc),
    )


@f32_matmuls
def kalman_log_likelihood(coeffs: Coefficients, t, diag, y):
    """Data log-likelihood via the filter (cross-check utility)."""
    real_ = realize(coeffs)
    if real_ is None:
        raise ValueError("kernel is not independently realizable")
    t = np.asarray(t, float)
    dt = np.concatenate([[0.0], np.diff(t)])
    rv = np.asarray(diag, float) + float(np.asarray(coeffs.jitter))
    _, _, ll = _run(real_, dt, y, rv, np.ones(t.shape[0]))
    return ll


@f32_matmuls
def predict_var(coeffs: Coefficients, t_train, diag, resid, t_test):
    """Posterior mean and variance of the latent GP at ``t_test``.

    O((N+M) p^2); exactly k* K^-1 r and k(0) + jitter-free variance
    k**(0) - k*^T K^-1 k* in exact arithmetic (validated vs the dense
    oracle in tests/test_smoother.py).  Returns (mean, var) at t_test.
    """
    real_ = realize(coeffs)
    if real_ is None:
        raise ValueError("kernel is not independently realizable")

    t_train = np.asarray(t_train, float)
    t_test = np.asarray(t_test, float)
    n, m = len(t_train), len(t_test)

    t_all = np.concatenate([t_train, t_test])
    kind = np.concatenate([np.ones(n), np.zeros(m)])
    src = np.concatenate([np.arange(n), np.arange(m)])
    order = np.argsort(t_all, kind="stable")
    t_s = t_all[order]
    obs_np = kind[order]
    src_s = src[order]

    yv = np.zeros(n + m)
    rv = np.ones(n + m)
    resid = np.asarray(resid, float)
    diag = np.asarray(diag, float)
    jitter = float(np.asarray(coeffs.jitter))
    train_mask = obs_np == 1
    yv[train_mask] = resid[src_s[train_mask]]
    rv[train_mask] = diag[src_s[train_mask]] + jitter

    dt = np.concatenate([[0.0], np.diff(t_s)])
    mean_s, var_s, _ = _run(real_, dt, yv, rv, obs_np)
    mean_s = np.asarray(mean_s)
    var_s = np.asarray(var_s)

    test_pos = np.flatnonzero(obs_np == 0)
    out_mean = np.empty(m)
    out_var = np.empty(m)
    out_mean[src_s[test_pos]] = mean_s[test_pos]
    out_var[src_s[test_pos]] = var_s[test_pos]
    return out_mean, out_var


@f32_matmuls
def sample_prior(coeffs: Coefficients, t, seed=None, rng=None):
    """Exact GP prior sample at ``t`` via the Gauss-Markov realization.

    Host-side float64 and O(N p^2) regardless of backend dtype — the
    robust way to simulate large-N datasets on accelerators whose f32
    factorization would be marginal (the draw is exact: x_0 ~ N(0,
    P_inf), x_n = A_n x_{n-1} + q_n with Q_n = P_inf - A_n P_inf A_n^T).
    Returns the latent kernel process only (no jitter / measurement
    noise).  Requires a realizable kernel (``realize`` returns None
    otherwise; see that docstring).
    """
    real_ = realize(coeffs)
    if real_ is None:
        raise ValueError("kernel is not Gauss-Markov realizable")
    if rng is None:
        rng = np.random.default_rng(seed)
    t = np.asarray(t, np.float64)
    n = t.shape[0]
    p = real_.p
    Pinf = np.asarray(real_.Pinf, np.float64)
    H = np.asarray(real_.H, np.float64)
    dt = np.concatenate([[0.0], np.diff(t)])
    A = np.asarray(_transitions(real_, jnp.asarray(dt)), np.float64)
    Q = Pinf[None] - A @ Pinf[None] @ np.swapaxes(A, 1, 2)

    # Robust symmetric square roots (Q_0 = 0; near-zero for tiny dt).
    Qs = 0.5 * (Q + np.swapaxes(Q, 1, 2))
    w, V = np.linalg.eigh(Qs)
    L = V * np.sqrt(np.clip(w, 0.0, None))[:, None, :]

    eps = rng.standard_normal((n, p))
    x = np.empty((n, p))
    x[0] = np.linalg.cholesky(
        Pinf + 1e-12 * np.trace(Pinf) / p * np.eye(p)
    ) @ eps[0]
    for k in range(1, n):
        x[k] = A[k] @ x[k - 1] + L[k] @ eps[k]
    return x @ H
