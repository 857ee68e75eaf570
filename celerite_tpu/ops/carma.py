"""CARMA(p, q) models: Kalman log-likelihood + celerite conversion.

JAX analog of the reference's complex-diagonalized CARMA solver
(/root/reference/cpp/include/celerite/carma.h:15-286, following Kelly et
al. 2014).  Two roles, as in the reference: a comparison baseline for the
semiseparable solver, and the constructive proof that the celerite kernel
family contains CARMA via :meth:`CARMASolver.get_celerite_coeffs`
(used by tests to cross-check the two likelihoods).

The sequential Kalman filter is a ``lax.scan`` over time in complex
arithmetic — jit-able and vmap-able; the O(p) root/coefficient setup is
host-side numpy (it involves ``np.roots``-style branching and runs once
per parameter set).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from .precision import f32_matmuls

__all__ = ["CARMASolver", "roots_from_params", "poly_from_roots"]


def roots_from_params(params):
    """Quadratic-factor parameterization -> roots (Kelly et al.).

    Parameters come in pairs (log c, log b) giving the monic quadratic
    z^2 + b z + c; an odd trailing parameter adds the real root -exp(p).
    """
    params = np.atleast_1d(np.asarray(params, dtype=float))
    n = len(params)
    roots = np.zeros(n, dtype=complex)
    if n == 0:
        return roots
    if n % 2 == 1:
        roots[n - 1] = -np.exp(params[n - 1])
    for i in range(0, n - 1, 2):
        b = np.exp(params[i + 1])
        c = np.exp(params[i])
        arg = np.sqrt(complex(b * b - 4.0 * c))
        roots[i] = 0.5 * (-b + arg)
        roots[i + 1] = 0.5 * (-b - arg)
    return roots


def poly_from_roots(roots):
    """Monic polynomial coefficients (ascending order) from its roots."""
    roots = np.atleast_1d(np.asarray(roots, dtype=complex))
    # np.poly gives descending coefficients of prod (z - r); ascending flip.
    return np.poly(roots)[::-1].astype(complex) if len(roots) else np.ones(
        1, dtype=complex
    )


class CARMASolver:
    """CARMA(p, q) Kalman-filter likelihood in the diagonalized basis.

    Args follow the reference binding (solver.cpp:200-235):
    ``log_sigma``, AR parameters (length p), MA parameters (length q < p).
    """

    def __init__(self, log_sigma, arparams, maparams):
        arparams = np.atleast_1d(np.asarray(arparams, dtype=float))
        maparams = np.atleast_1d(np.asarray(maparams, dtype=float))
        self.p = len(arparams)
        self.q = len(maparams)
        if self.q >= self.p:
            raise ValueError("q must be smaller than p")
        self.sigma = float(np.exp(log_sigma))
        self.arroots = roots_from_params(arparams)
        self.maroots = roots_from_params(maparams)
        self.alpha = poly_from_roots(self.arroots)
        beta = poly_from_roots(self.maroots)
        self.beta = beta / beta[0]

        # Rotation into the diagonalized space: U_ij = r_j^i.
        U = np.vander(self.arroots, self.p, increasing=True).T
        b = np.zeros(self.p, dtype=complex)
        b[: self.q + 1] = self.beta[: self.q + 1]
        self.b = b @ U

        e = np.zeros(self.p, dtype=complex)
        e[-1] = self.sigma
        J = np.linalg.solve(U, e)
        self.V = -np.outer(J, np.conj(J)) / (
            self.arroots[:, None] + np.conj(self.arroots)[None, :]
        )

    # -- Kalman filter -------------------------------------------------------
    def _scan_args(self, t, y, yerr):
        t = jnp.asarray(t, dtype=jnp.float64)
        dt = jnp.concatenate([jnp.diff(t), jnp.zeros((1,), t.dtype)])
        return (
            jnp.asarray(y, dtype=jnp.float64),
            jnp.asarray(yerr, dtype=jnp.float64) ** 2,
            dt,
        )

    def log_likelihood(self, t, y, yerr, quiet=False):
        """Exact Gaussian log-likelihood via the Kalman filter (O(N p^2)).

        ``quiet=True`` returns ``(ll, ok)`` instead of raising on a
        negative predictive variance (the generic failure mode of the
        diagonalized-basis filter at large p, carma.h:185-186).
        """
        t = np.atleast_1d(np.asarray(t))
        if len(y) != len(t) or len(yerr) != len(t):
            raise ValueError("dimension mismatch")
        ll, ok = self._kalman(*self._scan_args(t, y, yerr))
        if quiet:
            return float(ll), bool(ok)
        if not bool(ok):
            raise RuntimeError("negative predictive variance in CARMA filter")
        return float(ll)

    def _kalman(self, y, yvar, dt):
        """Jitted complex-arithmetic Kalman pass; returns (ll, ok)."""
        return _kalman_ll(
            jnp.asarray(self.b),
            jnp.asarray(self.V),
            jnp.asarray(self.arroots),
            y, yvar, dt,
        )

    # -- spectra -------------------------------------------------------------
    def psd(self, f):
        """Power spectrum at ordinary frequency f (reference carma.h:241)."""
        f = np.asarray(f, dtype=float)
        w = 2j * np.pi * f[..., None]
        num = np.sum(self.beta * w ** np.arange(self.q + 1), axis=-1)
        den = np.sum(self.alpha * w ** np.arange(self.p + 1), axis=-1)
        return self.sigma**2 * np.abs(num) ** 2 / np.abs(den) ** 2

    def covariance(self, tau):
        """Autocovariance k(tau) (reference carma.h:250-269)."""
        tau = np.asarray(tau, dtype=float)
        value = np.zeros(tau.shape, dtype=complex)
        for k in range(self.p):
            rk = self.arroots[k]
            n1 = np.sum(self.beta * rk ** np.arange(self.q + 1))
            n2 = np.sum(self.beta * (-rk) ** np.arange(self.q + 1))
            norm = n1 * n2 / rk.real
            for l in range(self.p):
                if l != k:
                    norm /= (self.arroots[l] - rk) * (
                        np.conj(self.arroots[l]) + rk
                    )
            value = value + norm * np.exp(rk * tau)
        return -0.5 * self.sigma**2 * value.real

    # -- the celerite bridge -------------------------------------------------
    def get_celerite_coeffs(self):
        """CARMA -> celerite coefficient conversion with conjugate dedup.

        Returns the 6 arrays (a_real, c_real, a_comp, b_comp, c_comp,
        d_comp); proves celerite contains CARMA (carma.h:72-139).
        """
        ar, cr = [], []
        ac, bc, cc, dc = [], [], [], []

        def isclose(a, b):
            return abs(a - b) <= 1e-6

        for k in range(self.p):
            rk = self.arroots[k]
            term1 = np.sum(self.beta * rk ** np.arange(self.q + 1))
            term2 = np.sum(self.beta * (-rk) ** np.arange(self.q + 1))
            full = self.sigma**2 * term1 * term2 / (-rk.real)
            for l in range(self.p):
                if l != k:
                    full /= (self.arroots[l] - rk) * (
                        np.conj(self.arroots[l]) + rk
                    )

            if isclose(full.imag, 0.0) and isclose(rk.imag, 0.0):
                ar.append(0.5 * full.real)
                cr.append(-rk.real)
            else:
                is_conj = any(
                    isclose(a, full.real)
                    and isclose(b, -full.imag)
                    and isclose(c, -rk.real)
                    and isclose(d, rk.imag)
                    for a, b, c, d in zip(ac, bc, cc, dc)
                )
                if not is_conj:
                    ac.append(full.real)
                    bc.append(full.imag)
                    cc.append(-rk.real)
                    dc.append(-rk.imag)

        return tuple(
            np.asarray(v, dtype=float) for v in (ar, cr, ac, bc, cc, dc)
        )


@jax.jit
@f32_matmuls
def _kalman_ll(b, V, roots, y, yvar, dt):
    """Sequential Kalman filter as a scan (reference carma.h:221-239)."""
    p = b.shape[0]
    dtype = y.dtype

    def step(carry, inp):
        x, P, acc, min_var = carry
        yn, vn, dtn = inp
        # Predict.
        expectation = jnp.real(b @ x)
        variance = vn + jnp.real(b @ P @ jnp.conj(b))
        # Update.
        K = P @ jnp.conj(b) / variance
        resid = yn - expectation
        x = x + resid * K
        P = P - variance * jnp.outer(K, jnp.conj(K))
        # Advance.
        lam = jnp.exp(roots * dtn)
        x = x * lam
        P = V + (lam[:, None] * (P - V)) * jnp.conj(lam)[None, :]
        acc = acc + resid * resid / variance + jnp.log(variance)
        min_var = jnp.minimum(min_var, variance)
        return (x, P, acc, min_var), None

    init = (
        jnp.zeros((p,), V.dtype),
        V,
        jnp.zeros((), dtype),
        jnp.array(jnp.inf, dtype),
    )
    (x, P, acc, min_var), _ = lax.scan(step, init, (y, yvar, dt))
    n = y.shape[0]
    ll = -0.5 * (acc + n * jnp.log(2.0 * jnp.pi))
    return ll, min_var > 0
