"""Automatic Differentiation Variational Inference (mean-field).

Reparameterized ELBO with a diagonal-Gaussian posterior q(theta) =
N(mu, diag(exp(2 log_sigma))), optimized with Adam (optax).  Matches
BASELINE.json configs[3]: ADVI over celerite kernel hyperparameters with a
Hessian check at the mode available via :func:`laplace_fit`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

__all__ = ["ADVIResult", "fit_advi", "laplace_fit"]


class ADVIResult(NamedTuple):
    mu: jnp.ndarray
    sigma: jnp.ndarray
    elbo_trace: jnp.ndarray

    def sample(self, key, num_samples):
        eps = jax.random.normal(
            key, (num_samples, self.mu.shape[0]), self.mu.dtype
        )
        return self.mu + self.sigma * eps


def fit_advi(
    logprob_fn,
    init_params,
    key,
    num_steps=2000,
    num_mc=8,
    learning_rate=5e-2,
):
    """Maximize the ELBO; returns an :class:`ADVIResult`.

    ELBO = E_q[logprob(theta)] + entropy(q); the entropy of a diagonal
    Gaussian is sum(log sigma) + const, so the reparameterized estimator is
    mean over eps of logprob(mu + sigma*eps) + sum(log_sigma).

    When ``logprob_fn`` carries a one-pass ``value_and_grad`` attribute
    (e.g. a GP.build_logprob closure on the fused route), the ELBO
    gradient is assembled in closed form from the vmapped theta-space
    gradients instead of AD through the vmapped closure:
    d/dmu = mean_i g_i,  d/dlog_sigma = mean_i (g_i * eps_i) * sigma + 1.
    """
    init_params = jnp.asarray(init_params)
    dim = init_params.shape[0]
    dtype = init_params.dtype

    def unpack(v):
        return v[:dim], v[dim:]

    v0 = jnp.concatenate(
        [init_params, jnp.full((dim,), -2.0, dtype)]
    )
    opt = optax.adam(learning_rate)
    opt_state = opt.init(v0)

    vag = getattr(logprob_fn, "value_and_grad", None)

    def neg_elbo(v, key):
        mu, log_sigma = unpack(v)
        eps = jax.random.normal(key, (num_mc, dim), dtype)
        thetas = mu + jnp.exp(log_sigma) * eps
        lps = jax.vmap(logprob_fn)(thetas)
        # -inf log-probs (out of support / non-PD) get clamped so a single
        # bad draw does not destroy the gradient signal.
        lps = jnp.where(jnp.isfinite(lps), lps, -1e10)
        return -(jnp.mean(lps) + jnp.sum(log_sigma))

    def neg_elbo_and_grad(v, key):
        """Closed-form reparameterization gradient over the fused path.

        Matches jax.value_and_grad(neg_elbo) exactly (non-finite draws
        contribute the same clamped value and zero gradient) — asserted
        by tests/test_inference.py::test_advi_fused_path_matches_ad.
        """
        mu, log_sigma = unpack(v)
        sigma = jnp.exp(log_sigma)
        eps = jax.random.normal(key, (num_mc, dim), dtype)
        thetas = mu + sigma * eps
        lps, gs = jax.vmap(vag)(thetas)
        finite = jnp.isfinite(lps)
        lps = jnp.where(finite, lps, -1e10)
        gs = jnp.where(finite[:, None], gs, 0.0)
        elbo = jnp.mean(lps) + jnp.sum(log_sigma)
        g_mu = jnp.mean(gs, axis=0)
        g_ls = jnp.mean(gs * eps, axis=0) * sigma + 1.0
        return -elbo, -jnp.concatenate([g_mu, g_ls])

    @jax.jit
    def step(carry, key):
        v, opt_state = carry
        if vag is None:
            loss, g = jax.value_and_grad(neg_elbo)(v, key)
        else:
            loss, g = neg_elbo_and_grad(v, key)
        updates, opt_state = opt.update(g, opt_state)
        v = optax.apply_updates(v, updates)
        return (v, opt_state), -loss

    keys = jax.random.split(key, num_steps)
    (v, _), elbo_trace = jax.lax.scan(step, (v0, opt_state), keys)
    mu, log_sigma = unpack(v)
    return ADVIResult(mu=mu, sigma=jnp.exp(log_sigma), elbo_trace=elbo_trace)


def laplace_fit(logprob_fn, init_params, num_steps=500, learning_rate=1e-2):
    """MAP + Laplace approximation (Hessian check at the mode).

    Returns (mode, cov) where cov = inverse negative Hessian at the mode —
    the 'Hessian-checked posterior at mode' of BASELINE.json configs[3].

    The MAP ascent consumes a fused ``value_and_grad`` attribute when
    present; the Hessian at the mode always goes through plain AD of
    ``logprob_fn`` (the hand-written kernels are first-order only).
    """
    opt = optax.adam(learning_rate)
    vag = getattr(logprob_fn, "value_and_grad", None)

    def neg_lp(v):
        lp = logprob_fn(v)
        return jnp.where(jnp.isfinite(lp), -lp, 1e10)

    @jax.jit
    def step(carry, _):
        v, opt_state = carry
        if vag is None:
            loss, g = jax.value_and_grad(neg_lp)(v)
        else:
            lp, g_lp = vag(v)
            bad = ~jnp.isfinite(lp)
            loss = jnp.where(bad, 1e10, -lp)
            g = jnp.where(bad, 0.0, -g_lp)
        updates, opt_state = opt.update(g, opt_state)
        v = optax.apply_updates(v, updates)
        return (v, opt_state), loss

    v0 = jnp.asarray(init_params)
    (mode, _), _ = jax.lax.scan(
        step, (v0, opt.init(v0)), None, length=num_steps
    )
    try:
        hess = jax.hessian(neg_lp)(mode)
    except TypeError:
        # logprob_fn routes through a custom_vjp (the hand-written
        # gradient kernels), which JAX cannot differentiate twice.
        # Central finite differences of the (exact) gradient recover the
        # Hessian to ~sqrt(eps) accuracy — ample for a Laplace check.
        g = (
            (lambda x: vag(x)[1]) if vag is not None
            else jax.grad(logprob_fn)
        )
        dim = mode.shape[0]
        h = 1e-4 * (1.0 + jnp.abs(mode))
        eye = jnp.eye(dim, dtype=mode.dtype)

        def col(i):
            hi = h[i]
            return -(g(mode + hi * eye[i]) - g(mode - hi * eye[i])) / (
                2.0 * hi
            )

        cols = jax.lax.map(col, jnp.arange(dim))
        hess = 0.5 * (cols + cols.T)
    cov = jnp.linalg.inv(hess)
    return mode, cov
