"""Warmup adaptation: dual-averaged step size + Welford mass matrix.

Nesterov dual averaging (Hoffman & Gelman 2014, section 3.2) drives the log
step size toward a target acceptance statistic; Welford accumulators over
warmup draws estimate a diagonal inverse mass matrix, refreshed at
Stan-style doubling window boundaries.

All states are pytrees of scalars/vectors so the adaptation loop jits and
the statistics can be psum-pooled across sharded chains.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

__all__ = [
    "DualAveragingState",
    "da_init",
    "da_update",
    "da_final",
    "WelfordState",
    "welford_init",
    "welford_update",
    "welford_variance",
    "welford_cov_init",
    "welford_cov_update",
    "welford_covariance",
    "window_boundaries",
]


class DualAveragingState(NamedTuple):
    log_step: jnp.ndarray
    log_step_avg: jnp.ndarray
    h_sum: jnp.ndarray
    mu: jnp.ndarray
    count: jnp.ndarray
    target: jnp.ndarray


def da_init(step_size, target=0.8, t0=10.0, gamma=0.05, kappa=0.75,
            mu=None):
    """Initial dual-averaging state.

    ``mu`` anchors the shrinkage point; the default log(10*step) is
    Stan's upward bias, appropriate when ``step_size`` is a blind guess.
    When the step size comes from an explicit search
    (find_reasonable_step_size) pass ``mu=jnp.log(step_size)`` so the
    calibrated value is not immediately pulled 10x high.
    """
    step_size = jnp.asarray(step_size)
    if mu is None:
        mu = jnp.log(10.0 * step_size)
    return DualAveragingState(
        log_step=jnp.log(step_size),
        log_step_avg=jnp.log(step_size),
        h_sum=jnp.zeros_like(step_size),
        mu=jnp.asarray(mu, step_size.dtype),
        count=jnp.zeros((), jnp.int32),
        target=jnp.asarray(target, step_size.dtype),
    )


def da_update(s: DualAveragingState, accept_prob, t0=10.0, gamma=0.05,
              kappa=0.75):
    count = s.count + 1
    tc = count.astype(s.log_step.dtype)
    h_sum = s.h_sum + (s.target - accept_prob)
    log_step = s.mu - jnp.sqrt(tc) / gamma * h_sum / (tc + t0)
    eta = tc ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * s.log_step_avg
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=log_step_avg,
        h_sum=h_sum,
        mu=s.mu,
        count=count,
        target=s.target,
    )


def da_final(s: DualAveragingState):
    return jnp.exp(s.log_step_avg)


class WelfordState(NamedTuple):
    count: jnp.ndarray
    mean: jnp.ndarray
    m2: jnp.ndarray


def welford_init(dim, dtype=jnp.float64):
    return WelfordState(
        count=jnp.zeros((), dtype),
        mean=jnp.zeros((dim,), dtype),
        m2=jnp.zeros((dim,), dtype),
    )


def welford_update(s: WelfordState, xs, axis_name=None):
    """Batch update with xs of shape (n_chains, dim) — pools all chains.

    With ``axis_name``, statistics pool across the sharded chain axis too
    (psum of counts/sums), so every device holds identical state.
    """
    from jax import lax

    xs = jnp.atleast_2d(xs)
    n = jnp.asarray(xs.shape[0], s.count.dtype)
    batch_sum = jnp.sum(xs, axis=0)
    if axis_name is not None:
        n = lax.psum(n, axis_name)
        batch_sum = lax.psum(batch_sum, axis_name)
    batch_mean = batch_sum / n
    batch_m2 = jnp.sum((xs - batch_mean) ** 2, axis=0)
    if axis_name is not None:
        batch_m2 = lax.psum(batch_m2, axis_name)
    count = s.count + n
    delta = batch_mean - s.mean
    mean = s.mean + delta * (n / count)
    m2 = s.m2 + batch_m2 + delta**2 * (n * s.count / count)
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_variance(s: WelfordState, regularize=True):
    var = s.m2 / jnp.maximum(s.count - 1.0, 1.0)
    if regularize:
        # Stan's shrinkage toward unit scale for small sample counts.
        w = s.count / (s.count + 5.0)
        var = w * var + (1.0 - w) * 1e-3
    return var


def welford_cov_init(dim, dtype=jnp.float64):
    """Dense-covariance Welford accumulator: ``m2`` is (dim, dim)."""
    return WelfordState(
        count=jnp.zeros((), dtype),
        mean=jnp.zeros((dim,), dtype),
        m2=jnp.zeros((dim, dim), dtype),
    )


def welford_cov_update(s: WelfordState, xs, axis_name=None):
    """Batch update accumulating full cross moments (dense mass matrix).

    Same pooling semantics as :func:`welford_update`; ``m2`` carries the
    sum of outer products of deviations, so ``welford_covariance``
    yields the sample covariance of all pooled draws.
    """
    from jax import lax

    xs = jnp.atleast_2d(xs)
    n = jnp.asarray(xs.shape[0], s.count.dtype)
    batch_sum = jnp.sum(xs, axis=0)
    if axis_name is not None:
        n = lax.psum(n, axis_name)
        batch_sum = lax.psum(batch_sum, axis_name)
    batch_mean = batch_sum / n
    dev = xs - batch_mean
    batch_m2 = jnp.matmul(dev.T, dev, precision="highest")
    if axis_name is not None:
        batch_m2 = lax.psum(batch_m2, axis_name)
    count = s.count + n
    delta = batch_mean - s.mean
    mean = s.mean + delta * (n / count)
    m2 = s.m2 + batch_m2 + jnp.outer(delta, delta) * (
        n * s.count / count
    )
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_covariance(s: WelfordState, regularize=True):
    """Sample covariance with Stan's shrinkage toward a scaled identity
    (the dense analog of :func:`welford_variance`)."""
    cov = s.m2 / jnp.maximum(s.count - 1.0, 1.0)
    if regularize:
        w = s.count / (s.count + 5.0)
        dim = s.mean.shape[0]
        cov = w * cov + (1.0 - w) * 1e-3 * jnp.eye(dim, dtype=cov.dtype)
    return cov


def window_boundaries(num_warmup, init_buffer=75, term_buffer=50,
                      base_window=25):
    """Boolean host-side schedules (mass-window membership, window ends).

    Mirrors Stan's three-phase warmup: a fast initial buffer (step size
    only), doubling slow windows (mass accumulation), and a fast terminal
    buffer.  Returns two boolean arrays of length num_warmup.
    """
    if num_warmup < init_buffer + term_buffer + base_window:
        init_buffer = max(1, int(0.15 * num_warmup))
        term_buffer = max(1, int(0.1 * num_warmup))
        base_window = max(1, num_warmup - init_buffer - term_buffer)

    in_window = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    start = init_buffer
    end_slow = num_warmup - term_buffer
    in_window[start:end_slow] = True
    size = base_window
    pos = start
    while pos < end_slow:
        nxt = pos + size
        if nxt + 2 * size > end_slow:
            nxt = end_slow
        window_end[min(nxt, num_warmup) - 1] = True
        pos = nxt
        size *= 2
    return jnp.asarray(in_window), jnp.asarray(window_end)
