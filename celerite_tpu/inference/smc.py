"""Adaptive-tempering Sequential Monte Carlo with HMC mutations.

Targets multimodal posteriors (BASELINE.json configs[4]: QPO posteriors).
Anneals from the prior-ish initial distribution to the posterior through
temperatures chosen adaptively so the effective sample size stays at a
fixed fraction; particles are resampled systematically and mutated with a
few jittered-HMC steps at each temperature.

Particle-parallel by construction: every stage is a vmap over particles,
and the only cross-particle operations are an ESS reduction, a weight
normalization, and the resampling gather — exactly the psum/all_gather
pattern of the sharded version in celerite_tpu.parallel.sharded_smc.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .hmc import hmc_kernel

__all__ = ["SMCResult", "sample_smc", "systematic_resample"]


class SMCResult(NamedTuple):
    particles: jnp.ndarray  # (n_particles, dim)
    log_evidence: jnp.ndarray  # log marginal-likelihood estimate
    num_stages: jnp.ndarray
    final_accept: jnp.ndarray


def systematic_resample(key, log_weights):
    """Systematic (low-variance) resampling; returns particle indices."""
    n = log_weights.shape[0]
    w = jax.nn.softmax(log_weights)
    positions = (
        jax.random.uniform(key, ()) + jnp.arange(n, dtype=w.dtype)
    ) / n
    cum = jnp.cumsum(w)
    return jnp.searchsorted(cum, positions, side="right").clip(0, n - 1)


def _ess(log_weights):
    lw = log_weights - jax.nn.logsumexp(log_weights)
    return jnp.exp(-jax.nn.logsumexp(2.0 * lw))


def _find_next_beta(log_like, beta, target_frac):
    """Largest next temperature keeping ESS >= target_frac * N (bisection)."""
    n = log_like.shape[0]
    target = target_frac * n

    def ess_at(b):
        return _ess((b - beta) * log_like)

    def body(_, bounds):
        lo, hi = bounds
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

    lo, hi = lax.fori_loop(
        0, 30, body, (beta, jnp.ones((), beta.dtype))
    )
    full = ess_at(jnp.ones((), beta.dtype)) >= target
    return jnp.where(full, 1.0, lo)


def sample_smc(
    log_prior_fn: Callable,
    log_like_fn: Callable,
    init_particles,
    key,
    num_mutations=5,
    hmc_step_size=0.1,
    num_leapfrog=8,
    target_ess_frac=0.5,
    max_stages=50,
    host_loop=False,
):
    """Adaptive-tempering SMC.  Returns an :class:`SMCResult`.

    ``init_particles`` (n, dim) should be draws from the prior (or any
    overdispersed initialization; the first tempering stage corrects).

    ``host_loop=True`` runs one tempering stage per device launch (a
    jitted stage inside a Python while) instead of a single
    ``lax.while_loop`` program — use on runtimes that bound per-launch
    wall-clock, or to insert per-stage logging/checkpointing.
    """
    particles = jnp.asarray(init_particles)
    n, dim = particles.shape
    dtype = particles.dtype

    vprior = jax.vmap(log_prior_fn)
    vlike = jax.vmap(log_like_fn)

    def safe(x):
        return jnp.where(jnp.isfinite(x), x, -1e12)

    vag_like = getattr(log_like_fn, "value_and_grad", None)

    def mutate(particles, key, beta, step_size):
        def tempered_logprob(theta):
            lp = log_prior_fn(theta) + beta * log_like_fn(theta)
            return jnp.where(jnp.isfinite(lp), lp, -1e12)

        # Propagate the one-pass value+gradient entry point through the
        # tempering: the HMC mutation kernel picks it up for the whole
        # particle cloud's leapfrog gradients (the NUTS path, reused).
        if vag_like is not None:
            vag_prior = getattr(
                log_prior_fn, "value_and_grad",
                jax.value_and_grad(log_prior_fn),
            )

            def tempered_vag(theta):
                lpri, gpri = vag_prior(theta)
                ll, gll = vag_like(theta)
                val = lpri + beta * ll
                grad = gpri + beta * gll
                bad = ~jnp.isfinite(val)
                return (
                    jnp.where(bad, -1e12, val),
                    jnp.where(bad, 0.0, grad),
                )

            tempered_logprob.value_and_grad = tempered_vag

        # Scale the HMC metric to the current particle cloud: as the
        # tempered posterior narrows (often anisotropically), unit-mass
        # proposals lose all acceptance; the cloud variance is the
        # standard adaptive choice.
        inv_mass = jnp.maximum(jnp.var(particles, axis=0), 1e-10)

        def one(p, k):
            def body(carry, kk):
                q, acc = carry
                q, info = hmc_kernel(
                    tempered_logprob,
                    q,
                    kk,
                    step_size,
                    inv_mass,
                    num_leapfrog=num_leapfrog,
                )
                return (q, acc + info.accept_prob), None

            (q, acc), _ = lax.scan(
                body, (p, jnp.zeros((), dtype)), jax.random.split(k, num_mutations)
            )
            return q, acc / num_mutations

        return jax.vmap(one)(particles, jax.random.split(key, n))

    class _S(NamedTuple):
        key: jnp.ndarray
        particles: jnp.ndarray
        beta: jnp.ndarray
        log_z: jnp.ndarray
        stage: jnp.ndarray
        accept: jnp.ndarray
        step_size: jnp.ndarray

    def cond(s: _S):
        return (s.beta < 1.0) & (s.stage < max_stages)

    def stage(s: _S):
        key, k_res, k_mut = jax.random.split(s.key, 3)
        ll = safe(vlike(s.particles))
        beta_new = _find_next_beta(ll, s.beta, target_ess_frac)
        lw = (beta_new - s.beta) * ll
        log_z = s.log_z + jax.nn.logsumexp(lw) - jnp.log(float(n))
        idx = systematic_resample(k_res, lw)
        particles = s.particles[idx]
        particles, accept = mutate(particles, k_mut, beta_new, s.step_size)
        mean_accept = jnp.mean(accept)
        # Crude step-size controller toward ~0.6 acceptance.
        step_size = s.step_size * jnp.exp(
            0.5 * (mean_accept - 0.6)
        )
        return _S(
            key=key,
            particles=particles,
            beta=beta_new,
            log_z=log_z,
            stage=s.stage + 1,
            accept=mean_accept,
            step_size=step_size,
        )

    init = _S(
        key=key,
        particles=particles,
        beta=jnp.zeros((), dtype),
        log_z=jnp.zeros((), dtype),
        stage=jnp.zeros((), jnp.int32),
        accept=jnp.ones((), dtype),
        step_size=jnp.asarray(hmc_step_size, dtype),
    )
    if host_loop:
        stage_jit = jax.jit(stage)
        out = init
        while bool(cond(out)):
            out = stage_jit(out)
            jax.block_until_ready(out.particles)
    else:
        out = lax.while_loop(cond, stage, init)
    return SMCResult(
        particles=out.particles,
        log_evidence=out.log_z,
        num_stages=out.stage,
        final_accept=out.accept,
    )
