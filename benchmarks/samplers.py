#!/usr/bin/env python
"""Sampler-path benchmark: one-pass value+grad vs plain-AD fallback.

Measures, on the current default backend (one GPU):

- one jitted ADVI step (num_mc reparameterized draws + closed-form ELBO
  gradient over the closure's ``value_and_grad``) vs the same step with
  plain AD through the vmapped closure;
- one SMC mutation round (vmapped jittered-HMC over the particle cloud,
  the per-stage hot loop) fused vs fallback;
- one batched NUTS-style value+grad call for reference.

Writes CSV rows: path,config,time_ms.

Usage: python benchmarks/samplers.py [--n 100000] [--out results.csv]
"""

import argparse
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np
import jax
import jax.numpy as jnp


def timeit(fn, *args, repeat=20, warmup=2):
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(repeat):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / repeat


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--num-mc", type=int, default=8)
    ap.add_argument("--particles", type=int, default=32)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    from celerite_tpu import GP, terms
    from celerite_tpu.inference import fit_advi
    from celerite_tpu.utils import enable_persistent_cache

    enable_persistent_cache()  # one-time compiles cache to disk

    rng = np.random.default_rng(0)
    n = args.n
    t = np.sort(rng.uniform(0, 100, n))
    yerr = np.full(n, 0.1)
    gp = GP(terms.SHOTerm(log_S0=0.1, log_Q=0.7, log_omega0=1.0))
    gp.compute(t, yerr)
    y = np.asarray(gp.sample(seed=1))

    prior = lambda th: -0.5 * jnp.sum((th / 3.0) ** 2)
    lp_fused = gp.build_logprob(t, y, yerr, log_prior=prior)
    # "plain" = same fused-kernel likelihood but consumed through
    # jax.value_and_grad of the vmapped closure (no folded batching).
    lp_plain = gp.build_logprob(
        t, y, yerr, log_prior=prior, fast_grad=False
    )
    # "blocked" = the round-2-era fallback: AD through the lax
    # block-parallel solver, vmapped (what ADVI/SMC actually ran before
    # they honored value_and_grad).
    lp_blocked = gp.build_logprob(
        t, y, yerr, log_prior=prior, solver="blocked", fast_grad=False
    )
    assert hasattr(lp_fused, "value_and_grad")
    assert not hasattr(lp_plain, "value_and_grad")
    dim = len(gp.get_parameter_vector())
    theta0 = jnp.asarray(gp.get_parameter_vector())

    rows = []

    def record(path, config, secs):
        ms = 1e3 * secs
        rows.append((path, config, ms))
        print(f"{path:22s} {config:28s} {ms:10.2f} ms")

    # ---- ADVI step ----
    import optax

    def make_advi_step(lp):
        opt = optax.adam(5e-2)
        vag = getattr(lp, "value_and_grad", None)
        num_mc = args.num_mc

        def neg_elbo(v, key):
            mu, log_sigma = v[:dim], v[dim:]
            eps = jax.random.normal(key, (num_mc, dim), mu.dtype)
            thetas = mu + jnp.exp(log_sigma) * eps
            lps = jax.vmap(lp)(thetas)
            lps = jnp.where(jnp.isfinite(lps), lps, -1e10)
            return -(jnp.mean(lps) + jnp.sum(log_sigma))

        def neg_elbo_and_grad(v, key):
            mu, log_sigma = v[:dim], v[dim:]
            sigma = jnp.exp(log_sigma)
            eps = jax.random.normal(key, (num_mc, dim), mu.dtype)
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
        def step(v, opt_state, key):
            if vag is None:
                loss, g = jax.value_and_grad(neg_elbo)(v, key)
            else:
                loss, g = neg_elbo_and_grad(v, key)
            updates, opt_state = opt.update(g, opt_state)
            v = optax.apply_updates(v, updates)
            return v, opt_state, loss

        v0 = jnp.concatenate([theta0, jnp.full((dim,), -2.0)])
        return step, v0, opt.init(v0)

    key = jax.random.PRNGKey(0)
    for name, lp in [("advi_fused", lp_fused), ("advi_plain_ad", lp_plain),
                     ("advi_blocked_ad", lp_blocked)]:
        step, v0, s0 = make_advi_step(lp)
        record(
            name, f"N={n} num_mc={args.num_mc}",
            timeit(lambda: step(v0, s0, key)),
        )

    # ---- SMC mutation round ----
    from celerite_tpu.inference.hmc import hmc_kernel

    npart = args.particles
    parts0 = theta0[None, :] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(1), (npart, dim)
    )

    def make_mutation(lp):
        def tempered(theta):
            v = lp(theta)
            return jnp.where(jnp.isfinite(v), v, -1e12)

        vag = getattr(lp, "value_and_grad", None)
        if vag is not None:
            def tempered_vag(theta):
                val, g = vag(theta)
                bad = ~jnp.isfinite(val)
                return (
                    jnp.where(bad, -1e12, val), jnp.where(bad, 0.0, g)
                )
            tempered.value_and_grad = tempered_vag

        @jax.jit
        def mutate(particles, key):
            inv_mass = jnp.maximum(jnp.var(particles, axis=0), 1e-10)

            def one(p, k):
                def body(carry, kk):
                    q, acc = carry
                    q, info = hmc_kernel(
                        tempered, q, kk, 0.05, inv_mass, num_leapfrog=8
                    )
                    return (q, acc + info.accept_prob), None

                (q, acc), _ = jax.lax.scan(
                    body, (p, jnp.zeros(())), jax.random.split(k, 5)
                )
                return q, acc / 5

            return jax.vmap(one)(
                particles, jax.random.split(key, npart)
            )

        return mutate

    for name, lp in [("smc_fused", lp_fused), ("smc_plain_ad", lp_plain),
                     ("smc_blocked_ad", lp_blocked)]:
        mut = make_mutation(lp)
        record(
            name,
            f"N={n} particles={npart} 5x8 leapfrogs",
            timeit(lambda: mut(parts0, key), repeat=5),
        )

    # ---- reference: one batched value+grad (the NUTS leapfrog cost) ----
    vag = lp_fused.value_and_grad
    thetas = parts0[:4]
    bat = jax.jit(lambda th: jax.vmap(vag)(th))
    record("vog_batch4", f"N={n} 4-chain value+grad", timeit(bat, thetas))

    if args.out:
        with open(args.out, "w") as f:
            f.write("path,config,time_ms\n")
            for p, c, ms in rows:
                f.write(f"{p},{c},{ms:.3f}\n")
        print("wrote", args.out)


if __name__ == "__main__":
    main()
