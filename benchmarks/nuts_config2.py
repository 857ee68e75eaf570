#!/usr/bin/env python
"""BENCH: config[2] NUTS end-to-end throughput on one GPU.

The asteroseismic granulation model (BASELINE configs[2]): 2 SHOTerms +
JitterTerm (7 params), N=1e5 points, 4 chains.
Measures post-warmup sampling throughput (the north-star samples/s
metric), with warmup and compile accounted separately.

Reference anchor: the reference's Ex.4 asteroseismology MCMC does 640k
evals in ~10 CPU-min = ~1.1k evals/s at N=1,440 (paper/figures/
example-stats.tex:10), i.e. ~2.4 effective samples/min; here N is 70x
larger and the sampler delivers tens of samples/s.

Writes one JSON line (BENCH-style) and optionally a results file.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np
import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument(
        "--sampling-chains", type=int, default=None,
        help="run the SAMPLING phase at this many chains (a multiple "
             "of --chains): warmup adapts step size/mass at the small "
             "chain count, then the sampling chains start from tiled "
             "warmup end states (draws from the stationary "
             "distribution) — amortizing the warmup wall clock over a "
             "wider vmapped batch",
    )
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--samples", type=int, default=600)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--target-accept", type=float, default=0.8)
    ap.add_argument(
        "--dense-mass", action="store_true",
        help="adapt a full (dim, dim) inverse mass matrix "
             "(pooled cross moments) instead of the diagonal",
    )
    ap.add_argument(
        "--precision", choices=["f32", "ds"], default="f32",
        help="likelihood/gradient kernels: native f32 or the "
             "double-single exact mode",
    )
    ap.add_argument(
        "--sampler", choices=["nuts", "hmc"], default="nuts",
        help="sampling-phase kernel (warmup adaptation is always "
             "NUTS).  hmc: fixed-budget jittered trajectories - no "
             "per-chain tree-depth variance, so vmapped chains stay in "
             "lockstep with zero padding waste",
    )
    ap.add_argument("--hmc-leapfrog", type=int, default=16)
    ap.add_argument(
        "--fast-compile", action="store_true",
        help="blocked solver with plain AD (GP.build_loglik "
             "fast_compile)",
    )
    ap.add_argument(
        "--cpu-f64", action="store_true",
        help="run on the host CPU in float64 (attribution experiment: "
             "is the divergence floor f32 noise or true geometry?)",
    )
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    if args.cpu_f64:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from celerite_tpu import GP, terms
    from celerite_tpu.inference.nuts import _build_segments
    from celerite_tpu.inference.adaptation import (
        da_final,
        window_boundaries,
    )
    from celerite_tpu.utils import enable_persistent_cache

    enable_persistent_cache()  # one-time compiles cache to disk
    from celerite_tpu.ops.lower import Coefficients
    from celerite_tpu.ops.smoother import sample_prior

    n, chains = args.n, args.chains
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0, 100.0, n))
    yerr = np.full(n, 0.3)
    kernel_true = (
        terms.SHOTerm(log_S0=0.5, log_Q=np.log(1 / np.sqrt(2)),
                      log_omega0=0.0)
        + terms.SHOTerm(log_S0=-1.0, log_Q=2.5, log_omega0=1.8)
        + terms.JitterTerm(log_sigma=-1.5)
    )
    kc = Coefficients(
        *[np.asarray(c) for c in kernel_true.coefficients],
        jitter=kernel_true.jitter,
    )
    y = (
        sample_prior(kc, t, seed=2)
        + np.sqrt(yerr**2 + kernel_true.jitter)
        * rng.standard_normal(n)
    )

    kernel = (
        terms.SHOTerm(log_S0=0.2, log_Q=-0.3, log_omega0=0.2)
        + terms.SHOTerm(log_S0=-0.7, log_Q=2.0, log_omega0=1.6)
        + terms.JitterTerm(log_sigma=-1.0)
    )
    gp = GP(kernel)
    logprob = gp.build_logprob(
        t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * jnp.sum((th / 3.0) ** 2),
        precision=None if args.precision == "f32" else args.precision,
        fast_compile=args.fast_compile,
    )
    dim = gp.vector_size
    dtype = jnp.result_type(float)

    _lpd = lambda data, th: logprob(th)
    _vag = getattr(logprob, "value_and_grad", None)
    if _vag is not None:
        _lpd.value_and_grad = lambda data, th: _vag(th)
    init_carry, warm_seg, samp_seg, _, _ = _build_segments(
        _lpd, chains, dim, dtype, 8, args.target_accept,
        warmup_max_tree_depth=6, dense_mass=args.dense_mass,
    )
    warm = jax.jit(
        lambda c, k, mf, ef: warm_seg(None, c, k, mf, ef)
    )
    if args.sampler == "hmc":
        from jax import lax

        from celerite_tpu.inference.hmc import hmc_kernel

        L = args.hmc_leapfrog
        _hmc_lp = lambda th: logprob(th)
        if _vag is not None:
            _hmc_lp.value_and_grad = _vag

        def hmc_segment(qs, keys, eps, im):
            n_ch = qs.shape[0]

            def one_step(qs, key):
                # ONE jittered trajectory length per transition, shared
                # by every chain: per-chain jitter under vmap pays the
                # max length while using the mean (the same padding
                # waste NUTS trees have); a shared draw keeps the
                # resonance-avoiding decorrelation with zero padding.
                k_n, key = jax.random.split(key)
                n = jax.random.randint(k_n, (), L // 2 + 1, L + 1)
                ks = jax.random.split(key, n_ch)
                qs, info = jax.vmap(
                    lambda q, k: hmc_kernel(
                        _hmc_lp, q, k, eps, im, num_leapfrog=n,
                        jitter=False,
                    )
                )(qs, ks)
                # same output tuple shape as the NUTS sample segment:
                # (chain, accept, divergences, steps, energy)
                return qs, (
                    qs, info.accept_prob,
                    jnp.zeros_like(info.accepted),
                    jnp.full((n_ch,), L, jnp.int32),
                    info.energy,
                )

            return lax.scan(one_step, qs, keys)

        samp = jax.jit(hmc_segment)
    else:
        samp = jax.jit(
            lambda qs, k, eps, im: samp_seg(None, qs, k, eps, im)
        )

    init = jnp.asarray(
        gp.get_parameter_vector()[None, :]
        + 0.02 * rng.standard_normal((chains, dim))
    )
    mass_win, win_end = window_boundaries(args.warmup)
    key = jax.random.PRNGKey(0)
    key, k_warm, k_samp = jax.random.split(key, 3)
    warm_keys = jax.random.split(k_warm, args.warmup)
    samp_keys = jax.random.split(k_samp, args.samples)

    # Warmup, chunked (first chunk includes the warm-segment compile).
    t0 = time.perf_counter()
    carry = init_carry(init, 0.1)
    for lo in range(0, args.warmup, args.chunk):
        hi = min(lo + args.chunk, args.warmup)
        carry, _ = warm(
            carry, warm_keys[lo:hi], mass_win[lo:hi], win_end[lo:hi]
        )
        # Block per chunk: long sampler runs through the remote runtime
        # must not queue an unbounded async dispatch stream (observed:
        # worker crash mid-stream on the ds run), and the per-chunk
        # prints give progress + crash isolation.
        jax.block_until_ready(carry[0])
        if lo == 0:
            t_compile_warm = time.perf_counter() - t0
            t0 = time.perf_counter()
        print(f"warmup {hi}/{args.warmup} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
    qs, da, wf, inv_mass = jax.block_until_ready(carry)
    t_warm = time.perf_counter() - t0
    eps = da_final(da)

    if args.sampling_chains:
        if args.sampler != "hmc":
            raise SystemExit(
                "--sampling-chains requires --sampler hmc (the NUTS "
                "segment is built at the warmup chain count)"
            )
        if args.sampling_chains % chains:
            raise SystemExit(
                "--sampling-chains must be a multiple of --chains"
            )
        reps = args.sampling_chains // chains
        # Warmup end states are draws from the (adapted) stationary
        # distribution; tiling them starts every sampling chain in
        # equilibrium.  Duplicates decorrelate within the first chunk,
        # which is excluded from the timed ESS accounting below.
        qs = jnp.tile(qs, (reps, 1))
        chains = args.sampling_chains

    # Sampling: first chunk = compile + run; remaining chunks timed.
    t0 = time.perf_counter()
    qs, out0 = samp(qs, samp_keys[: args.chunk], eps, inv_mass)
    jax.block_until_ready(qs)
    t_compile_samp = time.perf_counter() - t0

    t0 = time.perf_counter()
    chunks = [out0[0]]
    divs = [jnp.sum(out0[2])]
    steps = [jnp.sum(out0[3])]
    n_timed = 0
    for lo in range(args.chunk, args.samples, args.chunk):
        hi = min(lo + args.chunk, args.samples)
        qs, (c, a, d, s, e) = samp(
            qs, samp_keys[lo:hi], eps, inv_mass
        )
        chunks.append(c)
        divs.append(jnp.sum(d))
        steps.append(jnp.sum(s))
        n_timed += hi - lo
        jax.block_until_ready(qs)
        print(f"sampling {hi}/{args.samples} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
    t_samp = time.perf_counter() - t0

    chain = np.asarray(jnp.concatenate(chunks, axis=0))
    total_steps = int(sum(int(x) for x in steps))
    total_div = int(sum(int(x) for x in divs))

    samples_per_s = chains * n_timed / t_samp
    # End-to-end: warmup + all sampling, excluding one-time compiles.
    e2e = chains * args.samples / (
        t_warm + t_samp + (t_compile_samp if n_timed == 0 else 0.0)
    )

    from celerite_tpu.inference import summary

    stats = summary(np.swapaxes(chain, 0, 1))
    print(
        f"warmup {args.warmup} transitions: {t_warm:.1f}s "
        f"(+{t_compile_warm:.1f}s first-chunk incl. compile)"
    )
    print(
        f"sampling: {chains * n_timed} samples in {t_samp:.1f}s "
        f"= {samples_per_s:.1f} samples/s post-warmup "
        f"({total_steps} leapfrogs, {total_div} divergences)"
    )
    print(
        f"step_size={float(eps):.4f} max rhat="
        f"{float(np.max(stats['rhat'])):.3f} min ess="
        f"{float(np.min(stats['ess'])):.0f}"
    )
    # Honest effective-sample accounting: min-ESS computed over the
    # *timed* draws only (the first chunk's draws are excluded — their
    # wall clock includes the compile) divided by the timed wall clock.
    # (The old "vs_reference_ex4_eff_samples_per_min" compared RAW
    # samples/s against the reference's EFFECTIVE rate — apples to
    # oranges.)
    stats_timed = summary(np.swapaxes(chain[args.chunk:], 0, 1))
    min_ess = float(np.min(stats_timed["ess"]))
    min_ess_per_s = min_ess / t_samp
    n_draws = (chain.shape[0] - args.chunk) * chain.shape[1]
    rec = {
        "metric": "nuts_config2_min_ess_per_s",
        "value": round(min_ess_per_s, 2),
        "unit": "ess/s",
        "samples_per_s_postwarmup": round(samples_per_s, 2),
        "n": n,
        "chains": chains,
        "warmup_chains": args.chains,
        "dim": dim,
        "target_accept": args.target_accept,
        "dense_mass": bool(args.dense_mass),
        "precision": "f64" if args.cpu_f64 else args.precision,
        "fast_compile": bool(args.fast_compile),
        "platform": jax.default_backend(),
        "sampler": args.sampler,
        "hmc_leapfrog": (
            args.hmc_leapfrog if args.sampler == "hmc" else None
        ),
        "warmup_wall_s": round(t_warm, 2),
        "sampling_wall_s": round(t_samp, 2),
        "compile_wall_s": round(t_compile_warm + t_compile_samp, 2),
        "end_to_end_samples_per_s": round(e2e, 2),
        "divergences": total_div,
        "divergence_rate": round(
            total_div / max(chain.shape[0] * chain.shape[1], 1), 4
        ),
        "max_rhat": round(float(np.max(stats["rhat"])), 4),
        "min_ess": round(min_ess, 1),
        "ess_efficiency": round(min_ess / max(n_draws, 1), 4),
        # reference Ex.4 effective rate: ~2.4 eff samples/min = 0.04
        # eff/s at N=1,440 (paper/figures/example-stats.tex:10); ours
        # is measured at N 70x larger.
        "vs_reference_ex4_min_ess_per_s": round(
            min_ess_per_s / (2.4 / 60.0), 1
        ),
    }
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
