#!/usr/bin/env python
"""BENCH: fleet-scale fitting on one GPU (BASELINE configs[4]).

Two measurements at >=4k light curves (SHO kernel):

1. fleet gradient throughput — the fleet-summed log-likelihood +
   gradient for ALL curves (data.make_fleet_loglik, the vmapped masked
   scan): curves/s per population-fit gradient.

2. per-curve independent NUTS fits — every curve gets its own
   3-parameter posterior, vmapped across the whole fleet
   (inference.sample_nuts_batch over the problem axis, sequential-scan
   likelihood: at N~150 the scan vmaps to a (B*chains, ...) batch the
   compiler tiles natively): end-to-end curves/s for full MCMC fits.

Writes one JSON line per measurement; results go to ``--out``.
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
    ap.add_argument("--curves", type=int, default=4096)
    ap.add_argument("--nmin", type=int, default=96)
    ap.add_argument("--nmax", type=int, default=160)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--chains", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--out", default="benchmarks/results/fleet_gpu.json")
    args = ap.parse_args()

    from celerite_tpu import terms
    from celerite_tpu.data import LightCurveBatch, make_fleet_loglik
    from celerite_tpu.inference import sample_nuts_batch
    from celerite_tpu.ops.lower import Coefficients
    from celerite_tpu.ops.smoother import sample_prior
    from celerite_tpu.ops import seq
    from celerite_tpu.ops.lower import lower
    from celerite_tpu.utils import enable_persistent_cache

    enable_persistent_cache()  # one-time compiles cache to disk

    B = args.curves
    rng = np.random.default_rng(4)
    truth = np.array([0.0, 1.5, np.log(3.0)])  # log_S0, log_Q, log_w0
    kernel = terms.SHOTerm(
        log_S0=truth[0], log_Q=truth[1], log_omega0=truth[2]
    )
    kc = Coefficients(
        *[np.asarray(c) for c in kernel.coefficients],
        jitter=kernel.jitter,
    )

    print(f"simulating {B} curves...", flush=True)
    ts, ys, es = [], [], []
    for i in range(B):
        n = int(rng.integers(args.nmin, args.nmax + 1))
        t = np.sort(rng.uniform(0, 20, n))
        e = rng.uniform(0.1, 0.2, n)
        y = sample_prior(kc, t, seed=1000 + i) + e * rng.standard_normal(n)
        ts.append(t)
        ys.append(y)
        es.append(e)
    batch = LightCurveBatch.from_ragged(ts, ys, es)
    nmax = batch.t.shape[1]
    results = []

    # ---- 1. fleet gradient: all curves at once ----
    fleet_ll = make_fleet_loglik(kernel, batch)

    @jax.jit
    def fleet_vg(theta):
        def f(th):
            lls, oks = fleet_ll(th)
            return jnp.sum(jnp.where(oks, lls, -jnp.inf))
        return jax.value_and_grad(f)(theta)

    th0 = jnp.asarray(truth, jnp.float32)
    out = jax.block_until_ready(fleet_vg(th0))
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        out = fleet_vg(th0)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    rec1 = {
        "metric": "fleet_grad_curves_per_s",
        "value": round(B / dt, 1),
        "unit": "curves/s",
        "curves": B,
        "nmax": nmax,
        "launch_ms": round(1e3 * dt, 3),
        "note": "fleet-summed ll+grad, vmapped masked scan",
    }
    print(json.dumps(rec1), flush=True)
    results.append(rec1)

    # ---- 2. per-curve independent NUTS fits ----
    data_batch = {
        "t": jnp.asarray(batch.t, jnp.float32),
        "y": jnp.asarray(batch.y, jnp.float32),
        "diag": jnp.asarray(batch.yerr, jnp.float32) ** 2,
        "mask": jnp.asarray(batch.mask, jnp.float32),
        "n": jnp.asarray(batch.lengths, jnp.float32),
    }
    pr, pc = kernel.padded_size

    def logprob(data, theta):
        coeffs = Coefficients(
            *[c.astype(jnp.float32)
              for c in kernel.get_padded_coefficients(theta)],
            jitter=kernel.get_jitter(theta).astype(jnp.float32),
        )
        # Masked padded lowering: padded tail points carry zero dt and
        # zero data; their ll contribution is the (constant) log of the
        # diag, removed via the mask-corrected constant below.
        ssm = lower(coeffs, data["t"], data["diag"])
        resid = (data["y"]) * data["mask"]
        ll, ok = seq.gp_log_likelihood_masked(
            ssm, resid, data["mask"], data["n"]
        )
        lp = -0.5 * jnp.sum((theta / 3.0) ** 2)
        total = lp + jnp.where(ok, ll, -jnp.inf)
        return jnp.where(jnp.isfinite(total), total, -jnp.inf)

    init = jnp.asarray(
        truth[None, None, :]
        + 0.05 * rng.standard_normal((B, args.chains, 3)),
        jnp.float32,
    )
    t0 = time.perf_counter()
    chains, info = sample_nuts_batch(
        logprob, data_batch, init, jax.random.PRNGKey(0),
        num_warmup=args.warmup, num_samples=args.samples,
        max_tree_depth=7, warmup_max_tree_depth=6,
        chunk_size=args.chunk,
    )
    jax.block_until_ready(chains)
    wall = time.perf_counter() - t0
    post_mean = np.asarray(jnp.mean(chains, axis=(1, 2)))  # (B, 3)
    fleet_mean = post_mean.mean(axis=0)
    rec2 = {
        "metric": "fleet_nuts_curves_per_s",
        "value": round(B / wall, 2),
        "unit": "curves/s",
        "curves": B,
        "chains_per_curve": args.chains,
        "warmup": args.warmup,
        "samples": args.samples,
        "wall_s": round(wall, 1),
        "fleet_posterior_mean": [round(float(x), 3) for x in fleet_mean],
        "truth": [round(float(x), 3) for x in truth],
        "divergence_frac": round(
            float(np.sum(np.asarray(info["divergences"])))
            / (B * args.chains * args.samples), 4,
        ),
    }
    print(json.dumps(rec2), flush=True)
    results.append(rec2)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
