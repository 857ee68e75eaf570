#!/usr/bin/env python
"""Benchmark grid: (N, J) scaling of the solver backends + sampler rates.

Analog of the reference benchmark driver
(/root/reference/examples/benchmark/run.py): sweeps N = 2^minN..2^maxN and
J terms, timing factor+ll per backend, writing CSV.  Also measures NUTS
samples/s on a SHO fit (the metric BASELINE.json tracks).

Usage:
  python benchmarks/run.py --backends seq,blocked,fused,native \
      --minN 6 --maxN 20 --dtype float32 -o bench.csv
  python benchmarks/run.py --sampler -o sampler.csv
"""

from __future__ import annotations

import argparse
import os
import sys

# Allow running the script directly from a checkout without installation.
sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
import csv
import time

import numpy as np


def timer(fn, max_time=5.0, sync=None):
    """Adaptive wall-clock timer (reference celerite/timer.py analog).

    ``sync(out)``: drain async device dispatch (jax.block_until_ready).
    When given, iterations are submitted back-to-back and drained once —
    blocking per call would measure the host<->device round-trip, not
    device throughput.
    """
    out = fn()  # warmup / compile
    if sync is None:
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < 0.2 or k < 3:
            fn()
            k += 1
            if time.perf_counter() - t0 > max_time:
                break
        return (time.perf_counter() - t0) / k
    sync(out)
    t0 = time.perf_counter()
    sync(fn())
    est = time.perf_counter() - t0
    iters = max(3, min(200, int(1.0 / max(est, 1e-5))))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    sync(out)
    return (time.perf_counter() - t0) / iters


def make_kernel(terms_mod, j):
    """A kernel with 2*j semiseparable rank (j SHO terms)."""
    kernel = terms_mod.SHOTerm(
        log_S0=0.1, log_Q=1.0, log_omega0=0.5
    )
    for i in range(1, j):
        kernel = kernel + terms_mod.SHOTerm(
            log_S0=0.1 - 0.1 * i, log_Q=0.7, log_omega0=0.5 + 0.2 * i
        )
    return kernel


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default="bench.csv")
    ap.add_argument("--backends", default="seq,blocked,native")
    ap.add_argument("--minN", type=int, default=6)
    ap.add_argument("--maxN", type=int, default=18)
    ap.add_argument("--stepN", type=int, default=1)
    ap.add_argument("--terms", default="1,2,4")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--sampler", action="store_true")
    ap.add_argument("--carma", action="store_true")
    ap.add_argument("--grad", action="store_true")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from celerite_tpu import terms, native
    from celerite_tpu.ops import blocked, seq
    from celerite_tpu.ops.lower import Coefficients, lower

    dtype = jnp.dtype(args.dtype)
    backends = args.backends.split(",")
    rng = np.random.default_rng(42)

    if args.sampler:
        run_sampler_bench(args, jax, jnp, dtype)
        return
    if args.carma:
        run_carma_bench(args, jax, jnp, dtype)
        return
    if args.grad:
        run_grad_bench(args, jax, jnp, dtype)
        return

    rows = []
    for j in map(int, args.terms.split(",")):
        kernel = make_kernel(terms, j)
        coeffs_np = [np.asarray(c) for c in kernel.coefficients]
        for logn in range(args.minN, args.maxN + 1, args.stepN):
            n = 2**logn
            t = np.sort(rng.uniform(0, n / 1000.0, n))
            y = rng.standard_normal(n)
            diag = np.full(n, 0.01)

            coeffs = Coefficients(
                *[jnp.asarray(c, dtype) for c in coeffs_np],
                jitter=jnp.zeros((), dtype),
            )
            tj = jnp.asarray(t, dtype)
            dj = jnp.asarray(diag, dtype)
            yj = jnp.asarray(y, dtype)

            row = {"J": 2 * j, "N": n}
            for backend in backends:
                if backend == "native":
                    if not native.available():
                        continue
                    U, V, P, A = [
                        np.asarray(v)
                        for v in lower(
                            Coefficients(
                                *[jnp.asarray(c) for c in coeffs_np],
                                jitter=jnp.zeros(()),
                            ),
                            jnp.asarray(t),
                            jnp.asarray(diag),
                        )
                    ]
                    dt = timer(lambda: native.loglike(U, V, P, A, y))
                else:
                    from celerite_tpu.ops import fused

                    fn = {
                        "seq": seq.gp_log_likelihood,
                        "blocked": blocked.gp_log_likelihood,
                        "fused": fused.gp_log_likelihood,
                    }[backend]

                    @jax.jit
                    def ll(tj=tj, dj=dj, yj=yj, coeffs=coeffs, fn=fn):
                        ssm = lower(coeffs, tj, dj)
                        return fn(ssm, yj)[0]

                    dt = timer(ll, sync=jax.block_until_ready)
                row["{0}_time".format(backend)] = dt
            rows.append(row)
            print(row, flush=True)

    keys = ["J", "N"] + [
        "{0}_time".format(b) for b in backends
    ]
    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)


def run_grad_bench(args, jax, jnp, dtype):
    """value+grad timing sweep over model width (parameter count).

    The sampler-facing metric: NUTS cost is ~100% gradient evaluations.
    Reference analog: examples/benchmark/run.py grad mode producing
    benchmark_linux_grad.csv (forward-mode coefficient AD,
    /root/reference/celerite/solver.cpp:347-463); here the default is
    reverse-mode AD through the blocked solver (``fast_grad=True``) —
    cost independent of the parameter count.
    """
    from celerite_tpu import GP, terms

    rng = np.random.default_rng(42)

    def sho(i):
        return terms.SHOTerm(
            log_S0=0.1 - 0.2 * i, log_Q=1.0 - 0.2 * i,
            log_omega0=0.5 + 0.35 * i,
        )

    rows = []
    for nterms in map(int, args.terms.split(",")):
        kernel = sho(0)
        for i in range(1, nterms):
            kernel = kernel + sho(i)
        for logn in range(args.minN, args.maxN + 1, args.stepN):
            n = 2**logn
            t = np.sort(rng.uniform(0, n / 1000.0, n))
            yerr = np.full(n, 0.1)
            y = rng.standard_normal(n)
            gp = GP(kernel, mean=0.1, fit_mean=True)
            lp = gp.build_logprob(
                t, y, yerr=yerr, fast_grad=True,
                log_prior=lambda th: -0.5 * jnp.sum((th / 3.0) ** 2),
            )
            th = jnp.asarray(gp.get_parameter_vector(), dtype)
            vg = jax.jit(lp.value_and_grad)

            dt_grad = timer(lambda: vg(th), sync=jax.block_until_ready)
            ll_fn = jax.jit(lp)
            dt_val = timer(lambda: ll_fn(th), sync=jax.block_until_ready)
            row = {
                "n_params": int(th.shape[0]),
                "N": n,
                "value_time": dt_val,
                "value_grad_time": dt_grad,
            }
            rows.append(row)
            print(row, flush=True)

    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(
            f,
            fieldnames=["n_params", "N", "value_time", "value_grad_time"],
        )
        w.writeheader()
        w.writerows(rows)


def run_carma_bench(args, jax, jnp, dtype):
    """CARMA-vs-celerite agreement + timing sweep over model order.

    Reference analog: /root/reference/cpp/src/carma_comp.cc:64-111 — for
    each order p, time the CARMA(p, p-1) Kalman log-likelihood against
    the semiseparable log-likelihood after ``get_celerite_coeffs``
    conversion, asserting agreement.
    """
    from celerite_tpu.ops.carma import CARMASolver
    from celerite_tpu.solver import CholeskySolver

    rng = np.random.default_rng(42)
    n = 2 ** args.minN if args.minN > 6 else 1024
    t = np.sort(rng.uniform(0, n / 100.0, n))
    yerr = np.full(n, 0.1)
    y = rng.standard_normal(n)

    rows = []
    for p in map(int, args.terms.split(",")):
        # Stable AR polynomial via log-spaced positive parameters; MA
        # order q = p - 1 (the richest valid choice).
        arpars = list(0.5 + 0.1 * np.arange(p))
        mapars = list(0.1 + 0.05 * np.arange(max(p - 1, 0)))
        carma = CARMASolver(0.1, arpars, mapars)

        dt_kalman = timer(lambda: carma.log_likelihood(t, y, yerr))
        ll_kalman = float(carma.log_likelihood(t, y, yerr))

        coeffs = carma.get_celerite_coeffs()
        chol = CholeskySolver()

        def celerite_ll():
            chol.compute(0.0, *coeffs, t=t, diag=yerr**2)
            return -0.5 * (
                chol.dot_solve(y)
                + chol.log_determinant()
                + n * np.log(2 * np.pi)
            )

        dt_celerite = timer(celerite_ll)
        ll_celerite = float(celerite_ll())

        row = {
            "p": p,
            "N": n,
            "carma_time": dt_kalman,
            "celerite_time": dt_celerite,
            "ll_agree": abs(ll_kalman - ll_celerite)
            / max(abs(ll_kalman), 1.0),
        }
        rows.append(row)
        print(row, flush=True)

    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(
            f,
            fieldnames=["p", "N", "carma_time", "celerite_time",
                        "ll_agree"],
        )
        w.writeheader()
        w.writerows(rows)


def run_sampler_bench(args, jax, jnp, dtype):
    from celerite_tpu import GP, terms
    from celerite_tpu.inference import sample_nuts

    rng = np.random.default_rng(0)
    n = 1024
    t = np.sort(rng.uniform(0, 30, n))
    yerr = np.full(n, 0.25)
    gsim = GP(terms.SHOTerm(log_S0=0.3, log_Q=1.2, log_omega0=0.7))
    gsim.compute(t, yerr)
    y = gsim.sample(seed=3)

    gp = GP(terms.SHOTerm(log_S0=0.0, log_Q=0.5, log_omega0=0.5))
    gp.compute(t, yerr)
    lp = gp.build_logprob(
        t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * jnp.sum((th / 3.0) ** 2),
    )
    n_chains = 8
    init = jnp.asarray(
        gp.get_parameter_vector()[None, :]
        + 0.05 * rng.standard_normal((n_chains, 3))
    )

    t0 = time.perf_counter()
    chain, info = sample_nuts(
        lp, init, jax.random.PRNGKey(0), num_warmup=300, num_samples=300
    )
    jax.block_until_ready(chain)
    dt = time.perf_counter() - t0
    total = n_chains * 300
    print(
        {
            "samples_per_s": total / dt,
            "leapfrogs": int(info["num_steps"]),
            "accept": float(info["accept_prob"]),
        }
    )


if __name__ == "__main__":
    main()
