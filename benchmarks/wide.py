#!/usr/bin/env python
"""Wide-model (large-J) sweep on one GPU: the reference's J axis, covered.

Mirrors the reference benchmark grid's J dimension
(/root/reference/examples/benchmark/run.py: j = 2^0..2^8 with rank 2j;
anchor row `8,8,256,16384` = rank 512 at N=16384, 5.64 s on the
reference CPU).  Above the Triton kernels' width (P <= 8) the
block-parallel lax solver runs the cross-block Riccati composes as real
(P, P) matmuls — this sweep times its primal and AD
value+grad, plus the sequential scan for comparison, and reports f32
accuracy vs the native C++ f64 oracle.

Two-phase (the timed run stays in float32):
  1. python benchmarks/wide.py --make-oracles   (CPU, f64 oracle JSON)
  2. python benchmarks/wide.py                  (GPU timing + accuracy)

Writes CSV: P,N,backend,primal_ms,grad_ms,rel_err_vs_f64.
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

ORACLE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "results", "wide_oracles.json",
)


def make_wide_kernel(terms_mod, j):
    """j SHO terms (rank 2j), amplitude-normalized so the summed process
    variance stays O(1) at any width — keeps the f32 conditioning
    representative of a real multi-mode fit, not an adversarial stack."""
    base = -float(np.log(j))
    kernel = terms_mod.SHOTerm(
        log_S0=base, log_Q=1.0, log_omega0=0.0
    )
    for i in range(1, j):
        kernel = kernel + terms_mod.SHOTerm(
            log_S0=base - 0.02 * i, log_Q=0.7,
            log_omega0=0.05 * i + 0.1,
        )
    return kernel


def make_data(P, n):
    rng = np.random.default_rng(P * 1000003 + n)
    t = np.sort(rng.uniform(0, n / 100.0, n))
    y = rng.standard_normal(n)
    diag = np.full(n, 0.1)
    return t, y, diag


def timer(fn, sync, repeat=5):
    out = sync(fn())
    t0 = time.perf_counter()
    for _ in range(repeat):
        out = fn()
    sync(out)
    return (time.perf_counter() - t0) / repeat


def grid(args):
    for P in map(int, args.ranks.split(",")):
        for logn in range(args.minN, args.maxN + 1, 2):
            yield P, 2**logn


def make_oracles(args):
    """CPU/f64 phase: native C++ oracle log-likelihoods per config."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from celerite_tpu import terms, native
    from celerite_tpu.ops.lower import Coefficients, lower
    from celerite_tpu.utils import enable_persistent_cache

    enable_persistent_cache()  # one-time compiles cache to disk

    assert native.available(), "native toolchain required for oracles"
    out = {}
    for P, n in grid(args):
        if n * P * P > 2**33:
            continue
        kernel = make_wide_kernel(terms, P // 2)
        t, y, diag = make_data(P, n)
        U, V, Ph, A = [
            np.asarray(v) for v in lower(
                Coefficients(
                    *[jnp.asarray(np.asarray(c)) for c in
                      kernel.coefficients],
                    jitter=jnp.zeros(()),
                ),
                jnp.asarray(t), jnp.asarray(diag),
            )
        ]
        ll, ok = native.loglike(U, V, Ph, A, y)
        assert ok, (P, n)
        out[f"{P}_{n}"] = ll
        print(f"P={P} N={n}: ll64={ll:.4f}", flush=True)
    with open(ORACLE_PATH, "w") as f:
        json.dump(out, f, indent=0)
    print("wrote", ORACLE_PATH)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output",
                    default="benchmarks/results/gpu_wide.csv")
    ap.add_argument("--budget", type=float, default=5.0,
                    help="skip larger N for a width once primal+grad "
                         "exceeds this (reference run.py early-exit)")
    ap.add_argument("--ranks", default="16,32,64,128,256,512")
    ap.add_argument("--minN", type=int, default=12)
    ap.add_argument("--maxN", type=int, default=18)
    ap.add_argument("--make-oracles", action="store_true")
    args = ap.parse_args()

    if args.make_oracles:
        make_oracles(args)
        return

    import jax
    import jax.numpy as jnp

    from celerite_tpu import terms
    from celerite_tpu.ops import blocked, seq
    from celerite_tpu.ops.lower import Coefficients, lower

    oracles = {}
    if os.path.exists(ORACLE_PATH):
        with open(ORACLE_PATH) as f:
            oracles = json.load(f)

    sync = jax.block_until_ready
    rows = []
    over_budget = set()

    for P, n in grid(args):
        if P in over_budget:
            continue
        kernel = make_wide_kernel(terms, P // 2)
        coeffs_np = [np.asarray(c) for c in kernel.coefficients]
        t, y, diag = make_data(P, n)
        ll64 = oracles.get(f"{P}_{n}")

        for backend in ("blocked", "seq"):
            if backend == "seq" and P > 64:
                continue  # latency-bound, measured slower at all P
            print(f"... P={P} N={n} {backend}: compiling", flush=True)
            coeffs = Coefficients(
                *[jnp.asarray(c, jnp.float32) for c in coeffs_np],
                jitter=jnp.zeros((), jnp.float32),
            )
            tj = jnp.asarray(t, jnp.float32)
            dj = jnp.asarray(diag, jnp.float32)
            yj = jnp.asarray(y, jnp.float32)
            fn = {"blocked": blocked.gp_log_likelihood,
                  "seq": seq.gp_log_likelihood}[backend]

            @jax.jit
            def ll():
                ssm = lower(coeffs, tj, dj)
                return fn(ssm, yj)[0]

            @jax.jit
            def vg():
                def f(c0):
                    cf = coeffs._replace(
                        a_real=coeffs.a_real * jnp.exp(c0),
                        a_comp=coeffs.a_comp * jnp.exp(c0),
                        b_comp=coeffs.b_comp * jnp.exp(c0),
                    )
                    ssm = lower(cf, tj, dj)
                    return fn(ssm, yj)[0]
                return jax.value_and_grad(f)(
                    jnp.zeros((), jnp.float32)
                )

            try:
                t_p = timer(ll, sync)
                t_g = timer(vg, sync)
            except Exception as e:  # OOM and friends: record + move on
                print(f"P={P} N={n} {backend}: FAIL {e}", flush=True)
                continue
            val = float(ll())
            rel = (
                abs(val - ll64) / max(abs(ll64), 1.0)
                if ll64 is not None else np.nan
            )
            row = dict(P=P, N=n, backend=backend,
                       primal_ms=round(1e3 * t_p, 3),
                       grad_ms=round(1e3 * t_g, 3),
                       rel_err_vs_f64=(
                           f"{rel:.2e}" if np.isfinite(rel) else ""
                       ))
            rows.append(row)
            print(row, flush=True)
            if backend == "blocked" and (t_p + t_g) > args.budget:
                over_budget.add(P)

    import csv

    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(
            f, fieldnames=["P", "N", "backend", "primal_ms", "grad_ms",
                           "rel_err_vs_f64"]
        )
        w.writeheader()
        w.writerows(rows)
    print("wrote", args.output)


if __name__ == "__main__":
    main()
