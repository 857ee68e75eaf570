"""The No-U-Turn Sampler, iterative formulation.

A from-scratch implementation of multinomial NUTS (Hoffman & Gelman 2014;
Betancourt 2017 multinomial weighting; the iterative tree construction of
Phan & Pradhan 2019) designed for XLA: fixed ``max_tree_depth``, no
recursion, no dynamic shapes, fully vmap-able over chains.

Within a doubling, the 2^d new leapfrog states stream through an
early-exiting ``while_loop`` (stopping at the first U-turn or
divergence); sub-tree U-turn checks use O(max_depth) checkpoint slots
addressed by trailing-zero/trailing-one bit counts of the leaf index, so
every binary sub-tree of the trajectory is checked exactly once, matching
the recursive algorithm.

All momenta live on one simulated trajectory (backward expansion uses a
negative step, which yields time-reversed points with their *true*
momenta), so momentum sums compose across doublings without sign fixups.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["NUTSInfo", "nuts_kernel", "sample_nuts",
           "sample_nuts_batch", "find_reasonable_step_size"]

# Jitted warmup/sample segments keyed by (logprob_fn, static config).
# ``sample_nuts`` rebuilds its segment closures on every call; without
# this cache each call re-traces and re-compiles them (minutes-scale
# for large-N kernels).  Keying on the *user's* logprob object means
# repeated calls with the same held logprob (e.g. a ``build_logprob``
# result) hit the jit cache; a logprob rebuilt per call still re-traces,
# which is unavoidable (its closure constants differ).
_segment_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _cached_segments(logprob_fn, cfg, builder):
    try:
        per_fn = _segment_cache.get(logprob_fn)
        if per_fn is None:
            per_fn = {}
            _segment_cache[logprob_fn] = per_fn
    except TypeError:  # not weak-referenceable; build fresh
        return builder()
    if cfg not in per_fn:
        per_fn[cfg] = builder()
    return per_fn[cfg]


class NUTSInfo(NamedTuple):
    accept_prob: jnp.ndarray  # mean Metropolis accept stat over the tree
    num_steps: jnp.ndarray  # leapfrog steps taken
    tree_depth: jnp.ndarray
    diverging: jnp.ndarray
    energy: jnp.ndarray  # Hamiltonian H = -logp + kinetic at the accepted
    # point (Stan/numpyro convention; feed the series to
    # diagnostics.ebfmi for energy diagnostics)
    logp: jnp.ndarray  # log probability at the accepted point


def _popcount(x):
    return jax.lax.population_count(x)


def _trailing_zeros(n):
    """Trailing zero bits; returns a large value for n == 0."""
    return _popcount((n & -n) - 1)


def _velocity(inv_mass, p):
    """dq/dt = M^-1 p for a diagonal (vector) or dense (matrix) metric."""
    if inv_mass.ndim == 2:
        return jnp.matmul(inv_mass, p, precision="highest")
    return inv_mass * p


def _velocity_rows(inv_mass, P):
    """Velocity of a batch of momenta (rows of ``P``)."""
    if inv_mass.ndim == 2:
        # symmetric, so right-multiply works
        return jnp.matmul(P, inv_mass, precision="highest")
    return inv_mass[None, :] * P


def _sample_momentum(key, dim, dtype, inv_mass):
    """p ~ N(0, M) with M = inv_mass^-1 (so that cov of velocity draws
    matches the target scale).  Dense path: inv_mass = L L^T =>
    p = L^-T xi has covariance (L L^T)^-1 = M."""
    xi = jax.random.normal(key, (dim,), dtype)
    if inv_mass.ndim == 2:
        L = jnp.linalg.cholesky(inv_mass)
        return jax.scipy.linalg.solve_triangular(L.T, xi, lower=False)
    return xi / jnp.sqrt(inv_mass)


def _leapfrog(grad_fn, q, p, grad, eps, inv_mass):
    p = p - 0.5 * eps * grad
    q = q + eps * _velocity(inv_mass, p)
    new_grad, logp = grad_fn(q)
    p = p - 0.5 * eps * new_grad
    return q, p, new_grad, logp


def find_reasonable_step_size(logprob_fn, q, key, inv_mass=None,
                              initial=1.0, max_iters=30):
    """Double/halve eps until one leapfrog's accept ratio crosses 1/2.

    Hoffman & Gelman (2014) algorithm 4 — a handful of gradient
    evaluations that prevent warmup from opening with maximum-depth
    trees when the default step size is orders of magnitude off.
    Jittable; honors a fused ``value_and_grad`` attribute.
    """
    dim = q.shape[0]
    dtype = q.dtype
    if inv_mass is None:
        inv_mass = jnp.ones((dim,), dtype)
    inv_mass = jnp.asarray(inv_mass, dtype)
    if inv_mass.ndim < 2:
        inv_mass = jnp.broadcast_to(inv_mass, (dim,))
    vag = getattr(logprob_fn, "value_and_grad", None)

    def grad_fn(x):
        if vag is not None:
            logp, g = vag(x)
        else:
            logp, g = jax.value_and_grad(logprob_fn)(x)
        return -g, logp

    grad0, logp0 = grad_fn(q)
    p0 = _sample_momentum(key, dim, dtype, inv_mass)
    h0 = -logp0 + 0.5 * jnp.sum(p0 * _velocity(inv_mass, p0))

    def log_ratio(eps):
        _, pn, _, logpn = _leapfrog(grad_fn, q, p0, grad0, eps, inv_mass)
        h1 = -logpn + 0.5 * jnp.sum(pn * _velocity(inv_mass, pn))
        r = h0 - h1
        return jnp.where(jnp.isnan(r), -jnp.inf, r)

    eps = jnp.asarray(initial, dtype)
    direction = jnp.where(log_ratio(eps) > jnp.log(0.5), 1.0, -1.0)

    def cond(c):
        eps, i = c
        # while (accept ratio)^a > 2^(-a): keep moving in direction a
        keep = direction * log_ratio(eps) > direction * jnp.log(0.5)
        return keep & (i < max_iters)

    def body(c):
        eps, i = c
        return eps * jnp.exp2(direction).astype(dtype), i + 1

    eps, _ = jax.lax.while_loop(cond, body, (eps, jnp.zeros((), jnp.int32)))
    return eps


def nuts_kernel(
    logprob_fn,
    q,
    key,
    step_size,
    inv_mass,
    max_tree_depth=10,
    divergence_threshold=1000.0,
):
    """One NUTS transition.  Returns (q_new, NUTSInfo)."""
    dim = q.shape[0]
    dtype = q.dtype
    eps = jnp.asarray(step_size, dtype)
    inv_mass = jnp.asarray(inv_mass, dtype)
    if inv_mass.ndim < 2:
        inv_mass = jnp.broadcast_to(inv_mass, (dim,))

    # A logprob_fn carrying a ``value_and_grad`` attribute supplies both
    # in one pass (e.g. GP.build_logprob on the fused route); otherwise
    # fall back to AD.
    vag = getattr(logprob_fn, "value_and_grad", None)

    def grad_fn(q):
        if vag is not None:
            logp, g = vag(q)
        else:
            logp, g = jax.value_and_grad(logprob_fn)(q)
        return -g, logp  # gradient of potential U = -logp

    key, k_mom = jax.random.split(key)
    p0 = _sample_momentum(k_mom, dim, dtype, inv_mass)
    grad0, logp0 = grad_fn(q)
    h0 = -logp0 + 0.5 * jnp.sum(p0 * _velocity(inv_mass, p0))

    def kinetic_vec(psum):
        return _velocity(inv_mass, psum)

    # Tree state carried across doublings.
    class _T(NamedTuple):
        key: jnp.ndarray
        q_left: jnp.ndarray
        p_left: jnp.ndarray
        grad_left: jnp.ndarray
        q_right: jnp.ndarray
        p_right: jnp.ndarray
        grad_right: jnp.ndarray
        psum: jnp.ndarray
        q_prop: jnp.ndarray
        logp_prop: jnp.ndarray
        h_prop: jnp.ndarray  # Hamiltonian at the proposal point
        log_weight: jnp.ndarray  # log sum of exp(h0 - h) over tree
        sum_accept: jnp.ndarray
        num_steps: jnp.ndarray
        depth: jnp.ndarray
        turning: jnp.ndarray
        diverging: jnp.ndarray

    init = _T(
        key=key,
        q_left=q, p_left=p0, grad_left=grad0,
        q_right=q, p_right=p0, grad_right=grad0,
        psum=p0,
        q_prop=q, logp_prop=logp0, h_prop=h0,
        log_weight=jnp.zeros((), dtype),
        sum_accept=jnp.zeros((), dtype),
        num_steps=jnp.zeros((), jnp.int32),
        depth=jnp.zeros((), jnp.int32),
        turning=jnp.zeros((), bool),
        diverging=jnp.zeros((), bool),
    )

    def build_subtree(key, z0, eps_signed, n_leaves, depth):
        """Stream n_leaves leapfrog states; returns subtree summary.

        Checkpoint slots implement the iterative U-turn bookkeeping: leaf n
        opens level-j spans for all j <= tz(n) (storing its state and the
        pre-leaf momentum prefix), and closes level-j spans for
        j <= tz(n + 1), at which point that span's U-turn test runs.
        """
        q0, p0_, g0 = z0
        md = max_tree_depth

        class _S(NamedTuple):
            key: jnp.ndarray
            q: jnp.ndarray
            p: jnp.ndarray
            grad: jnp.ndarray
            psum: jnp.ndarray
            ckpt_q: jnp.ndarray  # (md, dim) span-start positions (unused in
            ckpt_p: jnp.ndarray  # the test but kept for clarity) / momenta
            ckpt_psum: jnp.ndarray  # (md, dim) momentum prefix before span
            q_prop: jnp.ndarray
            logp_prop: jnp.ndarray
            h_prop: jnp.ndarray
            log_weight: jnp.ndarray
            sum_accept: jnp.ndarray
            q_first: jnp.ndarray
            p_first: jnp.ndarray
            grad_first: jnp.ndarray
            turning: jnp.ndarray
            diverging: jnp.ndarray

        def leaf_step(n, s):
            qn, pn, gn, logpn = _leapfrog(
                grad_fn, s.q, s.p, s.grad, eps_signed, inv_mass
            )
            h = -logpn + 0.5 * jnp.sum(pn * _velocity(inv_mass, pn))
            delta_h = h - h0
            # NaN energy (e.g. a leapfrog that shot into a -inf/NaN-grad
            # region in low precision) counts as a divergence and must not
            # poison the running statistics.
            bad = jnp.isnan(delta_h)
            diverging = bad | (delta_h > divergence_threshold)
            logw = jnp.where(bad, -jnp.inf, -delta_h)
            accept = jnp.where(
                bad, 0.0, jnp.minimum(1.0, jnp.exp(-delta_h))
            )

            # Open spans: store checkpoint at levels 1..tz(n) (level j slot
            # j-1); leaf 0 opens every level.
            tz_open = _trailing_zeros(n)
            lvl = jnp.arange(1, md + 1)
            open_mask = lvl <= tz_open
            ckpt_p = jnp.where(open_mask[:, None], pn[None, :], s.ckpt_p)
            ckpt_q = jnp.where(open_mask[:, None], qn[None, :], s.ckpt_q)
            ckpt_psum = jnp.where(
                open_mask[:, None], s.psum[None, :], s.ckpt_psum
            )

            psum = s.psum + pn

            # Close spans: levels 1..tz(n+1); test U-turn on each.
            tz_close = _trailing_zeros(n + 1)
            close_mask = (lvl <= tz_close) & (lvl <= depth)
            span_psum = psum[None, :] - ckpt_psum  # (md, dim)
            v = _velocity_rows(inv_mass, span_psum)
            turn_j = (jnp.sum(v * ckpt_p, axis=1) <= 0) | (
                jnp.sum(v * pn[None, :], axis=1) <= 0
            )
            turning = s.turning | jnp.any(turn_j & close_mask)

            # Progressive multinomial proposal within the subtree.
            new_logw = jnp.logaddexp(s.log_weight, logw)
            key, sub = jax.random.split(s.key)
            take = jnp.log(jax.random.uniform(sub, (), dtype)) < (
                logw - new_logw
            )
            take = take & ~diverging
            q_prop = jnp.where(take, qn, s.q_prop)
            logp_prop = jnp.where(take, logpn, s.logp_prop)
            h_prop = jnp.where(take, h, s.h_prop)

            is_first = n == 0
            return _S(
                key=key,
                q=qn, p=pn, grad=gn,
                psum=psum,
                ckpt_q=ckpt_q, ckpt_p=ckpt_p, ckpt_psum=ckpt_psum,
                q_prop=q_prop, logp_prop=logp_prop, h_prop=h_prop,
                log_weight=new_logw,
                sum_accept=s.sum_accept + accept,
                q_first=jnp.where(is_first, qn, s.q_first),
                p_first=jnp.where(is_first, pn, s.p_first),
                grad_first=jnp.where(is_first, gn, s.grad_first),
                turning=turning,
                diverging=s.diverging | diverging,
            )

        def _leaf_cond(c):
            n, s = c
            return (n < n_leaves) & ~s.turning & ~s.diverging

        def _leaf_body(c):
            n, s = c
            return n + 1, leaf_step(n, s)

        zeros = jnp.zeros((md, dim), dtype)
        s0 = _S(
            key=key,
            q=q0, p=p0_, grad=g0,
            psum=jnp.zeros((dim,), dtype),
            ckpt_q=zeros, ckpt_p=zeros, ckpt_psum=zeros,
            q_prop=q0, logp_prop=jnp.array(-jnp.inf, dtype),
            h_prop=h0,
            log_weight=jnp.array(-jnp.inf, dtype),
            sum_accept=jnp.zeros((), dtype),
            q_first=q0, p_first=p0_, grad_first=g0,
            turning=jnp.zeros((), bool),
            diverging=jnp.zeros((), bool),
        )
        # Early-exit leaf stream: once this subtree turns or diverges, no
        # further leaves can change the outcome (the fori+guard form ran
        # every slot with a no-op cond, which under vmap still executes
        # the leapfrog for every lane).
        _, s = lax.while_loop(
            _leaf_cond, _leaf_body, (jnp.zeros((), jnp.int32), s0)
        )
        return s

    def doubling(t: _T):
        key, k_dir, k_sub, k_acc = jax.random.split(t.key, 4)
        go_right = jax.random.bernoulli(k_dir, 0.5)
        z0 = jax.tree_util.tree_map(
            lambda a, b: jnp.where(go_right, a, b),
            (t.q_right, t.p_right, t.grad_right),
            (t.q_left, t.p_left, t.grad_left),
        )
        n_leaves = jnp.left_shift(1, t.depth)
        eps_signed = jnp.where(go_right, eps, -eps)
        s = build_subtree(k_sub, z0, eps_signed, n_leaves, t.depth)

        ok = ~(s.turning | s.diverging)

        # New endpoint on the expanded side.
        q_right = jnp.where(go_right & ok, s.q, t.q_right)
        p_right = jnp.where(go_right & ok, s.p, t.p_right)
        g_right = jnp.where(go_right & ok, s.grad, t.grad_right)
        q_left = jnp.where(~go_right & ok, s.q, t.q_left)
        p_left = jnp.where(~go_right & ok, s.p, t.p_left)
        g_left = jnp.where(~go_right & ok, s.grad, t.grad_left)

        psum = t.psum + s.psum

        # Biased progressive sampling between old tree and new subtree.
        take_new = jnp.log(jax.random.uniform(k_acc, (), dtype)) < (
            s.log_weight - t.log_weight
        )
        take_new = take_new & ok
        q_prop = jnp.where(take_new, s.q_prop, t.q_prop)
        logp_prop = jnp.where(take_new, s.logp_prop, t.logp_prop)
        h_prop = jnp.where(take_new, s.h_prop, t.h_prop)
        log_weight = jnp.logaddexp(t.log_weight, s.log_weight)

        # Top-level U-turn across the merged trajectory.
        v = _velocity(inv_mass, psum)
        turning_top = (jnp.sum(v * p_left) <= 0) | (
            jnp.sum(v * p_right) <= 0
        )
        turning = s.turning | (ok & turning_top)

        return _T(
            key=key,
            q_left=q_left, p_left=p_left, grad_left=g_left,
            q_right=q_right, p_right=p_right, grad_right=g_right,
            psum=psum,
            q_prop=q_prop, logp_prop=logp_prop, h_prop=h_prop,
            log_weight=log_weight,
            sum_accept=t.sum_accept + s.sum_accept,
            num_steps=t.num_steps + n_leaves,
            depth=t.depth + 1,
            turning=turning,
            diverging=t.diverging | s.diverging,
        )

    def cond(t: _T):
        return (
            (t.depth < max_tree_depth) & ~t.turning & ~t.diverging
        )

    out = lax.while_loop(cond, doubling, init)

    accept_prob = out.sum_accept / jnp.maximum(
        out.num_steps.astype(dtype), 1.0
    )
    info = NUTSInfo(
        accept_prob=accept_prob,
        num_steps=out.num_steps,
        tree_depth=out.depth,
        diverging=out.diverging,
        energy=out.h_prop,
        logp=out.logp_prop,
    )
    return out.q_prop, info


def _build_segments(
    logprob_data_fn,
    n_chains,
    dim,
    dtype,
    max_tree_depth,
    target_accept,
    axis_name=None,
    warmup_max_tree_depth=None,
    dense_mass=False,
):
    """Jittable warmup/sample segment builders parameterized by data.

    ``logprob_data_fn(data, theta)`` is the per-problem log-probability;
    every returned function takes ``data`` explicitly so the same segment
    can be vmapped over a batch of problems (see sample_nuts_batch) or
    closed over ``data=None`` for a single problem.

    ``warmup_max_tree_depth`` (static) caps the tree depth during warmup
    only: early warmup runs with a badly-tuned step size, and an
    uncapped transition there pads every vmapped chain to the deepest
    tree (2^max_tree_depth gradient slots).  Sampling transitions always
    use the full ``max_tree_depth``.

    ``dense_mass`` (static): adapt a full (dim, dim) inverse mass matrix
    from pooled cross moments instead of the diagonal — the right metric
    for strongly correlated low-dimensional posteriors (e.g. the 7-param
    granulation model, whose diagonal-metric ESS efficiency is ~3%).
    """
    from .adaptation import (
        da_init,
        da_update,
        da_final,
        welford_init,
        welford_update,
        welford_variance,
        welford_cov_init,
        welford_cov_update,
        welford_covariance,
    )

    if dense_mass:
        wf_init = lambda: welford_cov_init(dim, dtype)
        wf_update = welford_cov_update
        wf_estimate = welford_covariance
        im_init = lambda: jnp.eye(dim, dtype=dtype)

        def im_sane(new, old):
            # A window covariance can be rank-deficient early on; accept
            # it only if finite, with positive diagonal, AND with a
            # finite Cholesky factor — a non-PD matrix slipping through
            # would NaN every subsequent momentum draw and silently
            # stall the chains rather than error.
            chol = jnp.linalg.cholesky(new)
            good = (
                jnp.all(jnp.isfinite(new))
                & jnp.all(jnp.diag(new) > 0)
                & jnp.all(jnp.isfinite(chol))
            )
            return jnp.where(good, new, old)
    else:
        wf_init = lambda: welford_init(dim, dtype)
        wf_update = welford_update
        wf_estimate = welford_variance
        im_init = lambda: jnp.ones((dim,), dtype)

        def im_sane(new, old):
            return jnp.where(
                jnp.isfinite(new) & (new > 0), new, old
            )

    if warmup_max_tree_depth is None:
        warmup_max_tree_depth = max_tree_depth
    warmup_max_tree_depth = min(warmup_max_tree_depth, max_tree_depth)

    def vkernel(data, qs, keys, eps, im, depth=max_tree_depth):
        lp = lambda th: logprob_data_fn(data, th)
        # Propagate the one-pass value+gradient entry point through the
        # data-binding wrapper to the leapfrog integrator.
        _vag = getattr(logprob_data_fn, "value_and_grad", None)
        if _vag is not None:
            lp.value_and_grad = lambda th: _vag(data, th)
        kernel = lambda q, k: nuts_kernel(
            lp, q, k, eps, im, max_tree_depth=depth,
        )
        return jax.vmap(kernel)(qs, keys)

    def pooled_mean(x):
        m = jnp.mean(x)
        if axis_name is not None:
            m = lax.pmean(m, axis_name)
        return m

    def pooled_sum(x):
        s = jnp.sum(x)
        if axis_name is not None:
            s = lax.psum(s, axis_name)
        return s

    def warmup_step(data, carry, inp):
        qs, da, wf, inv_mass = carry
        key, mass_win, win_end = inp
        keys = jax.random.split(key, n_chains)
        qs, info = vkernel(
            data, qs, keys, jnp.exp(da.log_step), inv_mass,
            depth=warmup_max_tree_depth,
        )
        # Cross-chain pooled accept statistic drives one shared step size.
        da = da_update(da, pooled_mean(info.accept_prob))
        wf = jax.lax.cond(
            mass_win,
            lambda w: wf_update(w, qs, axis_name=axis_name),
            lambda w: w,
            wf,
        )

        def close_window(args):
            da, wf, inv_mass = args
            new_inv_mass = im_sane(wf_estimate(wf), inv_mass)
            return (
                da_init(jnp.exp(da.log_step), target_accept),
                wf_init(),
                new_inv_mass,
            )

        da, wf, inv_mass = jax.lax.cond(
            win_end, close_window, lambda a: a, (da, wf, inv_mass)
        )
        return (qs, da, wf, inv_mass), info.accept_prob

    def init_carry(init_params, initial_step_size, mu=None):
        da0 = da_init(
            jnp.asarray(initial_step_size, dtype), target_accept, mu=mu
        )
        return (init_params, da0, wf_init(), im_init())

    def warmup_segment(data, carry, keys, mass_flags, end_flags):
        """Returns (carry, per-transition pooled accept stats)."""
        step = lambda c, i: warmup_step(data, c, i)
        return lax.scan(step, carry, (keys, mass_flags, end_flags))

    def sample_segment(data, qs, keys, step_size, inv_mass):
        def sample_step(qs, key):
            ks = jax.random.split(key, n_chains)
            qs, info = vkernel(data, qs, ks, step_size, inv_mass)
            return qs, (
                qs, info.accept_prob, info.diverging, info.num_steps,
                info.energy,
            )

        return lax.scan(sample_step, qs, keys)

    return init_carry, warmup_segment, sample_segment, pooled_mean, \
        pooled_sum


def sample_nuts(
    logprob_fn,
    init_params,
    key,
    num_warmup=500,
    num_samples=500,
    max_tree_depth=10,
    target_accept=0.8,
    initial_step_size=0.1,
    thin=1,
    axis_name=None,
    chunk_size=None,
    warmup_max_tree_depth=None,
    progress=None,
    dense_mass=False,
):
    """Vmapped multi-chain NUTS with cross-chain window adaptation.

    ``init_params``: (n_chains, dim).  Returns (samples, info_dict) where
    samples has shape (n_chains, num_samples // thin, dim).

    Adaptation (Stan-style): dual-averaged step size targeting
    ``target_accept``, diagonal mass matrix from cross-chain Welford
    variance in doubling windows.  Statistics pool over ALL chains each
    iteration — cross-chain adaptation converges faster than per-chain and
    is what makes the sharded version's psum collectives worthwhile.

    ``axis_name``: when running inside shard_map with chains sharded over
    a mesh axis, pass that axis name so adaptation statistics psum across
    devices (see parallel.sharded.sample_nuts_sharded).

    ``chunk_size``: when set, warmup and sampling run as host-driven
    segments of at most this many transitions per device launch — use on
    runtimes that bound single-execution wall-clock, or to interleave
    checkpointing.  Results are identical to the single-launch path.

    ``warmup_max_tree_depth``: optional smaller tree-depth cap applied to
    warmup transitions only (sampling always uses ``max_tree_depth``).
    Under vmap every chain pads to the per-launch deepest tree, so a
    single chain opening max-depth trees while the step size is still
    miscalibrated stalls the whole batch; capping warmup at 6-8 bounds
    that cost with no effect on the post-warmup kernel.

    ``progress``: live metrics for long runs (requires ``chunk_size``):
    ``True`` prints one line per chunk (phase, transitions/s,
    leapfrogs/s, acceptance, divergences, step size); a callable
    receives the same dict instead.  Metrics are read on the host
    between device launches — zero cost inside the compiled segments.

    ``dense_mass``: adapt a full (dim, dim) inverse mass matrix from
    pooled cross moments (Stan-style shrinkage).  Worth it for
    low-dimensional, strongly correlated posteriors; the per-leapfrog
    extra cost is one (dim, dim) matvec.
    """
    from .adaptation import da_final, window_boundaries

    init_params = jnp.atleast_2d(init_params)
    n_chains, dim = init_params.shape
    dtype = init_params.dtype

    def _make_segments():
        _lpd = lambda data, th: logprob_fn(th)
        _vag = getattr(logprob_fn, "value_and_grad", None)
        if _vag is not None:
            _lpd.value_and_grad = lambda data, th: _vag(th)
        init_carry, warm_seg_fn, samp_seg_fn, pooled_mean, pooled_sum = (
            _build_segments(
                _lpd,
                n_chains, dim, dtype, max_tree_depth, target_accept,
                axis_name,
                warmup_max_tree_depth=warmup_max_tree_depth,
                dense_mass=dense_mass,
            )
        )
        warmup_segment = jax.jit(
            lambda carry, keys, mf, ef: warm_seg_fn(
                None, carry, keys, mf, ef
            )
        )
        sample_segment = jax.jit(
            lambda qs, keys, eps, im: samp_seg_fn(
                None, qs, keys, eps, im
            )
        )
        return (init_carry, warmup_segment, sample_segment, pooled_mean,
                pooled_sum)

    cfg = (
        n_chains, dim, jnp.dtype(dtype).name, max_tree_depth,
        float(target_accept), axis_name, warmup_max_tree_depth,
        bool(dense_mass),
    )
    init_carry, warmup_segment, sample_segment, pooled_mean, pooled_sum = (
        _cached_segments(logprob_fn, cfg, _make_segments)
    )

    is_mass_window, is_window_end = window_boundaries(num_warmup)
    key, k_warm = jax.random.split(key)
    da_mu = None
    if initial_step_size == "auto" and num_warmup > 0:
        # Opt-in coarse step-size search before dual averaging
        # (Hoffman & Gelman alg. 4).  The found step size is already
        # calibrated (one-leapfrog accept ~ 1/2), so the dual-averaging
        # anchor re-anchors at mu = log(eps0) — Stan's log(10*eps0)
        # upward bias is for blind initial guesses and measurably pulls
        # a searched step size away from its calibrated value.
        key, k_eps = jax.random.split(key)
        eps_chains = jax.jit(jax.vmap(
            lambda q, k: find_reasonable_step_size(logprob_fn, q, k)
        ))(init_params, jax.random.split(k_eps, n_chains))
        initial_step_size = jnp.exp(jnp.mean(jnp.log(eps_chains)))
        da_mu = jnp.log(initial_step_size)
    carry = init_carry(init_params, initial_step_size, mu=da_mu)
    warm_keys = jax.random.split(k_warm, num_warmup)

    if chunk_size is None:
        carry, _ = warmup_segment(
            carry, warm_keys, is_mass_window, is_window_end
        )
        qs, da, wf, inv_mass = carry
        step_size = da_final(da)
        key, k_samp = jax.random.split(key)
        samp_keys = jax.random.split(k_samp, num_samples)
        _, (chain, accept, div, steps, energy) = sample_segment(
            qs, samp_keys, step_size, inv_mass
        )
        accept = pooled_mean(accept)
        div = pooled_sum(div)
        steps = pooled_sum(steps)
    else:
        # Host-chunked execution: each device launch covers <= chunk_size
        # transitions.  Needed where the runtime bounds single-execution
        # wall-clock (long NUTS programs otherwise hit device deadlines),
        # and the natural place for progress/checkpoint hooks.
        import time as _time

        def _emit(rec):
            if callable(progress):
                progress(rec)
            elif progress:
                print(
                    "[nuts] " + "  ".join(
                        f"{k}={v}" for k, v in rec.items()
                    ),
                    flush=True,
                )

        warm_seg = warmup_segment  # already jitted (cached across calls)
        samp_seg = sample_segment
        for lo in range(0, num_warmup, chunk_size):
            hi = min(lo + chunk_size, num_warmup)
            t0 = _time.perf_counter()
            carry, wacc = warm_seg(
                carry,
                warm_keys[lo:hi],
                is_mass_window[lo:hi],
                is_window_end[lo:hi],
            )
            if progress:
                jax.block_until_ready(carry[0])
                dt_c = _time.perf_counter() - t0
                _emit({
                    "phase": "warmup",
                    "done": hi,
                    "total": num_warmup,
                    "trans/s": round((hi - lo) / dt_c, 2),
                    "accept": round(float(jnp.mean(wacc)), 3),
                    "step_size": round(
                        float(jnp.exp(carry[1].log_step)), 5
                    ),
                })
        qs, da, wf, inv_mass = carry
        step_size = da_final(da)
        key, k_samp = jax.random.split(key)
        samp_keys = jax.random.split(k_samp, num_samples)
        chains, accepts, divs, steps_l, energies = [], [], [], [], []
        for lo in range(0, num_samples, chunk_size):
            hi = min(lo + chunk_size, num_samples)
            t0 = _time.perf_counter()
            qs, (c, a, d, s, e) = samp_seg(
                qs, samp_keys[lo:hi], step_size, inv_mass
            )
            chains.append(c)
            accepts.append(jnp.sum(a))
            divs.append(jnp.sum(d))
            steps_l.append(jnp.sum(s))
            energies.append(e)
            if progress:
                jax.block_until_ready(qs)
                dt_c = _time.perf_counter() - t0
                _emit({
                    "phase": "sample",
                    "done": hi,
                    "total": num_samples,
                    "samples/s": round(
                        n_chains * (hi - lo) / dt_c, 2
                    ),
                    "leapfrogs/s": round(
                        float(steps_l[-1]) / dt_c, 1
                    ),
                    "accept": round(float(jnp.mean(a)), 3),
                    "divergences": int(divs[-1]),
                })
        chain = jnp.concatenate(chains, axis=0)
        energy = jnp.concatenate(energies, axis=0)
        # Weight by transition count (chunks may be ragged).
        accept = pooled_mean(
            sum(accepts) / (num_samples * n_chains)
        )
        div = pooled_sum(jnp.stack(divs))
        steps = pooled_sum(jnp.stack(steps_l))

    # (num_samples, n_chains, dim) -> (n_chains, num_samples, dim)
    chain = jnp.swapaxes(chain, 0, 1)[:, ::thin]
    info = {
        "step_size": step_size,
        "inv_mass": inv_mass,
        "accept_prob": accept,
        "divergences": div,
        "num_steps": steps,
        # Per-transition Hamiltonian at the accepted point,
        # (n_chains, num_samples) — input to diagnostics.ebfmi.
        "energy": jnp.swapaxes(energy, 0, 1),
    }
    return chain, info


def sample_nuts_batch(
    logprob_fn,
    data_batch,
    init_params,
    key,
    num_warmup=500,
    num_samples=500,
    max_tree_depth=10,
    target_accept=0.8,
    initial_step_size=0.1,
    thin=1,
    chunk_size=None,
    warmup_max_tree_depth=None,
):
    """Independent NUTS fits for a batch of problems, fully vectorized.

    The pod-scale fleet-fitting primitive (BASELINE.json configs[4]:
    thousands of light curves, each with its own hyperparameters): one
    NUTS run per problem, vmapped over the problem axis, with warmup
    adaptation pooled per-problem across that problem's chains.

    ``chunk_size`` composes with batching: each device launch runs at most
    ``chunk_size`` transitions for ALL problems at once (the jitted
    per-chunk segment is vmapped over the problem axis; the chunk loop is
    a host loop carrying the state pytree) — required on runtimes that
    bound single-execution wall-clock.

    Args:
        logprob_fn: ``(data, theta) -> log prob`` for a single problem.
        data_batch: pytree whose leaves have leading dim B (one slice per
            problem).
        init_params: (B, n_chains, dim) initial positions.
        key: PRNG key (split across problems internally).

    Returns (chains, infos): chains (B, n_chains, num_samples // thin,
    dim); infos is a dict of per-problem arrays.
    """
    from .adaptation import da_final, window_boundaries

    b, n_chains, dim = init_params.shape
    dtype = init_params.dtype

    if chunk_size is None:
        keys = jax.random.split(key, b)

        def one(data, init, key):
            return sample_nuts(
                lambda th: logprob_fn(data, th), init, key,
                num_warmup=num_warmup, num_samples=num_samples,
                max_tree_depth=max_tree_depth,
                target_accept=target_accept,
                initial_step_size=initial_step_size, thin=thin,
                warmup_max_tree_depth=warmup_max_tree_depth,
            )

        return jax.vmap(one)(data_batch, init_params, keys)

    def _make_batch_segments():
        init_carry, warm_seg, samp_seg, _, _ = _build_segments(
            logprob_fn, n_chains, dim, dtype, max_tree_depth,
            target_accept,
            warmup_max_tree_depth=warmup_max_tree_depth,
        )
        vwarm = jax.jit(
            jax.vmap(warm_seg, in_axes=(0, 0, 0, None, None))
        )
        vsamp = jax.jit(jax.vmap(samp_seg, in_axes=(0, 0, 0, 0, 0)))
        return init_carry, vwarm, vsamp

    cfg = (
        "batch", n_chains, dim, jnp.dtype(dtype).name, max_tree_depth,
        float(target_accept), warmup_max_tree_depth,
    )
    init_carry, vwarm, vsamp = _cached_segments(
        logprob_fn, cfg, _make_batch_segments
    )

    is_mass_window, is_window_end = window_boundaries(num_warmup)
    key, k_warm, k_samp = jax.random.split(key, 3)
    warm_keys = jax.random.split(k_warm, (b, num_warmup))
    samp_keys = jax.random.split(k_samp, (b, num_samples))

    carry = jax.vmap(lambda q: init_carry(q, initial_step_size))(
        init_params
    )
    for lo in range(0, num_warmup, chunk_size):
        hi = min(lo + chunk_size, num_warmup)
        carry, _ = vwarm(
            data_batch, carry, warm_keys[:, lo:hi],
            is_mass_window[lo:hi], is_window_end[lo:hi],
        )
    qs, da, wf, inv_mass = carry
    step_size = jax.vmap(da_final)(da)

    chains, accepts, divs, steps_l, energies = [], [], [], [], []
    for lo in range(0, num_samples, chunk_size):
        hi = min(lo + chunk_size, num_samples)
        qs, (c, a, d, s, e) = vsamp(
            data_batch, qs, samp_keys[:, lo:hi], step_size, inv_mass
        )
        chains.append(c)
        accepts.append(jnp.sum(a, axis=(1, 2)))
        divs.append(jnp.sum(d, axis=(1, 2)))
        steps_l.append(jnp.sum(s, axis=(1, 2)))
        energies.append(e)

    # Per chunk c is (B, chunk, n_chains, dim).
    chain = jnp.concatenate(chains, axis=1)
    chain = jnp.swapaxes(chain, 1, 2)[:, :, ::thin]
    energy = jnp.swapaxes(jnp.concatenate(energies, axis=1), 1, 2)
    info = {
        "step_size": step_size,
        "inv_mass": inv_mass,
        "accept_prob": sum(accepts) / (num_samples * n_chains),
        "divergences": sum(divs),
        "num_steps": sum(steps_l),
        "energy": energy,
    }
    return chain, info
