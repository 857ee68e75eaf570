"""N-axis-sharded solver and mesh-sharded samplers.

Two orthogonal shardings, composable on a 2-D mesh:

1. **Data (N-axis) sharding** — ``sharded_gp_log_likelihood``: the time
   axis is split over the ``"data"`` mesh axis.  Each device runs the
   block-parallel solver (ops.blocked) on its shard; the only cross-device
   coupling is the P-dimensional boundary state, exchanged as composed
   Riccati/affine elements via ``all_gather`` (bytes per device), then the scalar reductions psum.  This is the celerite analog of
   sequence parallelism: the "ring attention" state here is a (P, P)
   matrix, so communication is negligible by construction (SURVEY.md 5.7).

2. **Chain sharding** — ``sample_nuts_sharded``: chains are vmapped per
   device and sharded over the ``"chains"`` axis; dual-averaging and mass
   adaptation pool statistics across ALL chains with psum (the adaptation
   collectives are tiny scalars/vectors, off the leapfrog critical path).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import blocked
from ..ops.lower import SSM
from ..ops.precision import f32_matmuls

__all__ = [
    "make_data_mesh",
    "sharded_gp_log_likelihood",
    "sample_nuts_sharded",
    "sample_smc_sharded",
]

DATA_AXIS = "data"
CHAIN_AXIS = "chains"


def make_data_mesh(n_devices=None, devices=None):
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def _device_prefix_elem(local_elem, axis_name):
    """Exclusive prefix of composed (A,J,C) elements over the device axis.

    all_gather the per-device totals (tiny), then fold locally; device i
    keeps the composition of devices 0..i-1.
    """
    gathered = jax.tree_util.tree_map(
        lambda x: lax.all_gather(x, axis_name), local_elem
    )
    idx = lax.axis_index(axis_name)
    p = local_elem[0].shape[-1]
    dtype = local_elem[0].dtype
    eye = jnp.eye(p, dtype=dtype)
    ident = (eye, jnp.zeros((p, p), dtype), jnp.zeros((p, p), dtype))
    n_dev = lax.axis_size(axis_name)

    def fold(i, acc):
        elem_i = jax.tree_util.tree_map(lambda x: x[i], gathered)
        combined = blocked._compose_full(acc, elem_i)
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(i < idx, b, a), acc, combined
        )

    return lax.fori_loop(0, n_dev, fold, ident)


def _device_prefix_affine(Mloc, mloc, axis_name):
    Mg = lax.all_gather(Mloc, axis_name)
    mg = lax.all_gather(mloc, axis_name)
    idx = lax.axis_index(axis_name)
    p = Mloc.shape[-1]
    ident = (jnp.eye(p, dtype=Mloc.dtype), jnp.zeros((p,), Mloc.dtype))
    n_dev = lax.axis_size(axis_name)

    def fold(i, acc):
        Ma, ma = acc
        comb = (Mg[i] @ Ma, Mg[i] @ ma + mg[i])
        keep = i < idx
        return (
            jnp.where(keep, comb[0], Ma),
            jnp.where(keep, comb[1], ma),
        )

    return lax.fori_loop(0, n_dev, fold, ident)


@f32_matmuls
def sharded_gp_log_likelihood(ssm: SSM, resid, mesh, block_size=None):
    """GP log-likelihood with the N axis sharded over ``mesh``.

    Each device: (pass 1) composes its local Riccati elements, exchanges
    per-device totals (3 P x P matrices) to seed the factor; (pass 2)
    factors its shard and builds affine solve maps, exchanges per-device
    affine totals (P x P + P) to seed the substitution; (pass 3) reduces
    quad/logdet partials, combined with one psum.  Inputs are padded to a
    multiple of (n_devices * block_size) with inert rows.

    Returns (ll, ok) replicated on every device.
    """
    n, p = ssm.U.shape
    n_dev = mesh.devices.size
    L = block_size or blocked.default_block_size(max(1, n // n_dev))
    if n % (n_dev * L):
        pad = n_dev * L - (n % (n_dev * L))
        zU = jnp.zeros((pad, p), ssm.U.dtype)
        ssm = SSM(
            U=jnp.concatenate([ssm.U, zU]),
            V=jnp.concatenate([ssm.V, zU]),
            phi=jnp.concatenate([ssm.phi, jnp.ones((pad, p), ssm.U.dtype)]),
            A=jnp.concatenate([ssm.A, jnp.ones((pad,), ssm.A.dtype)]),
        )
        resid = jnp.concatenate([resid, jnp.zeros((pad,), resid.dtype)])

    def local(U, V, phi, A, y):
        n_loc = U.shape[0]
        b = n_loc // L
        blk = SSM(
            U=U.reshape(b, L, p),
            V=V.reshape(b, L, p),
            phi=phi.reshape(b, L, p),
            A=A.reshape(b, L),
        )
        y_blk = y.reshape(b, L)
        dtype = U.dtype

        # Pass 1: local elements; cross-device exchange of composed totals.
        elems = blocked._block_elements(blk)
        incl = lax.associative_scan(blocked._compose_full, elems, axis=0)
        local_total = jax.tree_util.tree_map(lambda x: x[-1], incl)
        dev_pref = _device_prefix_elem(local_total, DATA_AXIS)
        S_hat_dev = dev_pref[2]  # prefix map applied to the zero state

        # Local exclusive prefix, seeded by the device's incoming state.
        eye = jnp.broadcast_to(jnp.eye(p, dtype=dtype), (1, p, p))
        zero = jnp.zeros((1, p, p), dtype)
        excl = tuple(
            jnp.concatenate([init, x[:-1]], axis=0)
            for init, x in zip((eye, zero, zero), incl)
        )
        S_hat_in = jax.vmap(
            lambda a, j, c: blocked.apply_elem((a, j, c), S_hat_dev)
        )(*excl)

        # Pass 2: factor + affine solve maps, once.
        def pass2(U, V, phi, A, y, Sh):
            def step(carry, inp):
                Sh, Mc, mc = carry
                u, v, ph, a, yn = inp
                S = (ph[:, None] * ph[None, :]) * Sh
                su = S @ u
                d = a - u @ su
                w = (v - su) / d
                Sh = S + d * jnp.outer(w, w)
                PhM = ph[:, None] * Mc
                Mc = PhM - jnp.outer(w, u @ PhM)
                mh = ph * mc
                mc = mh - w * (u @ mh) + w * yn
                return (Sh, Mc, mc), (d, w)

            init = (
                Sh, jnp.eye(p, dtype=dtype), jnp.zeros((p,), dtype)
            )
            (_, Mb, mb), (D, W) = lax.scan(
                step, init, (U, V, phi, A, y)
            )
            return D, W, Mb, mb

        D, W, M, m = jax.vmap(pass2)(
            blk.U, blk.V, blk.phi, blk.A, y_blk, S_hat_in
        )

        # Cross-device affine exchange, then local prefix seeded with it.
        Mp, mp = blocked._exclusive_prefix_affine(M, m)
        M_tot = M[-1] @ Mp[-1]
        m_tot = M[-1] @ mp[-1] + m[-1]
        _, h_dev = _device_prefix_affine(M_tot, m_tot, DATA_AXIS)
        h_in = jnp.einsum("bij,j->bi", Mp, h_dev) + mp

        # Pass 3: substitution + reductions.
        def pass3(U, phi, W, y, D, h):
            def step(carry, inp):
                h, quad, logdet, min_d = carry
                u, ph, w, yn, d = inp
                f = ph * h
                z = yn - u @ f
                h = f + w * z
                return (
                    h,
                    quad + z * z / d,
                    logdet + jnp.log(d),
                    jnp.minimum(min_d, d),
                ), None

            init = (
                h,
                jnp.zeros((), dtype),
                jnp.zeros((), dtype),
                jnp.array(jnp.inf, dtype),
            )
            (h, quad, logdet, min_d), _ = lax.scan(
                step, init, (U, phi, W, y, D)
            )
            return quad, logdet, min_d

        quad, logdet, min_d = jax.vmap(pass3)(
            blk.U, blk.phi, W, y_blk, D, h_in
        )

        quad_g = lax.psum(jnp.sum(quad), DATA_AXIS)
        logdet_g = lax.psum(jnp.sum(logdet), DATA_AXIS)
        # pmin has no AD rule; reduce a (stop-gradient) bad-pivot count.
        bad = jnp.sum(jnp.where(jnp.min(min_d) <= 0, 1.0, 0.0))
        bad_g = lax.psum(lax.stop_gradient(bad), DATA_AXIS)
        ll = -0.5 * (
            quad_g + logdet_g + n * jnp.log(2.0 * jnp.pi).astype(dtype)
        )
        ok = (bad_g == 0) & jnp.isfinite(ll)
        return jnp.where(ok, ll, -jnp.inf), ok

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
            P(DATA_AXIS),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(ssm.U, ssm.V, ssm.phi, ssm.A, resid)


def sample_nuts_sharded(
    logprob_fn,
    init_params,
    key,
    mesh=None,
    **kwargs,
):
    """Multi-chain NUTS with chains sharded over a 1-D mesh.

    Same semantics as inference.sample_nuts; adaptation statistics pool
    across ALL chains via psum on the ``chains`` axis.  ``init_params``
    must have its leading (chain) dimension divisible by the mesh size.
    """
    from ..inference.nuts import sample_nuts

    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh()

    n_chains = init_params.shape[0]
    n_dev = mesh.devices.size
    if n_chains % n_dev:
        raise ValueError(
            "number of chains must be divisible by the mesh size"
        )

    def local(thetas, key):
        # Decorrelate per-device RNG streams.
        key = jax.random.fold_in(key, lax.axis_index(CHAIN_AXIS))
        return sample_nuts(
            logprob_fn, thetas, key, axis_name=CHAIN_AXIS, **kwargs
        )

    mesh1 = Mesh(mesh.devices.reshape(-1), (CHAIN_AXIS,))
    # Adaptation/summary statistics psum-pool to identical values on every
    # device (replicated, P()); the per-transition energy series stays
    # per-chain and shards with the chain axis.
    info_specs = {
        "step_size": P(),
        "inv_mass": P(),
        "accept_prob": P(),
        "divergences": P(),
        "num_steps": P(),
        "energy": P(CHAIN_AXIS),
    }
    fn = jax.shard_map(
        local,
        mesh=mesh1,
        in_specs=(P(CHAIN_AXIS), P()),
        out_specs=(P(CHAIN_AXIS), info_specs),
        check_vma=False,
    )
    return fn(init_params, key)


def sample_smc_sharded(
    log_prior_fn,
    log_like_fn,
    init_particles,
    key,
    mesh=None,
    num_mutations=5,
    hmc_step_size=0.1,
    num_leapfrog=8,
    target_ess_frac=0.5,
    max_stages=50,
    particle_chunk=None,
    host_loop=False,
    progress=None,
    mass_fn=None,
):
    """Adaptive-tempering SMC with particles sharded over the mesh.

    Same algorithm as inference.sample_smc; the cross-particle operations
    become collectives on the particle axis:

    - the adaptive next-temperature search uses psum'd log-weight moments
      (every device runs the identical bisection on pooled statistics);
    - resampling is *global* systematic resampling: log-weights are
      all_gather'd (bytes), the index vector is computed identically on
      every device, and the particle exchange is an all_gather of the
      (n, dim) particle block over the device links — the celerite state
      is tiny, so this is the bandwidth-cheap variant (SURVEY.md 5.8).

    Returns an inference.smc.SMCResult with particles sharded back out.

    ``particle_chunk``: evaluate per-particle likelihoods/mutations in
    sequential chunks of this size (lax.map over chunks of vmap) instead
    of one flat vmap.  Needed at fleet scale: reverse-mode AD through a
    fleet's likelihood saves per-step residuals proportional to the
    curve count, so a flat vmap over n particles materializes n copies
    at once.  Must divide the per-device particle count.

    ``host_loop``: run the beta < 1 tempering loop on the host, one
    jitted device program per stage, instead of a single lax.while_loop
    program.  At fleet scale one stage is ~10^4 gradient evals of a
    10k-curve fleet, and per-stage programs keep each device launch
    short and give the host a place to report progress; whether the
    single-program loop is as good on a GPU is not measured yet.
    ``progress``
    (host_loop only): callback ``(stage, beta, accept, particles) ->
    None`` after each stage.
    """
    from ..inference.hmc import hmc_kernel
    from ..inference.smc import SMCResult

    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh()
    mesh1 = Mesh(mesh.devices.reshape(-1), (CHAIN_AXIS,))

    n_total, dim = init_particles.shape
    n_dev = mesh1.devices.size
    if n_total % n_dev:
        raise ValueError(
            "number of particles must be divisible by the mesh size"
        )

    def _chunked_vmap(f):
        """vmap over the particle axis, in sequential particle_chunk
        slabs (lax.map over chunks) to bound per-eval memory."""
        if particle_chunk is None:
            return jax.vmap(f)

        def g(*args):
            n = args[0].shape[0]
            c = min(particle_chunk, n)
            if n % c:
                raise ValueError(
                    "particle_chunk must divide the per-device "
                    "particle count"
                )
            if c == n:
                return jax.vmap(f)(*args)
            resh = lambda a: a.reshape((n // c, c) + a.shape[1:])
            out = lax.map(
                lambda xs: jax.vmap(f)(*xs), tuple(map(resh, args))
            )
            return jax.tree_util.tree_map(
                lambda a: a.reshape((n,) + a.shape[2:]), out
            )

        return g

    def local(particles, key, beta0, log_z0, k_stage0, accept0, step0):
        dtype = particles.dtype
        n_loc = particles.shape[0]
        vlike = _chunked_vmap(log_like_fn)

        def safe(x):
            return jnp.where(jnp.isfinite(x), x, -1e12)

        def global_logsumexp(lw):
            m_loc = jnp.max(lw)
            m = lax.pmax(m_loc, CHAIN_AXIS)
            s = lax.psum(jnp.sum(jnp.exp(lw - m)), CHAIN_AXIS)
            return m + jnp.log(s)

        def ess(lw):
            l1 = global_logsumexp(lw)
            l2 = global_logsumexp(2.0 * lw)
            return jnp.exp(2.0 * l1 - l2)

        def next_beta(ll, beta):
            target = target_ess_frac * n_total

            def body(_, bounds):
                lo, hi = bounds
                mid = 0.5 * (lo + hi)
                ok = ess((mid - beta) * ll) >= target
                return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

            lo, hi = lax.fori_loop(
                0, 30, body, (beta, jnp.ones((), dtype))
            )
            full = ess((1.0 - beta) * ll) >= target
            return jnp.where(full, 1.0, lo)

        def mutate(particles, key, beta, step_size):
            def tempered(theta):
                lp = log_prior_fn(theta) + beta * log_like_fn(theta)
                return jnp.where(jnp.isfinite(lp), lp, -1e12)

            # Propagate the one-pass value+gradient entry so the mutation
            # leapfrogs use it (see inference/smc.py mutate).
            vag_like = getattr(log_like_fn, "value_and_grad", None)
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

                tempered.value_and_grad = tempered_vag

            # Cloud-variance HMC metric, pooled across shards so every
            # device mutates with the same (global) scale
            # (inference/smc.py mutate).  ``mass_fn`` overrides it —
            # e.g. a mode-folded variance for multimodal targets, where
            # the raw cloud variance holds the inter-mode spread and
            # mis-scales every within-mode proposal.
            if mass_fn is not None:
                inv_mass = mass_fn(particles, CHAIN_AXIS)
            else:
                mean_loc = jnp.mean(particles, axis=0)
                mean_g = lax.pmean(mean_loc, CHAIN_AXIS)
                var_g = lax.pmean(
                    jnp.mean((particles - mean_g) ** 2, axis=0),
                    CHAIN_AXIS,
                )
                inv_mass = jnp.maximum(var_g, 1e-10)

            # One HMC transition for every particle, then a pooled
            # step-size correction, repeated num_mutations times: the
            # WITHIN-stage adaptation reacts num_mutations times faster
            # than once-per-stage correction — without it, a sharply
            # tempered target (fleet scale) outruns the step and the
            # mutations stall in a runaway (measured: accept 0.98 ->
            # 0.003 over 11 stages with per-stage-only adaptation).
            my = lax.axis_index(CHAIN_AXIS)

            def one_round(carry, kk):
                parts, step = carry
                keys = jax.random.split(
                    jax.random.fold_in(kk, my), n_loc
                )
                parts, info = _chunked_vmap(
                    lambda p, k: hmc_kernel(
                        tempered, p, k, step, inv_mass,
                        num_leapfrog=num_leapfrog,
                    )
                )(parts, keys)
                acc = lax.pmean(
                    jnp.mean(info.accept_prob), CHAIN_AXIS
                )
                step = step * jnp.exp(
                    jnp.clip(1.5 * (acc - 0.6), -1.2, 0.5)
                )
                return (parts, step), acc

            (particles, step_new), accs = lax.scan(
                one_round,
                (particles, step_size),
                jax.random.split(key, num_mutations),
            )
            return particles, jnp.mean(accs), step_new

        def stage(state):
            key, particles, beta, log_z, k_stage, accept, step = state
            key, k_res, k_mut = jax.random.split(key, 3)
            ll = safe(vlike(particles))
            beta_new = next_beta(ll, beta)
            lw = (beta_new - beta) * ll
            log_z = log_z + global_logsumexp(lw) - jnp.log(
                jnp.asarray(float(n_total), dtype)
            )

            # Global systematic resampling: gather weights + particles.
            lw_all = lax.all_gather(lw, CHAIN_AXIS).reshape(n_total)
            parts_all = lax.all_gather(
                particles, CHAIN_AXIS
            ).reshape(n_total, dim)
            w = jax.nn.softmax(lw_all)
            positions = (
                jax.random.uniform(k_res, (), dtype)
                + jnp.arange(n_total, dtype=dtype)
            ) / n_total
            idx = jnp.searchsorted(
                jnp.cumsum(w), positions, side="right"
            ).clip(0, n_total - 1)
            my = lax.axis_index(CHAIN_AXIS)
            local_idx = lax.dynamic_slice_in_dim(
                idx, my * n_loc, n_loc
            )
            particles = parts_all[local_idx]

            # NOTE on step scaling: the metric (cloud or ``mass_fn``
            # variance) already tracks the tempered posterior's
            # sharpening — the step stays in METRIC units, adapted
            # reactively per mutation round inside ``mutate``.  (A
            # predictive sqrt(beta ratio) rescale was tried and
            # double-counts the sharpening: steps collapse, accept
            # pins at ~1, and mutations stop mixing.)
            particles, mean_accept, step = mutate(
                particles, k_mut, beta_new, step
            )
            return (
                key, particles, beta_new, log_z, k_stage + 1,
                mean_accept, step,
            )

        def cond(state):
            _, _, beta, _, k_stage, _, _ = state
            return (beta < 1.0) & (k_stage < max_stages)

        init = (
            key, particles, beta0, log_z0, k_stage0, accept0, step0,
        )
        if host_loop:
            return stage(init)
        return lax.while_loop(cond, stage, init)

    state_specs = (P(), P(CHAIN_AXIS), P(), P(), P(), P(), P())
    fn = jax.shard_map(
        local,
        mesh=mesh1,
        in_specs=(P(CHAIN_AXIS),) + state_specs[:1] + state_specs[2:],
        out_specs=state_specs,
        check_vma=False,
    )
    dtype = init_particles.dtype
    key = jax.random.fold_in(key, 0)  # same stream on every device
    state = (
        key,
        init_particles,
        jnp.zeros((), dtype),
        jnp.zeros((), dtype),
        jnp.zeros((), jnp.int32),
        jnp.ones((), dtype),
        jnp.asarray(hmc_step_size, dtype),
    )
    if host_loop:
        # One jitted device program PER TEMPERING STAGE, with the
        # beta < 1 loop on the host: at fleet scale a single-program
        # while_loop runs for tens of minutes of device time; per-stage
        # calls give progress (``progress`` callback per stage) and
        # failure isolation.
        step_fn = jax.jit(fn)
        while True:
            beta = float(state[2])
            k_stage = int(state[4])
            if beta >= 1.0 or k_stage >= max_stages:
                break
            state = step_fn(
                state[1], state[0], *state[2:]
            )
            if progress is not None:
                progress(
                    int(state[4]), float(state[2]), float(state[5]),
                    state[1],
                )
    else:
        state = fn(state[1], state[0], *state[2:])
    _, particles, _, log_z, stages, accept, _ = state
    return SMCResult(
        particles=particles,
        log_evidence=log_z,
        num_stages=stages,
        final_accept=accept,
    )
