"""Mesh construction and sharded-chain execution.

Design (scaling-book recipe): one logical axis ``"chains"`` for
chain/particle parallelism laid out over all devices (the intra-host
links, and the network across hosts), with per-chain work vmapped so each device runs a dense
batch of chains.  Cross-chain adaptation statistics (dual-averaging step
size, mass-matrix moments) ride a single ``psum`` per step.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_chains", "sharded_chain_step"]

CHAIN_AXIS = "chains"


def make_mesh(n_devices=None, devices=None):
    """A 1-D mesh over the chain axis (all available devices by default)."""
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devices), (CHAIN_AXIS,))


def shard_chains(mesh, tree):
    """Place a pytree with leading chain axis onto the mesh."""
    sharding = NamedSharding(mesh, P(CHAIN_AXIS))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree
    )


def sharded_chain_step(logprob_fn, mesh, step_size=1e-2, n_leapfrog=3):
    """One sharded HMC-style step over all chains.

    Chains are sharded over the mesh; each device vmaps its local shard.
    The acceptance statistic is psum-reduced across the mesh — the same
    collective pattern the full samplers use for dual-averaging adaptation.
    Returns (thetas, accept_mean) — used by the multichip dry-run and as
    the template for inference.nuts's sharded driver.
    """
    def one_chain(theta, key):
        k1, k2 = jax.random.split(key)
        p0 = jax.random.normal(k1, theta.shape, theta.dtype)

        def grad_u(q):
            return -jax.grad(logprob_fn)(q)

        def leap(carry, _):
            q, p = carry
            p = p - 0.5 * step_size * grad_u(q)
            q = q + step_size * p
            p = p - 0.5 * step_size * grad_u(q)
            return (q, p), None

        (q, p), _ = jax.lax.scan(
            leap, (theta, p0), None, length=n_leapfrog
        )
        h0 = -logprob_fn(theta) + 0.5 * jnp.sum(p0 * p0)
        h1 = -logprob_fn(q) + 0.5 * jnp.sum(p * p)
        log_accept = jnp.minimum(0.0, h0 - h1)
        accept = jnp.log(jax.random.uniform(k2, ())) < log_accept
        theta = jnp.where(accept, q, theta)
        return theta, jnp.exp(log_accept)

    def local_step(thetas, keys):
        thetas, probs = jax.vmap(one_chain)(thetas, keys)
        # Cross-device adaptation statistic.
        total = jax.lax.psum(jnp.sum(probs), CHAIN_AXIS)
        count = jax.lax.psum(probs.shape[0], CHAIN_AXIS)
        return thetas, total / count

    # check_vma=False: the log-prob closure captures replicated data arrays
    # whose scan carries would otherwise trip the varying-axes checker.
    return jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(CHAIN_AXIS), P(CHAIN_AXIS)),
        out_specs=(P(CHAIN_AXIS), P()),
        check_vma=False,
    )
