"""Multi-host bring-up helpers.

Single-host multi-device needs nothing special; across hosts (a GPU
cluster or CPU fleet) JAX requires one ``jax.distributed.initialize`` call
per process before any computation.  These helpers wrap that plus the
host-prefixed RNG and the "global mesh over all processes" construction
used by the sharded samplers.

Ordering constraint (the reason ``initialize`` must not probe the
runtime): ``jax.distributed.initialize`` has to run *before* any backend
is instantiated, and almost every introspection API
(``jax.process_count()``, ``jax.devices()``, ...) instantiates one.  The
multi-process decision is therefore made from the explicit arguments and
the environment alone; only the already-initialized check touches JAX,
through the distributed-state handle, which does not create a backend.

Exercised for real by ``tests/test_multihost.py``: two spawned CPU
processes (4 virtual devices each) bring up a 2-process global mesh
through this helper and run the sharded sampler on it.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["initialize", "is_distributed_initialized", "global_chain_mesh",
           "host_local_batch"]


# Environment variables whose presence signals a managed multi-process
# launch that jax.distributed.initialize() can auto-detect.
_AUTO_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "OMPI_MCA_orte_hnp_uri",       # OpenMPI
    "PMI_SIZE",                    # MPICH / Hydra
    "SLURM_NTASKS",                # Slurm
)


def is_distributed_initialized():
    """True when jax.distributed.initialize has already run in this
    process.  Reads the distributed-state handle only — does NOT
    instantiate a backend, so it is safe to call before bring-up."""
    try:
        from jax._src import distributed

        return distributed.global_state.client is not None
    except Exception:
        return False


def initialize(coordinator_address=None, num_processes=None,
               process_id=None):
    """Bring up jax.distributed when a multi-process launch is requested.

    Returns True when running (or now brought up) multi-process, False
    for a plain single-process run.  The decision is made WITHOUT
    touching any backend-initializing API:

    - explicit ``coordinator_address`` (+ ``num_processes`` /
      ``process_id``) always initializes;
    - otherwise, initialization is attempted only when a recognized
      cluster environment variable is present (Slurm, MPI,
      JAX_COORDINATOR_ADDRESS), letting JAX auto-detect the topology;
    - with neither, this is a single-process run and the call is a no-op.

    Misconfiguration (a coordinator that never comes up, inconsistent
    topology) propagates as an exception rather than being silently
    swallowed into a single-process fallback.
    """
    import jax

    if is_distributed_initialized():
        return True

    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True

    if any(os.environ.get(v) for v in _AUTO_ENV_VARS):
        # Slurm with a single task is still single-process.
        ntasks = os.environ.get("SLURM_NTASKS")
        if ntasks is not None and int(ntasks) <= 1 and not any(
            os.environ.get(v) for v in _AUTO_ENV_VARS[:6]
        ):
            return False
        jax.distributed.initialize()
        return True

    return False


def global_chain_mesh():
    """A 1-D mesh over every device of every process (chains axis).

    With chains sharded over this mesh, the warmup psum collectives ride
    the intra-host links and the network across hosts automatically.
    """
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), ("chains",))


def host_local_batch(global_batch_size):
    """This process's share of a global chain/particle batch."""
    import jax

    if global_batch_size % jax.process_count():
        raise ValueError(
            "global batch must divide evenly across processes"
        )
    return global_batch_size // jax.process_count()
