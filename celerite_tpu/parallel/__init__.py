"""Distributed runtime: mesh construction, sharded chains, N-axis sharding.

The reference is single-process (SURVEY.md section 2.3); this layer is new,
built on one primitive: a ``jax.sharding.Mesh`` over (hosts x devices),
chains/particles vmapped per device and sharded over the mesh with ``shard_map``, and
XLA collectives (psum / all_gather / ppermute) for adaptation statistics,
SMC resampling, and cross-chip solver carries.
"""

from . import mesh, multihost, sharded  # noqa: F401
