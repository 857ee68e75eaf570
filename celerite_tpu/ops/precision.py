"""Float32 matmul-precision pinning for the semiseparable algebra.

On an NVIDIA GPU, XLA may run a float32 matmul/dot in TF32 on the tensor
cores (a 10-bit mantissa, about three decimal digits).  The celerite
recursions and the cross-block Riccati/affine prefix compositions are
pivot-critical: the factor pivots ``d_n`` sit orders of magnitude below
the raw data scale, so a TF32-class seed error in a (P, P) composition
can flip pivots negative, and the ``(ok, ll)`` contract then reports an
(incorrect) non-PD failure.

Every module whose numeric path uses ``@`` / ``jnp.dot`` / ``einsum``
wraps its public entry points with :func:`f32_matmuls` so those ops bind
at true float32 precision (or passes ``precision="highest"`` itself).
The affected contractions are tiny (P x P with P <= ~32), so the cost
is noise; the Triton kernels of ops/fused.py use unrolled elementwise
multiply-adds, which are always float32.
"""

from __future__ import annotations

import functools

import jax

__all__ = ["f32_matmuls"]


def f32_matmuls(fn):
    """Trace ``fn`` with float32 (HIGHEST) default matmul precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped
