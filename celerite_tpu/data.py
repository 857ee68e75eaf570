"""Batched light-curve containers and loaders.

Pod-scale workloads (BASELINE.json configs[4]: 10k light curves x sharded
chains) need ragged per-target time series packed into padded rectangular
batches for vmap/shard_map.  This module provides:

- :class:`LightCurveBatch`: padded (B, Nmax) arrays + mask, buildable from
  ragged lists (native multithreaded packer when available, numpy
  fallback);
- a simple binary container (``.lcb``) for bulk storage, mmap-read;
- :func:`batched_gp_log_likelihood`: masked, vmapped GP log-likelihood
  over a batch — padded samples are exactly inert (A=1, U=V=0, resid=0),
  the same trick the block-parallel solver uses for padding;
- :func:`make_fleet_loglik`: the same over many parameter sets.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from typing import NamedTuple, Sequence

import numpy as np

__all__ = [
    "LightCurveBatch",
    "save_lcb",
    "load_lcb",
    "batched_gp_log_likelihood",
    "make_fleet_loglik",
]

_MAGIC = b"CTLC"
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "lightcurve_io.cpp")
_BUILD_DIR = os.path.join(_ROOT, "native", "build")

_lib = None
_tried = False


def _get_lib():
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        try:
            with open(_SRC, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            os.makedirs(_BUILD_DIR, exist_ok=True)
            so = os.path.join(
                _BUILD_DIR, "lightcurve_io_{0}.so".format(digest)
            )
            if not os.path.exists(so):
                tmp = so + ".tmp.{0}".format(os.getpid())
                subprocess.run(
                    [
                        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                        "-pthread", "-o", tmp, _SRC,
                    ],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            i64 = ctypes.c_int64
            dptr = np.ctypeslib.ndpointer(
                np.float64, flags="C_CONTIGUOUS"
            )
            iptr = np.ctypeslib.ndpointer(
                np.int64, flags="C_CONTIGUOUS"
            )
            lib.lc_pack.restype = None
            lib.lc_pack.argtypes = [
                i64, i64, dptr, iptr, ctypes.c_double, dptr, ctypes.c_int
            ]
            lib.lc_pack_repeat.restype = None
            lib.lc_pack_repeat.argtypes = [
                i64, i64, dptr, iptr, dptr, ctypes.c_int
            ]
            assert lib.lc_abi_version() == 1
            _lib = lib
        except Exception:
            _lib = None
    return _lib


def _pack(ragged: Sequence[np.ndarray], nmax, fill=0.0, repeat_edge=False):
    arrays = [np.ascontiguousarray(a, dtype=np.float64) for a in ragged]
    lengths = np.array([len(a) for a in arrays], dtype=np.int64)
    offsets = np.zeros(len(arrays) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    flat = (
        np.concatenate(arrays)
        if arrays
        else np.zeros(0, dtype=np.float64)
    )
    out = np.empty((len(arrays), nmax), dtype=np.float64)
    lib = _get_lib()
    if lib is not None:
        if repeat_edge:
            lib.lc_pack_repeat(len(arrays), nmax, flat, offsets, out, 0)
        else:
            lib.lc_pack(len(arrays), nmax, flat, offsets, fill, out, 0)
    else:
        for b, a in enumerate(arrays):
            out[b, : len(a)] = a
            out[b, len(a):] = a[-1] if (repeat_edge and len(a)) else fill
    return out, lengths


class LightCurveBatch(NamedTuple):
    """Padded batch of light curves.

    t: (B, Nmax) sorted times, padded by repeating the last stamp;
    y, yerr: (B, Nmax) padded with zeros / ones; mask: (B, Nmax) bool;
    lengths: (B,).
    """

    t: np.ndarray
    y: np.ndarray
    yerr: np.ndarray
    mask: np.ndarray
    lengths: np.ndarray

    @classmethod
    def from_ragged(cls, ts, ys, yerrs, nmax=None):
        if not (len(ts) == len(ys) == len(yerrs)):
            raise ValueError("dimension mismatch")
        lengths = np.array([len(a) for a in ts], dtype=np.int64)
        if nmax is None:
            nmax = int(lengths.max()) if len(lengths) else 0
        t, _ = _pack(ts, nmax, repeat_edge=True)
        y, _ = _pack(ys, nmax, fill=0.0)
        yerr, _ = _pack(yerrs, nmax, fill=1.0)
        mask = np.arange(nmax)[None, :] < lengths[:, None]
        return cls(t=t, y=y, yerr=yerr, mask=mask, lengths=lengths)

    def __len__(self):
        return self.t.shape[0]


def save_lcb(path, ts, ys, yerrs):
    """Write ragged light curves to the .lcb binary container."""
    n = len(ts)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Iq", 1, n))
        for t, y, e in zip(ts, ys, yerrs):
            t = np.ascontiguousarray(t, dtype=np.float64)
            y = np.ascontiguousarray(y, dtype=np.float64)
            e = np.ascontiguousarray(e, dtype=np.float64)
            if not (len(t) == len(y) == len(e)):
                raise ValueError("dimension mismatch")
            f.write(struct.pack("<q", len(t)))
            f.write(t.tobytes())
            f.write(y.tobytes())
            f.write(e.tobytes())


def load_lcb(path, batch=True, nmax=None):
    """Read a .lcb container; returns a LightCurveBatch (or ragged lists)."""
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    if bytes(buf[:4]) != _MAGIC:
        raise ValueError("not an lcb file")
    version, n = struct.unpack("<Iq", bytes(buf[4:16]))
    if version != 1:
        raise ValueError("unsupported lcb version")
    ts, ys, es = [], [], []
    off = 16
    raw = buf
    for _ in range(n):
        (length,) = struct.unpack("<q", bytes(raw[off : off + 8]))
        off += 8
        nbytes = length * 8
        ts.append(
            np.frombuffer(raw, dtype=np.float64, count=length, offset=off)
        )
        off += nbytes
        ys.append(
            np.frombuffer(raw, dtype=np.float64, count=length, offset=off)
        )
        off += nbytes
        es.append(
            np.frombuffer(raw, dtype=np.float64, count=length, offset=off)
        )
        off += nbytes
    if not batch:
        return ts, ys, es
    return LightCurveBatch.from_ragged(ts, ys, es, nmax=nmax)


def batched_gp_log_likelihood(kernel, params, batch, dtype=None):
    """Vmapped masked GP log-likelihood over a LightCurveBatch.

    ``params``: (dim,) shared kernel parameters (use an outer vmap for
    per-curve parameters).  Returns (lls, oks) of shape (B,).  Padded
    samples are made exactly inert: U = V = 0, A = 1, resid = 0.
    """
    import jax
    import jax.numpy as jnp

    from .ops import seq
    from .ops.lower import Coefficients, lower

    if dtype is None:
        dtype = jnp.result_type(float)
    params = jnp.asarray(params, dtype)

    tb = jnp.asarray(batch.t, dtype)
    yb = jnp.asarray(batch.y, dtype)
    eb = jnp.asarray(batch.yerr, dtype)
    mb = jnp.asarray(batch.mask)
    nb = jnp.asarray(batch.lengths)

    def one(t, y, yerr, mask, n_valid):
        coeffs = Coefficients(
            *[c.astype(dtype) for c in kernel.get_padded_coefficients(params)],
            jitter=kernel.get_jitter(params).astype(dtype),
        )
        ssm = lower(coeffs, t, yerr**2)
        return seq.gp_log_likelihood_masked(ssm, y, mask, n_valid)

    return jax.vmap(one)(tb, yb, eb, mb, nb)


def make_fleet_loglik(kernel, batch: "LightCurveBatch", dtype=None,
                      n_chain=1):
    """Build ``theta -> (lls, oks)`` over a fleet of light curves.

    ``n_chain == 1``: ``params`` is one (dim,) parameter vector and the
    closure returns per-curve (lls, oks) of shape (B,), exactly
    :func:`batched_gp_log_likelihood`.

    ``n_chain > 1``: the closure accepts ``(n_chain, dim)`` parameters
    and returns each chain's fleet-summed (ll, ok) of shape (n_chain,)
    — the population-fit / SMC-particle hot path (BASELINE configs[4]).
    Both are the vmapped masked scan over curves.
    """
    import jax
    import jax.numpy as jnp

    def per_curve(params):
        return batched_gp_log_likelihood(kernel, params, batch, dtype=dtype)

    if n_chain == 1:
        return per_curve

    def per_chain(params):
        lls, oks = jax.vmap(per_curve)(params)
        return jnp.sum(lls, axis=-1), jnp.all(oks, axis=-1)

    return per_chain
