"""Sampler-chain checkpoint / resume.

The reference persists only the factorization via pickle
(solver.cpp:36-58); this build's long-running artifact is the sampler
state: chain positions, adaptation state (step size, mass matrix), and RNG
keys (SURVEY.md 5.4).  States are plain pytrees of arrays, stored as
compressed ``.npz`` with a flattened key -> array mapping, so checkpoints
are host-portable and need no framework at load time.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["save_state", "load_state", "SamplerState"]


def _flatten(prefix, obj, out):
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten("{0}.{1}".format(prefix, k) if prefix else str(k), v, out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten("{0}[{1}]".format(prefix, i), v, out)
    else:
        out[prefix] = np.asarray(obj)


def save_state(path, state, meta=None):
    """Save a pytree-of-arrays sampler state (dict/list/array nesting)."""
    flat = {}
    _flatten("", state, flat)
    if meta is not None:
        flat["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
    np.savez_compressed(path, **flat)


def load_state(path):
    """Load a checkpoint; returns (flat_dict, meta)."""
    data = np.load(path, allow_pickle=False)
    out = {}
    meta = None
    for k in data.files:
        if k == "__meta__":
            meta = json.loads(bytes(data[k].tobytes()).decode())
        else:
            out[k] = data[k]
    return out, meta


class SamplerState(dict):
    """Convenience dict for NUTS chain state.

    Keys: ``positions`` (C, D), ``step_size`` (), ``inv_mass`` (D,),
    ``rng_key`` (2,), ``iteration`` ().
    """

    @classmethod
    def create(cls, positions, step_size, inv_mass, rng_key, iteration=0):
        return cls(
            positions=np.asarray(positions),
            step_size=np.asarray(step_size),
            inv_mass=np.asarray(inv_mass),
            rng_key=np.asarray(rng_key),
            iteration=np.asarray(iteration),
        )

    def save(self, path):
        save_state(path, dict(self))

    @classmethod
    def load(cls, path):
        flat, _ = load_state(path)
        return cls(flat)
