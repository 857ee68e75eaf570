"""celerite_tpu: a scalable Gaussian-Process inference engine for accelerators.

A brand-new JAX/XLA/Pallas implementation of the capabilities of the
reference dfm/celerite package (scalable 1-D GP regression with
exponential-times-sinusoid kernels and exact O(N) semiseparable solvers),
re-architected for data-parallel accelerators: pure-function scan solvers with total (ok, value)
error semantics, statically-shaped kernel lowering for jit/vmap/grad, a
block-parallel factorization, and a sharded inference layer (NUTS/HMC, ADVI,
SMC) on top.
"""

from .gp import GP
from .modeling import ConstantModel, Model, ModelSet
from .solver import CARMASolver, CholeskySolver, LinAlgError
from . import data, modeling, native, ops, solver, terms

__version__ = "0.1.0"
__library_version__ = solver.__library_version__

__all__ = [
    "GP",
    "CholeskySolver",
    "CARMASolver",
    "LinAlgError",
    "Model",
    "ModelSet",
    "ConstantModel",
    "data",
    "modeling",
    "native",
    "ops",
    "solver",
    "terms",
    "__version__",
    "__library_version__",
]
