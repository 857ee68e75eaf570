"""Inference engine: NUTS/HMC, window adaptation, ADVI, SMC.

The reference delegates MCMC to scipy/emcee user-side
(docs/tutorials/modeling.rst:227-246); this layer is the new
component demanded by BASELINE.json: gradient-based samplers over the pure
(ll, ok) log-probability closures from GP.build_logprob, vmapped over chains
per chip and sharded across the mesh (see celerite_tpu.parallel).
"""

from . import (  # noqa: F401
    adaptation,
    advi,
    checkpoint,
    diagnostics,
    hmc,
    nuts,
    smc,
)
from .advi import fit_advi, laplace_fit  # noqa: F401
from .diagnostics import (  # noqa: F401
    ebfmi,
    effective_sample_size,
    split_rhat,
    summary,
)
from .nuts import sample_nuts, sample_nuts_batch  # noqa: F401
from .smc import sample_smc  # noqa: F401
