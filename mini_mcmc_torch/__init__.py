"""mini_mcmc_torch: the PyTorch + CUDA port of mini_mcmc_tpu.

Lockstep batched Metropolis-Hastings, HMC, MALA, NUTS, ChEES-HMC, the
ensemble stretch move, coordinate and elliptical slice sampling, Gibbs,
parallel tempering and stochastic-gradient SGLD/pSGLD/SGHMC over
``[n_chains, dim]`` tensors, log-Z by annealed importance sampling and
adaptive SMC, constrained parameters through
``transform=`` (``models/transforms.py``), with the fused tiers
(``use_pallas=True | "full" | "separable"``) run by hand-written CUDA kernels
for Hopper (``csrc/``) on CUDA tensors and by their plain PyTorch twins on
CPU tensors. Samplers and initial positions live on the GPU unless the
caller passes ``device="cpu"``. ``parallel`` shards the chains over a
``torch.distributed`` mesh, and ``data_parallel_grad`` a dataset.
``checkpoint`` saves and restores any sampler bit for bit, and ``io``
exports the sample cube as CSV, Arrow or
Parquet. The module names mirror ``mini_mcmc_tpu``'s,
which stays the reference the port is tested against; this package never
imports it or JAX.
"""

from . import io, models, ops, parallel, stats, utils
from .checkpoint import load_checkpoint, save_checkpoint
from .diagnostics import (
    ModernDiagnostics,
    Summary,
    rank_normalized_diagnostics,
    summary,
)
from .models import (
    CoordinateTransform,
    Preconditioner,
    diffable_gaussian2d,
    estimate_preconditioner,
    gaussian2d,
    gaussian_mixture_conditional,
    identity,
    interval,
    isotropic_gaussian_proposal,
    lower_bounded,
    neal_funnel,
    poisson_target,
    positive,
    precondition_target,
    random_walk_int_proposal,
    rosenbrock_nd,
    standard_normal,
    transformed_target,
    upper_bounded,
)
from .nuts import NUTS
from .ops.ais import AISResult, ais_log_z, linear_betas, resample
from .ops.sgmcmc import (
    data_parallel_grad,
    minibatch_grad,
    polynomial_decay,
    target_grad,
)
from .ops.smc import SMCResult, smc_log_z
from .ops.tempering import geometric_betas, tune_betas
from .runner import make_initial_recording_runner, make_simple_runner
from .samplers import (
    HMC,
    MALA,
    ChEESHMC,
    EllipticalSliceSampler,
    EnsembleSampler,
    GibbsSampler,
    MetropolisHastings,
    ParallelTempering,
    SGHMC,
    SGLD,
    SliceSampler,
)
from .stats import (
    RunStats,
    basic_stats,
    collect_rhat,
    run_stats,
    split_rhat_mean_ess,
)
from .stream import StreamResult, stream_run
from .utils.init import init, init_det, init_with_seed

__all__ = [
    "AISResult",
    "ChEESHMC",
    "CoordinateTransform",
    "EllipticalSliceSampler",
    "EnsembleSampler",
    "GibbsSampler",
    "HMC",
    "MALA",
    "MetropolisHastings",
    "ModernDiagnostics",
    "NUTS",
    "ParallelTempering",
    "Preconditioner",
    "RunStats",
    "SGHMC",
    "SGLD",
    "SMCResult",
    "SliceSampler",
    "StreamResult",
    "Summary",
    "ais_log_z",
    "basic_stats",
    "collect_rhat",
    "data_parallel_grad",
    "diffable_gaussian2d",
    "estimate_preconditioner",
    "gaussian2d",
    "gaussian_mixture_conditional",
    "geometric_betas",
    "identity",
    "init",
    "init_det",
    "init_with_seed",
    "interval",
    "io",
    "isotropic_gaussian_proposal",
    "linear_betas",
    "load_checkpoint",
    "lower_bounded",
    "make_initial_recording_runner",
    "make_simple_runner",
    "minibatch_grad",
    "models",
    "neal_funnel",
    "ops",
    "parallel",
    "poisson_target",
    "polynomial_decay",
    "positive",
    "precondition_target",
    "random_walk_int_proposal",
    "resample",
    "rank_normalized_diagnostics",
    "rosenbrock_nd",
    "run_stats",
    "save_checkpoint",
    "smc_log_z",
    "split_rhat_mean_ess",
    "standard_normal",
    "stats",
    "stream_run",
    "summary",
    "target_grad",
    "transformed_target",
    "tune_betas",
    "upper_bounded",
    "utils",
]
