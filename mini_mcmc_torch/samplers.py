"""User-facing sampler objects.

Counterpart of ``mini_mcmc_tpu/samplers.py`` (``_KernelSampler``,
``MetropolisHastings``, ``HMC``, ``MALA``, ``ChEESHMC``,
``EnsembleSampler``, ``ParallelTempering``, ``EllipticalSliceSampler``,
``SliceSampler``, ``GibbsSampler``, ``SGLD``, ``SGHMC``): construct with a
target (SG-MCMC: a gradient estimator) and initial positions, optionally
``seed``, then ``run(n_collect, n_discard)`` returns the ``[n_chains,
n_collect, dim]`` sample cube. The sampler carries the
state between runs, so consecutive runs continue the chains. ``tuned``
(HMC, MALA, MH) and ``warmed_up`` (HMC, MALA, ChEES-HMC) return new
samplers adapted by dual averaging (``ops/adapt.py``; ChEES also adapts
its trajectory length, ``ops/chees.py``). ``run_progress`` runs with a live
progress display and returns the cube with its :class:`~mini_mcmc_torch.
stats.RunStats`.

Seeding: each sampler owns a CPU ``torch.Generator``. Every ``run()`` takes
fresh words from it: a 64-bit Philox key for the fused kernel, and the seed
of a generator on the positions' device for the step-size jitter and the
non-fused tiers' draws, so no draw syncs the host.

Chain sharding: ``sampler.state = parallel.shard_sampler_state(mesh,
sampler.state)`` lays the chains out over a chain mesh (``parallel/``).
The sampler then keeps its rank's rows (``_state``) and where they lie
(``_layout``); ``state``, ``positions`` and the sample cubes come back as
DTensors sharded on their chain axis, and every step draws at its chains'
global places (``StepKey.chains``), so a shard's rows equal the unsharded
run's from the same seed. Assigning a sharded state hands every rank
rank 0's generator (one broadcast an axis of the mesh).

State splitting: ``shard_sampler_state(chain_state_mesh(a, b), state,
shard_state_dim=True)`` also splits D over the mesh's ``"state"`` axis
(``StepKey.state``). HMC, MALA and NUTS take such a state on the lockstep
tier (``use_pallas=False``, a diagonal metric allowed), HMC also on the
separable tier without a metric, ChEES-HMC (a diagonal metric allowed),
the ensemble, slice and elliptical slice samplers, ParallelTempering on
its plain tier, MetropolisHastings on its plain tier with a proposal that
sets ``Proposal.takes_state_split`` (the built-in random walks), and
SGLD, pSGLD and SGHMC on a ``grad_fn`` that sets ``takes_state_split``
(``minibatch_grad``, ``target_grad``), each without a transform; every
other sampler, tier, proposal and gradient raises ``ValueError`` at the
assignment (Gibbs sweeps its coordinates in order, and the fused tiers
keep a chain's whole row in one thread). ``tuned``,
``reconditioned("diag")``, ``warmed_up`` and ``retuned`` of a split
sampler build the new sampler on the split state, each rank from its own
D-slice.
"""

from __future__ import annotations

import secrets
from typing import Optional

import torch

from .models.base import (
    validate_conditional_dc,
    validate_coord_dc,
    validate_dc_forms,
    validate_proposal_dc,
    validate_separable,
)
from .models.precondition import (
    Preconditioner,
    estimate_preconditioner,
    precondition_target,
)
from .models.transforms import CoordinateTransform
from .ops.adapt import dual_average_step_size
from .ops.chees import chees_adapt, chees_hmc_kernel
from .ops.elliptical import elliptical_kernel
from .ops.ensemble import ensemble_kernel
from .ops.gibbs import gibbs_kernel
from .ops.hmc import hmc_kernel
from .ops.kernels import gibbs_full, hmc, hmc_full, hmc_sep, pt_full
from .ops.kernels._build import check_tier_dtype, kernel_lib
from .ops.kernels.gibbs_full import gibbs_lib
from .ops.kernels.hmc_sep import sep_instance
from .ops.kernels.mh_full import mh_lib
from .ops.kernels.pt_full import pt_lib
from .ops.mh import mh_kernel, mh_step_alpha
from .ops.sgmcmc import sghmc_kernel, sgld_kernel
from .ops.slice import slice_kernel
from .ops.tempering import geometric_betas, tempering_kernel, tune_betas
from .parallel.collectives import broadcast, gather_chains, split
from .parallel.mesh import _mesh_device, local_state
from .progress import progress_run
from .runner import (
    StepKey,
    _default_positions_of,
    make_block_runner,
    make_simple_runner,
)
from .stats import RunStats, run_stats
from .utils.init import resolve_device


def initial_positions_on(initial_positions, device) -> torch.Tensor:
    """A copy of ``initial_positions`` on ``device`` (``"cuda"`` by
    default; raises without a GPU): the sampler's state never aliases the
    caller's tensor."""
    return torch.as_tensor(initial_positions).to(
        resolve_device(device), copy=True)


def _generator(seed: Optional[int]) -> torch.Generator:
    if seed is None:
        seed = secrets.randbits(63)
    return torch.Generator().manual_seed(seed)


def _check_transformed_inits(transform, y) -> None:
    """Reject initial positions outside the transform's range
    (``mini_mcmc_tpu/samplers.py:53-82``): a bijector's inverse gives NaN
    or an infinity there, and the chain would cache a NaN density and
    freeze. One host check at construction names the offenders. (Values
    exactly on a boundary pass: the saturating inverses snap them just
    inside.)"""
    bad = ~torch.isfinite(y)
    if not bool(bad.any()):
        return
    chains, dims = torch.nonzero(bad.reshape(y.shape[0], -1),
                                 as_tuple=True)
    shown = ", ".join(
        f"(chain {c}, coordinate {d}: {transform._table[d].name})"
        for c, d in list(zip(chains.tolist(), dims.tolist()))[:5])
    raise ValueError(
        f"initial positions map to non-finite unconstrained values at "
        f"{int(bad.sum())} entries: they lie outside the transform's range "
        f"(e.g. a negative value for a positive() coordinate, or a value "
        f"above `high` for interval()). First offenders: {shown}. Initial "
        "positions are given in NATURAL coordinates and must lie inside "
        "every constrained coordinate's range.")


def _transform_of(transform, positions):
    """``transform`` checked: ``None`` for none or the identity, else a
    :class:`~mini_mcmc_torch.models.transforms.CoordinateTransform` of
    the positions' D; anything else raises ``ValueError``."""
    if transform is None:
        return None
    if not isinstance(transform, CoordinateTransform):
        raise ValueError("transform must be a CoordinateTransform (models."
                         f"transforms); got {type(transform).__name__}")
    if transform.dim != positions.shape[-1]:
        raise ValueError(f"a D={transform.dim} transform for positions of "
                         f"D={positions.shape[-1]}")
    return None if transform.is_identity else transform


def _wrap_sampler_target(target, positions, transform, metric, layout=None):
    """The samplers' coordinate wrap (``mini_mcmc_tpu/samplers.py:
    85-112``): the transform first (natural -> unconstrained,
    ``models/transforms.py``), then the metric's whitening of the
    unconstrained coordinates (``models/precondition.py``). Returns
    ``(kernel_target, kernel_positions, metric)``: the target the kernels
    run, the initial positions in its coordinates, and the metric on the
    positions' device (the map back is :meth:`_KernelSampler.
    _set_row_map`'s). Under a rebuild on a split state (``layout``, the
    rank's) the positions are the rank's D-slice: the metric's D is the
    global one and the rows whiten through its slice
    (:meth:`~mini_mcmc_torch.models.Preconditioner.at_slice`)."""
    kernel_target = target
    transform = _transform_of(transform, positions)
    if transform is not None:
        if not positions.dtype.is_floating_point:
            # the JAX package maps an integer state to float y and walks it
            # there, giving non-integer draws (ROADMAP.md, Queue 3)
            raise ValueError(
                "transform= maps positions to unconstrained real "
                f"coordinates and needs a floating-point state; got "
                f"{positions.dtype} (a discrete target takes no transform)")
        kernel_target = transform.wrap(target)
        positions = transform.to_y(positions)
        _check_transformed_inits(transform, positions)
    if metric is None:
        return kernel_target, positions, None
    if not isinstance(metric, Preconditioner):
        raise ValueError("metric must be a Preconditioner (models."
                         f"precondition); got {type(metric).__name__}")
    st = None if layout is None else layout.state
    dim = positions.shape[-1] if st is None else st.n_dim
    if metric.dim != dim:
        raise ValueError(f"a D={metric.dim} metric for positions of D="
                         f"{dim}")
    metric = metric.to(positions.device)
    rows = metric if st is None else metric.at_slice(st)
    return (precondition_target(kernel_target, metric), rows.to_y(positions),
            metric)


def _unconstrained_positions(sampler) -> torch.Tensor:
    """The ensemble in unconstrained, unwhitened coordinates, what
    ``estimate_preconditioner`` must see (``mini_mcmc_tpu/samplers.py:
    115-123``): the kernels run, and a metric whitens, the transform's
    y-space, so estimating from the natural ``positions`` would whiten the
    wrong space. Under a state split, every chain's D-slice of this
    rank."""
    pos = gather_chains(sampler._state.positions, sampler._chains)
    if sampler.metric is not None:
        st = sampler._state_group
        pos = (sampler.metric if st is None
               else sampler.metric.at_slice(st)).to_x(pos)
    return pos


def _estimate_metric(sampler, kind: str) -> Preconditioner:
    """The metric ``reconditioned(kind)`` estimates from ``sampler``'s
    ensemble: over every chain shard's chains (one all-gather of the
    rank's rows over the chain axis, so the estimate is the unsharded
    one), each rank of a state split its D-slice
    (:func:`~mini_mcmc_torch.models.estimate_preconditioner`)."""
    return estimate_preconditioner(_unconstrained_positions(sampler), kind,
                                   state=sampler._state_group)


class _KernelSampler:
    """Shared run/run_progress plumbing for kernel-based samplers.

    ``recorded(state)`` is the ``[C, D]`` tensor a run records, when it is
    not the (mapped) positions: tempering's cold rung.
    """

    def __init__(self, init_fn, step_fn, initial_positions, seed=None,
                 runner=None, recorded=None, layout=None):
        if initial_positions.dim() != 2:
            raise ValueError(
                "initial_positions must be [n_chains, dim]; got shape "
                f"{tuple(initial_positions.shape)}"
            )
        if layout is None:
            self._layout = None
            self.state = init_fn(initial_positions)
        else:  # a rebuild's rank (_rebuild): its rows, D-slices evaluated
            # on the split under a state split
            self._state = init_fn(initial_positions, layout.state)
            self._layout = layout
            self._set_row_map()
        self._step_fn = step_fn
        self._gen = _generator(seed)
        recorded = recorded or _default_positions_of
        self._recorded = recorded
        # one step a call: the runner of run_progress's sub-K tail, and
        # NUTS's chunked path
        self._simple_runner = make_simple_runner(step_fn, self._positions_of,
                                                 recorded)
        self._progress_block_size = 1
        block_fn = getattr(step_fn, "block_fn", None)
        if runner is not None:
            self._runner = runner
        elif block_fn is not None:
            # K fused sampler steps per call; run() lengths are multiples of K
            self._runner = make_block_runner(
                block_fn, step_fn.block_size, recorded=recorded,
                positions_map=None if self._positions_map is None
                else lambda rows: self._positions_map(rows))
            self._progress_block_size = step_fn.block_size
        else:
            self._runner = self._simple_runner

    def _positions_of(self, state) -> torch.Tensor:
        pos = self._recorded(state)
        if self._positions_map is None:
            return pos
        return self._positions_map(pos)

    @property
    def state(self):
        """The chains' state NamedTuple; under a chain mesh its tensor
        leaves are DTensors (``parallel.shard_sampler_state``). Assigning
        a sharded state shards this sampler."""
        return (self._state if self._layout is None
                else self._layout.wrap(self._state))

    @state.setter
    def state(self, value):
        local, layout = local_state(value)
        if layout is not None:
            self._check_shard(local, layout)
            if layout.chains.size > 1 or split(layout.state):
                self._share_generator(layout)
        self._state, self._layout = local, layout
        self._set_row_map()

    def _set_row_map(self) -> None:
        """Set ``_positions_map``, the map from the state's (unconstrained,
        whitened) rows to the user's coordinates applied to every recorded
        row and to ``positions``: the metric's un-whitening (its D-slice's
        under a state split), then the transform's; ``None`` without
        either."""
        metric = getattr(self, "metric", None)
        st = self._state_group
        rows = (None if metric is None
                else (metric if st is None else metric.at_slice(st)).to_x)
        natural = self.transform.to_x if self._transformed() else None
        if rows is None or natural is None:
            self._positions_map = rows or natural
        else:
            self._positions_map = lambda p: natural(rows(p))

    @property
    def _state_group(self):
        """The rank's :class:`~mini_mcmc_torch.parallel.collectives.
        StateGroup` under a state split, else ``None``."""
        return None if self._layout is None else self._layout.state

    #: what takes a state split over a "state" axis, for the refusals
    _STATE_SPLIT_TAKERS = (
        "lockstep HMC, MALA and NUTS (use_pallas=False; a diagonal metric "
        "allowed), HMC(use_pallas='separable') without a metric, ChEESHMC "
        "(a diagonal metric allowed), EnsembleSampler, SliceSampler, "
        "EllipticalSliceSampler, ParallelTempering(use_pallas=False), "
        "MetropolisHastings(use_pallas=False) with a proposal that sets "
        "takes_state_split (the built-in random walks), and SGLD, pSGLD "
        "and SGHMC with a grad_fn that sets it (minibatch_grad, "
        "target_grad), each without a transform")

    def _takes_state_split(self) -> bool:
        """Whether this sampler runs a state whose D is split over a
        ``"state"`` axis (the samplers that do override)."""
        return False

    def _transformed(self) -> bool:
        transform = getattr(self, "transform", None)
        return transform is not None and not transform.is_identity

    def _check_shard(self, local, layout) -> None:
        """Raise for a shard this sampler cannot run: a split D where it
        does not take one (and, in the ensemble sampler, broken
        ensembles)."""
        if layout.state is not None and not self._takes_state_split():
            raise ValueError(
                f"{self._tier_name()} takes its chains' whole state: a "
                "state split over a 'state' axis (shard_state_dim=True) "
                f"runs only on {self._STATE_SPLIT_TAKERS}; shard the "
                "chains alone (shard_state_dim=False)")

    def _tier_name(self) -> str:
        tier = getattr(self, "_ctor", {}).get("use_pallas", False)
        name = (f"{type(self).__name__}(use_pallas={tier!r})" if tier
                else type(self).__name__)
        metric = getattr(self, "metric", None)
        if self._transformed():
            return f"{name} with a transform"
        if metric is not None:
            return f"{name} with a {metric.kind} metric"
        return name


    def _share_generator(self, layout) -> None:
        """Every rank takes mesh rank 0's generator, so that a sharded
        run draws one stream whatever seed each rank was built with: one
        broadcast over the chain axis, then one over the state axis (a
        rank's state group then holds its chain shard's rank 0's, which
        is mesh rank 0's)."""
        g = self._gen.get_state().to(_mesh_device(layout.mesh))
        if layout.chains.size > 1:
            broadcast(g, layout.chains.group)
        if split(layout.state):
            broadcast(g, layout.state.group)
        self._gen.set_state(g.cpu())

    @property
    def _chains(self):
        """The rank's :class:`~mini_mcmc_torch.parallel.collectives.
        ChainGroup`, ``None`` unsharded."""
        return None if self._layout is None else self._layout.chains

    def _out(self, x: torch.Tensor, axis: int = 0):
        """A local tensor whose axis ``axis`` holds the rank's chains, as
        the caller sees it: itself unsharded, else a DTensor."""
        return x if self._layout is None else self._layout.wrap_chains(x,
                                                                       axis)

    def _rebuild(self, build):
        """The sampler ``build(layout)`` constructs from this sampler's
        local rows and layout (a rebuild of ``tuned`` or
        ``reconditioned``), sharded as this one is. Under a state split the
        constructor evaluates the target on the split (its ``init_fn``
        given the ``StateGroup``) and maps the rows through the metric's
        slice; a new sampler that does not take the split raises, as an
        assignment would."""
        new = build(self._layout)
        if self._layout is not None:
            new._check_shard(new._state, self._layout)
        return new

    def seed(self, seed: int):
        """Reseed the sampler (chainable)."""
        self._gen = _generator(seed)
        return self

    set_seed = seed

    def _child_generator(self) -> torch.Generator:
        """A generator seeded from this sampler's stream: a sampler derived
        without a seed keeps a seeded workflow reproducible."""
        return _generator(int(torch.randint(0, 2**62, (1,),
                                            generator=self._gen)))

    def _next_key(self) -> StepKey:
        w = torch.randint(0, 2**32, (3,), generator=self._gen,
                          dtype=torch.int64).tolist()
        device = self._state.positions.device
        gen = torch.Generator(device=device).manual_seed(w[2])
        return StepKey(seed=w[0] | (w[1] << 32), step=0, generator=gen,
                       chains=self._chains,
                       state=None if self._layout is None
                       else self._layout.state)

    @property
    def positions(self) -> torch.Tensor:
        """``[n_chains, dim]`` in the user's coordinates (the state's own
        are unconstrained under a transform, whitened under a metric)."""
        return self._out(self._positions_of(self._state))

    @property
    def n_chains(self) -> int:
        """The chains over every shard."""
        if self._layout is not None:
            return self._layout.chains.n_chains
        return self._recorded(self._state).shape[0]

    @property
    def dim(self) -> int:
        """The state dimension over every shard."""
        if self._layout is not None and self._layout.state is not None:
            return self._layout.state.n_dim
        return self._state.positions.shape[1]

    def run(self, n_collect: int, n_discard: int = 0, *,
            time_major: bool = False) -> torch.Tensor:
        """Advance ``n_collect + n_discard`` steps; return the last
        ``n_collect`` states as ``[n_chains, n_collect, dim]``, or
        ``[n_collect, n_chains, dim]`` with ``time_major=True`` (the layout
        the fused kernel writes rows into contiguously). A sharded sampler
        returns the cube as a DTensor sharded on its chain axis."""
        self._state, sample, _ = self._runner(
            self._state, self._next_key(), n_collect, n_discard,
            time_major=time_major,
        )
        return self._out(sample, 1 if time_major else 0)

    def run_progress(self, n_collect: int, n_discard: int = 0, *,
                     stream=None, time_major: bool = False
                     ) -> tuple[torch.Tensor, RunStats]:
        """:meth:`run` with live progress (a global bar and rotating
        per-chain ``p(accept)`` bars, the lockstep form of the reference's
        ``core.rs:208-360``) on ``stream`` (default stderr); returns
        ``(sample, run_stats(sample))``. A fused sampler runs its K-step
        blocks for the K-aligned bulk and single steps for a sub-K tail;
        at K-aligned lengths the cube is the one :meth:`run` gives from
        the same seed. A sharded sampler's display shows the global
        acceptance and R-hat and its rank's chains."""
        self._state, sample = progress_run(
            self._runner, self._state, self._next_key(), n_collect,
            n_discard, n_chains=self._recorded(self._state).shape[0],
            dim=self._recorded(self._state).shape[1], stream=stream,
            time_major=time_major,
            block_size=self._progress_block_size,
            tail_runner=self._simple_runner,
        )
        sample = self._out(sample, 1 if time_major else 0)
        return sample, run_stats(sample, time_major=time_major)


class MetropolisHastings(_KernelSampler):
    """Batched Metropolis-Hastings over parallel chains.

    Mirrors ``mini_mcmc_tpu.MetropolisHastings``'s constructor, so one
    kwargs dict builds both packages (``convert.mh_sampler_kwargs``).
    ``use_pallas="full"`` runs K whole steps per launch of Kernel 5
    (``ops/mh.py:mh_kernel``); it needs a symmetric proposal with a fused
    form (a built-in ``cuda_functor``, or ``propose_words`` and
    ``cuda_words`` with ``cuda_source`` on CUDA) and, on CUDA positions, a
    built-in (target, proposal, state dtype, D) or, for a user density
    (``Target.cuda_source``, or generated from its batch form) or a user
    proposal, a library of its own (float32, D <= 16), and raises
    ``ValueError`` otherwise, naming what is missing. With ``validate_dc``
    (the default) that library's density is held to the batch form and a
    user proposal to its twin on the initial positions
    (:func:`~mini_mcmc_torch.models.base.validate_dc_forms` with
    ``need_grad=False``, as the JAX sampler,
    :func:`~mini_mcmc_torch.models.base.validate_proposal_dc`).

    The state keeps the initial positions' dtype (an int32 init stays
    int32; its logp is float32). The sampler runs on ``device``
    (``"cuda"`` by default; it raises without a GPU); pass ``device="cpu"``
    for the plain tier and the kernel's plain twin on the CPU.

    :meth:`tuned` adapts the proposal scale by dual averaging. The plain
    tier takes a state split over a ``"state"`` axis (``ops/mh.py``) with
    a proposal that sets ``Proposal.takes_state_split`` (a random walk,
    whose draw at a coordinate reads no other coordinate and whose
    ``logp`` runs on DTensor views; the built-in walks set it); the
    assignment refuses any other proposal.
    ``transform``: optional :class:`~mini_mcmc_torch.models.transforms.
    CoordinateTransform`; ``target`` is then a density in natural
    coordinates and the proposal walks the unconstrained ones, while
    ``initial_positions``, the samples and ``positions`` stay natural.
    ``"full"`` runs it through Kernel 5's transformed instance
    (``targets.cuh:Transformed``). An integer state takes no transform
    (``ValueError``). ``pallas_interpret`` has no counterpart.

    Example:
        >>> import mini_mcmc_torch as mt
        >>> from mini_mcmc_torch.models import (gaussian2d,
        ...                                     isotropic_gaussian_proposal)
        >>> mh = mt.MetropolisHastings(
        ...     gaussian2d([0., 0.], [[1., 0.], [0., 1.]]),
        ...     isotropic_gaussian_proposal(1.0),
        ...     mt.init_det(4, 2, device="cpu"), device="cpu").seed(42)
        >>> tuple(mh.run(1000, 100).shape)
        (4, 1000, 2)
    """

    def __init__(self, target, proposal, initial_positions,
                 seed: Optional[int] = None, use_pallas=False,
                 steps_per_call: int = 1, transform=None,
                 validate_dc: bool = True, *, device="cuda", _layout=None):
        self.target = target
        self.proposal = proposal
        #: proposal scale factor against the proposal first constructed
        #: (1.0 unless this sampler came from :meth:`tuned`)
        self.scale_factor = 1.0
        self._ctor = dict(use_pallas=use_pallas,
                          steps_per_call=steps_per_call, transform=transform,
                          validate_dc=validate_dc, device=device)
        positions = initial_positions_on(initial_positions, device)
        kernel_target, positions, _ = _wrap_sampler_target(
            target, positions, transform, None)
        self.transform = transform
        self.kernel_target = kernel_target
        init_fn, step_fn = mh_kernel(kernel_target, proposal,
                                     use_pallas=use_pallas,
                                     steps_per_call=steps_per_call)
        if use_pallas and positions.is_cuda and positions.dim() == 2:
            # a pair the kernel cannot run (plain or transformed): raise
            # now; a user form's library is built here
            mh_lib(kernel_target, proposal, positions.dtype,
                   positions.shape[1], positions.device)
            if validate_dc:
                validate_dc_forms(kernel_target, positions, need_grad=False,
                                  proposal=proposal)
                validate_proposal_dc(proposal, kernel_target, positions)
        super().__init__(init_fn, step_fn, positions, seed,
                         layout=_layout)

    #: random-walk optimal acceptance rate (Roberts, Gelman & Gilks 1997)
    _default_target_accept = 0.234

    def _takes_state_split(self) -> bool:
        return (not self._ctor["use_pallas"] and not self._transformed()
                and self.proposal.takes_state_split)

    def _tier_name(self) -> str:
        name = super()._tier_name()
        if self.proposal.takes_state_split:
            return name
        return f"{name} with a proposal that does not set takes_state_split"

    def tuned(self, n_adapt: int = 500, *, target_accept=None,
              seed=None) -> "MetropolisHastings":
        """A new sampler continuing from the adapted positions with the
        proposal scale tuned by dual averaging
        (``mini_mcmc_tpu/samplers.py:312-361``): ``n_adapt`` plain MH steps
        from the current state (``ops/mh.py:mh_step_alpha``) drive the
        cross-chain mean acceptance toward ``target_accept`` (default
        0.234, the random-walk optimum); the averaged factor is then
        frozen. Needs a proposal with a ``scaled`` family
        (``Proposal.scaled``; the Gaussian random walks have one) and
        raises ``ValueError`` otherwise. The new sampler's proposal is
        ``proposal.scaled(factor)`` with ``factor`` a host float, so the
        fused kernel gets it in ``cuda_params``; ``scale_factor`` is the
        cumulative factor against the first proposal. Without ``seed`` the
        new sampler's generator is seeded from this sampler's, so a seeded
        workflow stays reproducible. On a split state the factor is the
        same host float on every rank and the new sampler is split as
        this one is."""
        if self.proposal.scaled is None:
            raise ValueError(
                "tuned() needs a proposal with a `scaled` family "
                "(Proposal.scaled); the built-in Gaussian random-walk "
                "proposals provide one")
        if target_accept is None:
            target_accept = self._default_target_accept
        # the kernel's target: under a transform the state is
        # unconstrained (the JAX package tunes on the natural target there,
        # mini_mcmc_tpu/samplers.py:340, a fault not copied)
        step_eps = mh_step_alpha(self.kernel_target, self.proposal.scaled)
        state, factor, _ = dual_average_step_size(
            step_eps, self._state, self._next_key(), n_adapt, 1.0,
            target_accept)
        new = self._rebuild(lambda layout: MetropolisHastings(
            self.target, self.proposal.scaled(factor),
            self._positions_of(state), seed=seed, _layout=layout,
            **self._ctor))
        # cumulative: self.proposal is already scaled by self.scale_factor
        new.scale_factor = self.scale_factor * factor
        if seed is None:
            new._gen = self._child_generator()
        return new


def check_kernel_target(kernel_target, positions, validate_dc: bool,
                        tier: str) -> None:
    """Raise now, at construction, for a target Kernels 1-4 cannot run on
    ``positions`` (CUDA, kernel coordinates): a state dtype that ``tier``
    (a kernel module's ``TIER``) does not take, a built-in functor at a D
    it is not built for, or a batch form the code generator cannot
    translate (named); this builds a user density's library (Kernel 1's
    float64 one for float64 positions). With ``validate_dc`` the compiled
    user density is held to its batch form there
    (:func:`~mini_mcmc_torch.models.base.validate_dc_forms`)."""
    check_tier_dtype(tier, positions.dtype)
    kernel_lib(kernel_target, positions.shape[1], positions.device,
               positions.dtype)
    if validate_dc:
        validate_dc_forms(kernel_target, positions)


class HMC(_KernelSampler):
    """Batched Hamiltonian Monte Carlo (data-parallel leapfrog).

    Mirrors ``mini_mcmc_tpu.HMC``'s constructor, so one kwargs dict builds
    both packages. ``use_pallas`` selects the fused hand-written kernel
    tier: ``True`` fuses the leapfrog trajectory, ``"full"`` whole K-step
    blocks, ``"separable"`` the large-D tier for coordinate-separable
    targets (see :func:`~mini_mcmc_torch.ops.hmc.hmc_kernel`). On CUDA
    positions ``True`` and ``"full"`` run a built-in CUDA density
    (``Target.cuda_functor``) or compile the target's own C++
    (``Target.cuda_source``, or C++ generated from its batch form; D <=
    16), raising ``ValueError`` now for a batch form the generator cannot
    translate; with ``validate_dc`` (the default) a compiled density is
    held to the batch form on the initial positions
    (:func:`~mini_mcmc_torch.models.base.validate_dc_forms`).
    ``"separable"`` runs a coordinate functor on CUDA: a built-in one
    (``_build.SEP_FUNCTORS``), ``Target.cuda_coord_source``, or the one
    generated from the target's tile form (at most two tables), checked
    under ``validate_dc`` against the tile form and autograd
    (:func:`~mini_mcmc_torch.models.base.validate_coord_dc`); it validates
    separability on the initial positions
    (:func:`~mini_mcmc_torch.models.base.validate_separable`) on every
    device, and nothing turns that off (``validate_dc`` included).

    The sampler runs on ``device`` (``"cuda"`` by default; it raises
    without a GPU), where it moves a copy of the initial positions; pass
    ``device="cpu"`` for the plain twins on the CPU.

    The JAX-only knobs have no counterpart here: ``unroll`` (no scan to
    unroll) and ``pallas_interpret`` (CPU tensors run the kernels' plain
    twins). ``convert.sampler_kwargs`` drops them.

    ``metric``: optional :class:`~mini_mcmc_torch.models.Preconditioner`;
    the sampler runs in whitened coordinates ``y = L^-1 x`` (HMC with mass
    matrix ``(L L^T)^-1``) on the plain, ``True`` and ``"full"`` tiers, the
    kernels through their affine wrapper (``models/precondition.py``).
    ``initial_positions``, recorded samples and ``positions`` stay in x;
    ``state`` and ``step_size`` are the whitened ones, ``kernel_target``
    the whitened target. Under ``"separable"`` a diagonal metric runs
    Kernel 7's scaled instance on CUDA (the scale as one more coordinate
    table) and its twin on the CPU; a dense metric couples the coordinates
    and the tier's validation rejects it.

    ``transform``: optional :class:`~mini_mcmc_torch.models.transforms.
    CoordinateTransform`; ``target`` is then a density in natural
    coordinates (e.g. ``tau > 0``, no Jacobian terms) and the sampler runs
    on its unconstrained wrap (``models/transforms.py``), on every tier:
    the kernels through their transformed instances. ``initial_positions``
    (which must lie inside every constrained coordinate's range), the
    samples and ``positions`` stay natural. A metric whitens the
    unconstrained coordinates.

    :meth:`tuned` dual-averages the step size, :meth:`reconditioned`
    estimates a metric from the ensemble, and :meth:`warmed_up` composes
    the two (``tuned``, ``reconditioned``, ``tuned``).
    """

    def __init__(self, target, initial_positions, step_size: float,
                 n_leapfrog: int, seed: Optional[int] = None,
                 use_pallas=False, jitter: float = 0.0,
                 steps_per_call: int = 1, metric=None, transform=None,
                 validate_dc: bool = True, *, device="cuda", _layout=None):
        self.target = target
        self.step_size = step_size
        self.n_leapfrog = n_leapfrog
        self.transform = transform
        self._ctor = dict(step_size=step_size, n_leapfrog=n_leapfrog,
                          use_pallas=use_pallas, jitter=jitter,
                          steps_per_call=steps_per_call, transform=transform,
                          validate_dc=validate_dc, device=device)
        positions = initial_positions_on(initial_positions, device)
        kernel_target, positions, self.metric = (
            _wrap_sampler_target(target, positions, transform, metric,
                                 _layout))
        self.kernel_target = kernel_target
        # a rebuild on a split state holds D-slices: its target was
        # validated on the whole state when the first sampler was built
        whole = _layout is None or _layout.state is None
        if use_pallas == "separable":
            if whole:
                validate_separable(kernel_target, positions)
            if positions.is_cuda:
                # a target the kernel cannot run: raise now
                sep_instance(kernel_target)
                check_tier_dtype(hmc_sep.TIER, positions.dtype)
                if validate_dc and whole:
                    validate_coord_dc(kernel_target, positions)
        elif use_pallas and positions.is_cuda:
            check_kernel_target(
                kernel_target, positions, validate_dc,
                hmc_full.TIER if use_pallas == "full" else hmc.TIER)
        init_fn, step_fn = hmc_kernel(kernel_target, step_size, n_leapfrog,
                                      use_pallas=use_pallas, jitter=jitter,
                                      steps_per_call=steps_per_call)
        super().__init__(init_fn, step_fn, positions, seed,
                         layout=_layout)

    #: the dual-averaging default: the optimal acceptance rate of
    #: fixed-L HMC (Beskos et al. 2013); MALA overrides it with 0.574
    _default_target_accept = 0.651

    def _takes_state_split(self) -> bool:
        tier = self._ctor["use_pallas"]
        if self._transformed():
            return False
        if self.metric is None:
            return tier in (False, "separable")
        return tier is False and self.metric.kind == "diag"

    def _check_shard(self, local, layout) -> None:
        super()._check_shard(local, layout)
        state = layout.state
        if (split(state) and self._ctor["use_pallas"] == "separable"
                and state.n_dim % (4 * state.size)):
            raise ValueError(
                f"HMC(use_pallas='separable') splits D at multiples of 4 "
                f"(Kernel 7's coordinate quads): D = {state.n_dim} over "
                f"{state.size} 'state' shards needs D a multiple of "
                f"{4 * state.size}")

    @classmethod
    def _construct(cls, target, positions, metric, seed, ctor, layout):
        """The rebuild of :meth:`tuned` and :meth:`reconditioned` on the
        rank's ``layout``: a subclass with a narrower signature (MALA)
        filters ``ctor`` here."""
        return cls(target, positions, metric=metric, seed=seed,
                   _layout=layout, **ctor)

    def tuned(self, n_adapt: int = 500, *, target_accept=None,
              seed=None) -> "HMC":
        """A new sampler continuing from the adapted positions at a step
        size tuned by dual averaging (``mini_mcmc_tpu/samplers.py:
        427-458``): ``n_adapt`` steps of this sampler's tier from the
        current state (``step_fn.step_eps``; under ``"full"`` that is
        Kernel 1's trajectory, the momentum and accept outside), then
        ``exp(log_eps_bar)`` is frozen. ``target_accept`` defaults to the
        algorithm's optimum (0.651 for HMC, 0.574 for MALA). The step size
        is in the kernel's (whitened) coordinates; the positions go back
        to the user's. Without ``seed`` the new sampler's generator is
        seeded from this sampler's, so a seeded workflow stays
        reproducible. A split sampler tunes on its split state (the mean
        acceptance is every chain's, the same on every rank) and returns
        a split sampler."""
        if target_accept is None:
            target_accept = self._default_target_accept
        state, eps, _ = dual_average_step_size(
            self._step_fn.step_eps, self._state, self._next_key(), n_adapt,
            self._ctor["step_size"], target_accept)
        ctor = dict(self._ctor, step_size=eps)
        new = self._rebuild(lambda layout: type(self)._construct(
            self.target, self._positions_of(state), self.metric, seed, ctor,
            layout))
        if seed is None:
            new._gen = self._child_generator()
        return new

    def warmed_up(self, n_adapt: int = 300, kind: str = "diag", *,
                  target_accept=None, seed=None) -> "HMC":
        """The warm-up in one call (``mini_mcmc_tpu/samplers.py:460-487``):
        :meth:`tuned` (``n_adapt`` steps at the current metric, which also
        equilibrates the ensemble), :meth:`reconditioned` (``kind``), and
        :meth:`tuned` again in the whitened coordinates. ``target_accept``
        applies to both tuning legs. Returns a new sampler of this class;
        without ``seed`` its generator descends from this sampler's."""
        rough = self.tuned(n_adapt, target_accept=target_accept)
        pre = rough.reconditioned(kind)
        return pre.tuned(n_adapt, target_accept=target_accept, seed=seed)

    def reconditioned(self, kind: str = "diag", *, seed=None,
                      step_size=None, n_leapfrog=None) -> "HMC":
        """A new HMC continuing from the current positions, whitened by a
        metric estimated from the chain ensemble
        (``mini_mcmc_tpu/samplers.py:489-527``). Run a warm-up first, so
        that the ensemble is in the typical set. ``kind``: ``"diag"`` or
        ``"dense"``.

        The step size moves to whitened units, ``eps_y = eps_x /
        sigma_min(metric)``, after undoing this sampler's own metric
        (``eps_x = eps_y * sigma_min``); ``step_size``/``n_leapfrog``
        override. Without ``seed`` the new sampler's generator is seeded
        from this sampler's, so a seeded workflow stays reproducible. On a
        split state each rank estimates its D-slice of a diagonal metric
        (``kind="dense"`` raises there) and the new sampler is split as
        this one is."""
        pre = _estimate_metric(self, kind)
        ctor = dict(self._ctor)
        eps_x = ctor["step_size"] * (
            self.metric.sigma_min() if self.metric is not None else 1.0)
        ctor["step_size"] = (
            step_size if step_size is not None else eps_x / pre.sigma_min())
        if n_leapfrog is not None:
            ctor["n_leapfrog"] = n_leapfrog
        new = self._rebuild(lambda layout: type(self)._construct(
            self.target, self._positions_of(self._state), pre, seed, ctor,
            layout))
        if seed is None:
            new._gen = self._child_generator()
        return new


class MALA(HMC):
    """Metropolis-adjusted Langevin algorithm: HMC with one leapfrog step
    (``mini_mcmc_tpu/samplers.py:530-588``).

    The proposal ``x' = x + (eps^2 / 2) grad logp(x) + eps xi``, ``xi ~
    N(0, I)``, with the Metropolis correction, is one leapfrog step of HMC
    and its Hamiltonian accept, term for term; so every HMC tier, a
    ``metric=`` and the kernels carry over (``"full"``: Kernel 2 at L=1).
    ``step_size`` is the proposal std ``eps``. :meth:`tuned` dual-averages
    it toward the MALA optimum acceptance 0.574 (Roberts & Rosenthal
    1998). Runs on ``device`` (``"cuda"`` by default).

    Example:
        >>> import mini_mcmc_torch as mt
        >>> mala = mt.MALA(mt.standard_normal(), mt.init_det(4, 2,
        ...                device="cpu"), step_size=1.0,
        ...                device="cpu").seed(42)
        >>> tuple(mala.run(1000, 100).shape)
        (4, 1000, 2)
    """

    _default_target_accept = 0.574

    def __init__(self, target, initial_positions, step_size: float,
                 seed: Optional[int] = None, use_pallas=False,
                 steps_per_call: int = 1, metric=None, transform=None,
                 validate_dc: bool = True, *, device="cuda", _layout=None):
        super().__init__(target, initial_positions, step_size, n_leapfrog=1,
                         seed=seed, use_pallas=use_pallas,
                         steps_per_call=steps_per_call, metric=metric,
                         transform=transform, validate_dc=validate_dc,
                         device=device, _layout=_layout)

    @classmethod
    def _construct(cls, target, positions, metric, seed, ctor, layout):
        ctor = {k: v for k, v in ctor.items()
                if k not in ("n_leapfrog", "jitter")}
        return cls(target, positions, metric=metric, seed=seed,
                   _layout=layout, **ctor)

    def reconditioned(self, kind: str = "diag", *, seed=None,
                      step_size=None, n_leapfrog=None) -> "MALA":
        if n_leapfrog is not None:
            raise ValueError(
                "MALA has no trajectory length to override (n_leapfrog is "
                "fixed at 1); use HMC for longer trajectories")
        return super().reconditioned(kind, seed=seed, step_size=step_size)


class ChEESHMC(_KernelSampler):
    """Jittered-trajectory HMC with ChEES trajectory-length adaptation
    (``mini_mcmc_tpu/samplers.py:591-711``, ``ops/chees.py``): every chain
    integrates for one shared time ``u T`` a step, the lockstep
    alternative to NUTS.

    Construct with a rough ``step_size`` (``traj_len`` defaults to it, one
    leapfrog), call :meth:`warmed_up` to adapt the step size (dual
    averaging toward 0.651) and ``traj_len`` (Adam on the ChEES
    criterion) together, then :meth:`run`. A step's leapfrog count is a
    host integer, so ``run()`` reads nothing from the device. ``metric``
    and ``transform`` as :class:`HMC`'s (the kernel's coordinates are
    unconstrained, then whitened); runs on ``device`` (``"cuda"`` by
    default; ``device="cpu"`` on the CPU). A state split over a
    ``"state"`` axis runs without a transform, a diagonal metric allowed
    (``ops/chees.py``); :meth:`warmed_up` and ``reconditioned("diag")``
    of a split sampler return a split one.

    Example:
        >>> import mini_mcmc_torch as mt
        >>> ch = mt.ChEESHMC(mt.gaussian2d([0., 0.], [[1., 0.], [0., 1.]]),
        ...                  mt.init_det(64, 2, device="cpu"),
        ...                  step_size=0.5, seed=42, device="cpu")
        >>> tuple(ch.warmed_up(50).run(100, 20).shape)
        (64, 100, 2)
    """

    _default_target_accept = 0.651

    def __init__(self, target, initial_positions, step_size: float,
                 traj_len: Optional[float] = None, max_leapfrog: int = 1024,
                 seed: Optional[int] = None, metric=None, transform=None, *,
                 device="cuda", _layout=None):
        self.target = target
        self.step_size = step_size
        #: the integration time T: a step integrates for u T, u ~ U(0, 1),
        #: about T / (2 step_size) leapfrogs on average
        self.traj_len = float(traj_len) if traj_len is not None else step_size
        self.max_leapfrog = max_leapfrog
        self.transform = transform
        self._ctor = dict(max_leapfrog=max_leapfrog, transform=transform,
                          device=device)
        positions = initial_positions_on(initial_positions, device)
        kernel_target, positions, self.metric = (
            _wrap_sampler_target(target, positions, transform, metric,
                                 _layout))
        self.kernel_target = kernel_target
        init_fn, step_fn = chees_hmc_kernel(kernel_target, step_size,
                                            self.traj_len, max_leapfrog)
        super().__init__(init_fn, step_fn, positions, seed, layout=_layout)

    def _takes_state_split(self) -> bool:
        return not self._transformed() and (self.metric is None
                                            or self.metric.kind == "diag")

    def warmed_up(self, n_adapt: int = 500, *, target_accept=None,
                  adam_lr: float = 0.025, seed=None) -> "ChEESHMC":
        """A new sampler continuing from the adapted positions with the
        step size and trajectory length tuned together
        (``ops/chees.py:chees_adapt``: ``n_adapt`` jittered steps, Halton
        jitter, one device read a step). The returned sampler's
        ``warmup_trace`` holds the per-step ``alpha``, ``traj_len`` and
        ``eps``. Without ``seed`` its generator descends from this
        sampler's, so a seeded workflow stays reproducible. A split
        sampler adapts on its split state (every rank reads the same
        summed statistics and tunes alike) and returns a split sampler."""
        if target_accept is None:
            target_accept = self._default_target_accept
        state, eps, traj_len, trace = chees_adapt(
            self.kernel_target, self._state, self._next_key(), n_adapt,
            self.step_size, self.traj_len, target_accept=target_accept,
            adam_lr=adam_lr, max_leapfrog=self.max_leapfrog)
        new = self._rebuild(lambda layout: ChEESHMC(
            self.target, self._positions_of(state), eps, traj_len,
            seed=seed, metric=self.metric, _layout=layout, **self._ctor))
        new.warmup_trace = trace
        if seed is None:
            new._gen = self._child_generator()
        return new

    def reconditioned(self, kind: str = "diag", *, seed=None,
                      step_size=None, traj_len=None) -> "ChEESHMC":
        """A new ChEESHMC continuing from the current positions, whitened
        by a metric estimated from the ensemble (:meth:`HMC.reconditioned`'s
        contract): the step size and the trajectory length move to whitened
        units through ``sigma_min`` after undoing this sampler's metric;
        ``step_size``/``traj_len`` override. A later :meth:`warmed_up`
        tunes both anew. On a split state each rank estimates its D-slice
        of a diagonal metric (``kind="dense"`` raises there) and the new
        sampler is split as this one is."""
        pre = _estimate_metric(self, kind)
        old = self.metric.sigma_min() if self.metric is not None else 1.0
        new_min = pre.sigma_min()
        new = self._rebuild(lambda layout: ChEESHMC(
            self.target, self._positions_of(self._state),
            step_size if step_size is not None
            else self.step_size * old / new_min,
            traj_len if traj_len is not None
            else self.traj_len * old / new_min,
            seed=seed, metric=pre, _layout=layout, **self._ctor))
        if seed is None:
            new._gen = self._child_generator()
        return new


class EnsembleSampler(_KernelSampler):
    """Affine-invariant ensemble sampler, the stretch move of Goodman &
    Weare (2010) (``mini_mcmc_tpu/samplers.py:714-756``,
    ``ops/ensemble.py``).

    ``initial_positions [C, D]`` holds ``C / walkers_per_ensemble``
    independent ensembles advancing in one batch (one ensemble of all C by
    default); use >= 2 D walkers an ensemble and a spread initial cloud.
    One ``run`` row is one sweep (both halves). ``steps_per_call`` > 1
    runs K sweeps a block. ``transform``: the move interpolates in the
    unconstrained space; samples and ``positions`` stay natural. Runs on
    ``device`` (``"cuda"`` by default). A state split over a ``"state"``
    axis runs without a transform (``ops/ensemble.py``), each chain shard
    holding whole ensembles.
    """

    def __init__(self, target, initial_positions,
                 walkers_per_ensemble: Optional[int] = None, a: float = 2.0,
                 seed: Optional[int] = None, steps_per_call: int = 1,
                 transform=None, *, device="cuda"):
        self.target = target
        self.a = a
        self.transform = transform
        positions = initial_positions_on(initial_positions, device)
        kernel_target, positions, _ = _wrap_sampler_target(
            target, positions, transform, None)
        self.kernel_target = kernel_target
        if walkers_per_ensemble is None:
            walkers_per_ensemble = positions.shape[0]
        self.walkers_per_ensemble = walkers_per_ensemble
        init_fn, step_fn = ensemble_kernel(
            kernel_target, walkers_per_ensemble=walkers_per_ensemble, a=a,
            steps_per_call=steps_per_call)
        super().__init__(init_fn, step_fn, positions, seed)

    def _takes_state_split(self) -> bool:
        return not self._transformed()

    def _check_shard(self, local, layout) -> None:
        super()._check_shard(local, layout)
        # a shard holds whole ensembles: partners never cross a rank
        c = local.positions.shape[0]
        if c % self.walkers_per_ensemble:
            raise ValueError(
                f"a shard of {c} chains does not hold whole ensembles of "
                f"walkers_per_ensemble={self.walkers_per_ensemble}; shard "
                "a chain count whose share per rank is a multiple of it")


class EllipticalSliceSampler(_KernelSampler):
    """Elliptical slice sampling (Murray, Adams & MacKay 2010) for ``p(x)
    ~ N(x; prior_mean, Sigma) L(x)`` (``mini_mcmc_tpu/samplers.py:
    874-912``, ``ops/elliptical.py``).

    ``loglik`` is the likelihood ``L`` alone (a Target); the prior is
    ``prior_mean`` (scalar or ``[D]``) and ``prior_scale`` (a scalar std,
    ``[D]`` stds or the ``[D, D]`` lower Cholesky factor of Sigma), handled
    exactly by the ellipse. Nothing to tune. Runs on ``device`` (``"cuda"``
    by default). It runs a state split over a ``"state"`` axis
    (``ops/elliptical.py``).
    """

    def __init__(self, loglik, initial_positions, prior_mean=0.0,
                 prior_scale=1.0, max_shrink: int = 32,
                 seed: Optional[int] = None, steps_per_call: int = 1, *,
                 device="cuda"):
        self.loglik = loglik
        self.prior_mean = prior_mean
        self.prior_scale = prior_scale
        positions = initial_positions_on(initial_positions, device)
        init_fn, step_fn = elliptical_kernel(
            loglik, prior_mean=prior_mean, prior_scale=prior_scale,
            max_shrink=max_shrink, steps_per_call=steps_per_call)
        super().__init__(init_fn, step_fn, positions, seed)

    def _takes_state_split(self) -> bool:
        return True


class SliceSampler(_KernelSampler):
    """Coordinate-wise slice sampler (Neal 2003): one step is one sweep
    over the coordinates, stepping out and shrinkage in masked lockstep
    loops (``mini_mcmc_tpu/samplers.py:915-968``, ``ops/slice.py``).

    ``width``: the initial bracket, a scalar or ``[D]``, or ``"auto"``:
    the per-coordinate cross-chain std (ddof 0) of the initial positions
    in the kernel's coordinates, 1 where that spread is at most 1e-6. Any
    positive width is exact. ``transform``: the bracket walks the
    unconstrained space. Runs on ``device`` (``"cuda"`` by default). A
    state split over a ``"state"`` axis runs without a transform
    (``ops/slice.py``: one all-reduce a density evaluation, so a sweep
    costs about D times the evaluations of one coordinate's update).
    """

    def __init__(self, target, initial_positions, width=1.0,
                 max_stepouts: int = 8, max_shrink: int = 32,
                 seed: Optional[int] = None, steps_per_call: int = 1,
                 transform=None, *, device="cuda"):
        self.target = target
        self.transform = transform
        positions = initial_positions_on(initial_positions, device)
        kernel_target, positions, _ = _wrap_sampler_target(
            target, positions, transform, None)
        self.kernel_target = kernel_target
        if isinstance(width, str):
            if width != "auto":
                raise ValueError(
                    f'width must be positive or "auto", got {width!r}')
            spread = torch.std(positions, dim=0, correction=0)
            width = torch.where(spread > 1e-6, spread, 1.0)
        self.width = width
        init_fn, step_fn = slice_kernel(
            kernel_target, width=width, max_stepouts=max_stepouts,
            max_shrink=max_shrink, steps_per_call=steps_per_call)
        super().__init__(init_fn, step_fn, positions, seed)

    def _takes_state_split(self) -> bool:
        return not self._transformed()


class GibbsSampler(_KernelSampler):
    """Batched Gibbs sampler: one step is one full coordinate sweep
    (reference ``gibbs.rs:95-99``).

    Mirrors ``mini_mcmc_tpu.GibbsSampler``'s constructor.
    ``use_pallas="full"`` runs K whole sweeps per launch of Kernel 6
    (``ops/gibbs.py:gibbs_kernel``); it needs a conditional with a fused
    form (a built-in ``cuda_functor``, or ``sample_words`` and
    ``cuda_words`` with ``cuda_source`` on CUDA, in a library of its own
    at D <= 16) and, on CUDA positions, float32 states at an instantiated
    D. A user conditional's compiled sweep is always held to its twin on
    the initial positions (:func:`~mini_mcmc_torch.models.base.
    validate_conditional_dc`; the JAX sampler needs no such check, since
    one ``sample_dc`` serves its kernel and its twin). ``steps_per_call``
    > 1 fuses K sweeps per
    call (run lengths must then be multiples of K). Runs on ``device``
    (``"cuda"`` by default); ``device="cpu"`` runs the plain tier and the
    kernel's plain twin on the CPU.
    """

    def __init__(self, conditional, initial_positions,
                 seed: Optional[int] = None, use_pallas=False,
                 steps_per_call: int = 1, *, device="cuda"):
        self.conditional = conditional
        positions = initial_positions_on(initial_positions, device)
        init_fn, step_fn = gibbs_kernel(conditional, use_pallas=use_pallas,
                                        steps_per_call=steps_per_call)
        if use_pallas and positions.is_cuda:
            # raise now; a user conditional's library is built here
            check_tier_dtype(gibbs_full.TIER, positions.dtype)
            gibbs_lib(conditional, positions.shape[-1])
            validate_conditional_dc(conditional, positions)
        super().__init__(init_fn, step_fn, positions, seed)


def _cold(state) -> torch.Tensor:
    """The cold rung of a ``[T, D, C]`` replica batch as ``[C, D]``."""
    return state.positions[0].T


class ParallelTempering(_KernelSampler):
    """Replica-exchange random-walk Metropolis (``ops/tempering.py``).

    Mirrors ``mini_mcmc_tpu.ParallelTempering``'s constructor: ``C``
    logical chains, each with ``len(betas)`` replicas against ``beta *
    logp`` (``betas`` defaults to ``geometric_betas(8)``), the cold-chain
    random-walk scale ``proposal_std`` (a scalar or ``[D]``; rung t uses
    ``proposal_std / sqrt(beta_t)``), ``n_inner`` sweeps per swap sweep.
    The sample cube holds only the cold rung, ``[n_chains, n_collect,
    dim]``; hot replicas are internal state. ``swap_acceptance`` is the
    per-pair EWMA of swap accepts, averaged over chains.

    ``use_pallas="full"`` runs ``steps_per_call`` whole steps per launch
    of Kernel 8 (``ops/kernels/pt_full.py``); on CUDA positions it needs a
    target whose ``cuda_functor`` is instantiated at its D
    (``_build.PT_INSTANCES``) or a user density (``Target.cuda_source``,
    or generated from its batch form; D <= 16, a library of its own), and
    at most ``_build.PT_MAX_TEMPS`` rungs, and raises ``ValueError``
    otherwise. With ``validate_dc`` (the default) a user density's
    compiled value is held to the batch form on the initial positions
    (:func:`~mini_mcmc_torch.models.base.validate_dc_forms` with
    ``need_grad=False``, as the JAX sampler). Runs on ``device`` (``"cuda"`` by
    default); ``device="cpu"`` runs the plain tier and the kernel's twin.
    ``transform``: optional :class:`~mini_mcmc_torch.models.transforms.
    CoordinateTransform`; the replicas walk the unconstrained space (the
    tempered densities are ``beta`` times the wrapped logp) and the cold
    cube and ``positions`` stay natural. ``"full"`` runs it through Kernel
    8's transformed instance (``targets.cuh:Transformed``).
    ``pallas_interpret`` has no counterpart.

    The plain tier runs a state split over a ``"state"`` axis without a
    transform (``ops/tempering.py``: the replicas' D, where the JAX
    package's rule splits their chains); Kernel 8 refuses it, and
    :meth:`retuned` of a split sampler returns a split one.
    """

    def __init__(self, target, initial_positions,
                 betas: Optional[tuple] = None, proposal_std=1.0,
                 n_inner: int = 1, seed: Optional[int] = None,
                 steps_per_call: int = 1, use_pallas=False, transform=None,
                 validate_dc: bool = True, *, device="cuda", _layout=None):
        self.target = target
        self.transform = transform
        self.betas = tuple(float(b) for b in (
            geometric_betas(8) if betas is None else betas))
        self._ctor = dict(proposal_std=proposal_std, n_inner=n_inner,
                          steps_per_call=steps_per_call,
                          use_pallas=use_pallas, transform=transform,
                          validate_dc=validate_dc, device=device)
        positions = initial_positions_on(initial_positions, device)
        kernel_target, positions, _ = _wrap_sampler_target(
            target, positions, transform, None)
        self.kernel_target = kernel_target
        init_fn, step_fn = tempering_kernel(
            kernel_target, self.betas, proposal_std=proposal_std,
            n_inner=n_inner, steps_per_call=steps_per_call,
            use_pallas=use_pallas)
        if use_pallas and positions.is_cuda and positions.dim() == 2:
            # a target (plain or transformed) or ladder the kernel cannot
            # run: raise now; a user density's library is built here
            check_tier_dtype(pt_full.TIER, positions.dtype)
            pt_lib(kernel_target, len(self.betas), positions.shape[1],
                   positions.device)
            if validate_dc:
                validate_dc_forms(kernel_target, positions, need_grad=False)
        # the cold rung, mapped to natural coordinates under a transform
        super().__init__(init_fn, step_fn, positions, seed, recorded=_cold,
                         layout=_layout)

    def _takes_state_split(self) -> bool:
        return not self._ctor["use_pallas"] and not self._transformed()

    @property
    def dim(self) -> int:
        st = self._state_group
        return self._state.positions.shape[1] if st is None else st.n_dim

    @property
    def n_replicas(self) -> int:
        return self._state.positions.shape[0] * self.n_chains

    @property
    def swap_acceptance(self) -> torch.Tensor:
        """``[T-1]`` swap-accept EWMA per pair, the mean over chains (the
        per-chain ``[T-1, C]`` is ``state.swap_accept``; a sharded
        sampler's mean covers every shard, one all-gather)."""
        return gather_chains(self._state.swap_accept, self._chains,
                             1).mean(dim=1)

    def retuned(self, n_temps: Optional[int] = None, *,
                seed=None) -> "ParallelTempering":
        """A new sampler continuing from the cold positions on the ladder
        :func:`~mini_mcmc_torch.ops.tempering.tune_betas` re-spaces from
        this run's swap rates (hot replicas restart from the cold state).
        Without ``seed`` its generator is seeded from this sampler's, so a
        seeded workflow stays reproducible. A split sampler's swap rates
        are the same on every rank, and so is its new ladder; the new
        sampler is split as this one is."""
        tuned = tune_betas(self.betas, self.swap_acceptance, n_temps=n_temps)
        new = self._rebuild(lambda layout: ParallelTempering(
            self.target, self._positions_of(self._state), betas=tuned,
            seed=seed, _layout=layout, **self._ctor))
        if seed is None:
            new._gen = self._child_generator()
        return new


class _SGSampler(_KernelSampler):
    """SGLD and SGHMC: a state split runs on a gradient that takes the
    rank's D-slice, one that sets ``grad_fn.takes_state_split``
    (:func:`~mini_mcmc_torch.minibatch_grad`, :func:`~mini_mcmc_torch.
    target_grad`)."""

    def _takes_state_split(self) -> bool:
        return getattr(self.grad_fn, "takes_state_split", False)

    def _tier_name(self) -> str:
        name = type(self).__name__
        if getattr(self.grad_fn, "data_parallel", False):
            return f"{name} with data_parallel_grad"
        if not self._takes_state_split():
            return (f"{name} with a grad_fn that does not set "
                    "takes_state_split")
        return name


class SGLD(_SGSampler):
    """Stochastic-gradient Langevin dynamics (Welling & Teh 2011), with
    optional RMSProp preconditioning (pSGLD, Li et al. 2016)
    (``mini_mcmc_tpu/samplers.py:995-1039``, ``ops/sgmcmc.py``).

    ``grad_fn(positions [C, D], key) -> [C, D]`` supplies the stochastic
    gradient: :func:`~mini_mcmc_torch.minibatch_grad` (data subsampling)
    or :func:`~mini_mcmc_torch.target_grad` (full-batch unadjusted
    Langevin); ``key`` is the step's :class:`~mini_mcmc_torch.runner.
    StepKey` (its ``generator`` on the positions' device). ``step_size`` is
    a constant or a host schedule ``(step: int) -> float`` such as
    :func:`~mini_mcmc_torch.polynomial_decay`. There is no accept/reject:
    the tracker's ``p(accept)`` reads 1.0. ``steps_per_call`` > 1 runs K
    steps a block (run lengths multiples of K). Runs on ``device``
    (``"cuda"`` by default; it raises without a GPU). A state split over
    a ``"state"`` axis runs on a ``grad_fn`` that sets
    ``takes_state_split``: it receives the rank's D-slice and returns its
    gradient (``minibatch_grad`` and ``target_grad`` set it and take the
    gradient on a DTensor view of the slice); the assignment refuses any
    other ``grad_fn``, ``data_parallel_grad``'s included.

    Example:
        >>> import torch
        >>> import mini_mcmc_torch as mt
        >>> data = torch.linspace(-1., 1., 256)[:, None]  # [N, 1]
        >>> grad_fn = mt.minibatch_grad(
        ...     lambda x: -0.5 * torch.sum(x**2),              # prior
        ...     lambda x, b: -0.5 * torch.sum((b - x)**2),     # batch loglike
        ...     data, batch_size=32, device="cpu")
        >>> sgld = mt.SGLD(grad_fn, mt.init_det(8, 1, device="cpu"),
        ...                step_size=1e-3, seed=42, device="cpu")
        >>> tuple(sgld.run(100, 100).shape)
        (8, 100, 1)
    """

    def __init__(self, grad_fn, initial_positions, step_size,
                 seed: Optional[int] = None, temperature: float = 1.0,
                 preconditioner: Optional[str] = None,
                 rms_decay: float = 0.99, rms_eps: float = 1e-5,
                 steps_per_call: int = 1, *, device="cuda"):
        self.grad_fn = grad_fn
        self.step_size = step_size
        init_fn, step_fn = sgld_kernel(
            grad_fn, step_size, temperature=temperature,
            preconditioner=preconditioner, rms_decay=rms_decay,
            rms_eps=rms_eps, steps_per_call=steps_per_call)
        super().__init__(init_fn, step_fn,
                         initial_positions_on(initial_positions, device),
                         seed)


class SGHMC(_SGSampler):
    """Stochastic-gradient Hamiltonian Monte Carlo (Chen, Fox & Guestrin
    2014), the friction-damped momentum variant of :class:`SGLD`
    (``mini_mcmc_tpu/samplers.py:1042-1074``, ``ops/sgmcmc.py``).

    Same ``grad_fn``/``step_size`` contract as :class:`SGLD`; ``friction``
    (alpha, in (0, 1]) must dominate the minibatch gradient-noise scale.
    Momenta start at zero; discard at least ``~1/friction`` steps. Runs on
    ``device`` (``"cuda"`` by default).
    """

    def __init__(self, grad_fn, initial_positions, step_size,
                 seed: Optional[int] = None, friction: float = 0.1,
                 temperature: float = 1.0, steps_per_call: int = 1, *,
                 device="cuda"):
        self.grad_fn = grad_fn
        self.step_size = step_size
        self.friction = friction
        init_fn, step_fn = sghmc_kernel(
            grad_fn, step_size, friction=friction, temperature=temperature,
            steps_per_call=steps_per_call)
        super().__init__(init_fn, step_fn,
                         initial_positions_on(initial_positions, device),
                         seed)
