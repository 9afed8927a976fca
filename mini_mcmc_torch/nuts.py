"""User-facing NUTS sampler (counterpart of ``mini_mcmc_tpu/nuts.py``).

Construct with a target, initial positions ``[n_chains, D]`` and a desired
average acceptance probability; ``run(n_collect, n_discard)`` adapts the
step size during burn-in by dual averaging and returns the
``[n_chains, n_collect, D]`` sample cube. Collection follows the reference
convention (row 0 is the position at collection start;
``n_collect + n_discard - 1`` steps in all, ``nuts.rs:457-470``).

``metric=`` whitens the target (``models/precondition.py``) on every
tier, the kernels through their affine wrapper; ``reconditioned`` and
``warmed_up`` estimate the metric from the chain ensemble. ``transform=``
samples a natural-coordinates density on its unconstrained wrap
(``models/transforms.py``) on every tier, the kernels through their
transformed instances, the metric (if any) on the unconstrained
coordinates. ``run_progress`` samples with a live progress display and
returns the cube with its ``RunStats``.

A state split over a ``"state"`` axis (``parallel.shard_sampler_state(
chain_state_mesh(a, b), ..., shard_state_dim=True)``) runs on the lockstep
tier (``use_pallas=False``), with a diagonal metric or none and no
transform (``ops/nuts.py``); ``reconditioned("diag")`` and ``warmed_up``
then estimate each rank's D-slice of the metric and stay split.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ops.kernels import nuts_full, nuts_subtree
from .ops.kernels.nuts_subtree import MAX_DEPTH
from .ops.nuts import nuts_kernel
from .progress import progress_run
from .runner import make_initial_recording_runner
from .samplers import (
    _KernelSampler,
    _estimate_metric,
    _wrap_sampler_target,
    check_kernel_target,
    initial_positions_on,
)
from .stats import RunStats, run_stats


class NUTS(_KernelSampler):
    """No-U-Turn Sampler with dual-averaging step-size adaptation.

    Mirrors ``mini_mcmc_tpu.NUTS``'s constructor, so one kwargs dict builds
    both packages (``convert.nuts_sampler_kwargs``).

    Args:
        target: target density.
        initial_positions: ``[n_chains, D]`` starting points.
        target_accept_p: desired average acceptance probability.
        max_depth: tree-depth cap (10, Stan's default; the CUDA kernels
            are built for at most 10).
        seed: optional base seed.
        use_pallas: ``True`` runs each subtree in Kernel 3, ``"full"`` the
            whole step in Kernel 4 (float32 only); on CUDA tensors both
            run a built-in CUDA density (``Target.cuda_functor``) or
            compile the target's own C++ (``Target.cuda_source``, or C++
            generated from its batch form; D <= 16) and raise
            ``ValueError`` now for a batch form the generator cannot
            translate. On CPU tensors they run the kernels' plain twins.
        warmup_max_depth: optional tree-depth cap during adaptation.
        metric: optional :class:`~mini_mcmc_torch.models.Preconditioner`:
            the chains run in whitened coordinates ``y = L^-1 x`` (NUTS
            with mass matrix ``(L L^T)^-1``); ``initial_positions``, the
            samples and ``positions`` stay in x, ``state``, ``step_size``
            and ``kernel_target`` are the whitened ones.
        transform: optional :class:`~mini_mcmc_torch.models.transforms.
            CoordinateTransform` (``mini_mcmc_tpu/nuts.py:68-99``):
            ``target`` is a density in natural coordinates, the chains run
            on its unconstrained wrap; ``initial_positions`` (inside every
            constrained coordinate's range), the samples and
            ``positions`` stay natural, ``state`` and ``kernel_target``
            are unconstrained (and whitened under a metric).
        validate_dc: hold a compiled user density to its batch form on
            the initial positions at construction on CUDA
            (:func:`~mini_mcmc_torch.models.base.validate_dc_forms`).
        device: where the chains run, ``"cuda"`` by default (raises
            without a GPU); ``"cpu"`` runs the plain twins.
    """

    def __init__(self, target, initial_positions,
                 target_accept_p: float = 0.8, max_depth: int = 10,
                 seed: Optional[int] = None, use_pallas=False,
                 warmup_max_depth: Optional[int] = None, metric=None,
                 transform=None, validate_dc: bool = True, *,
                 device="cuda", _layout=None):
        if warmup_max_depth is not None and not (
                1 <= warmup_max_depth <= max_depth):
            raise ValueError(
                f"warmup_max_depth must be in [1, max_depth={max_depth}]; "
                f"got {warmup_max_depth}")
        self.target = target
        self.target_accept_p = target_accept_p
        self.max_depth = max_depth
        self.warmup_max_depth = warmup_max_depth
        self.transform = transform
        self._ctor = dict(target_accept_p=target_accept_p,
                          max_depth=max_depth, use_pallas=use_pallas,
                          warmup_max_depth=warmup_max_depth,
                          transform=transform, validate_dc=validate_dc,
                          device=device)
        positions = initial_positions_on(initial_positions, device)
        kernel_target, positions, self.metric = (
            _wrap_sampler_target(target, positions, transform, metric,
                                 _layout))
        self.kernel_target = kernel_target
        if use_pallas and positions.is_cuda:
            check_kernel_target(
                kernel_target, positions, validate_dc,
                nuts_full.TIER if use_pallas == "full"
                else nuts_subtree.TIER)
            if max_depth > MAX_DEPTH:
                raise ValueError(f"the NUTS kernels are built for max_depth "
                                 f"<= {MAX_DEPTH}; got {max_depth}")
        init_fn, self._prepare_fn, step_fn = nuts_kernel(
            kernel_target, target_accept_p, max_depth, use_pallas=use_pallas,
            warmup_max_depth=warmup_max_depth)
        super().__init__(init_fn, step_fn, positions, seed,
                         runner=make_initial_recording_runner(
                             step_fn, self._positions_of),
                         layout=_layout)
        self._div_before_run = None
        self._lf_before_run = None

    def _takes_state_split(self) -> bool:
        return (not self._ctor["use_pallas"] and not self._transformed()
                and (self.metric is None or self.metric.kind == "diag"))

    def reconditioned(self, kind: str = "diag", *, seed=None) -> "NUTS":
        """A new NUTS continuing from the current positions, whitened by a
        metric estimated from the chain ensemble, unconstrained under a
        transform (``mini_mcmc_tpu/nuts.py:152-170``). Run an adaptation
        first, so
        that the ensemble is in the typical set. The new sampler starts at
        ``epsilon = -1``: its first ``run`` finds a step size and dual
        averages again in the whitened space. Without ``seed`` its
        generator is seeded from this sampler's. On a split state each rank
        estimates its D-slice of a diagonal metric (``kind="dense"``
        raises there) and the new sampler is split as this one is."""
        pre = _estimate_metric(self, kind)
        new = self._rebuild(lambda layout: NUTS(
            self.target, self._positions_of(self._state), metric=pre,
            seed=seed, _layout=layout, **self._ctor))
        if seed is None:
            new._gen = self._child_generator()
        return new

    def warmed_up(self, n_adapt: int = 300, kind: str = "diag", *,
                  seed=None) -> "NUTS":
        """The warm-up in one call (``mini_mcmc_tpu/nuts.py:134-150``):
        ``n_adapt`` adaptation steps that advance THIS sampler's chains in
        place, then :meth:`reconditioned`. The returned sampler adapts its
        step size again during its next ``run``'s discard phase, so follow
        with e.g. ``run(n_collect, n_discard=100)``."""
        self.run(0, n_adapt)
        return self.reconditioned(kind, seed=seed)

    @property
    def step_size(self) -> torch.Tensor:
        """Per-chain step size ``[C]``: the dual-averaging ``epsilon``
        during adaptation, ``epsilon_bar`` after; ``-1.0`` before the first
        run (found by ``find_reasonable_epsilon``)."""
        return self._out(self._state.epsilon)

    @property
    def divergences(self) -> torch.Tensor:
        """Per-chain divergent transitions, cumulative over every run."""
        return self._out(self._state.divergences)

    @property
    def last_run_divergences(self) -> torch.Tensor:
        """Per-chain divergences of the most recent ``run`` only."""
        if self._div_before_run is None:
            return self._out(torch.zeros_like(self._state.divergences))
        return self._out(self._state.divergences - self._div_before_run)

    @property
    def leapfrogs(self) -> torch.Tensor:
        """Per-chain leapfrog steps, cumulative: ``2^J - 1`` gradient
        evaluations per step for a J-deep doubling loop. On the plain and
        ``True`` tiers all chains run in lockstep, so J is the deepest
        chain's (the executed cost), whether or not a chain's own tree
        finished earlier; under ``use_pallas="full"`` J is each chain's own
        (its own tree's cost; the kernel runs a warp of 32 chains to its
        deepest, and the JAX package's fused kernel reports per 8,192-chain
        grid block). Saturates at ~2.0e9 instead of wrapping."""
        return self._out(self._state.leapfrogs)

    @property
    def last_run_leapfrogs(self) -> torch.Tensor:
        """Per-chain executed leapfrogs of the most recent ``run`` only."""
        if self._lf_before_run is None:
            return self._out(torch.zeros_like(self._state.leapfrogs))
        return self._out(self._state.leapfrogs - self._lf_before_run)

    def _snapshot_divergences(self) -> None:
        """The counters before a run, for ``last_run_*``."""
        self._div_before_run = self._state.divergences.clone()
        self._lf_before_run = self._state.leapfrogs.clone()

    def run(self, n_collect: int, n_discard: int = 0, *,
            time_major: bool = False) -> torch.Tensor:
        """Sample; returns ``[n_chains, n_collect, D]``, or
        ``[n_collect, n_chains, D]`` with ``time_major=True``."""
        self._snapshot_divergences()
        self._state = self._prepare_fn(self._state, self._next_key(),
                                       n_discard)
        return super().run(n_collect, n_discard, time_major=time_major)

    def run_progress(self, n_collect: int, n_discard: int = 0, *,
                     stream=None, time_major: bool = False
                     ) -> tuple[torch.Tensor, RunStats]:
        """:meth:`run` with live progress bars on ``stream`` (default
        stderr); returns ``(sample, run_stats(sample))``
        (``mini_mcmc_tpu/nuts.py:280-309``, the analog of
        ``nuts.rs:194-338``). The prepare pass runs once, then the chunks
        go through the one-step runner: with ``n_discard == 0`` the current
        position is the first row and ``n_collect - 1`` steps follow,
        otherwise ``n_discard - 1`` unrecorded steps do, the convention of
        :meth:`run`, whose cube it equals from the same seed."""
        self._snapshot_divergences()
        self._state = self._prepare_fn(self._state, self._next_key(),
                                       n_discard)
        kw = dict(n_chains=self._state.positions.shape[0],
                  dim=self._state.positions.shape[1],
                  stream=stream, time_major=time_major)
        if n_discard == 0 and n_collect > 0:
            # [1, C, D]
            kw["initial_rows"] = self._positions_of(self._state)[None]
        self._state, sample = progress_run(
            self._simple_runner, self._state, self._next_key(), n_collect,
            max(n_discard - 1, 0), **kw)
        sample = self._out(sample, 1 if time_major else 0)
        return sample, run_stats(sample, time_major=time_major)
