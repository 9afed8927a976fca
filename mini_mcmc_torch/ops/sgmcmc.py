"""Stochastic-gradient MCMC: SGLD, pSGLD, SGHMC.

Counterpart of ``mini_mcmc_tpu/ops/sgmcmc.py``:

- **SGLD** (Welling & Teh, ICML 2011): Langevin dynamics driven by an
  unbiased minibatch estimate of ``grad log pi``; with a decaying step size
  the MH correction is unnecessary.
- **pSGLD** (Li et al., AAAI 2016): SGLD with an RMSProp diagonal
  preconditioner, for badly scaled posteriors.
- **SGHMC** (Chen, Fox & Guestrin, ICML 2014): underdamped Langevin with
  friction, the momentum variant that survives gradient noise.
- :func:`data_parallel_grad`: the minibatch gradient over a dataset whose
  rows are split over a ``"data"`` mesh (``parallel/mesh.py``), one
  all-reduce a call.

:func:`minibatch_grad` hands the whole minibatch to the user's
``log_like(position, batch) -> scalar``, maps it over the chains with
``torch.func.vmap`` and differentiates the summed per-chain values with
``torch.autograd.grad``, so a regression likelihood's ``[B, D] @ [D]``
becomes one ``[B, D] @ [D, C]`` product a step for all chains (and its
backward one more). One shared minibatch a step (a ``[B]`` gather) feeds
every chain by default; ``shared_batch=False`` gathers ``[C, B]`` rows.

The step counter is a host int: the host knows it as it knows the step, so
a step-size schedule is evaluated on the host, in numpy float32 as XLA
evaluates it, and no step reads the device. The scalar algebra of a step
(``eps / 2``, ``sqrt(eps T)``, pSGLD's debiasing ``1 - rms_decay **
(step + 1)``) is done there too and enters the device ops as scalars.
:func:`sgld_update` and :func:`sghmc_update` are a step on a given gradient
and given normals, and ``grad_fn.on_indices`` a gradient on given batch
indices, so the CPU tests feed them the JAX package's own draws.

Under a state split (``key.state``: D split over a ``"state"`` axis) a
step's positions are the rank's D-slice: the normals are the global
``[C, D]`` draw's block (``collectives.state_draw``), and
:func:`minibatch_grad` and :func:`target_grad` take the gradient on a
DTensor view of the slice (``parallel.mesh.on_slice``), so a likelihood's
``X @ p`` all-reduces inside and an elementwise gradient needs no
collective. The minibatch indices are drawn once per chain, the same on
every state shard. Both set ``grad_fn.takes_state_split``; a ``grad_fn``
of the caller's own runs on a split D only when it sets it too (it then
receives the slice and returns its gradient), and the samplers refuse any
other. :func:`data_parallel_grad` refuses a split D.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from ..parallel.collectives import all_reduce, chain_draw, split, state_draw
from ..parallel.mesh import SliceTarget, on_slice
from ..runner import StepKey, key_chains, key_generator, make_scan_block_fn
from ..utils.init import resolve_device


class SGLDState(NamedTuple):
    positions: torch.Tensor  # [C, D]
    sq_avg: torch.Tensor  # [C, D] RMSProp EWMA of grad^2 (a 0-d zero unused)
    step: int  # host step counter (drives step-size schedules)

    #: the state-dimension axis per field for ``parallel.
    #: shard_sampler_state(..., shard_state_dim=True)`` (a 0-d ``sq_avg``
    #: stays replicated)
    STATE_AXIS_INDEX = {"positions": 1, "sq_avg": 1}


class SGHMCState(NamedTuple):
    positions: torch.Tensor  # [C, D]
    momenta: torch.Tensor  # [C, D] velocity v (position-increment units)
    step: int  # host step counter

    STATE_AXIS_INDEX = {"positions": 1, "momenta": 1}


@dataclasses.dataclass(frozen=True)
class PolynomialDecay:
    """The schedule ``eps_t = a * (b + t)^-gamma`` of
    :func:`polynomial_decay`, evaluated on the host in float32."""

    a: float
    b: float
    gamma: float

    def __call__(self, t: int) -> float:
        f32 = np.float32
        return float(f32(self.a) * (f32(self.b) + f32(t)) ** f32(-self.gamma))


def polynomial_decay(a: float, b: float, gamma: float) -> PolynomialDecay:
    """Welling & Teh (2011) eq. 2 schedule: ``eps_t = a * (b + t)^-gamma``.

    Pass the result as ``step_size=`` to :class:`~mini_mcmc_torch.SGLD` /
    :class:`~mini_mcmc_torch.SGHMC`. ``gamma in (0.5, 1]`` satisfies the
    decreasing-step-size conditions under which SGLD needs no MH
    correction. It takes the host step count and returns a float, the
    float32 value the JAX package's schedule gives; ``a``, ``b`` and
    ``gamma`` are its attributes.

    Example:
        >>> from mini_mcmc_torch import polynomial_decay
        >>> sched = polynomial_decay(1e-2, 10.0, 0.55)
        >>> sched(0) > sched(1000)
        True
    """
    if gamma < 0:
        raise ValueError(f"gamma must be >= 0, got {gamma}")
    return PolynomialDecay(float(a), float(b), float(gamma))


def _tree_map(fn, data):
    """``fn`` on every leaf of a tensor or a tuple, list or dict of them."""
    if isinstance(data, dict):
        return {k: _tree_map(fn, v) for k, v in data.items()}
    if isinstance(data, (tuple, list)):
        return type(data)(_tree_map(fn, v) for v in data)
    return fn(data)


def _leaves(data) -> list:
    out = []
    _tree_map(out.append, data)
    return out


def _key_state(key):
    """The ``StateGroup`` of a :class:`StepKey`, ``None`` for a bare
    generator."""
    return getattr(key, "state", None)


def _grad_of_sum(fn: Callable, positions: torch.Tensor, state=None):
    """The gradient of ``fn(x).sum()`` at ``positions`` (the rows are
    independent, so each row's own); on a rank's D-slice (``state``
    split) taken on its DTensor view, the slice's share returned."""
    def grad(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(fn(x).sum(), x)
        return g

    if not split(state):
        return grad(positions)
    from ..parallel.mesh import _dtensor

    _, shard, _ = _dtensor()
    g = on_slice(state, grad, positions)
    return g.redistribute(state.mesh, (shard(1),)).to_local()


def minibatch_grad(
    log_prior: Callable,
    log_like: Callable,
    data,
    batch_size: int,
    *,
    shared_batch: bool = True,
    device="cuda",
) -> Callable:
    """Unbiased minibatch estimator of ``grad log pi`` for SG-MCMC.

    ``log pi(x) = log_prior(x) + sum_i log_like_i(x)``; the estimator
    replaces the sum with ``(N/B) * log_like(x, batch)`` over ``B`` indices
    drawn uniformly with replacement: unbiased for any ``B``.

    Args:
        log_prior: ``[D] -> scalar`` log prior density (functional torch
            ops: no in-place ops, no ``.item()``).
        log_like: ``(position [D], batch) -> scalar``, the SUMMED
            log-likelihood of the minibatch at one position.
        data: a ``[N, ...]`` tensor or array, or a tuple, list or dict of
            them sharing the leading ``N`` axis (e.g. ``(X, y)``); ``batch``
            has the same structure with leading axis ``B``. It is moved to
            ``device`` once, here.
        batch_size: minibatch size ``B``.
        shared_batch: one batch a step shared by all chains (one ``[B]``
            gather; default) or an independent batch per chain (``[C, B]``).
        device: where the data live (``"cuda"`` by default; raises without
            a GPU).

    Returns:
        ``grad_fn(positions [C, D], key) -> [C, D]`` stochastic gradients,
        ``key`` a :class:`~mini_mcmc_torch.runner.StepKey` or a
        ``torch.Generator`` on the positions' device, and
        ``grad_fn.on_indices(positions, idx, state=None)`` the gradient
        on given batch indices (``[B]`` shared, ``[C, B]`` per chain;
        ``state``: the ``StateGroup`` of a rank's D-slice).
    """
    device = resolve_device(device)
    data = _tree_map(lambda a: torch.as_tensor(a).to(device), data)
    leaves = _leaves(data)
    if not leaves:
        raise ValueError("data must contain at least one array")
    n = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise ValueError(
                "all data leaves must share the leading axis; got "
                f"{[leaf.shape[0] for leaf in leaves]}"
            )
    if not 1 <= batch_size <= n:
        raise ValueError(
            f"batch_size must be in [1, {n}], got {batch_size}"
        )
    scale = n / batch_size

    def logp_hat(x, batch):
        return log_prior(x) + scale * log_like(x, batch)

    logp_shared = torch.func.vmap(logp_hat, in_dims=(0, None))
    logp_per_chain = torch.func.vmap(logp_hat)  # batch leaves [C, B, ...]

    def on_indices(positions, idx, state=None):
        batch = _tree_map(lambda a: a[idx], data)
        logp = logp_shared if idx.dim() == 1 else logp_per_chain
        # the chains are independent: the gradient of the summed [C]
        # values is each chain's own (fewer host calls a step than a
        # vmap of torch.func.grad)
        return _grad_of_sum(lambda x: logp(x, batch), positions, state)

    def grad_fn(positions, key):
        def draw(shape):
            return torch.randint(0, n, shape, generator=key_generator(key),
                                 device=positions.device)

        if shared_batch:
            idx = draw((batch_size,))
        else:  # a chain shard's rows of the global draw
            idx = chain_draw(key_chains(key), draw,
                             (positions.shape[0], batch_size))
        return on_indices(positions, idx, _key_state(key))

    grad_fn.on_indices = on_indices
    grad_fn.takes_state_split = True
    return grad_fn


def data_parallel_grad(log_prior: Callable, log_like: Callable, data,
                       batch_size: int, mesh, *,
                       axis: Optional[str] = None) -> Callable:
    """Data-sharded stochastic gradient for SG-MCMC over a mesh
    (``mini_mcmc_tpu/ops/sgmcmc.py:162-301``).

    :func:`minibatch_grad` keeps the dataset on one device; this is its
    sibling for a dataset split over the ranks of a mesh axis. The rows
    split on the leading axis, ``N / n_shards`` a rank. Every call each
    rank draws ``batch_size / n_shards`` rows from its own shard, takes the
    partial minibatch-likelihood gradient of the (replicated) ``[C, D]``
    chains, and the partials reduce with ONE all-reduce of ``[C, D]``: the
    one collective a call. The prior's gradient is taken locally. The
    estimator is unbiased for equal shards: uniform draws within each
    shard, scaled by ``N / B`` as :func:`minibatch_grad` scales them
    (stratified by shard, each datum counted with weight ``N / B`` in
    expectation).

    Args:
        log_prior / log_like / batch_size: as :func:`minibatch_grad`
            (``log_like`` receives the rank's minibatch).
        data: a ``[N, ...]`` tensor or array, or a tuple, list or dict of
            them sharing the leading axis. ``N`` and ``batch_size`` must
            divide by the axis size. Each rank keeps its own rows, moved to
            the mesh's device; a leaf that is already a DTensor is taken
            only as ``Shard(0)`` over ``axis`` of this mesh (anything else
            raises: a reshard every call would add collectives).
        mesh: a mesh (:func:`~mini_mcmc_torch.parallel.data_mesh`).
        axis: the mesh axis the rows split over (default: the mesh's
            first). The chains are replicated over it: do not shard them
            over the same axis.

    Returns:
        ``grad_fn(positions [C, D], key) -> [C, D]``, usable with
        :class:`~mini_mcmc_torch.SGLD` / :class:`~mini_mcmc_torch.SGHMC`.
        Rank r's indices are row r of one ``[n_shards, B / n_shards]``
        draw from the key's generator: distinct per rank, fixed by the
        key, and every rank's generator advances alike.
    """
    from ..parallel.mesh import _dtensor, _mesh_device

    dtensor, shard, _ = _dtensor()
    leaves = _leaves(data)
    if not leaves:
        raise ValueError("data must contain at least one array")
    n = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise ValueError(
                "all data leaves must share the leading axis; got "
                f"{[leaf.shape[0] for leaf in leaves]}"
            )
    names = tuple(mesh.mesh_dim_names or ())
    if axis is None:
        axis = names[0]
    if axis not in names:
        raise ValueError(f"the mesh has no '{axis}' axis; got {names}")
    dim = names.index(axis)
    n_shards, rank = mesh.size(dim), mesh.get_local_rank(dim)
    if n % n_shards != 0:
        raise ValueError(
            f"N={n} must divide by the '{axis}' mesh axis ({n_shards}); "
            "pad or trim the dataset to equal shards (unequal shards "
            "bias the estimator)"
        )
    if batch_size % n_shards != 0 or not 1 <= batch_size <= n:
        raise ValueError(
            f"batch_size must be in [1, {n}] and divide by the mesh "
            f"axis size {n_shards}, got {batch_size}"
        )
    b_loc, n_loc = batch_size // n_shards, n // n_shards
    scale = n / batch_size
    device = _mesh_device(mesh)
    group = mesh.get_group(dim)

    def local_rows(a):
        if isinstance(a, dtensor):
            want = [f"Shard(dim=0) on '{axis}'" if i == dim else "Replicate()"
                    for i in range(mesh.ndim)]
            ok = (a.device_mesh == mesh and all(
                isinstance(p, shard) and p.dim == 0 if i == dim
                else not isinstance(p, shard)
                for i, p in enumerate(a.placements)))
            if not ok:
                raise ValueError(
                    "data_parallel_grad: a data leaf is pre-sharded as "
                    f"{tuple(a.placements)} on a mesh with axes "
                    f"{tuple(a.device_mesh.mesh_dim_names or ())}, which "
                    f"does not match the required layout {want} on this "
                    f"mesh's axes {names}; pass it unsharded (each rank "
                    f"keeps its rows) or shard it over the mesh's '{axis}' "
                    "axis on dimension 0")
            return a.to_local().to(device)
        a = torch.as_tensor(a)
        return a.narrow(0, rank * n_loc, n_loc).to(device)

    local = _tree_map(local_rows, data)

    def like_hat(x, batch):
        return scale * log_like(x, batch)

    like_batched = torch.func.vmap(like_hat, in_dims=(0, None))
    prior_batched = torch.func.vmap(log_prior)

    def grad_fn(positions, key):
        if split(_key_state(key)):
            raise ValueError(
                "data_parallel_grad takes the chains' whole state: it does "
                "not run on a state split over a 'state' axis "
                "(shard_state_dim=True); use minibatch_grad there")
        idx = torch.randint(0, n_loc, (n_shards, b_loc),
                            generator=key_generator(key),
                            device=positions.device)[rank]
        batch = _tree_map(lambda a: a[idx], local)
        x = positions.detach().requires_grad_(True)
        with torch.enable_grad():
            (g_like,) = torch.autograd.grad(like_batched(x, batch).sum(), x)
            (g_prior,) = torch.autograd.grad(prior_batched(x).sum(), x)
        return g_prior + all_reduce(g_like, group).to(positions.dtype)

    #: the samplers refuse a state split at the assignment
    grad_fn.data_parallel = True
    return grad_fn


def target_grad(target) -> Callable:
    """Full-batch ``grad_fn`` from a :class:`~mini_mcmc_torch.models.Target`
    (the key places a D-slice, nothing more): SGLD/SGHMC then run as exact unadjusted Langevin /
    underdamped Langevin on any target."""

    def grad_fn(positions, key):
        st = _key_state(key)
        if split(st):
            return SliceTarget(target, st).batch_grad(positions)
        return target.batch_logp_and_grad(positions)[1]

    grad_fn.takes_state_split = True
    return grad_fn


def _resolve_step_size(step_size) -> Callable:
    if callable(step_size):
        return step_size
    eps = float(step_size)
    if eps <= 0:
        raise ValueError(f"step_size must be positive, got {eps}")
    eps32 = float(np.float32(eps))
    return lambda t: eps32


def _host_float(x: torch.Tensor):
    """The numpy scalar type of the host algebra for ``x``'s dtype."""
    return np.float64 if x.dtype == torch.float64 else np.float32


def sgld_update(state: SGLDState, g, xi, eps: float, *,
                temperature: float = 1.0,
                preconditioner: Optional[str] = None,
                rms_decay: float = 0.99,
                rms_eps: float = 1e-5) -> SGLDState:
    """One (p)SGLD step from ``state`` on the gradient ``g`` and the normals
    ``xi`` (each ``[C, D]``) at step size ``eps``::

        G  = 1 / (sqrt(V / (1 - rms_decay^(t+1))) + rms_eps)  # pSGLD only
        x += eps/2 * G * g + sqrt(eps * T * G) * xi
    """
    x = state.positions
    f = _host_float(x)
    e = f(eps)
    half_eps = float(f(0.5) * e)
    eps_t = f(e * f(temperature))
    if preconditioner == "rmsprop":
        # the Adam-style debiased EWMA: without it V starts at 0 and the
        # first preconditioner is 1/rms_eps, a 1e5x step
        sq_avg = torch.addcmul(state.sq_avg * float(f(rms_decay)), g, g,
                               value=float(f(1.0 - rms_decay)))
        debias = float(f(1.0) - f(rms_decay) ** (f(state.step) + f(1.0)))
        precond = torch.reciprocal(torch.sqrt(sq_avg / debias)
                                   + float(f(rms_eps)))
        x = (x + precond * half_eps * g
             + torch.sqrt(precond * float(eps_t)) * xi)
    else:
        sq_avg = state.sq_avg
        x = x.add(g, alpha=half_eps).add_(xi, alpha=float(np.sqrt(eps_t)))
    return SGLDState(positions=x, sq_avg=sq_avg, step=state.step + 1)


def sghmc_update(state: SGHMCState, g, xi, eps: float, *, friction: float,
                 temperature: float = 1.0) -> SGHMCState:
    """One SGHMC step from ``state`` on the gradient ``g`` and the normals
    ``xi`` at step size ``eps``::

        v  = (1 - alpha) v + eps g + sqrt(2 alpha eps T) xi;  x += v
    """
    f = _host_float(state.positions)
    e = f(eps)
    noise = np.sqrt(f(2.0 * friction) * e * f(temperature))
    v = (state.momenta * float(f(1.0 - friction))).add_(
        g, alpha=float(e)).add_(xi, alpha=float(noise))
    return SGHMCState(positions=state.positions + v, momenta=v,
                      step=state.step + 1)


def _check_common(temperature: float, steps_per_call: int) -> None:
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")


def _noise(x: torch.Tensor, key) -> torch.Tensor:
    return state_draw(key_chains(key), _key_state(key), lambda s: torch.randn(
        s, generator=key_generator(key), dtype=x.dtype, device=x.device),
        x.shape)


def _with_blocks(step_fn, steps_per_call: int):
    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call
    return step_fn


def sgld_kernel(
    grad_fn: Callable,
    step_size: Union[float, Callable],
    *,
    temperature: float = 1.0,
    preconditioner: Optional[str] = None,
    rms_decay: float = 0.99,
    rms_eps: float = 1e-5,
    steps_per_call: int = 1,
):
    """Build ``(init_fn, step_fn)`` for (p)SGLD (Welling & Teh 2011 eq. 1;
    Li et al. 2016 eq. 5 with ``preconditioner="rmsprop"``, the ``Gamma``
    curvature-drift term dropped as in their implementation).

    Args:
        grad_fn: ``(positions [C, D], key) -> [C, D]``, from
            :func:`minibatch_grad` or :func:`target_grad`; its result is
            cast to the positions' dtype.
        step_size: constant float, or a schedule ``(step: int) -> float``
            evaluated on the host (:func:`polynomial_decay`).
        temperature: ``T`` scales the injected noise; ``T=0`` is plain SGD.
        preconditioner: ``None`` or ``"rmsprop"`` (pSGLD).
        rms_decay / rms_eps: pSGLD EWMA decay and regularizer.
        steps_per_call: > 1 attaches a K-step block function
            (``step_fn.block_fn``/``block_size``).
    """
    if preconditioner not in (None, "rmsprop"):
        raise ValueError(
            f'preconditioner must be None or "rmsprop", got {preconditioner!r}'
        )
    _check_common(temperature, steps_per_call)
    eps_of = _resolve_step_size(step_size)

    def init_fn(positions: torch.Tensor, state=None) -> SGLDState:
        # the unused EWMA is a 0-d zero, so every state round-trips through
        # a checkpoint (no zero-size tensor)
        sq_avg = (torch.zeros_like(positions) if preconditioner == "rmsprop"
                  else positions.new_zeros(()))
        return SGLDState(positions=positions, sq_avg=sq_avg, step=0)

    def step_fn(state: SGLDState, key: StepKey) -> SGLDState:
        x = state.positions
        g = grad_fn(x, key).to(x.dtype)
        return sgld_update(state, g, _noise(x, key), eps_of(state.step),
                           temperature=temperature,
                           preconditioner=preconditioner,
                           rms_decay=rms_decay, rms_eps=rms_eps)

    return init_fn, _with_blocks(step_fn, steps_per_call)


def sghmc_kernel(
    grad_fn: Callable,
    step_size: Union[float, Callable],
    *,
    friction: float = 0.1,
    temperature: float = 1.0,
    steps_per_call: int = 1,
):
    """Build ``(init_fn, step_fn)`` for SGHMC (Chen, Fox & Guestrin 2014
    eq. 15, the ``v = eps * momentum`` parametrization of their code).

    The friction ``alpha`` in (0, 1] absorbs gradient noise and must
    dominate its (unknown) scale: 0.01..0.1 is the usual range. Momenta
    start at zero and equilibrate within ``~1/alpha`` steps. Other
    arguments as :func:`sgld_kernel`.
    """
    if not 0.0 < friction <= 1.0:
        raise ValueError(f"friction must be in (0, 1], got {friction}")
    _check_common(temperature, steps_per_call)
    eps_of = _resolve_step_size(step_size)

    def init_fn(positions: torch.Tensor, state=None) -> SGHMCState:
        return SGHMCState(positions=positions,
                          momenta=torch.zeros_like(positions), step=0)

    def step_fn(state: SGHMCState, key: StepKey) -> SGHMCState:
        x = state.positions
        g = grad_fn(x, key).to(x.dtype)
        return sghmc_update(state, g, _noise(x, key), eps_of(state.step),
                            friction=friction, temperature=temperature)

    return init_fn, _with_blocks(step_fn, steps_per_call)
