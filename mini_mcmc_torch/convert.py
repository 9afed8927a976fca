"""Carry chain state and sampler configuration across from the JAX package.

No model here has weights: what carries over is the chain state
(positions and their cached logp, and the gradient for HMC and ChEES-HMC;
the positions and adaptation state for NUTS; the replica ladder for
parallel tempering; the cached likelihood for elliptical slice sampling)
and the sampler's configuration, a metric, a transform and a prior
included; for SG-MCMC the positions, the RMSProp average or the momenta
and the step count, and the minibatch estimator's data.
Everything crosses as numpy arrays, so this module imports neither JAX nor
the JAX package. States land on ``device``, ``"cuda"`` by default (raises
without a GPU); pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.precondition import Preconditioner
from .models.transforms import (
    CoordinateTransform,
    _interval,
    identity,
    lower_bounded,
    positive,
    upper_bounded,
)
from .ops.elliptical import EllipticalState
from .ops.ensemble import EnsembleState
from .ops.hmc import HMCSepState, HMCState
from .ops.mh import MHState
from .ops.nuts import NUTSState
from .ops.sgmcmc import (
    PolynomialDecay,
    SGHMCState,
    SGLDState,
    _tree_map,
    polynomial_decay,
)
from .ops.slice import SliceState
from .ops.tempering import PTState
from .utils.init import resolve_device

#: JAX constructor keywords with no counterpart in the port
_JAX_ONLY = ("unroll", "pallas_interpret")
#: the port's samplers that take ``validate_dc`` (the JAX samplers that
#: run a user density in a fused kernel); the others drop it
_VALIDATE_DC = ("HMC", "MALA", "NUTS", "MetropolisHastings",
                "ParallelTempering")


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


def hmc_state_from_numpy(positions, logp, grad, device="cuda") -> HMCState:
    """An ``HMCState`` of float32 tensors on ``device`` from numpy arrays
    (e.g. ``np.asarray`` of a JAX sampler's ``.state`` fields)."""
    device = resolve_device(device)
    return HMCState(_f32(positions, device), _f32(logp, device),
                    _f32(grad, device))


def ensemble_state_from_numpy(positions, logp,
                              device="cuda") -> EnsembleState:
    """An ``EnsembleState`` of float32 tensors on ``device``."""
    device = resolve_device(device)
    return EnsembleState(_f32(positions, device), _f32(logp, device))


def slice_state_from_numpy(positions, logp, device="cuda") -> SliceState:
    """A ``SliceState`` of float32 tensors on ``device``."""
    device = resolve_device(device)
    return SliceState(_f32(positions, device), _f32(logp, device))


def elliptical_state_from_numpy(positions, loglik,
                                device="cuda") -> EllipticalState:
    """An ``EllipticalState`` (positions and the cached likelihood, not the
    prior) of float32 tensors on ``device``."""
    device = resolve_device(device)
    return EllipticalState(_f32(positions, device), _f32(loglik, device))


def sgld_state_from_numpy(positions, sq_avg, step,
                          device="cuda") -> SGLDState:
    """An ``SGLDState`` on ``device``: float32 positions and RMSProp
    average (a 0-d zero when unused, as the JAX package keeps it) and the
    step count as a host int."""
    device = resolve_device(device)
    return SGLDState(_f32(positions, device), _f32(sq_avg, device),
                     int(step))


def sghmc_state_from_numpy(positions, momenta, step,
                           device="cuda") -> SGHMCState:
    """An ``SGHMCState`` on ``device``: float32 positions and momenta and
    the step count as a host int."""
    device = resolve_device(device)
    return SGHMCState(_f32(positions, device), _f32(momenta, device),
                      int(step))


def data_from_numpy(data, device="cuda"):
    """``minibatch_grad``'s data, an array or a tuple, list or dict of
    arrays (e.g. the JAX package's, through ``np.asarray``), as tensors on
    ``device`` of the same structure and dtypes."""
    device = resolve_device(device)
    return _tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(device),
                     data)


def hmc_sep_state_from_numpy(positions, logp, device="cuda") -> HMCSepState:
    """An ``HMCSepState`` (the separable tier's, no gradient) of float32
    tensors on ``device`` from numpy arrays."""
    device = resolve_device(device)
    return HMCSepState(_f32(positions, device), _f32(logp, device))


def mh_state_from_numpy(positions, logp, device="cuda") -> MHState:
    """An ``MHState`` on ``device`` from numpy arrays: integer positions
    stay integer (as int32, the kernels' integer type), float positions
    become float32; logp is float32."""
    device = resolve_device(device)
    positions = np.asarray(positions)
    if np.issubdtype(positions.dtype, np.integer):
        pos = torch.as_tensor(positions.astype(np.int32), device=device)
    else:
        pos = _f32(positions, device)
    return MHState(pos, _f32(logp, device))


def nuts_state_from_numpy(state, device="cuda") -> NUTSState:
    """A ``NUTSState`` on ``device`` from a JAX ``NUTSState`` (or any
    object with its fields) read as numpy arrays: float32 positions and
    adaptation state, int32 counters, and the per-chain step count ``m``
    and horizon ``n_discard`` (the same for every chain) as host ints."""
    device = resolve_device(device)

    def i32(x):
        return torch.as_tensor(np.array(x, np.int32), device=device)

    m = np.asarray(state.m)
    n_discard = np.asarray(state.n_discard)
    return NUTSState(
        positions=_f32(state.positions, device),
        epsilon=_f32(state.epsilon, device),
        epsilon_bar=_f32(state.epsilon_bar, device),
        h_bar=_f32(state.h_bar, device),
        mu=_f32(state.mu, device),
        m=int(m.reshape(-1)[0]),
        n_discard=int(n_discard.reshape(-1)[0]),
        divergences=i32(state.divergences),
        leapfrogs=i32(state.leapfrogs),
    )


def pt_state_from_numpy(state, device="cuda") -> PTState:
    """A ``PTState`` on ``device`` from a JAX ``PTState`` (or any object
    with its fields) read as numpy arrays: the ``[T, D, C]`` replica
    positions, ``[T, C]`` raw logp and ``[T-1, C]`` swap EWMA as float32,
    the parity as a host int."""
    device = resolve_device(device)
    return PTState(
        positions=_f32(state.positions, device),
        raw_logp=_f32(state.raw_logp, device),
        parity=int(np.asarray(state.parity).reshape(-1)[0]),
        swap_accept=_f32(state.swap_accept, device),
    )


def preconditioner_from_numpy(kind: str, array,
                              device="cuda") -> Preconditioner:
    """A ``Preconditioner`` of ``kind`` on ``device`` from its numpy
    ``array``, float32: the ``[D]`` scale (``"diag"``) or the ``[D, D]``
    Cholesky factor (``"dense"``), e.g. ``np.asarray`` of a JAX metric's
    ``scale`` or ``chol``."""
    arr = _f32(array, resolve_device(device))
    if kind == "diag":
        return Preconditioner("diag", scale=arr)
    return Preconditioner(kind, chol=arr)


def _closure(fn) -> dict:
    """A function's free variables by name (the constants a built-in
    bijector's closures hold)."""
    cells = fn.__closure__ or ()
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in cells)))


def _free_var(fn, name: str):
    """The value of the free variable ``name`` of ``fn`` or of a function
    it closes over (a setting a JAX kernel keeps only in its closures)."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if id(f) in seen or not hasattr(f, "__code__"):
            continue
        seen.add(id(f))
        free = _closure(f)
        if name in free:
            return free[name]
        todo.extend(v for v in free.values() if callable(v))
    raise ValueError(f"no setting {name!r} in the JAX sampler's closures")


def _host(x):
    """A scalar as a float, anything else as a float32 numpy array."""
    arr = np.array(x, np.float32)
    return float(arr) if arr.ndim == 0 else arr


#: the JAX package's module of built-in bijectors, named, never imported
_JAX_TRANSFORMS = "mini_mcmc_tpu.models.transforms"


def _bijector_from_jax(bij):
    """The port's counterpart of a JAX built-in bijector, its constants
    read from the closures of its forward map (exact, where the name
    rounds them). A built-in is one whose forward map was made by the JAX
    module's factory of its name."""
    name = bij.name
    fwd = getattr(bij, "forward", None)
    factory = name.split("(")[0]
    if (getattr(fwd, "__module__", None) == _JAX_TRANSFORMS
            and getattr(fwd, "__qualname__", "").startswith(
                f"{factory}.<locals>.")):
        free = _closure(fwd)
        if factory == "identity":
            return identity()
        if factory == "positive":
            return positive()
        if factory == "lower_bounded":
            return lower_bounded(free["low"])
        if factory == "upper_bounded":
            return upper_bounded(free["high"])
        if factory == "interval":
            return _interval(float(free["low"]), float(free["width"]), name)
    raise ValueError(
        f"transform holds a custom Bijector ({name!r}); only the built-in "
        "bijectors (identity, positive, lower_bounded, upper_bounded, "
        "interval) carry across: rebuild it with the port's Bijector")


def transform_from_jax(jax_transform) -> CoordinateTransform:
    """The port's :class:`~mini_mcmc_torch.models.transforms.
    CoordinateTransform` of a JAX one made of built-in bijectors: the same
    names and constants coordinate by coordinate, and the same grouping
    (one port bijector per distinct JAX one). Raises ``ValueError`` for a
    custom bijector, and for anything but a JAX ``CoordinateTransform``."""
    table = getattr(jax_transform, "_table", None)
    if not isinstance(table, list) or not all(
            isinstance(getattr(b, "name", None), str) for b in table):
        raise ValueError("transform must be a JAX CoordinateTransform; got "
                         f"{type(jax_transform).__name__}")
    ported = {}
    return CoordinateTransform([
        ported.setdefault(id(b), _bijector_from_jax(b)) for b in table])


def state_to_numpy(state):
    """The state's fields as numpy arrays (host ints stay ints)."""
    return tuple(np.asarray(x.detach().cpu()) if torch.is_tensor(x) else x
                 for x in state)


def _kwargs(jax_sampler, name: str, ctor=None) -> dict:
    ctor = dict(jax_sampler._ctor if ctor is None else ctor)
    transform = ctor.pop("transform", None)
    if transform is not None:
        ctor["transform"] = transform_from_jax(transform)
    dropped = _JAX_ONLY if name in _VALIDATE_DC else (
        _JAX_ONLY + ("validate_dc",))
    for key in dropped:
        ctor.pop(key, None)
    metric = getattr(jax_sampler, "metric", None)
    if metric is not None:
        kind = getattr(metric, "kind", None)
        if kind not in ("diag", "dense"):
            raise ValueError("metric must be a Preconditioner; got "
                             f"{type(metric).__name__}")
        ctor["metric"] = preconditioner_from_numpy(
            kind, np.asarray(metric.scale if kind == "diag" else metric.chol),
            device="cpu")
    return ctor


def sampler_kwargs(jax_hmc) -> dict:
    """The port's ``HMC`` keyword arguments read from a JAX ``HMC``'s
    recorded constructor arguments (``_ctor``) and its metric (a CPU
    ``Preconditioner``; the sampler moves it to its device) and its
    transform (:func:`transform_from_jax`)."""
    return _kwargs(jax_hmc, "HMC")


def nuts_sampler_kwargs(jax_nuts) -> dict:
    """The port's ``NUTS`` keyword arguments read from a JAX ``NUTS``'s
    ``_ctor``, its metric and its transform; drops ``pallas_interpret``."""
    return _kwargs(jax_nuts, "NUTS")


def mala_sampler_kwargs(jax_mala) -> dict:
    """The port's ``MALA`` keyword arguments read from a JAX ``MALA``'s
    ``_ctor`` (HMC's, with its fixed ``n_leapfrog=1`` and ``jitter``
    dropped), its metric and its transform."""
    kwargs = _kwargs(jax_mala, "MALA")
    for key in ("n_leapfrog", "jitter"):
        kwargs.pop(key, None)
    return kwargs


def mh_sampler_kwargs(jax_mh) -> dict:
    """The port's ``MetropolisHastings`` keyword arguments read from a JAX
    ``MetropolisHastings``'s ``_ctor`` and its transform (and
    ``validate_dc``); drops ``pallas_interpret``."""
    return _kwargs(jax_mh, "MetropolisHastings")


def gibbs_sampler_kwargs(jax_gibbs, use_pallas=False) -> dict:
    """The port's ``GibbsSampler`` keyword arguments of a JAX
    ``GibbsSampler``. It records no ``_ctor`` and exposes no
    ``use_pallas``, so the caller passes that; ``steps_per_call`` is its
    step function's ``block_size`` (1 without one). ``pallas_interpret``
    has no counterpart."""
    return _kwargs(jax_gibbs, "GibbsSampler", dict(
        use_pallas=use_pallas,
        steps_per_call=getattr(jax_gibbs._step_fn, "block_size", 1)))


def pt_sampler_kwargs(jax_pt) -> dict:
    """The port's ``ParallelTempering`` keyword arguments read from a JAX
    ``ParallelTempering``: its ``_ctor`` and its ladder (``betas``), a
    non-scalar ``proposal_std`` as a float32 numpy array. Drops
    ``pallas_interpret``; carries its transform and ``validate_dc``."""
    kwargs = _kwargs(jax_pt, "ParallelTempering")
    std = kwargs["proposal_std"]
    if not isinstance(std, (int, float)):
        kwargs["proposal_std"] = np.asarray(std, np.float32)
    return dict(kwargs, betas=tuple(jax_pt.betas))


def chees_sampler_kwargs(jax_chees) -> dict:
    """The port's ``ChEESHMC`` keyword arguments of a JAX ``ChEESHMC``: its
    step size and trajectory length (adapted ones after ``warmed_up``),
    ``max_leapfrog``, its metric and its transform. The state carries over
    with :func:`hmc_state_from_numpy`."""
    return _kwargs(jax_chees, "ChEESHMC", dict(
        step_size=float(jax_chees.step_size),
        traj_len=float(jax_chees.traj_len),
        max_leapfrog=int(jax_chees.max_leapfrog),
        transform=jax_chees.transform))


def _steps_per_call(jax_sampler) -> int:
    return getattr(jax_sampler._step_fn, "block_size", 1)


def ensemble_sampler_kwargs(jax_es) -> dict:
    """The port's ``EnsembleSampler`` keyword arguments of a JAX one:
    ``walkers_per_ensemble``, ``a``, ``steps_per_call`` and its
    transform."""
    return _kwargs(jax_es, "EnsembleSampler", dict(
        walkers_per_ensemble=int(jax_es.walkers_per_ensemble),
        a=float(jax_es.a), steps_per_call=_steps_per_call(jax_es),
        transform=jax_es.transform))


def slice_sampler_kwargs(jax_ss) -> dict:
    """The port's ``SliceSampler`` keyword arguments of a JAX one: its
    width (a float, or a float32 numpy ``[D]``; an ``"auto"`` width as the
    JAX sampler resolved it), ``max_stepouts`` and ``max_shrink`` (read
    from its step function's closures), ``steps_per_call`` and its
    transform."""
    update = _free_var(jax_ss._step_fn, "_update_coordinate")
    return _kwargs(jax_ss, "SliceSampler", dict(
        width=_host(jax_ss.width),
        max_stepouts=int(_free_var(update, "max_stepouts")),
        max_shrink=int(_free_var(update, "max_shrink")),
        steps_per_call=_steps_per_call(jax_ss), transform=jax_ss.transform))


def elliptical_sampler_kwargs(jax_el) -> dict:
    """The port's ``EllipticalSliceSampler`` keyword arguments of a JAX
    one: the prior mean and scale (the ``[D, D]`` Cholesky factor when
    given so) as floats or float32 numpy arrays, ``max_shrink`` and
    ``steps_per_call``."""
    return _kwargs(jax_el, "EllipticalSliceSampler", dict(
        prior_mean=_host(jax_el.prior_mean),
        prior_scale=_host(jax_el.prior_scale),
        max_shrink=int(_free_var(jax_el._step_fn, "max_shrink")),
        steps_per_call=_steps_per_call(jax_el)))


def _step_size(jax_sampler, schedule) -> float | PolynomialDecay:
    """A JAX SG-MCMC sampler's constant step size as a float, or its
    ``polynomial_decay`` rebuilt from ``schedule = (a, b, gamma)``: the
    JAX schedule is a closure, so its constants are passed, not read."""
    if not callable(jax_sampler.step_size):
        if schedule is not None:
            raise ValueError("schedule= is for a sampler whose step size is "
                             "a schedule; this one's is constant")
        return float(jax_sampler.step_size)
    if schedule is None:
        raise ValueError("the JAX sampler's step size is a schedule (a "
                         "closure): pass its polynomial_decay constants as "
                         "schedule=(a, b, gamma)")
    return polynomial_decay(*schedule)


def sgld_sampler_kwargs(jax_sgld, schedule=None) -> dict:
    """The port's ``SGLD`` keyword arguments of a JAX ``SGLD`` but its
    ``grad_fn`` (a JAX function; build the port's with
    ``minibatch_grad`` on :func:`data_from_numpy`'s data): the step size
    (``schedule=(a, b, gamma)`` for a ``polynomial_decay``), temperature,
    preconditioner, ``rms_decay``, ``rms_eps`` (read from its step
    function's closures) and ``steps_per_call``."""
    fn = jax_sgld._step_fn
    return dict(step_size=_step_size(jax_sgld, schedule),
                temperature=float(_free_var(fn, "temperature")),
                preconditioner=_free_var(fn, "preconditioner"),
                rms_decay=float(_free_var(fn, "rms_decay")),
                rms_eps=float(_free_var(fn, "rms_eps")),
                steps_per_call=_steps_per_call(jax_sgld))


def sghmc_sampler_kwargs(jax_sghmc, schedule=None) -> dict:
    """The port's ``SGHMC`` keyword arguments of a JAX ``SGHMC`` but its
    ``grad_fn``: the step size (as :func:`sgld_sampler_kwargs`), friction,
    temperature and ``steps_per_call``."""
    return dict(step_size=_step_size(jax_sghmc, schedule),
                friction=float(jax_sghmc.friction),
                temperature=float(_free_var(jax_sghmc._step_fn,
                                            "temperature")),
                steps_per_call=_steps_per_call(jax_sghmc))
