"""Kernel 1: the fused leapfrog trajectory (``csrc/hmc_leapfrog.cu``).

Replaces ``mini_mcmc_tpu/ops/pallas/hmc.py:make_pallas_leapfrog`` with the
same contract: ``(pos, mom, grad [C, D], eps) -> (pos', mom', logp' [C],
grad' [C, D])``, L steps with the cached half-step gradient at a runtime
step size. ``eps`` is a 0-d or ``[1]`` tensor on the positions' device, so
a jittered step size never syncs the host.

States are float32 or float64: the JAX kernel takes the state's dtype
and runs float64 under ``jax_enable_x64``, so Kernel 1 has float64
instances (``mm_leapfrog_f64``: every built-in instance, and a user
density's own float64 library), eps, params and outputs in float64. The
other fused kernels take float32 (``_build.TIER_DTYPES``).

:func:`leapfrog_trajectory` launches the CUDA kernel for CUDA tensors and
runs :func:`leapfrog_trajectory_plain` for CPU tensors only; it never
falls back from one to the other.
"""

from __future__ import annotations

import torch

from . import _build

#: the tier that runs this kernel, and the dtypes it takes on CUDA
TIER = _build.tier("HMC/MALA use_pallas=True (Kernel 1)", torch.float32,
                   torch.float64)


def leapfrog_trajectory_plain(target, pos, mom, grad, eps, n_leapfrog: int):
    """Plain PyTorch twin of the kernel, and the leapfrog of the
    ``use_pallas=False`` tier (``mini_mcmc_tpu/ops/hmc.py:170-190``)."""
    leapfrog_trajectory_plain.calls += 1
    half_eps = eps * 0.5
    for _ in range(n_leapfrog):
        mom = mom + grad * half_eps
        pos = pos + mom * eps
        grad = target.batch_grad(pos)
        mom = mom + grad * half_eps
    return pos, mom, target.batch_logp(pos), grad


leapfrog_trajectory_plain.calls = 0


def check_state(pos, *others, tier: str, dims=_build.KERNEL_DIMS):
    """Validate what the kernels take: contiguous CUDA tensors of one
    dtype that ``tier`` (a kernel module's ``TIER``) takes on CUDA
    (``_build.TIER_DTYPES``: float32, and float64 for Kernel 1), ``pos`` ``[C, D]`` with a D in ``dims`` (the
    built-in instances' by default; ``_build.kernel_dims`` of a target),
    the rest on its device."""
    if pos.dim() != 2:
        raise ValueError(f"positions must be [C, D]; got {tuple(pos.shape)}")
    if pos.shape[1] not in dims:
        raise ValueError(
            f"the CUDA kernels are built for D in {dims}; got "
            f"D={pos.shape[1]}"
        )
    _build.check_tier_dtype(tier, pos.dtype)
    for t in (pos, *others):
        if t.dtype != pos.dtype or t.device != pos.device:
            raise ValueError(
                f"the CUDA kernels take {_build.dtype_name(pos.dtype)} "
                f"tensors on one device, the positions'; got {t.dtype} on "
                f"{t.device}"
            )
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")


def leapfrog_trajectory(target, pos, mom, grad, eps, n_leapfrog: int):
    """L leapfrog steps of ``target`` from ``(pos, mom, grad)`` at ``eps``.

    Returns ``(pos', mom', logp', grad')``.
    """
    if not pos.is_cuda:
        return leapfrog_trajectory_plain(target, pos, mom, grad, eps,
                                         n_leapfrog)
    eps = eps.reshape(1)
    check_state(pos, mom, grad, eps, dims=_build.kernel_dims(target),
                tier=TIER)
    lib, tid, params = _build.kernel_lib(target, pos.shape[1], pos.device,
                                         pos.dtype)
    c, d = pos.shape
    if mom.shape != pos.shape or grad.shape != pos.shape:
        raise ValueError("pos, mom and grad must all be [C, D]")
    pos_o = torch.empty_like(pos)
    mom_o = torch.empty_like(pos)
    grad_o = torch.empty_like(pos)
    logp_o = torch.empty((c,), dtype=pos.dtype, device=pos.device)
    f64 = pos.dtype == torch.float64
    entry = lib.mm_leapfrog_f64 if f64 else lib.mm_leapfrog_f32
    leapfrog_trajectory.launches += 1
    leapfrog_trajectory.f64_launches += f64
    leapfrog_trajectory.transformed_launches += (
        target.cuda_transform is not None)
    leapfrog_trajectory.user_launches += target.cuda_functor is None
    # the kernel moves rows in 16-byte pieces where every [C, D] pointer
    # allows it (a view at a row offset does not), element by element else
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (pos, mom, grad, pos_o, mom_o, grad_o))
    _build.check(entry(
        pos.data_ptr(), mom.data_ptr(), grad.data_ptr(), eps.data_ptr(),
        params, n_leapfrog, c, d, tid, _build.instance_flags(target),
        int(aligned), pos_o.data_ptr(), mom_o.data_ptr(),
        logp_o.data_ptr(), grad_o.data_ptr(), _build.stream_ptr(pos.device),
    ), lib)
    return pos_o, mom_o, logp_o, grad_o


leapfrog_trajectory.launches = 0
#: the launches of the float64 instances, also counted in ``launches``
leapfrog_trajectory.f64_launches = 0
#: the launches of the transformed instances (``mm::Transformed``, a
#: metric's wrapper around it included), also counted in ``launches``
leapfrog_trajectory.transformed_launches = 0
#: the launches of user instances (``Target.cuda_source`` or a generated
#: source: ``user_density.py``), also counted in ``launches``
leapfrog_trajectory.user_launches = 0
