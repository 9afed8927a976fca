"""Large-D HMC on the separable fused tier, with constraints.

Counterpart of ``examples/bigd_separable_hmc.py``. For
coordinate-separable targets — ``logp(x) = sum_d f_d(x_d)`` — the
``use_pallas="separable"`` tier runs a whole HMC step per chain in one
launch of the separable kernel (``csrc/hmc_separable.cu``: momentum drawn
in the kernel, the gradient re-derived per coordinate tile, the accept
fused), so a step's memory traffic does not grow with the trajectory
length. Per-coordinate ``transform=`` bijectors ride the same kernel
through its coordinate tables.

The size follows the device the caller asks for, as the JAX example's
follows its backend: on CUDA 1,024 chains x D = 10,000 through the
kernel, one launch a step; on the CPU 64 chains x D = 128 on the plain
path. At D = 10,000 the constrained half takes step size 0.04 and 40
leapfrogs: the JAX example's 0.22 and 8 accept no step there (from
x = 1 a trajectory's energy error is about -80), so its sample would be
the start.
"""

import math

import torch

from .. import HMC, init_with_seed
from ..models import standard_normal
from ..models.transforms import CoordinateTransform, positive


def main(device="cuda"):
    on_gpu = torch.device(device).type == "cuda"
    c, d, n = (1024, 10_000, 64) if on_gpu else (64, 128, 64)
    kw = {"use_pallas": "separable"} if on_gpu else {}
    eps_c, l_c = (0.04, 40) if on_gpu else (0.22, 8)

    # 1) plain separable target at scale
    h = HMC(standard_normal(), init_with_seed(c, d, seed=0, device=device),
            0.1, 10, device=device, **kw).seed(0)
    s = h.run(n, n)
    var, mean = torch.var_mean(s, correction=0)
    print(f"[{'separable fused' if on_gpu else 'plain'}] {c} chains x "
          f"d={d}: mean {float(mean):+.4f} "
          f"var {float(var):.4f} (expect 0, 1)")

    # 2) constrained: N(0,1) on natural coordinates restricted positive
    #    (the half-normal — exact moments sqrt(2/pi), 1 - 2/pi); the
    #    positivity bijector rides the same kernel
    tf = CoordinateTransform({i: positive() for i in range(d)}, d)
    h = HMC(standard_normal(), torch.full((c, d), 1.0, device=device),
            eps_c, l_c, transform=tf, device=device, **kw).seed(1)
    s = h.run(n, n)  # samples come back in natural (positive) coordinates
    var, mean = torch.var_mean(s, correction=0)
    print(f"[constrained]     mean {float(mean):+.4f} "
          f"(exact {math.sqrt(2 / math.pi):.4f}) "
          f"var {float(var):.4f} "
          f"(exact {1 - 2 / math.pi:.4f}) min {float(s.min()):.2e}")


if __name__ == "__main__":
    main()
