#!/usr/bin/env python3
"""Device time of Kernels 2, 3, 7 and 8 alone (the kernels whose draws
take an offset: a chain offset, ``chain0``, in 2, 3 and 8, a coordinate
offset, ``d0``, in 7's trajectory form), for a comparison of two trees on
one card.

Run from the root of a checkout of the port (it imports the
``mini_mcmc_torch`` found there and builds its kernels into that
checkout's ``build/``); to compare two trees, run it in each, in turns
(parent, change, change, parent), in one call on one card:

    python3 tools/k238_times.py

At the main paths' shapes of ``chip_smoke.py``, from states drawn from
their targets: Kernel 2's flagship block (Rosenbrock D = 3, 65,536
chains, K = 16, L = 192), Kernel 3 on the NUTS stage's Gaussian (131,072
chains, j = 4), Kernel 8 on the 0.3/0.7 mixture (8,192 chains, 8
rungs, K = 16) and Kernel 7 on the separable stage's standard normal
(1,024 chains, D = 10,000, L = 10: the fused step and the trajectory-only
form), each launched with the wrappers' default offsets, 50 launches
under ``torch.profiler`` three times. Prints one JSON line: the card's
name and power limit, the microseconds a launch of each (three profiled
calls), a hash of each kernel's outputs (a tree whose offset leaves the
default's draws alone gives its parent's) and each instance's ``ptxas
-v`` line.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import mini_mcmc_torch as mt  # noqa: E402
from mini_mcmc_torch.ops.kernels import _build  # noqa: E402
from mini_mcmc_torch.ops.kernels.hmc_full import hmc_multistep  # noqa: E402
from mini_mcmc_torch.ops.kernels.hmc_sep import (  # noqa: E402
    hmc_separable,
    hmc_separable_step,
)
from mini_mcmc_torch.ops.kernels.nuts_subtree import subtree  # noqa: E402
from mini_mcmc_torch.ops.kernels.pt_full import (  # noqa: E402
    make_ladder,
    pt_multistep,
)
from mini_mcmc_torch.utils.profiling import device_profile  # noqa: E402

REPS = 50


def cases(dev):
    gen = torch.Generator(device=dev).manual_seed(2323)
    rosen = mt.rosenbrock_nd()
    c2 = 65536
    x2 = torch.randn((c2, 3), generator=gen, device=dev) * 0.3 + 0.9
    lp2, g2 = rosen.batch_logp_and_grad(x2)
    eps2 = 0.02 * (1.0 + 0.3 * (2.0 * torch.rand(
        (16,), generator=gen, device=dev) - 1.0))
    h2 = torch.empty((16, c2, 3), device=dev)
    gauss = mt.diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    c3 = 131072
    x3 = torch.randn((c3, 2), generator=gen, device=dev) * 1.5
    m3 = torch.randn((c3, 2), generator=gen, device=dev)
    lp3, g3 = gauss.batch_logp_and_grad(x3)
    j0 = lp3 - 0.5 * (m3 * m3).sum(1)
    logu = j0 - torch.empty_like(j0).exponential_(generator=gen)
    u = torch.rand((3, c3), generator=gen, device=dev)
    v = torch.where(u[0] < 0.5, -1, 1).to(torch.int32)
    active = u[1] < 0.9
    eps3 = 0.3 + 0.9 * u[2]
    lw0, lw1 = math.log(0.3), math.log(0.7)
    mix = mt.models.Target(logp=lambda x: x[..., 0],
                           cuda_functor="gaussian_mixture_1d",
                           cuda_params=(lw0, -8.0, 0.5, lw1, 8.0, 0.5))
    t, c8 = 8, 8192
    side = torch.where(torch.rand((t, 1, c8), generator=gen, device=dev)
                       < 0.7, 8.0, -8.0)
    x8 = side + 0.5 * torch.randn((t, 1, c8), generator=gen, device=dev)
    lp8 = torch.zeros((t, c8), device=dev)
    sa8 = torch.zeros((t - 1, c8), device=dev)
    lad = make_ladder(mt.geometric_betas(t, 0.01), 1.0, 1, dev)
    h8 = torch.empty((16, c8, 1), device=dev)
    sn = mt.standard_normal()
    x7 = torch.randn((1024, 10_000), generator=gen, device=dev)
    lp7 = sn.batch_logp(x7)
    eps7 = torch.tensor([0.1], device=dev)
    t7 = x7.new_empty((0, 10_000))
    return {
        "multistep_kernel": lambda: (*hmc_multistep(
            rosen, x2, lp2, g2, eps2, 192, 0x5EED, 0, h2), h2),
        "subtree_kernel": lambda: tuple(subtree(
            gauss, x3, m3, g3, logu, v, 4, eps3, j0, active,
            (0x1234567, -0x7654321), 10)),
        "pt_multistep_kernel": lambda: (*pt_multistep(
            mix, x8, lp8, sa8, 0, lad, 0x5EED, 0, 16, 1, h8), h8),
        "hmc_separable_kernel_fused": lambda: hmc_separable_step(
            sn, x7, lp7, eps7, 10, 0x5EED, 6, t7),
        "hmc_separable_kernel_trajectory": lambda: hmc_separable(
            sn, x7, eps7, 10, 0x5EED, 6, t7)[:4],
    }


#: a profiled case's kernel: the name its events hold, and for Kernel 7's
#: two forms the template flag that tells them apart
EVENTS = {"hmc_separable_kernel_fused": ("hmc_separable_kernel", "true>"),
          "hmc_separable_kernel_trajectory": ("hmc_separable_kernel",
                                              "false>")}


def digest(tensors) -> str:
    """sha256 of the outputs' bytes, in order: equal digests are equal
    outputs bit for bit."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def ptxas_lines(log: str) -> dict:
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            out.setdefault(name, {})["frame_spill"] = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["regs"] = int(m.group(1))
    # the flagship's and the stages' instances: Rosenbrock D = 3, the
    # diffable Gaussian at D = 2, the mixture at D = 1, the standard
    # normal's coordinate functor in Kernel 7's two forms
    return {k: v for k, v in out.items() if re.search(
        r"multistep_kernel.*Rosenbrock.*Li3E|subtree_kernel.*Gaussian2D"
        r".*Li2E|pt_multistep_kernel.*GaussianMixture1D|"
        r"hmc_separable_kernelIN2mm\d+StandardNormalCoordE", k)}


def main() -> None:
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    so = _build.build()
    _build.lib()
    launches = cases(dev)
    # each kernel's outputs at the first chain 0 (the wrapper's default)
    hashes = {name: digest(fn()) for name, fn in launches.items()}
    torch.cuda.synchronize()
    times = {}
    for name, fn in launches.items():
        event, flag = EVENTS.get(name, (name, ""))
        us = []
        for _ in range(3):
            _, _, by_name = device_profile(
                lambda: [fn() for _ in range(REPS)], expect=event)
            hit = {k: v for k, v in by_name.items()
                   if event in k and flag in k}
            n = sum(c for c, _ in hit.values())
            t = sum(u for _, u in hit.values())
            us.append(t / n if n else None)
        times[name] = us
    print(json.dumps({"card": smi, "tree": os.getcwd(), "device_us": times,
                      "output_sha256": hashes,
                      "ptxas": ptxas_lines(so.with_suffix(".log")
                                           .read_text())}), flush=True)


if __name__ == "__main__":
    main()
