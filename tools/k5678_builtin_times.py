#!/usr/bin/env python3
"""Device time of the built-in instances of Kernels 5-8 alone, and their
registers, stack frames and spills, for a comparison of two trees on one
card.

Run from the root of a checkout of the port (it imports the
``mini_mcmc_torch`` found there and builds its kernels into that
checkout's ``build/``); to compare two trees, run it in each, in turns
(parent, change, change, parent), in one call on one card:

    python3 tools/k5678_builtin_times.py

At the main paths' shapes of ``chip_smoke.py``: Kernel 5 on Gaussian2D
(65,536 chains, K = 16, the isotropic walk), Kernel 6 on the mixture
(65,536 chains, K = 32), Kernel 7's fused step on the standard normal
(1,024 chains, D = 10,000, L = 10, eps 0.1) and Kernel 8 on the 0.3/0.7
mixture (8,192 chains, 8 rungs, K = 16), each from states drawn from its
target, 50 launches under ``torch.profiler`` three times. Prints one JSON
line: the card's name and power limit, the microseconds a launch of each
(three profiled calls) and each instance's ``ptxas -v`` line.
"""

from __future__ import annotations

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
from mini_mcmc_torch.ops.kernels.gibbs_full import gibbs_multistep  # noqa
from mini_mcmc_torch.ops.kernels.hmc_sep import hmc_separable_step  # noqa
from mini_mcmc_torch.ops.kernels.mh_full import mh_multistep  # noqa: E402
from mini_mcmc_torch.ops.kernels.pt_full import (  # noqa: E402
    make_ladder,
    pt_multistep,
)
from mini_mcmc_torch.utils.profiling import device_profile  # noqa: E402

REPS = 50
MIX = (-2.0, 1.0, 3.0, 1.5, 0.5)


def cases(dev):
    gen = torch.Generator(device=dev).manual_seed(606)
    c = 65536
    gauss = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    x = torch.randn((c, 2), generator=gen, device=dev)
    lp = gauss.batch_logp(x)
    hk = torch.empty((16, c, 2), device=dev)
    walk = mt.isotropic_gaussian_proposal(1.0)
    mu0, sigma0, mu1, sigma1, pi0 = MIX
    z = (torch.rand(c, generator=gen, device=dev) >= pi0).float()
    n = torch.randn(c, generator=gen, device=dev)
    xm = torch.stack([torch.where(z > 0, mu1 + sigma1 * n, mu0 + sigma0 * n),
                      z], dim=1)
    hg = torch.empty((32, c, 2), device=dev)
    cond = mt.gaussian_mixture_conditional(*MIX)
    xs = torch.randn((1024, 10000), generator=gen, device=dev)
    sn = mt.standard_normal()
    lps = sn.batch_logp(xs)
    eps = torch.tensor([0.1], device=dev)
    tables = xs.new_empty((0, 10000))
    lw0, lw1 = math.log(0.3), math.log(0.7)
    mix = mt.models.Target(logp=lambda v: v[..., 0],
                           cuda_functor="gaussian_mixture_1d",
                           cuda_params=(lw0, -8.0, 0.5, lw1, 8.0, 0.5))
    t, cp = 8, 8192
    side = torch.where(torch.rand((t, 1, cp), generator=gen, device=dev)
                       < 0.7, 8.0, -8.0)
    pos = side + 0.5 * torch.randn((t, 1, cp), generator=gen, device=dev)
    lpp = torch.zeros((t, cp), device=dev)
    sa = torch.zeros((t - 1, cp), device=dev)
    lad = make_ladder(mt.geometric_betas(t, 0.01), 1.0, 1, dev)
    hp = torch.empty((16, cp, 1), device=dev)
    return {
        "mh_multistep_kernel": lambda: mh_multistep(
            gauss, walk, x, lp, 0x5EED, 0, 16, hk),
        "gibbs_multistep_kernel": lambda: gibbs_multistep(
            cond, xm, 0x5EED, 0, 32, hg),
        "hmc_separable_kernel": lambda: hmc_separable_step(
            sn, xs, lps, eps, 10, 0x5EED, 1, tables),
        "pt_multistep_kernel": lambda: pt_multistep(
            mix, pos, lpp, sa, 0, lad, 0x5EED, 0, 16, 1, hp),
    }


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
    return {k: v for k, v in out.items() if re.search(
        r"mh_multistep|gibbs_multistep|hmc_separable|pt_multistep", k)}


def main() -> None:
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    so = _build.build()
    _build.lib()
    launches = cases(dev)
    for fn in launches.values():
        fn()
    torch.cuda.synchronize()
    times = {}
    for name, fn in launches.items():
        us = []
        for _ in range(3):
            _, _, by_name = device_profile(
                lambda: [fn() for _ in range(REPS)], expect=name)
            n = sum(c for k, (c, _) in by_name.items() if name in k)
            t = sum(u for k, (_, u) in by_name.items() if name in k)
            us.append(t / n if n else None)
        times[name] = us
    print(json.dumps({"card": smi, "tree": os.getcwd(), "device_us": times,
                      "ptxas": ptxas_lines(so.with_suffix(".log")
                                           .read_text())}), flush=True)


if __name__ == "__main__":
    main()
