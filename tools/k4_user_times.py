#!/usr/bin/env python3
"""Device time of Kernel 4's user instances alone, and their registers,
spills and SASS per leaf and per merge, for a comparison of two trees on
one card.

Run from the root of a checkout of the port (it imports the
``mini_mcmc_torch`` and ``chip_smoke.py`` found there and builds their
kernels into that checkout's ``build/``); to compare two trees, run it in
each, in turns (parent, change, change, parent), in one call on one card,
with one state file for all four runs:

    python3 tools/k4_user_times.py --state STATE.pt [--dims [D ...]]

Eight schools (``chip_smoke.py:user_requests``: the hand, derived and
traced forms at D = 10, plain and under a diagonal metric) at its
equilibrium: the first run makes it (``NUTS(..., use_pallas="full")
.warmed_up(300, "diag")`` and ``run(256, 0)`` on 4,096 chains, the hand
form) and saves it to ``--state``, the later runs load it, so that every
tree steps the same chains. Each instance steps them (depth limit 10,
``chip_smoke.py:phase_nuts_step``'s key and step) 20 times under
``torch.profiler``, three times; the whitened hand instance also on the
state tiled to 16,384 and 65,536 chains. ``--dims [D ...]`` adds a traced
banded Gaussian at each D (5, 6, 8, 10, 12 and 16 if none is named) on
4,096 chains from fixed inputs. Each depth count is the kernel's own
``depth`` output.

From each library's ``cuobjdump -sass``: the merge loop (the smallest loop
that loads from the stack) and the leaf loop (the smallest loop around
it) without it, in all and by opcode group. A reference isotropic
Gaussian density at D = 10 (hand gradient, ``logp = -x.x / 2``), built
alike, prices the leaf without its density: a form's density is its leaf
less the reference's, plus the reference density's D + 1 instructions.

Prints one JSON line: the card's name, power limit and largest SM clock,
each instance's microseconds a launch (three profiled calls), depth
counts, ``ptxas -v`` line and SASS counts.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import mini_mcmc_torch as mt  # noqa: E402
from mini_mcmc_torch.ops.kernels import user_density  # noqa: E402
from mini_mcmc_torch.ops.kernels import nuts_full  # noqa: E402
from mini_mcmc_torch.utils.profiling import device_profile  # noqa: E402

REPS = 20
KEY, STEP, DEPTH = 0x5EED_0123_4567_89AB, 9, 10
TILES = (4, 16)

#: the reference density: the least a leaf's density can cost
GAUSS_SOURCE = """\
struct Density {
  __device__ __forceinline__ explicit Density(const float*) {}
  template <class S, int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {
    S acc = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) acc = acc - 0.5f * (x[i] * x[i]);
    return acc;
  }
  template <int D>
  __device__ __forceinline__ void grad(const float (&x)[D],
                                       float (&g)[D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) g[i] = -x[i];
  }
};
"""

#: the D of the traced banded Gaussian's sweep (``--dims``)
DIMS = (5, 6, 8, 10, 12, 16)


def banded_gaussian(d: int) -> "mt.models.Target":
    """A Gaussian at D = ``d`` with neighbours coupled, traced (no
    source): ``z = x / s``, ``logp = -z.z / 2 - sum(z_i z_(i+1)) / 4``,
    ``s`` 0.5..2.0."""
    s = torch.linspace(0.5, 2.0, d)

    def logp(x):
        z = x / s.to(x.device)
        return (-0.5 * torch.sum(z * z, dim=-1)
                - 0.25 * torch.sum(z[..., :-1] * z[..., 1:], dim=-1))
    return mt.models.Target(logp=logp)


def dims_case(d: int, dev, c: int = 4096) -> tuple:
    """The sweep's step at D = ``d``: ``c`` chains from 0.8 N(0, I), step
    sizes uniform on (0.15, 0.45), from a fixed numpy seed."""
    g = np.random.default_rng(100 + d)
    pos = torch.from_numpy((0.8 * g.standard_normal((c, d))).astype(
        np.float32)).to(dev)
    eps = torch.from_numpy(g.uniform(0.15, 0.45, c).astype(
        np.float32)).to(dev)
    return pos, eps


#: SASS opcode groups of a leaf and a merge
GROUPS = (
    ("stack_store", ("STS",)),
    ("stack_load", ("LDS",)),
    ("shuffle", ("SHFL",)),
    ("mufu", ("MUFU",)),
    ("fp32", ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK")),
    ("philox", ("IMAD.WIDE", "IMAD.HI", "LOP3")),
    ("control", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "WARPSYNC",
                 "VOTE")),
)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def make_state(path: Path, dev) -> SimpleNamespace:
    """The hand stage's equilibrium: made and saved, or loaded."""
    from mini_mcmc_torch.examples.eight_schools import (
        make_noncentered_target,
    )

    if not path.exists():
        nuts = mt.NUTS(make_noncentered_target("hand"), mt.init_with_seed(
            cs.ES8_CHAINS, 10, seed=cs.ES8_FUSED_SEED, device=dev), 0.9,
            seed=cs.ES8_FUSED_SEED, use_pallas="full").warmed_up(
                cs.ES8_ADAPT, "diag")
        nuts.run(256, 0)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"y": nuts.state.positions.cpu(),
                    "eps": nuts.step_size.cpu(),
                    "scale": nuts.metric.scale.cpu()}, path)
    s = torch.load(path, weights_only=True)
    metric = mt.models.Preconditioner("diag", scale=s["scale"].to(dev))
    y = s["y"].to(dev)
    return SimpleNamespace(positions=(y * metric.scale).contiguous(),
                           state=SimpleNamespace(positions=y),
                           step_size=s["eps"].to(dev), metric=metric)


def device_us(fn) -> list:
    out = []
    for _ in range(3):
        _, _, by_name = device_profile(
            lambda: [fn() for _ in range(REPS)], expect="nuts_step_kernel")
        n = sum(c for k, (c, _) in by_name.items() if "nuts_step_kernel"
                in k)
        us = sum(u for k, (_, u) in by_name.items() if "nuts_step_kernel"
                 in k)
        out.append(us / n if n else None)
    return out


def depth_counts(depth: torch.Tensor) -> dict:
    d = depth.to(torch.int64)
    return {"chain_depth_max": int(d.max()),
            "chain_depth_mean": float(d.double().mean()),
            "chain_depth_counts": torch.bincount(d).tolist()}


def counts(ops: list) -> dict:
    out = {"all": len(ops)}
    for name, prefixes in GROUPS:
        out[name] = sum(op.startswith(prefixes) for op in ops)
    return out


def sass_leaf_merge(so: Path) -> dict:
    """Kernel 4's leaf and merge loops in the library's SASS: the merge
    loop the smallest loop that loads from the stack, the leaf loop the
    smallest loop around it."""
    funcs = cs.sass_functions(so)
    name = next(k for k in funcs if k.startswith("nuts_step_kernel"))
    insns, labels = funcs[name]
    bodies = [(b[0][0], b[-1][0], [op for _, op, _ in b])
              for b in cs.sass_loops(insns, labels)]
    out = {"kernel": name[:72], "instructions": len(insns)}
    merge = min((b for b in bodies if any(o.startswith("LDS")
                                          for o in b[2])),
                key=lambda b: len(b[2]), default=None)
    if merge is None:
        return out
    leaf = min((b for b in bodies if b[0] <= merge[0] and b[1] >= merge[1]
                and len(b[2]) > len(merge[2])), key=lambda b: len(b[2]),
               default=None)
    if leaf is None:
        return out
    leaf_only = [op for a, op, _ in insns if leaf[0] <= a <= leaf[1]
                 and not merge[0] <= a <= merge[1]]
    out["leaf"] = counts(leaf_only)
    out["merge"] = counts(merge[2])
    return out


def ptxas_line(so: Path) -> dict:
    _, reported = cs.ptxas_report(so.with_suffix(".log").read_text())
    return {k[:72]: v for k, v in reported.items()
            if k.startswith("nuts_step_kernel")}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default="build/k4_user_state.pt")
    ap.add_argument("--dims", nargs="*", type=int)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = smi()
    reqs = cs.user_requests(dev)
    ref = [(GAUSS_SOURCE, 10, 0), (GAUSS_SOURCE, 10, 5)]
    dims = () if args.dims is None else args.dims or DIMS
    banded = {d: banded_gaussian(d) for d in dims}
    sweep = [tuple(user_density.density_spec(t, d, dev)[0])
             for d, t in banded.items()]
    user_density.build(reqs + ref + sweep)
    st = make_state(Path(args.state), dev)
    starts = cs.user_starts(st, dev)
    res = {}
    for (form, kind), s in starts.items():
        t, pos, eps = s.kernel_target, s.state.positions, s.step_size
        step = (t, pos, eps, DEPTH, KEY, STEP, DEPTH)
        grid = {}
        out = nuts_full.nuts_step(*step, grid=grid)
        res[f"{form}_{kind}"] = dict(
            chains=pos.shape[0], device_us=device_us(
                lambda: nuts_full.nuts_step(*step)), grid=grid,
            **depth_counts(out[4]))
    hw = starts[("hand", "whitened")]
    t, pos, eps = hw.kernel_target, hw.state.positions, hw.step_size
    for k in TILES:
        pk, ek = pos.repeat(k, 1).contiguous(), eps.repeat(k).contiguous()
        step = (t, pk, ek, DEPTH, KEY, STEP, DEPTH)
        grid = {}
        out = nuts_full.nuts_step(*step, grid=grid)
        res[f"hand_whitened_x{k}"] = dict(
            chains=pk.shape[0], device_us=device_us(
                lambda: nuts_full.nuts_step(*step)), grid=grid,
            **depth_counts(out[4]))
    for d, t in banded.items():
        pos, eps = dims_case(d, dev)
        step = (t, pos, eps, DEPTH, KEY, STEP, DEPTH)
        grid = {}
        out = nuts_full.nuts_step(*step, grid=grid)
        res[f"banded_d{d}"] = dict(
            chains=pos.shape[0], device_us=device_us(
                lambda: nuts_full.nuts_step(*step)), grid=grid,
            **depth_counts(out[4]))
    libs = {f"{form}_{kind}": user_density.library_path(src, d, flags)
            for (src, d, flags), (kind, form) in zip(
                reqs, [(k, f) for k in ("plain", "whitened")
                       for f in cs.ES8_FORMS])}
    libs.update(gauss_plain=user_density.library_path(*ref[0]),
                gauss_whitened=user_density.library_path(*ref[1]))
    libs.update({f"banded_d{d}": user_density.library_path(*spec)
                 for d, spec in zip(banded, sweep)})
    print(json.dumps({
        "card": card, "tree": os.getcwd(), "times": res,
        "ptxas": {k: ptxas_line(so) for k, so in libs.items()},
        "sass": {k: sass_leaf_merge(so) for k, so in libs.items()}}),
        flush=True)


if __name__ == "__main__":
    main()
