#!/usr/bin/env python3
"""Kernel 1 (the leapfrog trajectory) alone on the card: device time,
output hashes and SASS of every instance ``chip_smoke.py`` holds against
its twin, for a comparison of two trees on one card.

Run from the root of a checkout of the port (it imports the
``mini_mcmc_torch`` and ``chip_smoke.py`` found there and builds their
kernels into that checkout's ``build/``); to compare two trees, run it in
each, in turns (parent, change, change, parent), in one call on one card,
with one state file for all four runs:

    python3 tools/k1_times.py --state STATE.pt [--out OUT.json]

The rows, each at the smoke's inputs:

- ``mala_f32``: the tuned-MALA stage's Gaussian2D, D = 2, L = 1, 65,536
  chains (``phase_mala_kernel``), at the state after ``tuned(256)`` and
  ``run(2048, 0)``;
- ``tier_f32_L192`` and ``tier_f32_L8``: Rosenbrock D = 3 on the
  flagship's 65,536 chains after its burn-in (``phase_leapfrog``);
- ``es8_<form>_<kind>``: eight schools (D = 10, 4,096 chains) at its
  equilibrium, hand, derived and traced, plain and whitened diag, L = 8
  (``phase_user_kernels``' ``k1_args``);
- ``f64_<case>``: the float64 cases of ``chip_smoke.py:f64_cases``, the
  flagship's also at L = 16-128 (``SWEEP_L``), and ``f32_funnel_d4`` the
  funnel at float32 (a row of 16 bytes).

The first run makes the float32 states (each stage through its public
entry points) and saves them to ``--state``; the later runs load them, so
that every tree steps the same chains. The float64 cases are drawn from
fixed device generators. Momenta come from a numpy seed a row.

Each row: device µs a launch from three ``torch.profiler`` calls of 20
launches (over the launches each recorded), a SHA-256 of each of the four
outputs (``pos``, ``mom``, ``logp``, ``grad``), and the bytes-bound µs
(each input read once, each output written once, at 3.35 TB/s).

From ``cuobjdump -sass`` and the ``ptxas -v`` logs, each instance a row
launches: the leapfrog loop (of the innermost loops,
``chip_smoke.sass_loops``, the one with the most FP32 or FP64
arithmetic) in all and by opcode group, the
whole function's global loads and stores by width, and its registers,
stack and spills.

Prints the device times as one JSON line; ``--out`` receives all of it.
"""

from __future__ import annotations

import argparse
import hashlib
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
from mini_mcmc_torch.ops.kernels import _build, user_density  # noqa: E402
from mini_mcmc_torch.ops.kernels.hmc import leapfrog_trajectory  # noqa: E402
from mini_mcmc_torch.utils.profiling import device_profile  # noqa: E402

REPS = 20
#: the float64 flagship's trajectory lengths between L = 8 and 192
SWEEP_L = (16, 32, 64, 96, 128)

#: SASS opcode groups of the leapfrog loop and of the whole function
LOOP_GROUPS = (
    ("fp32", ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK")),
    ("fp64", ("DADD", "DMUL", "DFMA", "DSETP")),
    ("mufu", ("MUFU",)),
    ("control", ("BRA", "BSSY", "BSYNC", "CALL", "RET")),
)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def make_states(path: Path, dev) -> dict:
    """The float32 rows' states: made through the stages' entry points
    and saved, or loaded."""
    from mini_mcmc_torch.examples.eight_schools import (
        make_noncentered_target,
    )

    if not path.exists():
        ml = mt.MALA(mt.diffable_gaussian2d(cs.MALA_MEAN, cs.NUTS_COV),
                     mt.init_with_seed(cs.MALA_CHAINS, 2, seed=13,
                                       device=dev),
                     step_size=1.0, use_pallas="full",
                     steps_per_call=cs.MALA_K).seed(13).tuned(cs.MALA_ADAPT)
        ml.run(cs.MALA_COLLECT, 0)
        h = cs.flagship(dev)
        h.run(cs.N_COLLECT, 0)
        nuts = mt.NUTS(make_noncentered_target("hand"), mt.init_with_seed(
            cs.ES8_CHAINS, 10, seed=cs.ES8_FUSED_SEED, device=dev), 0.9,
            seed=cs.ES8_FUSED_SEED, use_pallas="full").warmed_up(
                cs.ES8_ADAPT, "diag")
        nuts.run(256, 0)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({
            "mala_x": ml.state.positions.cpu(), "mala_g": ml.state.grad.cpu(),
            "mala_eps": float(ml.step_size),
            "hmc_x": h.state.positions.cpu(), "hmc_g": h.state.grad.cpu(),
            "es8_y": nuts.state.positions.cpu(),
            "es8_eps": nuts.step_size.cpu(),
            "es8_scale": nuts.metric.scale.cpu()}, path)
    return torch.load(path, weights_only=True)


def momenta(shape, seed: int, dev, dtype=torch.float32) -> torch.Tensor:
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape)).to(dev, dtype)


def rows(st: dict, dev) -> dict:
    """name -> (target, pos, mom, grad, eps [1], L)."""
    out = {}
    mala_t = mt.diffable_gaussian2d(cs.MALA_MEAN, cs.NUTS_COV)
    x = st["mala_x"].to(dev)
    out["mala_f32"] = (mala_t, x, momenta(x.shape, 1, dev),
                       st["mala_g"].to(dev),
                       torch.tensor([st["mala_eps"]], device=dev), 1)
    x = st["hmc_x"].to(dev)
    for n_lf in (cs.N_LEAPFROG, 8):
        out[f"tier_f32_L{n_lf}"] = (
            mt.rosenbrock_nd(), x, momenta(x.shape, 2, dev),
            st["hmc_g"].to(dev), torch.tensor([cs.STEP_SIZE], device=dev),
            n_lf)
    metric = mt.models.Preconditioner("diag",
                                      scale=st["es8_scale"].to(dev))
    y = st["es8_y"].to(dev)
    nuts = SimpleNamespace(positions=(y * metric.scale).contiguous(),
                           state=SimpleNamespace(positions=y),
                           step_size=st["es8_eps"].to(dev), metric=metric)
    for i, ((form, kind), s) in enumerate(cs.user_starts(nuts, dev)
                                          .items()):
        t, pos = s.kernel_target, s.state.positions
        _, grad = t.batch_logp_and_grad(pos)
        out[f"es8_{form}_{kind}"] = (
            t, pos, momenta(pos.shape, 10 + i, dev), grad,
            s.step_size.median().reshape(1), 8)
    for i, (name, (t, x, eps, n_lf, _)) in enumerate(
            cs.f64_cases(dev).items()):
        _, g = t.batch_logp_and_grad(x)
        out[f"f64_{name}"] = (
            t, x, momenta(x.shape, 40 + i, dev, torch.float64), g,
            torch.tensor([eps], device=dev, dtype=torch.float64), n_lf)
        if name == "flagship":  # where staging stops paying
            for n in SWEEP_L:
                out[f"f64_flagship_L{n}"] = out["f64_flagship"][:5] + (n,)
        if name == "funnel_d4":  # a float row of 16 bytes
            x = x.float()
            _, g = t.batch_logp_and_grad(x)
            out["f32_funnel_d4"] = (t, x, momenta(x.shape, 40 + i, dev), g,
                                    torch.tensor([eps], device=dev), n_lf)
    return out


def device_us(fn) -> list:
    out = []
    for _ in range(3):
        _, _, by_name = device_profile(
            lambda: [fn() for _ in range(REPS)], expect="leapfrog_kernel")
        n = sum(c for k, (c, _) in by_name.items() if "leapfrog_kernel" in k)
        us = sum(u for k, (_, u) in by_name.items() if "leapfrog_kernel" in k)
        out.append(us / n if n else None)
    return out


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def bytes_bound_us(pos) -> float:
    c, d = pos.shape
    n = pos.element_size() * (3 * c * d + 1 + c * (3 * d + 1))
    return n / cs.HBM_BYTES_PER_S * 1e6


def opcode_counts(ops) -> dict:
    out = {"all": len(ops)}
    for name, prefixes in LOOP_GROUPS:
        out[name] = sum(op.startswith(prefixes) for op in ops)
    return out


def io_counts(ops) -> dict:
    """Global and shared loads and stores by width, and async copies."""
    out = {}
    for op in ops:
        base = op.split(".")[0]
        if base not in ("LDG", "STG", "LDS", "STS", "LDGSTS"):
            continue
        width = next((w for w in ("128", "64") if f".{w}" in op), "32")
        key = f"{base}.{width}"
        out[key] = out.get(key, 0) + 1
    return out


def sass_rows(so: Path) -> dict:
    """Each leapfrog_kernel instance of the library: its leapfrog loop
    and its loads and stores."""
    out = {}
    for name, (insns, labels) in cs.sass_functions(so).items():
        if not name.startswith("leapfrog_kernel"):
            continue
        spans = [(b[0][0], b[-1][0], [op for _, op, _ in b])
                 for b in cs.sass_loops(insns, labels)]
        # the innermost loops (none inside), the one with the most FP
        inner = [ops for lo, hi, ops in spans if not any(
            lo <= a and b <= hi and (a, b) != (lo, hi)
            for a, b, _ in spans)]
        loop = max(inner, key=lambda ops: sum(o.startswith(
            ("FFMA", "FADD", "FMUL", "DFMA", "DADD", "DMUL"))
            for o in ops), default=[])
        ops = [op for _, op, _ in insns]
        out[name[:96]] = {"instructions": len(ops),
                          "loop": opcode_counts(loop), "io": io_counts(ops)}
    return out


def ptxas_rows(so: Path) -> dict:
    _, reported = cs.ptxas_report(so.with_suffix(".log").read_text())
    return {k[:96]: v for k, v in reported.items()
            if k.startswith("leapfrog_kernel")}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default="build/k1_state.pt")
    ap.add_argument("--out")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = smi()
    reqs = cs.user_requests(dev)
    r64 = cs.f64_int32_requests(dev)[0]
    so = _build.build(also=user_density.jobs(reqs + r64))
    st = make_states(Path(args.state), dev)
    res = {}
    for name, (t, pos, mom, grad, eps, n_lf) in rows(st, dev).items():
        got = leapfrog_trajectory(t, pos, mom, grad, eps, n_lf)
        torch.cuda.synchronize()
        res[name] = dict(
            chains=pos.shape[0], D=pos.shape[1], L=n_lf,
            dtype=str(pos.dtype).replace("torch.", ""),
            device_us=device_us(
                lambda: leapfrog_trajectory(t, pos, mom, grad, eps, n_lf)),
            bytes_bound_us=bytes_bound_us(pos),
            sha=dict(zip(("pos", "mom", "logp", "grad"),
                         (sha(v) for v in got))))
    libs = {"builtin": so}
    for (src, d, flags), (kind, form) in zip(
            reqs, [(k, f) for k in ("plain", "whitened")
                   for f in cs.ES8_FORMS]):
        libs[f"es8_{form}_{kind}"] = user_density.library_path(src, d, flags)
    for spec, form in zip(r64, ("hand", "traced")):
        libs[f"f64_user_{form}_d5"] = user_density.library_path(*spec)
    full = {"card": card, "tree": os.getcwd(), "times": res,
            "ptxas": {k: ptxas_rows(p) for k, p in libs.items()},
            "sass": {k: sass_rows(p) for k, p in libs.items()}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(full) + "\n")
    # the times alone on the standard output; the rest in --out
    print(json.dumps({"card": card, "tree": os.getcwd(), "device_us": {
        k: v["device_us"] for k, v in res.items()}}), flush=True)


if __name__ == "__main__":
    main()
