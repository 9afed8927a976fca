#!/usr/bin/env python3
"""Fingerprint the SASS of every float32 kernel instance a tree builds, to
show that a change kept their code: the built-in library (Kernels 0-8)
and the per-form libraries of ``chip_smoke.py``'s user stages
(``user_requests`` and ``k5678_user_requests``, the eight-schools and
Kernels 5-8 user forms), each function's instructions hashed, with its
``ptxas -v`` registers, stack frame and spills, and the device time of
Kernels 1 and 2 alone at the flagship's shape.

Run from the root of a checkout of the port on a machine with a GPU and
``nvcc`` (it builds the kernels into that checkout's ``build/``):

    python3 tools/f32_sass_identity.py OUT.json

and compare two fingerprints (here or anywhere):

    python3 tools/f32_sass_identity.py --compare PARENT.json CHANGE.json

The comparison keys a function by its library (the built-in one, or the
user library's place in the request lists and its spec) and its
``chip_smoke.kernel_name``; Kernel 1's float instances carry their scalar
as a third template argument since float64 ones exist (``...Ef``), which
the key drops. It prints each function whose hash or ``ptxas`` line
differs and the float64 instances the change adds, and exits 1 if any
float32 function differs or is missing.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def _key(name: str) -> str:
    """A function's key across trees: Kernel 1's scalar argument dropped
    from its float instances."""
    if name.startswith("leapfrog_kernel") and name.endswith("Ef"):
        return name[:-2]
    return name


def fingerprint(out_path: str) -> None:
    import torch

    import chip_smoke as cs
    from mini_mcmc_torch.ops.kernels import _build, user_density
    from mini_mcmc_torch.ops.kernels.hmc import leapfrog_trajectory
    from mini_mcmc_torch.ops.kernels.hmc_full import hmc_multistep

    dev = torch.device("cuda", 0)
    reqs = list(cs.user_requests(dev)) + list(cs.k5678_user_requests(dev))
    so = _build.build(also=user_density.jobs(reqs))
    libs = {"builtin": so}
    for i, spec in enumerate(reqs):
        spec = user_density.Spec(*spec)
        tag = hashlib.sha256(
            f"{spec.source}|{spec.dim}|{spec.flags}|{spec.kind}|"
            f"{spec.types!r}".encode()).hexdigest()[:12]
        libs[f"user{i}:{spec.kind}:{tag}"] = user_density.library_path(*spec)
    funcs, ptxas = {}, {}
    for lib, path in libs.items():
        for name, (insns, _) in cs.sass_functions(path).items():
            text = "\n".join(f"{op} {rest}" for _, op, rest in insns)
            funcs[f"{lib}|{_key(name)}"] = {
                "sha": hashlib.sha256(text.encode()).hexdigest(),
                "n": len(insns), "name": name}
        _, reported = cs.ptxas_report(path.with_suffix(".log").read_text())
        for name, info in reported.items():
            ptxas[f"{lib}|{_key(name)}"] = info
    # Kernels 1 and 2 alone at the flagship's shape, from states drawn
    # near its typical set
    _build.lib()
    gen = torch.Generator(device=dev).manual_seed(7)
    c, d = cs.N_CHAINS, cs.DIM
    target = cs.mt.rosenbrock_nd()
    x = torch.randn((c, d), generator=gen, device=dev) * 0.3 + 0.8
    lp, g = target.batch_logp_and_grad(x)
    mom = torch.randn((c, d), generator=gen, device=dev)
    eps = torch.full((1,), cs.STEP_SIZE, device=dev)
    epsk = torch.full((cs.STEPS_PER_CALL,), cs.STEP_SIZE, device=dev)
    times = cs.device_ms_each({
        "leapfrog_kernel": lambda: leapfrog_trajectory(
            target, x, mom, g, eps, cs.N_LEAPFROG),
        "multistep_kernel": lambda: hmc_multistep(
            target, x, lp, g, epsk, cs.N_LEAPFROG, 0x5EED, 0),
    }, reps=20)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with open(out_path, "w") as f:
        json.dump({"card": smi, "functions": funcs, "ptxas": ptxas,
                   "device_ms": times}, f)
    print(json.dumps({"card": smi, "functions": len(funcs),
                      "device_ms": times}))


def compare(a_path: str, b_path: str) -> int:
    a, b = (json.load(open(p)) for p in (a_path, b_path))
    fa, fb = a["functions"], b["functions"]
    bad = []
    for key, info in fa.items():
        if key not in fb:
            bad.append(f"missing: {key}")
        elif fb[key]["sha"] != info["sha"]:
            bad.append(f"SASS differs: {key} ({info['n']} -> "
                       f"{fb[key]['n']} instructions)")
        if a["ptxas"].get(key) != b["ptxas"].get(key):
            bad.append(f"ptxas differs: {key} {a['ptxas'].get(key)} -> "
                       f"{b['ptxas'].get(key)}")
    added = sorted(k for k in fb if k not in fa)
    f64 = [k for k in added if re.search(r"Ed$", k)]
    print(json.dumps({"compared": len(fa), "same": len(fa) - len(
        [x for x in bad if not x.startswith("ptxas")]), "differ": bad,
        "added": len(added), "added_float64_leapfrog": len(f64),
        "added_other": [k for k in added if k not in f64],
        "device_ms": [a["device_ms"], b["device_ms"]],
        "cards": [a["card"], b["card"]]}, indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--compare"]:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    fingerprint(sys.argv[1])
