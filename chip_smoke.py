#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one GPU, and check its
hand-written kernels against their plain PyTorch versions.

Run from the repository root on a machine with an NVIDIA GPU (built for
the H100, ``sm_90a``):

    python3 chip_smoke.py

Phases, one line each (every check raises on failure):

1. the device (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the build of ``mini_mcmc_torch/csrc`` with ``nvcc`` (seconds);
3. Philox: the known-answer vector, and CUDA bits equal to the plain bits
   on 2**20 counters;
4. the main path at the flagship size of ``bench.py`` (Rosenbrock3D HMC,
   65,536 chains x 8,192 draws, L = 192, K = 16, jitter 0.3) through
   ``mini_mcmc_torch.HMC(use_pallas="full")``: burn-in run, timed run,
   the five ``bench.py`` quality gates, the kernel launch counts, and a
   short ``use_pallas=True`` run through the same entry point;
5. the leapfrog kernel against its plain version (L = 8 and L = 192) on the
   main path's equilibrium state;
6. the multistep kernel against its plain version (K = 16, L = 8) from
   the same state and seed;
7. kernel and plain times at the main path's shapes (CUDA events);
8. with ``--profile`` only: five more timed runs (their spread), one run
   under ``torch.profiler`` (device time by kernel, the device's idle
   share) and Kernel 1's device time per call.

The second-to-last line is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
raises at once and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.ops.kernels import _build, rng
from mini_mcmc_torch.ops.kernels.hmc import (
    leapfrog_trajectory,
    leapfrog_trajectory_plain,
)
from mini_mcmc_torch.ops.kernels.hmc_full import (
    hmc_multistep,
    hmc_multistep_plain,
)
from mini_mcmc_torch.utils.profiling import device_profile

# the flagship configuration of bench.py:64-92
N_CHAINS = 65536
DIM = 3
STEP_SIZE = 0.02
N_LEAPFROG = 192
N_COLLECT = 8192
JITTER = 0.3
STEPS_PER_CALL = 16
ROSEN3D_X0_MEAN = 0.785217  # quadrature, bench.py:91-92
ROSEN3D_X0_VAR = 0.229370

# Kernel-versus-plain tolerance on stable trajectories, as
# tests/test_pallas.py:56 holds the TPU kernel: the kernel contracts
# multiply-adds into FMAs and the plain version does not, a difference of
# about one f32 ulp per operation that a short trajectory does not grow
# anywhere near 1e-3.
RTOL, ATOL = 1e-3, 1e-4


def say(phase: str, **vals) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in vals.items()),
          flush=True)


def check(name: str, ok: bool, info) -> None:
    if not ok:
        raise AssertionError(f"check FAILED [{name}]: {info}")


def chain_agree(kernel: torch.Tensor, plain: torch.Tensor) -> torch.Tensor:
    """Per chain (axis 0): every component within RTOL/ATOL of the plain
    value, or non-finite in both."""
    ok = (kernel - plain).abs() <= ATOL + RTOL * plain.abs()
    ok |= ~torch.isfinite(kernel) & ~torch.isfinite(plain)
    return ok.reshape(ok.shape[0], -1).all(dim=1)


def grad_agree(kernel: torch.Tensor, plain: torch.Tensor) -> torch.Tensor:
    """:func:`chain_agree` for gradients, the absolute tolerance scaled to
    the chain's largest |g| as ``tests/test_torch_models.py`` scales it:
    the x_{i+1} - x_i^2 cancellation leaves float32 noise of that size near
    a component's zero."""
    scale = plain.abs().amax(dim=1, keepdim=True)
    ok = (kernel - plain).abs() <= ATOL + RTOL * (plain.abs() + scale)
    ok |= ~torch.isfinite(kernel) & ~torch.isfinite(plain)
    return ok.all(dim=1)


def max_abs_err(kernel, plain, mask=None) -> float:
    d = (kernel - plain).abs()
    if mask is not None:
        d = d[mask]
    d = d[torch.isfinite(d)]
    return float(d.max()) if d.numel() else 0.0


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def reset_counts() -> None:
    leapfrog_trajectory.launches = 0
    hmc_multistep.launches = 0
    leapfrog_trajectory_plain.calls = 0
    hmc_multistep_plain.calls = 0


def read_counts() -> dict:
    return {
        "hmc_multistep": hmc_multistep.launches,
        "leapfrog_trajectory": leapfrog_trajectory.launches,
        "plain_multistep_calls": hmc_multistep_plain.calls,
        "plain_leapfrog_calls": leapfrog_trajectory_plain.calls,
    }


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())


def phase_build() -> None:
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    regs = [line.strip() for line in so.with_suffix(".log").read_text()
            .splitlines() if "registers" in line]
    say("build", seconds=round(time.perf_counter() - t0, 3), lib=so.name,
        ptxas=repr(regs))


def phase_philox(dev) -> None:
    kat = rng.philox_fill(1, 0, 0, 0, dev).cpu().tolist()[0]
    want = [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    check("philox known answer", kat == want, [hex(w) for w in kat])
    seed = 0x0123456789ABCDEF
    bits = rng.philox_fill(1 << 20, 7, 3, seed, dev)
    plain = rng.philox_fill_plain(1 << 20, 7, 3, seed, dev)
    n_diff = int((bits != plain).sum())
    check("philox bits", n_diff == 0, f"{n_diff} words differ")
    say("philox", known_answer="ok", counters=1 << 20, words_differing=0)


def phase_main_path(dev):
    """The flagship through the public entry points. Returns the sampler,
    the launch counts of the main path (burn-in and timed run) and those
    of a separate one-block ``use_pallas=True`` run."""
    target = mt.rosenbrock_nd()
    init = mt.init_with_seed(N_CHAINS, DIM, seed=42, device=dev) * 0.5 + 1.0
    reset_counts()
    hmc = mt.HMC(target, init, STEP_SIZE, N_LEAPFROG, use_pallas="full",
                 jitter=JITTER, steps_per_call=STEPS_PER_CALL).seed(42)
    per_run = N_COLLECT // STEPS_PER_CALL
    burn = hmc.run(N_COLLECT, 0, time_major=True)
    torch.cuda.synchronize()
    check("burn-in launches", hmc_multistep.launches == per_run,
          hmc_multistep.launches)
    del burn

    t0 = time.perf_counter()
    sample = hmc.run(N_COLLECT, 0, time_major=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    check("main-path launches", counts["hmc_multistep"] == 2 * per_run
          and counts["leapfrog_trajectory"] == 0, counts)
    check("plain path never ran", counts["plain_multistep_calls"] == 0
          and counts["plain_leapfrog_calls"] == 0, counts)
    check("sample shape", tuple(sample.shape) == (N_COLLECT, N_CHAINS, DIM),
          tuple(sample.shape))
    check("sample finite", bool(torch.isfinite(sample).all()), "non-finite")

    rhat, ess = mt.split_rhat_mean_ess(sample, time_major=True)
    x0 = sample[:, :, 0]
    m = {
        "elapsed_s": elapsed,
        "rhat_mean": float(rhat.mean()),
        "ess_mean": float(ess.mean()),
        "ess_min": float(ess.min()),
        "x0_mean": float(x0.mean()),
        "x0_var": float(x0.var(unbiased=False)),
    }
    total_draws = N_CHAINS * N_COLLECT
    # the quality gates of bench.py:183-187,228
    check("hmc rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
    check("hmc ess floor", m["ess_min"] >= 0.01 * total_draws,
          (m["ess_min"], total_draws))
    check("hmc x0 mean", abs(m["x0_mean"] - ROSEN3D_X0_MEAN) <= 0.05,
          m["x0_mean"])
    check("hmc x0 var", abs(m["x0_var"] - ROSEN3D_X0_VAR) <= 0.04,
          m["x0_var"])
    # contiguous [512, 2048, 3] tail: chains are exchangeable and the last
    # draws are the steady state (torch.quantile caps at 2**24 draws)
    sub = sample[N_COLLECT - 512:, :2048]
    modern = mt.rank_normalized_diagnostics(sub, time_major=True)
    m["rank_rhat_max"] = float(modern.rhat.max())
    check("hmc rank-normalized rhat", m["rank_rhat_max"] <= 1.02,
          m["rank_rhat_max"])
    del sample, x0, sub
    steps_per_sec = N_COLLECT / elapsed
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    m["draws_per_sec"] = steps_per_sec * N_CHAINS
    m["grad_evals_per_sec"] = m["draws_per_sec"] * N_LEAPFROG

    # the trajectory-kernel tier through the same entry point, one block;
    # not part of the main path, so counted on its own
    reset_counts()
    tier = mt.HMC(target, hmc.positions, STEP_SIZE, N_LEAPFROG,
                  use_pallas=True, jitter=JITTER,
                  steps_per_call=STEPS_PER_CALL).seed(7)
    rows = tier.run(STEPS_PER_CALL, 0, time_major=True)
    torch.cuda.synchronize()
    check("use_pallas=True rows", bool(torch.isfinite(rows).all())
          and tuple(rows.shape) == (STEPS_PER_CALL, N_CHAINS, DIM),
          tuple(rows.shape))
    tier_counts = read_counts()
    check("use_pallas=True launches", tier_counts == {
        "hmc_multistep": 0, "leapfrog_trajectory": STEPS_PER_CALL,
        "plain_multistep_calls": 0, "plain_leapfrog_calls": 0}, tier_counts)
    say("main_path", **{k: repr(v) for k, v in m.items()},
        launches_per_run=per_run, **counts)
    say("tier_run", use_pallas=True, steps=STEPS_PER_CALL, **tier_counts)
    return hmc, counts, tier_counts


def phase_leapfrog(hmc, dev) -> dict:
    """Kernel 1 against its plain twin, and both against the twin run in
    float64. Rosenbrock trajectories near the leapfrog stability edge
    (large |x0|, eps * sqrt(curvature) close to 2) amplify a one-ulp
    difference without bound, so the gate is that the kernel agrees with
    the float64 trajectory on at least as many chains as the float32 twin
    does, less 0.1% of the chains."""
    target = hmc.target
    state = hmc.state
    gen = torch.Generator(device=dev).manual_seed(11)
    mom = torch.randn(state.positions.shape, generator=gen, device=dev)
    eps = torch.tensor([STEP_SIZE], device=dev)
    out = {}
    for n_leapfrog in (8, N_LEAPFROG):
        k = leapfrog_trajectory(target, state.positions, mom, state.grad,
                                eps, n_leapfrog)
        p = leapfrog_trajectory_plain(target, state.positions, mom,
                                      state.grad, eps[0], n_leapfrog)
        p64 = leapfrog_trajectory_plain(
            target, state.positions.double(), mom.double(),
            state.grad.double(), eps[0].double(), n_leapfrog)

        def share(xs, ys):
            agree = torch.stack([chain_agree(a, b.to(a.dtype))
                                 for a, b in zip(xs, ys)]).all(0)
            return float(agree.float().mean())

        err = max(max_abs_err(a, b) for a, b in zip(k, p))
        out[n_leapfrog] = (err, share(k, p), share(k, p64), share(p, p64))
        say("leapfrog", L=n_leapfrog, chains=N_CHAINS, max_abs_err=err,
            share_kernel_vs_plain=out[n_leapfrog][1],
            share_kernel_vs_f64=out[n_leapfrog][2],
            share_plain_vs_f64=out[n_leapfrog][3])
    _, _, k64, p64 = out[8]
    check("leapfrog L=8 accuracy", k64 >= p64 - 1e-3, out[8])
    return out


def phase_multistep(hmc, dev) -> float:
    target = hmc.target
    s = hmc.state
    k_steps, n_leapfrog, seed = STEPS_PER_CALL, 8, 0x5EED_1234_ABCD
    gen = torch.Generator(device=dev).manual_seed(13)
    eps = STEP_SIZE * (1.0 + JITTER * (
        2.0 * torch.rand((k_steps,), generator=gen, device=dev) - 1.0))
    hk = torch.empty((k_steps, N_CHAINS, DIM), device=dev)
    hp = torch.empty_like(hk)
    outk = hmc_multistep(target, s.positions, s.logp, s.grad, eps,
                         n_leapfrog, seed, 0, hk)
    outp = hmc_multistep_plain(target, s.positions, s.logp, s.grad, eps,
                               n_leapfrog, seed, 0, hp)
    torch.cuda.synchronize()

    def accepts(h):
        prev = torch.cat([s.positions[None], h[:-1]], dim=0)
        return (h != prev).any(dim=2)  # [K, C]

    acc_k, acc_p = accepts(hk), accepts(hp)
    same_acc = (acc_k == acc_p).all(dim=0)
    pos_ok = chain_agree(hk.transpose(0, 1), hp.transpose(0, 1))
    pos_ok &= chain_agree(outk[0], outp[0])
    # the returned state feeds the next block's h_cur and first half-kick
    logp_ok = chain_agree(outk[1][:, None], outp[1][:, None])
    grad_ok = grad_agree(outk[2], outp[2])
    # and is the density at the returned position: the plain target there
    self_ok = chain_agree(outk[1][:, None],
                          target.batch_logp(outk[0])[:, None])
    self_ok &= grad_agree(outk[2], target.batch_grad(outk[0]))
    shares = {name: float((same_acc & ok).float().mean()) for name, ok in
              (("positions", pos_ok), ("logp", logp_ok), ("grad", grad_ok))}
    share_acc = float(same_acc.float().mean())
    share_self = float(self_ok.float().mean())
    err = max_abs_err(hk.transpose(0, 1), hp.transpose(0, 1), same_acc)
    say("multistep", K=k_steps, L=n_leapfrog, chains=N_CHAINS,
        accept_rate=float(acc_k.float().mean()),
        share_same_accepts=share_acc,
        **{f"share_{k}_within_tol": v for k, v in shares.items()},
        share_state_is_density_at_pos=share_self,
        max_abs_err_same_accepts=err,
        max_abs_err_logp_same_accepts=max_abs_err(outk[1], outp[1],
                                                  same_acc))
    check("multistep accepts agree", share_acc >= 0.999, share_acc)
    for name, share in shares.items():
        check(f"multistep {name}", share >= 0.999, share)
    check("multistep state is the density at its position",
          share_self == 1.0, share_self)
    return err


def phase_times(hmc, dev) -> dict:
    target = hmc.target
    s = hmc.state
    gen = torch.Generator(device=dev).manual_seed(17)
    mom = torch.randn(s.positions.shape, generator=gen, device=dev)
    eps1 = torch.tensor([STEP_SIZE], device=dev)
    eps = torch.full((STEPS_PER_CALL,), STEP_SIZE, device=dev)
    hist = torch.empty((STEPS_PER_CALL, N_CHAINS, DIM), device=dev)
    t = {
        "leapfrog_ms": cuda_ms(lambda: leapfrog_trajectory(
            target, s.positions, mom, s.grad, eps1, N_LEAPFROG), 20),
        "leapfrog_plain_ms": cuda_ms(lambda: leapfrog_trajectory_plain(
            target, s.positions, mom, s.grad, eps1[0], N_LEAPFROG), 3),
        "multistep_ms": cuda_ms(lambda: hmc_multistep(
            target, s.positions, s.logp, s.grad, eps, N_LEAPFROG, 1, 0,
            hist), 20),
        "multistep_plain_ms": cuda_ms(lambda: hmc_multistep_plain(
            target, s.positions, s.logp, s.grad, eps, N_LEAPFROG, 1, 0,
            hist), 2),
        "philox_ms": cuda_ms(lambda: rng.philox_fill(
            N_CHAINS * (DIM + 1), 0, 0, 1, dev), 20),
        "philox_plain_ms": cuda_ms(lambda: rng.philox_fill_plain(
            N_CHAINS * (DIM + 1), 0, 0, 1, dev), 5),
    }
    say("times", shape=f"C={N_CHAINS},D={DIM},L={N_LEAPFROG},"
        f"K={STEPS_PER_CALL}", **{k: repr(v) for k, v in t.items()})
    return t


def phase_profile(hmc, dev) -> None:
    """``--profile``: the spread of five more timed runs of the main path,
    one more under ``torch.profiler``, and Kernel 1 at its shapes."""
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        hmc.run(N_COLLECT, 0, time_major=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    say("profile_runs", timed_s=repr(walls),
        spread=(max(walls) - min(walls)) / min(walls))
    wall, busy, by_name = device_profile(hmc.run, N_COLLECT, 0,
                                         time_major=True)
    say("profile_run", wall_s=repr(wall), device_busy_us=repr(busy),
        idle_share=1.0 - busy / (wall * 1e6), kernel_names=len(by_name))
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        say("profile_kernel", name=repr(name[:60]), count=n, device_us=us,
            per_launch_us=us / n, share_of_busy=us / busy)

    s = hmc.state
    gen = torch.Generator(device=dev).manual_seed(19)
    mom = torch.randn(s.positions.shape, generator=gen, device=dev)
    eps = torch.tensor([STEP_SIZE], device=dev)
    reps = 20
    _, _, lf = device_profile(lambda: [leapfrog_trajectory(
        hmc.target, s.positions, mom, s.grad, eps, N_LEAPFROG)
        for _ in range(reps)])
    n, us = next(v for k, v in lf.items() if "leapfrog_kernel" in k)
    check("profiled leapfrog launches", n == reps, n)
    say("profile_leapfrog", L=N_LEAPFROG, calls=n, device_us_per_call=us / n)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also time five more runs and profile one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; nothing run")
    dev = torch.device("cuda", 0)
    phase_device()
    phase_build()
    phase_philox(dev)
    hmc, counts, tier_counts = phase_main_path(dev)
    lf = phase_leapfrog(hmc, dev)
    ms_err = phase_multistep(hmc, dev)
    t = phase_times(hmc, dev)
    if args.profile:
        phase_profile(hmc, dev)
    # "kernels": those the main path launched, with its counts; Kernel 1
    # (the use_pallas=True tier) is off that path and reports its own run
    kernels = [
        {"name": "hmc_multistep", "route": "cuda",
         "source": "mini_mcmc_torch/csrc/hmc_multistep.cu",
         "replaces": "mini_mcmc_tpu/ops/pallas/hmc_full.py:86",
         "launches": counts["hmc_multistep"], "max_abs_err": ms_err,
         "ms": t["multistep_ms"], "plain_ms": t["multistep_plain_ms"]},
    ]
    off_path = [
        {"name": "leapfrog_trajectory", "route": "cuda",
         "source": "mini_mcmc_torch/csrc/hmc_leapfrog.cu",
         "replaces": "mini_mcmc_tpu/ops/pallas/hmc.py:46",
         "launches": counts["leapfrog_trajectory"],
         "tier_run_launches": tier_counts["leapfrog_trajectory"],
         "max_abs_err": lf[8][0],
         "ms": t["leapfrog_ms"], "plain_ms": t["leapfrog_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels, "off_main_path": off_path}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
