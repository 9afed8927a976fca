"""ChEES-HMC: let the chains pick their own trajectory length.

Counterpart of ``examples/chees_trajectory_adaptation.py``. On an
ill-scaled Gaussian a short fixed trajectory decorrelates the widest
coordinate at a crawl; ChEES adaptation (Hoffman, Radul & Sountsov 2021)
grows the integration time from a cross-chain criterion until
trajectories span the slowest timescale. Compare the effective sample
size per gradient evaluation before and after.
"""

from .. import HMC, ChEESHMC, init_with_seed, run_stats
from ..models import diffable_gaussian2d


def main(device="cuda"):
    # sigma = (1, 8): the slow coordinate needs ~8x longer trajectories.
    target = diffable_gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 64.0]])
    chains, draws = 256, 1000

    # Baseline: eps-tuned but SHORT fixed trajectories (dual-averaged
    # step size).
    short = HMC(target, init_with_seed(chains, 2, seed=0, device=device),
                step_size=0.5, n_leapfrog=2, seed=1,
                device=device).tuned(200)
    stats_short = run_stats(short.run(draws, 100))
    grads_short = draws * 2  # n_leapfrog gradient evals per draw

    # ChEES: jointly adapt (step size, trajectory length).
    chees = ChEESHMC(target, init_with_seed(chains, 2, seed=0,
                                            device=device),
                     step_size=0.5, seed=1, device=device).warmed_up(300)
    trace = chees.warmup_trace
    print("adapted step size:   %.3f" % chees.step_size)
    print("adapted traj length: %.2f  (grew from %.2f; ~%.1f leapfrogs "
          "per draw on average)"
          % (chees.traj_len, 0.5,
             chees.traj_len / (2 * chees.step_size)))
    print("acceptance over warmup: %.2f -> %.2f"
          % (float(trace["alpha"][:20].mean()),
             float(trace["alpha"][-20:].mean())))

    stats_chees = run_stats(chees.run(draws, 100))
    grads_chees = draws * max(
        1.0, chees.traj_len / (2 * chees.step_size))

    print("\nshort fixed trajectories:", stats_short)
    print("ChEES-adapted trajectories:", stats_chees)
    # The bottleneck is the WORST coordinate (the wide one): sampling is
    # only as done as its slowest margin.
    eff_short = stats_short.ess.min / grads_short
    eff_chees = stats_chees.ess.min / grads_chees
    print("\nbottleneck (min) ESS per gradient evaluation: "
          "%.1f -> %.1f (%.1fx)"
          % (eff_short, eff_chees, eff_chees / max(eff_short, 1e-9)))

    sample = chees.run(200)
    var = sample.var(dim=(0, 1), correction=0).cpu().numpy()
    print("posterior variances:", var, "(true: [1, 64])")


if __name__ == "__main__":
    main()
