"""The port's other examples run end to end on the CPU: each
``main(device="cpu")`` at the JAX example's defaults, its asserts the JAX
example's own and its return value that of the JAX ``main``; without a
GPU and without ``device`` each raises, as the samplers it builds do.
``bigd_separable_hmc`` takes its CPU shape, (64, 128, 64) on the plain
path, as the JAX example does off the accelerator."""

import importlib
import math

import pytest

EXAMPLES = ["minimal_mh", "gauss_mh", "rosenbrock_mh", "mixture_gibbs",
            "minimal_hmc", "rosenbrock3d_hmc", "ensemble_walkers",
            "chees_trajectory_adaptation", "bimodal_tempering",
            "gp_robust_regression", "streaming_production_run"]
#: every example of mini_mcmc_torch/examples/ with a main()
ALL = EXAMPLES + ["bigd_separable_hmc", "minimal_nuts", "metric_nuts",
                  "logistic_regression_nuts", "eight_schools", "ais_log_z",
                  "sgld_minibatch_logreg", "constrained_transforms",
                  "poisson_mh", "sharded_chains", "sgld_data_parallel"]
#: the examples on a mesh, run here on a one-rank gloo group (their
#: two-rank runs are test_torch_parallel.py's), and a line each prints
MESH_EXAMPLES = {
    "poisson_mh": "65536 chains x 200 draws over 1 device(s)",
    "sharded_chains": "512 chains sharded over 1 device(s)",
    "sgld_data_parallel": "data mesh: 1 device(s), 8192 rows",
}


def _module(name):
    return importlib.import_module(f"mini_mcmc_torch.examples.{name}")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name, capsys):
    assert _module(name).main(device="cpu") is None
    assert capsys.readouterr().out


def test_bigd_separable_hmc_moments(capsys):
    """Both halves' printed moments: the standard normal's and the
    half-normal's, every draw positive."""
    assert _module("bigd_separable_hmc").main(device="cpu") is None
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "mean" in ln]
    plain = lines[0].split()
    cons = lines[1].split()
    mean, var = float(plain[plain.index("mean") + 1]), float(
        plain[plain.index("var") + 1])
    assert abs(mean) < 0.05 and abs(var - 1.0) < 0.05
    mean, var, lo = (float(cons[cons.index(k) + 1])
                     for k in ("mean", "var", "min"))
    assert abs(mean - math.sqrt(2 / math.pi)) < 0.05
    assert abs(var - (1 - 2 / math.pi)) < 0.05 and lo > 0


def test_ais_log_z_within_005_of_the_evidence():
    from mini_mcmc_torch.examples import ais_log_z as ais

    log_z = ais.main(device="cpu")
    assert abs(log_z - ais.exact_log_z()) < 0.05


def test_sgld_lands_on_the_mala_posterior():
    """The example asserts SGLD's mean within 4 MALA sds + 0.05 of MALA's;
    it returns SGLD's posterior mean."""
    mean = _module("sgld_minibatch_logreg").main(device="cpu")
    assert mean.shape == (4,)


@pytest.mark.parametrize("name", sorted(MESH_EXAMPLES))
def test_mesh_example_runs_on_one_rank(name, capsys):
    """main(device="cpu") builds its mesh on a one-rank gloo group of its
    own and passes the JAX example's asserts."""
    out = _module(name).main(device="cpu")
    if name == "sgld_data_parallel":
        assert tuple(out.shape) == (64, 1500, 4)
    assert MESH_EXAMPLES[name] in capsys.readouterr().out


@pytest.mark.parametrize("name", ALL)
def test_example_needs_a_gpu_by_default(name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _module(name).main()
