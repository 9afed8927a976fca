"""The port's NUTS examples run end to end on the CPU: each
``main(device="cpu")`` at the JAX example's defaults, its asserts the JAX
example's own (``examples/minimal_nuts.py``, ``metric_nuts.py``,
``logistic_regression_nuts.py``, ``constrained_transforms.py``), and its
return value that of the JAX ``main``. Eight schools' halves run in
``test_torch_examples_eight_schools.py`` and
``test_torch_examples.py``."""

import importlib

import numpy as np
import pytest

from mini_mcmc_torch.examples import constrained_transforms as ct


@pytest.mark.parametrize("name", ["minimal_nuts", "metric_nuts"])
def test_example_runs(name):
    mod = importlib.import_module(f"mini_mcmc_torch.examples.{name}")
    assert mod.main(device="cpu") is None


def test_logistic_regression_recovers_the_weights():
    """The posterior mean within 4 posterior sds + 0.5 of the weights the
    data were drawn from (the example's assert), returned as ``[D]``."""
    from mini_mcmc_torch.examples import logistic_regression_nuts as lr

    post_mean = lr.main(device="cpu")
    assert post_mean.shape == (4,) and np.all(np.isfinite(post_mean))


def test_constrained_transforms_recovers_the_exact_moments():
    lam_mean, p_mean = ct.main(device="cpu")
    ex = ct.exact_moments()
    assert abs(lam_mean - ex["lam_mean"]) < 0.05
    assert abs(p_mean - ex["p_mean"]) < 0.02
