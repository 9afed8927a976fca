"""Kernel 0 (Philox4x32-10) plain twin: known answers, exact parity with
the TPU helpers' bit-to-float map, and the statistics of its draws.

Statistical bands (stated per check): means within 5 standard errors,
variances within 5 standard errors of the sample variance, KS p-value
above 1e-4, lag-1 correlation within 5 / sqrt(n). With the fixed seeds
here each check is deterministic; the bands say how far off a correct
generator could land.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_tpu.ops.pallas import rng as jax_rng

torch.set_num_threads(1)

SEED = 0x0123456789ABCDEF


# Random123's known-answer vectors for Philox4x32-10
# (counter words, key words, expected output words)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    words = rng.philox4x32_10(torch.tensor([ctr[0]]), *ctr[1:], key)
    assert tuple(int(w[0]) for w in words) == want


def test_philox_fill_on_cpu_is_the_plain_version():
    before = rng.philox_fill.launches
    got = rng.philox_fill(8, 0, 0, 0)
    assert rng.philox_fill.launches == before  # no kernel on a CPU tensor
    assert torch.equal(got, rng.philox_fill_plain(8, 0, 0, 0))
    assert tuple(got[0].tolist()) == KAT[0][2]


def test_seed_words_keep_all_64_bits():
    assert rng.seed_words(SEED) == (0x89ABCDEF, 0x01234567)
    a = rng.philox_fill_plain(64, 1, 2, 0x1_0000_0005)
    b = rng.philox_fill_plain(64, 1, 2, 0x2_0000_0005)  # high word only
    assert not torch.equal(a, b)


def test_unit_open_matches_tpu_helper():
    # the exact float map of mini_mcmc_tpu/ops/pallas/rng.py:40-46
    edge = [0, 1, 0xFF, 0x100, 0x7FFFFFFF, 0x80000000, 0xFFFFFEFF,
            0xFFFFFF00, 0xFFFFFFFF]
    bits = np.concatenate([
        np.array(edge, np.uint32),
        np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint32),
    ])
    want = np.asarray(jax_rng.bits_to_unit_open(jnp.asarray(bits)))
    got = rng.unit_open(torch.from_numpy(bits.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got > 0).all() and (got <= 1).all()  # never 0


def _draws(n_chains=1 << 15, dim=3, step=7):
    """One HMC step's draws (Kernel 2's layout): ``[C, D]`` momentum
    normals in Box-Muller pairs from the (chain, step) word stream and the
    ``[C]`` accept uniforms from its word ``2 ceil(D / 2)``."""
    accept_word = 2 * ((dim + 1) // 2)
    w = rng.stream_words(n_chains, accept_word + 1, step, SEED)
    return rng.pair_normals(w, dim), rng.unit_open(w[:, accept_word])


@pytest.mark.parametrize("dim", [2, 3, 4])
def test_step_draws_follow_the_counter_layout(dim):
    """A step's words are those of the counters (chain, step, q, 0) in
    order; normals 2p and 2p + 1 the cosine and sine of one angle, the
    accept uniform word 2 ceil(D / 2): one evaluation at D = 2, two at
    D = 3, 4."""
    mom, u = _draws(5, dim, 9)
    k0, k1 = rng.seed_words(SEED)
    n_evals = 1 if dim <= 2 else 2
    assert rng.stream_words(5, 2 * ((dim + 1) // 2) + 1, 9,
                            SEED).shape == (5, 4 * n_evals)
    for c in range(5):
        words = [int(x) for q in range(n_evals) for x in rng.philox4x32_10(
            torch.tensor([c]), 9, q, 0, (k0, k1))]
        for p in range((dim + 1) // 2):
            cos, sin = rng.box_muller_pair(torch.tensor(words[2 * p]),
                                           torch.tensor(words[2 * p + 1]))
            assert torch.equal(mom[c, 2 * p], cos)
            if 2 * p + 1 < dim:
                assert torch.equal(mom[c, 2 * p + 1], sin)
        w_u = words[2 * ((dim + 1) // 2)]
        assert torch.equal(u[c], rng.unit_open(torch.tensor(w_u)))


def test_same_seed_same_bits_distinct_counters_distinct_bits():
    a_mom, a_u = _draws(256)
    b_mom, b_u = _draws(256)
    assert torch.equal(a_mom, b_mom) and torch.equal(a_u, b_u)
    c_mom, _ = _draws(256, step=8)
    assert not torch.equal(a_mom, c_mom)
    # every chain's words differ from every other chain's
    words = rng.philox_fill_plain(4096, 7, 0, SEED)
    assert len(set(map(tuple, words.tolist()))) == 4096


def test_normals_statistics():
    mom, _ = _draws()
    x = mom.double().numpy().ravel()
    n = x.size
    assert abs(x.mean()) < 5 / np.sqrt(n)  # 5 standard errors
    assert abs(x.var() - 1.0) < 5 * np.sqrt(2.0 / n)
    assert sps.kstest(x, "norm").pvalue > 1e-4
    r = np.corrcoef(x[:-1], x[1:])[0, 1]  # along chains and coordinates
    assert abs(r) < 5 / np.sqrt(n)
    # coordinates of one chain are independent draws
    r_dim = np.corrcoef(mom[:, 0].numpy(), mom[:, 1].numpy())[0, 1]
    assert abs(r_dim) < 5 / np.sqrt(mom.shape[0])


def test_normals_independent_across_steps():
    a, _ = _draws(step=100)
    b, _ = _draws(step=101)
    r = np.corrcoef(a.numpy().ravel(), b.numpy().ravel())[0, 1]
    assert abs(r) < 5 / np.sqrt(a.numel())


def test_uniform_statistics():
    _, u = _draws(1 << 16)
    x = u.double().numpy()
    n = x.size
    assert (x > 0).all() and (x <= 1).all()
    assert abs(x.mean() - 0.5) < 5 * np.sqrt(1 / 12 / n)
    assert sps.kstest(x, "uniform").pvalue > 1e-4
    r = np.corrcoef(x[:-1], x[1:])[0, 1]
    assert abs(r) < 5 / np.sqrt(n)
