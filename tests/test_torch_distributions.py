"""The port's distributions and math (sheeprl_tpu_torch/ops) against the JAX
package's (sheeprl_tpu/ops).

Densities, entropies and modes are compared value by value (fp32, 1e-5:
the same formulas in another framework). Samplers cannot match across JAX
keys and torch generators, so they are tested apart: the draws of a seeded
generator must fit the probabilities, and a seed must reproduce its draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import distributions as jd
from sheeprl_tpu.ops import math as jm
from sheeprl_tpu_torch.ops import distributions as td
from sheeprl_tpu_torch.ops import math as tm

TOL = 1e-5


@pytest.mark.parametrize("fn", ["symlog", "symexp"])
def test_symlog_symexp_match(fn):
    x = np.linspace(-8, 8, 101, dtype=np.float32)
    np.testing.assert_allclose(
        getattr(tm, fn)(torch.tensor(x)).numpy(), np.asarray(getattr(jm, fn)(x)), atol=TOL, rtol=TOL
    )
    np.testing.assert_allclose(tm.symexp(tm.symlog(torch.tensor(x))).numpy(), x, atol=1e-4, rtol=TOL)


def test_normal_and_independent_match():
    rng = np.random.default_rng(0)
    loc = rng.standard_normal((4, 3)).astype(np.float32)
    scale = rng.uniform(0.2, 2.0, (4, 3)).astype(np.float32)
    v = rng.standard_normal((4, 3)).astype(np.float32)
    for t_dist, j_dist in (
        (td.Normal(torch.tensor(loc), torch.tensor(scale)), jd.Normal(loc, scale)),
        (td.Independent(td.Normal(torch.tensor(loc), torch.tensor(scale)), 1), jd.Independent(jd.Normal(loc, scale), 1)),
    ):
        np.testing.assert_allclose(t_dist.log_prob(torch.tensor(v)).numpy(), np.asarray(j_dist.log_prob(v)), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(t_dist.entropy().numpy(), np.asarray(j_dist.entropy()), atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(t_dist.mode.numpy(), np.asarray(j_dist.mode))


@pytest.mark.parametrize("cls", ["OneHotCategorical", "OneHotCategoricalStraightThrough"])
def test_one_hot_categorical_matches(cls):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((5, 4, 6)).astype(np.float32)
    value = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (5, 4))]
    t_dist, j_dist = getattr(td, cls)(torch.tensor(logits)), getattr(jd, cls)(logits=logits)
    np.testing.assert_allclose(t_dist.probs.numpy(), np.asarray(j_dist.probs), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t_dist.log_prob(torch.tensor(value)).numpy(), np.asarray(j_dist.log_prob(value)), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t_dist.entropy().numpy(), np.asarray(j_dist.entropy()), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(t_dist.mode.numpy(), np.asarray(j_dist.mode))


def test_one_hot_sample_frequencies_fit_the_probabilities():
    probs = torch.tensor([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]])
    dist = td.OneHotCategorical(torch.log(probs))
    n = 20000
    draws = dist.sample(torch.Generator().manual_seed(0), (n,))
    assert draws.shape == (n, 2, 3)
    assert torch.all(draws.sum(-1) == 1)
    freq = draws.mean(0)
    # binomial standard error <= sqrt(0.25 / n) = 0.0035; 5 sigma
    torch.testing.assert_close(freq, probs, atol=0.018, rtol=0)


def test_sampling_is_reproducible_from_a_seed():
    dist = td.OneHotCategorical(torch.randn(3, 5, generator=torch.Generator().manual_seed(1)))
    a = dist.sample(torch.Generator().manual_seed(7), (4,))
    b = dist.sample(torch.Generator().manual_seed(7), (4,))
    torch.testing.assert_close(a, b)
    normal = td.Normal(torch.zeros(3), torch.ones(3))
    torch.testing.assert_close(
        normal.sample(torch.Generator().manual_seed(2)), normal.sample(torch.Generator().manual_seed(2))
    )


def test_straight_through_is_one_hot_forward_and_carries_the_probs_gradient():
    logits = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(3), requires_grad=True)
    dist = td.OneHotCategoricalStraightThrough(logits)
    sample = dist.rsample(torch.Generator().manual_seed(4))
    hard = td.OneHotCategorical(logits).sample(torch.Generator().manual_seed(4))
    torch.testing.assert_close(sample.detach(), hard)
    weights = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(5))
    (grad,) = torch.autograd.grad((sample * weights).sum(), logits)
    (want,) = torch.autograd.grad((dist.probs * weights).sum(), logits)
    torch.testing.assert_close(grad, want)


def test_normal_sample_moments():
    loc, scale = torch.tensor([0.5, -1.0]), torch.tensor([0.2, 2.0])
    draws = td.Normal(loc, scale).sample(torch.Generator().manual_seed(6), (40000,))
    assert not draws.requires_grad
    torch.testing.assert_close(draws.mean(0), loc, atol=0.05, rtol=0)
    torch.testing.assert_close(draws.std(0), scale, atol=0.05, rtol=0.02)


def test_jax_normal_sample_moments_agree():
    """The same sampler statistics hold for the JAX reference."""
    import jax

    draws = np.asarray(jd.Normal(jnp.array([0.5, -1.0]), jnp.array([0.2, 2.0])).sample(jax.random.PRNGKey(0), (40000,)))
    np.testing.assert_allclose(draws.mean(0), [0.5, -1.0], atol=0.05)
    np.testing.assert_allclose(draws.std(0), [0.2, 2.0], atol=0.05, rtol=0.02)
