"""The port's sampler against the JAX sampler, on the CPU.

Greedy rows must give the JAX tokens, and every row the same logprob and
top-alternative outputs (float32, atol = rtol = 1e-5: the log-sum-exp
order differs). Random draws cannot match JAX's threefry bits, so the
draw is held to its own contract: noise depends only on (engine seed,
request seed, position), it is Gumbel distributed, and a sampled token
always lies inside the top-k / top-p set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.engine import sampling as jsamp
from llms_on_kubernetes_tpu_torch.engine import sampling as tsamp

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, B=4, V=300):
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, size=(B, V)).astype(np.int32)
    presence = np.asarray([0.0, 0.5, -0.5, 1.0][:B], np.float32)
    frequency = np.asarray([0.0, 0.2, 0.1, -0.3][:B], np.float32)
    return logits, counts, presence, frequency


@pytest.mark.parametrize("penalized", [False, True])
def test_greedy_matches_jax(rng, penalized):
    logits, counts, presence, frequency = _inputs(rng)
    B, V = logits.shape
    temps = np.zeros(B, np.float32)
    top_k = np.asarray([0, 5, 64, 1], np.int32)
    top_p = np.asarray([1.0, 0.9, 0.5, 1.0], np.float32)
    pen_j = ((jnp.asarray(presence), jnp.asarray(frequency), jnp.asarray(counts))
             if penalized else None)
    pen_t = ((torch.from_numpy(presence), torch.from_numpy(frequency),
              torch.from_numpy(counts)) if penalized else None)
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(0), s))(jnp.arange(B))
    ref = jsamp.sample(jnp.asarray(logits), keys, jnp.asarray(temps), jnp.asarray(top_k),
                       jnp.asarray(top_p), penalties=pen_j)
    noise = tsamp.gumbel_noise(0, torch.arange(B), torch.arange(B), min(64, V))
    out = tsamp.sample(torch.from_numpy(logits), noise, torch.from_numpy(temps),
                       torch.from_numpy(top_k), torch.from_numpy(top_p), penalties=pen_t)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(out.logprobs.numpy(), np.asarray(ref.logprobs), **TOL)
    np.testing.assert_array_equal(out.top_ids.numpy(), np.asarray(ref.top_ids))
    np.testing.assert_allclose(out.top_logprobs.numpy(), np.asarray(ref.top_logprobs), **TOL)


def test_sampled_tokens_respect_top_k_and_top_p(rng):
    logits, _, _, _ = _inputs(rng, B=2)
    lt = torch.from_numpy(logits)
    order = torch.argsort(lt, dim=-1, descending=True)
    probs = torch.softmax(lt, dim=-1)
    for pos in range(200):
        noise = tsamp.gumbel_noise(7, torch.tensor([1, 2]), torch.tensor([pos, pos]), 64)
        res = tsamp.sample(lt, noise, torch.tensor([1.5, 1.5]), torch.tensor([3, 0]),
                           torch.tensor([1.0, 0.6]))
        assert int(res.tokens[0]) in order[0, :3].tolist()
        rank = order[1].tolist().index(int(res.tokens[1]))
        mass_before = float(probs[1, order[1, :rank]].sum())
        assert mass_before < 0.6


def test_gumbel_noise_is_keyed_by_seed_and_position():
    seeds = torch.tensor([5, 5, 6, 5])
    pos = torch.tensor([10, 11, 10, 10])
    n = tsamp.gumbel_noise(0, seeds, pos, 64)
    assert torch.equal(n[0], n[3])                      # same (seed, position)
    assert not torch.equal(n[0], n[1]) and not torch.equal(n[0], n[2])
    alone = tsamp.gumbel_noise(0, torch.tensor([5]), torch.tensor([10]), 64)
    assert torch.equal(alone[0], n[0])                  # batch makeup irrelevant
    assert not torch.equal(tsamp.gumbel_noise(1, seeds, pos, 64)[0], n[0])


def test_gumbel_noise_distribution():
    n = tsamp.gumbel_noise(0, torch.arange(4000), torch.zeros(4000, dtype=torch.long), 64)
    assert torch.isfinite(n).all()
    assert abs(float(n.mean()) - 0.5772) < 0.01         # Euler-Mascheroni
    assert abs(float(n.var()) - np.pi ** 2 / 6) < 0.03


def test_temperature_sampling_frequencies_follow_softmax():
    """Gumbel-max over the candidates draws token i with p_i."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    draws = []
    for pos in range(4000):
        noise = tsamp.gumbel_noise(3, torch.tensor([1]), torch.tensor([pos]), 4)
        draws.append(int(tsamp.sample(logits, noise, torch.tensor([1.0]), torch.tensor([0]),
                                      torch.tensor([1.0])).tokens[0]))
    freq = np.bincount(draws, minlength=4) / len(draws)
    np.testing.assert_allclose(freq, [0.5, 0.3, 0.15, 0.05], atol=0.03)
