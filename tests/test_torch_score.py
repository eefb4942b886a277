"""Prompt scoring (``echo`` + ``logprobs``) in the port against the JAX
package, on the CPU: ``models/decoder.forward_score`` against the JAX
``forward_score`` and ``Engine.score_prompt`` against the JAX engine's
(debug-tiny in float32, the JAX ``init_params`` weights on both sides;
logprobs within 1e-4, top ids exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.models.decoder import forward_score as j_forward_score
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu_torch.configs import get_config
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.models import decoder
from llms_on_kubernetes_tpu_torch.models.decoder import forward_score

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=2, page_size=8,
             num_pages=64, pages_per_slot=16, prefill_buckets=(16, 32))


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("bucket,n", [(16, 1), (16, 9), (32, 32), (64, 40)])
def test_forward_score_matches_jax(jparams, tparams, rng, bucket, n):
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = rng.integers(0, 256, n)
    want = j_forward_score(jparams, jget_config("debug-tiny"), jnp.asarray(toks),
                           jnp.asarray([n], jnp.int32), 8)
    got = forward_score(tparams, get_config("debug-tiny"), torch.from_numpy(toks),
                        torch.tensor([n], dtype=torch.int32), 8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)
    assert float(got[0][0, max(n - 1, 0):].abs().sum()) == 0.0     # past the last: 0


def test_forward_score_slabs_equal_one_pass(tparams, rng, monkeypatch):
    """The [T, V] logits reduce in slabs: any slab height gives the same
    values (the rows are independent)."""
    toks = torch.from_numpy(rng.integers(0, 256, (1, 48)).astype(np.int32))
    n = torch.tensor([45], dtype=torch.int32)
    whole = forward_score(tparams, get_config("debug-tiny"), toks, n, 8)
    monkeypatch.setattr(decoder, "SCORE_SLAB", 7)
    slabbed = forward_score(tparams, get_config("debug-tiny"), toks, n, 8)
    for a, b in zip(whole, slabbed):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prompt_len", [2, 13, 30, 70])
def test_score_prompt_matches_jax_engine(jparams, tparams, rng, prompt_len):
    """Past the largest bucket (32) the prompt pads to a multiple of it
    (70 -> 96), as the JAX engine pads it."""
    prompt = rng.integers(0, 256, prompt_len).tolist()
    want = JEngine(JEngineConfig(**SMALL), params=jparams).score_prompt(prompt)
    got = Engine(EngineConfig(**SMALL, device="cpu"), params=tparams).score_prompt(prompt)
    assert len(got[0]) == prompt_len - 1 and len(got[1]) == len(got[2]) == prompt_len
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), **TOL)
    assert got[1] == want[1]
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]), **TOL)


def test_scoring_leaves_the_serving_pool_alone(tparams):
    """A score between steps writes nothing into the engine's pools and
    changes no stream."""
    eng = Engine(EngineConfig(**SMALL, device="cpu"), params=tparams)
    req = eng.submit([5, 6, 7, 8], SamplingParams(temperature=0.0, max_tokens=10))
    eng.step()
    k0, v0 = eng.k_pages.data.clone(), eng.v_pages.data.clone()
    eng.score_prompt(list(range(20, 50)))
    assert torch.equal(eng.k_pages.data, k0) and torch.equal(eng.v_pages.data, v0)
    while eng.has_work():
        eng.step()
    ref = Engine(EngineConfig(**SMALL, device="cpu"), params=tparams)
    assert req.output == ref.generate([5, 6, 7, 8],
                                      SamplingParams(temperature=0.0, max_tokens=10))


def test_score_prompt_refuses(tparams):
    eng = Engine(EngineConfig(**SMALL, device="cpu"), params=tparams)
    with pytest.raises(ValueError, match="max_model_len"):
        eng.score_prompt([1] * (eng.config.max_model_len + 1))
    with pytest.raises(ValueError, match="empty"):
        eng.score_prompt([])
