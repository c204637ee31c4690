"""The port's sampler with ``top_k`` at or above the vocabulary size: top-k
is off, as at ``top_k = 0``, in the port and in the JAX package.

Greedy rows are compared token for token. Sampled rows are compared by
distribution, as the port's seeded on-device draws and ``jax.random`` give
other draws: 4000 draws (4000 slots of one batch, seeds 1234 to 5233) at
``top_k = V + 84`` against the JAX sampler's own
probabilities at ``top_k = 0`` (``_transformed_probs``), total-variation
distance at most 0.05. With V = 16 the expected distance of 4000 draws from
their own distribution is about 0.02, and its standard deviation under
0.005, so the bound sits more than five deviations above it; a sampler that
cut to one token (the fault: index past the vocabulary, or every token
filtered) lies at a distance of 0.5 or more.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.engine.sampler import _transformed_probs, make_batch_state
from mistralrs_tpu.engine.sampler import sample as jax_sample
from mistralrs_tpu_torch.engine.sampler import BatchSamplingState, SamplingParams, sample

V = 16
LOGITS = np.random.default_rng(0).standard_normal((1, V)).astype(np.float32) * 1.5


def _port_draws(params: SamplingParams, n: int):
    state = BatchSamplingState.create(n, V, "cpu")
    for slot in range(n):
        state.admit(slot, params, [], seed=1234 + slot)
    toks, _, _ = sample(torch.from_numpy(LOGITS).repeat(n, 1), state)
    return toks.numpy()


def test_top_k_above_vocab_greedy_matches_top_k_off():
    port_big = _port_draws(SamplingParams(temperature=0.0, top_k=V + 84), 1)
    port_off = _port_draws(SamplingParams(temperature=0.0, top_k=0), 1)
    jstate = make_batch_state([JaxParams(temperature=0.0, top_k=0)], V, [[]])
    jtok, _, _, _ = jax_sample(jnp.asarray(LOGITS), jstate, jax.random.PRNGKey(0))
    assert port_big[0] == port_off[0] == int(np.asarray(jtok)[0]) == int(LOGITS.argmax())


def test_top_k_above_vocab_samples_the_full_distribution():
    draws = _port_draws(SamplingParams(temperature=0.8, top_k=V + 84), 4000)
    emp = np.bincount(draws, minlength=V) / draws.size
    jstate = make_batch_state([JaxParams(temperature=0.8, top_k=0)], V, [[]])
    probs = np.asarray(_transformed_probs(jnp.asarray(LOGITS), jstate))[0]
    np.testing.assert_allclose(probs.sum(), 1.0, rtol=1e-5)
    tv = 0.5 * np.abs(emp - probs).sum()
    assert tv <= 0.05, tv
    assert (emp > 0).sum() >= V - 2  # every token but the rarest is drawn
