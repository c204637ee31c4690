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

With ``constraint_bias`` rows (grammar masks and DRY), greedy tokens and
logprobs are held against JAX ``_sample_core``.
"""

import dataclasses

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


def test_constraint_bias_matches_jax_sample_core():
    """``constraint_bias`` (grammar masks at -1e30 plus a DRY-like row) is
    added beside ``logit_bias`` as JAX ``_sample_core`` adds it: greedy
    tokens identical, logprobs and top logprobs within 1e-5 (f32), with
    penalties and counts in play and one row unmasked."""
    from mistralrs_tpu.engine.sampler import _sample_core

    rng = np.random.default_rng(7)
    b, v = 4, 64
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    cbias = np.zeros((b, v), np.float32)
    for row in range(3):  # row 3 stays unconstrained
        allow = rng.random(v) < 0.2
        cbias[row] = np.where(allow, 0.0, -1e30)
        cbias[row, rng.integers(0, v, 3)] -= rng.uniform(0.5, 4, 3).astype(np.float32)
    cbias[0, int(np.argmax(np.where(cbias[0] == 0, logits[0], -np.inf)))] -= 5.0  # DRY bites
    params = [dict(temperature=0.0, repetition_penalty=1.3, frequency_penalty=0.2,
                   presence_penalty=0.1, logit_bias={int(rng.integers(v)): 2.0})
              for _ in range(b)]
    contexts = [[int(x) for x in rng.integers(0, v, 12)] for _ in range(b)]
    state = BatchSamplingState.create(b, v, "cpu")
    for slot in range(b):
        state.admit(slot, SamplingParams(**params[slot]), contexts[slot], seed=slot)
        state.constraint_bias[slot] = torch.from_numpy(cbias[slot])
    toks, lps, (tv, ti) = sample(torch.from_numpy(logits), state)
    jstate = dataclasses.replace(make_batch_state([JaxParams(**p) for p in params], v, contexts),
                                 constraint_bias=jnp.asarray(cbias))
    jt, jl, (jtv, jti), _ = _sample_core(jnp.asarray(logits), jstate, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    assert all(cbias[r, int(toks[r])] > -1e29 for r in range(b))  # masked tokens never win
    np.testing.assert_allclose(lps.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jtv), rtol=1e-5, atol=1e-5)
    assert ((cbias == 0).sum(axis=1) >= 8).all()  # no tie among the top 8
    np.testing.assert_array_equal(ti.numpy(), np.asarray(jti))
