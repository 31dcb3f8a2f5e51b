"""The port's samplers against the reference on the same logits.

``jax.random`` and ``torch.Generator`` draw different numbers from one
seed, so greedy rows are compared token for token and sampled rows as the
warped distribution (``_warp``: temperature, top-k, top-p over the top-c
candidates) fed the same numpy logits, to 1e-6 (f32 softmax and cumsum
in another order). Draws of the port's sampler are then checked against
that distribution: every draw lies in its support, and the empirical
frequencies over many seeded draws sit within a few standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from p2p_llm_chat_tpu.models import sampling as ref_sampling
from p2p_llm_chat_tpu_torch.models import sampling

torch.set_num_threads(2)

V, C = 300, 64


def _logits(rng, B):
    return (rng.normal(size=(B, V)) * 3).astype(np.float32)


def _opts():
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.5], np.float32)
    top_k = np.array([0, 0, 5, 40, 1], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 0.3], np.float32)
    return temp, top_k, top_p


def test_warp_matches_reference():
    rng = np.random.default_rng(0)
    temp, top_k, top_p = _opts()
    logits = _logits(rng, len(temp))
    srt = -np.sort(-logits, axis=-1)[:, :C]
    want = ref_sampling._warp(jnp.asarray(srt), jnp.asarray(temp),
                              jnp.asarray(top_k), jnp.asarray(top_p))
    got = sampling._warp(torch.from_numpy(srt), torch.from_numpy(temp),
                         torch.from_numpy(top_k).long(),
                         torch.from_numpy(top_p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_repeat_penalty_and_greedy_match_reference():
    rng = np.random.default_rng(1)
    B, R = 3, 8
    logits = _logits(rng, B)
    ring = rng.integers(0, V, size=(B, R)).astype(np.int32)
    ring[0, :3] = V                               # empty slots drop out
    ring[1, 1] = ring[1, 0]                       # a repeated id counts once
    rp = np.array([1.0, 1.3, 0.8], np.float32)
    want = ref_sampling.apply_repeat_penalty(
        jnp.asarray(logits), jnp.asarray(ring), jnp.asarray(rp))
    got = sampling.apply_repeat_penalty(torch.from_numpy(logits),
                                        torch.from_numpy(ring),
                                        torch.from_numpy(rp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    zeros = np.zeros(B, np.float32)
    ref_tok, _ = ref_sampling.sample_batched(
        jnp.asarray(logits), jax.random.split(jax.random.PRNGKey(0), B),
        jnp.asarray(zeros), jnp.zeros(B, jnp.int32), jnp.ones(B),
        ring=jnp.asarray(ring), rp=jnp.asarray(rp))
    tok = sampling.sample_batched(
        torch.from_numpy(logits), [None] * B, torch.from_numpy(zeros),
        torch.zeros(B, dtype=torch.long), torch.ones(B),
        ring=torch.from_numpy(ring), rp=torch.from_numpy(rp))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(tok.numpy(),
                                  sampling.greedy(got).numpy())


def test_sample_step_ring_update_matches_reference():
    rng = np.random.default_rng(2)
    B, R = 4, 6
    logits = _logits(rng, B)
    ring = np.full((B, R), V, np.int32)
    emit = np.array([0, 5, 6, 13], np.int32)
    active = np.array([True, False, True, True])
    zeros = np.zeros(B, np.float32)
    ones = np.ones(B, np.float32)
    ref_tok, _, ref_ring = ref_sampling.sample_step_batched(
        jnp.asarray(logits), jax.random.split(jax.random.PRNGKey(0), B),
        jnp.asarray(zeros), jnp.zeros(B, jnp.int32), jnp.asarray(ones),
        ring=jnp.asarray(ring), rp=jnp.asarray(ones),
        emit_pos=jnp.asarray(emit), active=jnp.asarray(active))
    tok, got_ring = sampling.sample_step_batched(
        torch.from_numpy(logits), [None] * B, torch.from_numpy(zeros),
        torch.zeros(B, dtype=torch.long), torch.from_numpy(ones),
        ring=torch.from_numpy(ring), rp=torch.from_numpy(ones),
        emit_pos=torch.from_numpy(emit), active=torch.from_numpy(active))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(got_ring.numpy(), np.asarray(ref_ring))


def test_seeded_draws_follow_the_warped_distribution():
    rng = np.random.default_rng(3)
    logits = np.repeat(_logits(rng, 1), 2, axis=0)
    temp = np.array([0.9, 0.9], np.float32)
    top_k = np.array([0, 0], np.int32)
    top_p = np.array([0.95, 0.95], np.float32)
    srt = -np.sort(-logits, axis=-1)[:, :C]
    order = np.argsort(-logits[0], kind="stable")[:C]
    probs = np.asarray(ref_sampling._warp(
        jnp.asarray(srt), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))[0]
    n = 1500
    counts = np.zeros(V)
    args = (torch.from_numpy(logits), torch.from_numpy(temp),
            torch.from_numpy(top_k).long(), torch.from_numpy(top_p))
    for seed in range(n // 2):
        gens = [torch.Generator().manual_seed(2 * seed + i) for i in range(2)]
        tok = sampling.sample_batched(args[0], gens, *args[1:])
        for t in tok.tolist():
            counts[t] += 1
    want = np.zeros(V)
    want[order] = probs
    assert counts[want == 0].sum() == 0          # never outside the support
    se = np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(counts / n - want) <= 5 * se + 1e-3)
    # Same seed, same draws.
    again = [sampling.sample_batched(
        args[0], [torch.Generator().manual_seed(7), None], *args[1:])
        for _ in range(2)]
    assert again[0][0] == again[1][0]
