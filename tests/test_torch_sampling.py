"""The port's samplers against the reference on the same logits.

``jax.random``'s threefry keys and the port's hashed ``[seed, counter]``
keys draw different numbers from one seed, so greedy rows are compared
token for token and sampled rows as the warped distribution (``_warp``:
temperature, top-k, top-p over the top-c candidates) fed the same numpy
logits, to 1e-6 (f32 softmax and cumsum in another order). Draws of the
port's sampler are then checked against that distribution: every draw
lies in its support, and the empirical frequencies over many seeded
draws sit within a few standard errors. A row's draw depends on its own
key only, and every row's key advances at every call.
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
    tok, _ = sampling.sample_batched(
        torch.from_numpy(logits), _keys(range(B)), torch.from_numpy(zeros),
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
    keys = _keys(range(B))
    tok, got_keys, got_ring = sampling.sample_step_batched(
        torch.from_numpy(logits), keys, torch.from_numpy(zeros),
        torch.zeros(B, dtype=torch.long), torch.from_numpy(ones),
        ring=torch.from_numpy(ring), rp=torch.from_numpy(ones),
        emit_pos=torch.from_numpy(emit), active=torch.from_numpy(active))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(got_ring.numpy(), np.asarray(ref_ring))
    # Every row's key advances, the parked row's too (as the reference
    # splits every row's key).
    np.testing.assert_array_equal(got_keys.numpy(),
                                  (keys + torch.tensor([0, 1])).numpy())


def _keys(seeds, counter: int = 0) -> torch.Tensor:
    return torch.tensor([[s, counter] for s in seeds], dtype=torch.long)


def _dist_case():
    rng = np.random.default_rng(3)
    logits = _logits(rng, 1)
    temp = np.array([0.9], np.float32)
    top_k = np.array([0], np.int32)
    top_p = np.array([0.95], np.float32)
    srt = -np.sort(-logits, axis=-1)[:, :C]
    order = np.argsort(-logits[0], kind="stable")[:C]
    probs = np.asarray(ref_sampling._warp(
        jnp.asarray(srt), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))[0]
    want = np.zeros(V)
    want[order] = probs
    args = (torch.from_numpy(temp), torch.from_numpy(top_k).long(),
            torch.from_numpy(top_p))
    return torch.from_numpy(logits), args, want


def _check_frequencies(toks: np.ndarray, want: np.ndarray) -> None:
    n = toks.size
    counts = np.bincount(toks, minlength=V)
    assert counts[want == 0].sum() == 0          # never outside the support
    se = np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(counts / n - want) <= 5 * se + 1e-3)


def test_seeded_draws_follow_the_warped_distribution():
    """Draws over 1500 seeds (counter 0), one batched call: the warped
    distribution's support and frequencies; the same key gives the same
    draw."""
    logits, args, want = _dist_case()
    n = 1500
    rep = [a.expand(n) for a in args]
    tok, keys = sampling.sample_batched(logits.expand(n, V), _keys(range(n)),
                                        *rep)
    _check_frequencies(tok.numpy(), want)
    assert torch.equal(keys[:, 1], torch.ones(n, dtype=torch.long))
    again, _ = sampling.sample_batched(logits.expand(n, V), _keys(range(n)),
                                       *rep)
    assert torch.equal(again, tok)


def test_one_seeds_counter_stream_follows_the_warped_distribution():
    """One row's successive draws (its counter advancing from one call to
    the next, as a decode stream's does) follow the same distribution."""
    logits, args, want = _dist_case()
    keys = _keys([11])
    toks = []
    for _ in range(1500):
        tok, keys = sampling.sample_batched(logits, keys, *args)
        toks.append(int(tok[0]))
    assert int(keys[0, 1]) == 1500
    _check_frequencies(np.asarray(toks), want)


def test_a_rows_draw_does_not_depend_on_the_batch():
    """Row b's token alone equals its token in a batch of 3 with other
    rows' options and keys (what makes fused and plain ticks, and any
    batch composition, draw the same stream)."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(_logits(rng, 3))
    temp = torch.tensor([0.8, 0.0, 1.2])
    top_k = torch.tensor([0, 0, 7])
    top_p = torch.tensor([0.9, 1.0, 1.0])
    for counter in range(20):
        keys = _keys([5, 6, 7], counter)
        batch, _ = sampling.sample_batched(logits, keys, temp, top_k, top_p)
        for b in range(3):
            alone, _ = sampling.sample_batched(
                logits[b:b + 1], keys[b:b + 1], temp[b:b + 1],
                top_k[b:b + 1], top_p[b:b + 1])
            assert int(alone[0]) == int(batch[b])
