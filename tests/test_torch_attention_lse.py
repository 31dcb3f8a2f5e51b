"""The log-sum-exp that kernels D and B return beside their output
(``return_lse=True``), held on the CPU through their plain versions
(ops/prefill_attention.prefill_attention_reference,
ops/dense_attention.dense_attention_plain), one process:

- the plain versions' lse equals ``m + log l`` of the reference's own
  flash statistics (p2p_llm_chat_tpu/parallel/ring.py ``_chunk_scores``
  then ``_online_update`` from the empty state), for a causal chunk at an
  offset (a ring hop) and for decode over a length mask;
- a causal attention over S positions cut into sp chunks and computed
  as ring hops (kernel D's offset semantics: the diagonal chunk at
  offset 0, each earlier chunk at ``(my - src) Sl``, later chunks
  skipped) and merged by their lse (parallel/ring._merge_hop) equals the
  one-shot attention; so does a decode window cut into sequence shards
  at local lengths ``clamp(lengths - i Sl, 0, Sl)``, merged the same way;
- a row with no slot to attend (a shard past the row's length) comes
  back as lse -inf and output 0, never NaN;
- without ``return_lse`` the output is the same tensor bit for bit.

Tolerance: 1e-5 of max|value| (f32 on both sides, summed in another
order); the output with and without the lse bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models.layers import NEG_INF as REF_NEG_INF
from p2p_llm_chat_tpu.parallel.ring import _chunk_scores, _online_update
from p2p_llm_chat_tpu_torch.ops.dense_attention import dense_attention_plain
from p2p_llm_chat_tpu_torch.ops.prefill_attention import (
    prefill_attention, prefill_attention_reference)
from p2p_llm_chat_tpu_torch.parallel.ring import _merge_hop

TOL = 1e-5       # of max|value|: f32 both sides, another summation order


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _ref_lse(q, k, v, mask):
    """m + log l of the reference's statistics: q [B, Sq, Hq, D], k/v
    [B, Sk, Hkv, D], mask [Sq, Sk] or [B, Sq, Sk] (True = attend);
    returns [B, Hq, Sq]."""
    B, Sq, Hq, _ = q.shape
    G = k.shape[2]
    s = _chunk_scores(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()))
    m0 = jnp.full((B, G, Hq // G, Sq), REF_NEG_INF, jnp.float32)
    l0 = jnp.zeros((B, G, Hq // G, Sq), jnp.float32)
    a0 = jnp.zeros((B, G, Hq // G, Sq, q.shape[-1]), jnp.float32)
    mask = jnp.asarray(mask.numpy())
    mask = mask[None, None, None] if mask.ndim == 2 else \
        mask[:, None, None]
    m, l, _ = _online_update(s, jnp.asarray(v.numpy()), mask, m0, l0, a0)
    return np.asarray(m + jnp.log(l)).reshape(B, Hq, Sq)


@pytest.mark.parametrize("Sq,Skv,off,Hq,Hkv", [(16, 16, 0, 4, 2),
                                               (8, 40, 32, 8, 2),
                                               (12, 12, 24, 6, 6)])
def test_prefill_lse_is_the_references_flash_statistics(Sq, Skv, off, Hq,
                                                        Hkv):
    q, k, v = (_rand((2, S, H, 32), i) for i, (S, H) in
               enumerate(((Sq, Hq), (Skv, Hkv), (Skv, Hkv))))
    out, lse = prefill_attention_reference(q, k, v, off, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, Hq, Sq)
    mask = (torch.arange(Skv)[None, :]
            <= off + torch.arange(Sq)[:, None])
    _close(lse, _ref_lse(q, k, v, mask), "prefill lse")
    assert torch.equal(out, prefill_attention(q, k, v, off))


def test_decode_lse_is_the_references_flash_statistics():
    B, W, Hq, Hkv, D = 3, 64, 8, 2, 32
    q = _rand((B, Hq, D), 1)
    ck, cv = _rand((2, B, W, Hkv, D), 2), _rand((2, B, W, Hkv, D), 3)
    lengths = torch.tensor([64, 17, 1], dtype=torch.int32)
    out, lse = dense_attention_plain(q, ck, cv, lengths, 1, window=W,
                                     return_lse=True)
    assert lse.shape == (B, Hq)
    mask = torch.arange(W)[None, None, :] < lengths[:, None, None]
    want = _ref_lse(q[:, None], ck[1], cv[1], mask)[..., 0]
    _close(lse, want, "decode lse")
    assert torch.equal(out, dense_attention_plain(q, ck, cv, lengths, 1,
                                                  window=W))


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_hops_merged_by_lse_equal_the_one_shot_attention(sp):
    B, S, Hq, Hkv, D = 2, 32, 4, 2, 32
    q, k, v = (_rand((B, S, H, D), 10 + i)
               for i, H in enumerate((Hq, Hkv, Hkv)))
    whole = prefill_attention_reference(q, k, v, 0)
    Sl = S // sp
    for my in range(sp):
        qc = q[:, my * Sl:(my + 1) * Sl]
        out, lse = prefill_attention_reference(
            qc, k[:, my * Sl:(my + 1) * Sl], v[:, my * Sl:(my + 1) * Sl], 0,
            return_lse=True)
        for t in range(1, sp):
            src = (my - t) % sp
            if src > my:
                continue
            o, lo = prefill_attention_reference(
                qc, k[:, src * Sl:(src + 1) * Sl],
                v[:, src * Sl:(src + 1) * Sl], (my - src) * Sl,
                return_lse=True)
            out, lse = _merge_hop(out, lse, o, lo)
        _close(out, whole[:, my * Sl:(my + 1) * Sl], f"chunk {my}")
        _close(lse, prefill_attention_reference(q, k, v, 0, True)[1][
            :, :, my * Sl:(my + 1) * Sl], f"chunk {my} lse")


@pytest.mark.parametrize("sp", [2, 4])
def test_decode_shards_merged_by_lse_equal_the_one_shot_attention(sp):
    B, W, Hq, Hkv, D = 3, 64, 8, 2, 32
    q = _rand((B, Hq, D), 20)
    ck, cv = _rand((1, B, W, Hkv, D), 21), _rand((1, B, W, Hkv, D), 22)
    lengths = torch.tensor([64, 20, 3], dtype=torch.int32)
    whole, whole_lse = dense_attention_plain(q, ck, cv, lengths, 0,
                                             window=W, return_lse=True)
    Sl = W // sp
    out = lse = None
    for i in range(sp):
        local = (lengths - i * Sl).clamp(0, Sl).to(torch.int32)
        o, lo = dense_attention_plain(q, ck[:, :, i * Sl:(i + 1) * Sl],
                                      cv[:, :, i * Sl:(i + 1) * Sl], local,
                                      0, window=Sl, return_lse=True)
        assert torch.isfinite(o).all()
        if out is None:
            out, lse = o[:, None].float(), lo[..., None]
        else:
            out, lse = _merge_hop(out, lse, o[:, None], lo[..., None])
    _close(out[:, 0], whole, "merged decode")
    _close(lse[..., 0], whole_lse, "merged decode lse")


def test_a_row_with_no_slot_gives_minus_inf_and_zero():
    B, W, Hq, Hkv, D = 2, 64, 4, 2, 32
    q = _rand((B, Hq, D), 30)
    ck = _rand((1, B, W, Hkv, D), 31)
    cv = _rand((1, B, W, Hkv, D), 32)
    cv[:, 1] = float("nan")          # never read for a row of 0 slots
    out, lse = dense_attention_plain(
        q, ck, cv, torch.tensor([5, 0], dtype=torch.int32), 0, window=W,
        return_lse=True)
    assert torch.isneginf(lse[1]).all() and torch.isfinite(lse[0]).all()
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert torch.isfinite(out).all()
