"""The port's dense KV path (models/llama.py and models/mixtral.py dense
forms, ops/dense_attention.py's plain versions) against the reference's
on the CPU, same numpy-seeded inputs.

Weights cross from the JAX package through numpy (models/convert.py):
int8 weights, or bf16 weights (the reference's bf16 init, held in f32),
both with f32 activations, so a near-tie in mixtral's router cannot
flip an expert between the packages. Tolerance 1e-4 of the logit scale
max|logits| (only the f32 summation order differs); written cache slots
within 1e-4 of the cache scale, and slots nobody wrote bitwise zero on
both sides. The quote-weight streams run bf16 activations.

- ``prefill`` into a cache, ``prefill_chunk_dense``, ``decode_step``
  with ragged lengths and a parked row, ``verify_step`` and
  ``verify_tree``, the general ``forward`` (llama ``tiny`` and mixtral
  ``tiny-moe``);
- ``decode_fused`` at K = 4 bitwise equal to four ``decode_step`` calls
  (greedy and sampled rows, one EOS mid-burst), its greedy rows equal to
  the reference's ``decode_fused``;
- a verify write at or past max_seq dropped (the reference's
  ``mode="drop"``), the rest of the cache unchanged;
- greedy streams identical over 16 steps on quote weights;
- the identity pool view: zero-copy, and the pool function of kernel B's
  plain version over it equals the dense plain version.

The bf16-weight forms and the rep-8 view case are the ``slow`` leg (the
larger matrices; ``ci.sh full`` runs them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models import mixtral as ref_mixtral
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.layers import attend_gqa as ref_attend
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu_torch.models import family_for, llama
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.models.sampling import sample_step_batched
from p2p_llm_chat_tpu_torch.ops import dense_attention as da
from p2p_llm_chat_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)
pytestmark = pytest.mark.model

_REF = {"tiny": ref_llama, "tiny-moe": ref_mixtral}
T = 48          # max_seq of the test caches
TOL = {"int8": 1e-4, "bf16": 1e-4}


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _ref_params(config: str, kind: str):
    cfg = ref_config(config)
    if kind == "int8":
        return _REF[config].init_params_quantized(
            cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = _REF[config].init_params(cfg, jax.random.PRNGKey(0),
                                      dtype=jnp.bfloat16)
    return jax.tree.map(lambda x: x.astype(jnp.float32), params)


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x)
                      else np.asarray(x, np.float32), np.float32)


class _Pair:
    """One model in both packages with a prefilled dense cache each."""

    def __init__(self, config: str, kind: str, prompts, ref_params=None):
        self.ref = _REF[config]
        self.cfg_ref = ref_config(config)
        self.cfg = get_config(config)
        self.fam = family_for(self.cfg)
        self.params_ref = (_ref_params(config, kind) if ref_params is None
                           else ref_params)
        self.params = self.fam.fuse_params(
            params_from_numpy(_np_tree(self.params_ref), device="cpu"))
        self.dtype = self.params["embed"].dtype
        jdt = jnp.float32 if self.dtype == torch.float32 else jnp.bfloat16
        B = len(prompts)
        S = 16
        toks = np.zeros((B, S), np.int32)
        self.lens = np.array([len(p) for p in prompts], np.int32)
        for b, p in enumerate(prompts):
            toks[b, :len(p)] = p
        self.toks = toks
        rc = ref_llama.KVCache.create(self.cfg_ref, B, T, dtype=jdt)
        logits, self.ref_cache = self.ref.prefill(
            self.params_ref, self.cfg_ref, jnp.asarray(toks),
            jnp.asarray(self.lens), rc)
        self.ref_logits = np.asarray(logits)
        self.cache = llama.KVCache.create(self.cfg, B, T, dtype=self.dtype,
                                          device="cpu")
        got, _ = self.fam.prefill(self.params, self.cfg,
                                  torch.from_numpy(toks).long(),
                                  torch.from_numpy(self.lens), cache=self.cache)
        self.logits = got.float().numpy()

    def assert_caches_close(self, tol: float) -> None:
        for name in ("k", "v"):
            full = _np(getattr(self.cache, name))
            # The port rounds the slot axis up to a page; the pad slots
            # are never written.
            assert full.shape[2] == da.cache_slots(T)
            assert not full[:, :, T:].any()
            got = full[:, :, :T]
            want = _np(getattr(self.ref_cache, name))
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                                       err_msg=name)
            # Slots neither side wrote are zero on both.
            np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_array_equal(self.cache.lengths.numpy(),
                                      np.asarray(self.ref_cache.lengths))


def _close(got, want, tol: float) -> None:
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


PROMPTS = [[1, 40, 41, 42, 43], [1, 300, 301, 302, 303, 304, 305, 306, 307],
           [1, 7]]


@pytest.mark.parametrize("kind", ["int8",
                                  pytest.param("bf16", marks=pytest.mark.slow)])
@pytest.mark.parametrize("config", ["tiny", "tiny-moe"])
def test_dense_forms_match_reference(config, kind):
    pair = _Pair(config, kind, PROMPTS)
    tol = TOL[kind]
    for b, n in enumerate(pair.lens):
        _close(pair.logits[b, :n], pair.ref_logits[b, :n], tol)
    pair.assert_caches_close(tol)
    rng = np.random.default_rng(4)
    B = len(PROMPTS)
    # decode_step: ragged lengths, row 2 parked, a window below max_seq.
    active = np.array([True, True, False])
    for _ in range(3):
        tokens = rng.integers(3, 500, size=(B, 1))
        ref_l, pair.ref_cache = pair.ref.decode_step(
            pair.params_ref, pair.cfg_ref, jnp.asarray(tokens, jnp.int32),
            pair.ref_cache, active=jnp.asarray(active), kv_window=32)
        got, _ = pair.fam.decode_step(
            pair.params, pair.cfg, torch.from_numpy(tokens).long(),
            pair.cache, torch.from_numpy(active), kv_window=32)
        _close(got.float().numpy(), np.asarray(ref_l), tol)
        pair.assert_caches_close(tol)
    assert pair.cache.lengths.tolist() == [8, 12, 2]
    # verify_step: S = 4 candidate positions per row.
    tokens = rng.integers(3, 500, size=(B, 4))
    ref_l, pair.ref_cache = pair.ref.verify_step(
        pair.params_ref, pair.cfg_ref, jnp.asarray(tokens, jnp.int32),
        pair.ref_cache, kv_window=32)
    got, _ = pair.fam.verify_step(pair.params, pair.cfg,
                                  torch.from_numpy(tokens).long(), pair.cache,
                                  kv_window=32)
    _close(got.float().numpy(), np.asarray(ref_l), tol)
    pair.assert_caches_close(tol)
    # verify_tree: 6 nodes, chain 0-1-2 plus siblings at depths 1 and 2.
    N = 6
    depths = np.array([0, 1, 2, 1, 2, 3])
    parent = [-1, 0, 1, 0, 1, 2]
    anc = np.zeros((N, N), bool)
    for i in range(N):
        j = i
        while j >= 0:
            anc[i, j] = True
            j = parent[j]
    tokens = rng.integers(3, 500, size=(B, N))
    ref_l, pair.ref_cache = pair.ref.verify_tree(
        pair.params_ref, pair.cfg_ref, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(np.tile(depths, (B, 1)), jnp.int32),
        jnp.asarray(np.tile(anc, (B, 1, 1))), pair.ref_cache, kv_window=32)
    got, _ = pair.fam.verify_tree(
        pair.params, pair.cfg, torch.from_numpy(tokens).long(),
        torch.from_numpy(np.tile(depths, (B, 1))),
        torch.from_numpy(np.tile(anc, (B, 1, 1))), pair.cache, kv_window=32)
    _close(got.float().numpy(), np.asarray(ref_l), tol)
    pair.assert_caches_close(tol)


@pytest.mark.parametrize("config", ["tiny", "tiny-moe"])
def test_prefill_chunk_and_forward_match_reference(config):
    pair = _Pair(config, "int8", PROMPTS)
    tol = TOL["int8"]
    rng = np.random.default_rng(5)
    B = len(PROMPTS)
    tokens = rng.integers(3, 500, size=(B, 8))
    last = np.array([7, 3, 0])
    ref_l, pair.ref_cache = pair.ref.prefill_chunk(
        pair.params_ref, pair.cfg_ref, jnp.asarray(tokens, jnp.int32),
        pair.ref_cache, 16, last_idx=jnp.asarray(last, jnp.int32))
    got, _ = pair.fam.prefill_chunk_dense(
        pair.params, pair.cfg, torch.from_numpy(tokens).long(), pair.cache,
        16, torch.from_numpy(last))
    _close(got.float().numpy(), np.asarray(ref_l), tol)
    pair.assert_caches_close(tol)
    # The general forward under an arbitrary (here: strided) mask.
    positions = np.tile(np.arange(24, 27), (B, 1))
    mask = (np.arange(32)[None, None, None, :] % 3 != 1) | (
        np.arange(32)[None, None, None, :] >= 24)
    mask = np.broadcast_to(mask, (1, 1, 3, 32)).copy()
    tokens = rng.integers(3, 500, size=(B, 3))
    ref_l, pair.ref_cache = pair.ref.forward(
        pair.params_ref, pair.cfg_ref, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(positions, jnp.int32), pair.ref_cache, jnp.asarray(mask),
        kv_window=32)
    got, _ = pair.fam.forward(
        pair.params, pair.cfg, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions), pair.cache, torch.from_numpy(mask),
        kv_window=32)
    _close(got.float().numpy(), np.asarray(ref_l), tol)
    pair.assert_caches_close(tol)


@pytest.mark.parametrize("config", ["tiny", "tiny-moe"])
def test_decode_fused_equals_sequential_steps(config):
    """K = 4 in one call: bitwise the stream of four decode_step calls
    with the device sampler between them (rows 0 and 2 greedy, row 1
    sampled), row 0 parking on the EOS id it emits at step 2; its greedy
    rows equal the reference's decode_fused."""
    pair = _Pair(config, "int8", PROMPTS)
    B = len(PROMPTS)
    start = torch.from_numpy(pair.logits[np.arange(B), pair.lens - 1]
                             ).argmax(-1)[:, None]
    temps = torch.tensor([0.0, 0.8, 0.0])
    top_ks = torch.tensor([0, 40, 0])
    top_ps = torch.tensor([1.0, 0.9, 1.0])
    keys0 = torch.tensor([[3, 0], [4, 0], [5, 0]])

    rps = torch.ones(3)

    def sample_fn(logits, state, emit_pos, act):
        keys, ring = state
        toks, keys, ring = sample_step_batched(
            logits, keys, temps, top_ks, top_ps, ring=ring, rp=rps,
            emit_pos=emit_pos, active=act)
        return toks, (keys, ring)

    ring0 = torch.full((3, 8), 512)

    def clone(c):
        return llama.KVCache(c.k.clone(), c.v.clone(), c.lengths.clone(),
                             c.max_seq)

    base = clone(pair.cache)
    # Sequential: which id does row 0 emit at step 2? It becomes the stop.
    seq, cache, tok, keys = [], clone(base), start, (keys0, ring0)
    act = torch.ones(B, dtype=torch.bool)
    for _ in range(4):
        emit = cache.lengths + 1
        logits, cache = pair.fam.decode_step(pair.params, pair.cfg, tok,
                                             cache, act, kv_window=32)
        t, keys = sample_fn(logits[:, 0], keys, emit, act)
        seq.append(t)
        tok = torch.where(act[:, None], t[:, None], tok)
    stop = seq[1][0:1].clone()
    # Sequential again, with the host parking row 0 after its stop id.
    seq, cache, tok, keys = [], clone(base), start, (keys0, ring0)
    act = torch.ones(B, dtype=torch.bool)
    for _ in range(4):
        emit = cache.lengths + 1
        logits, cache = pair.fam.decode_step(pair.params, pair.cfg, tok,
                                             cache, act, kv_window=32)
        t, keys = sample_fn(logits[:, 0], keys, emit, act)
        seq.append(t)
        tok = torch.where(act[:, None], t[:, None], tok)
        act = act & (t[:, None] != stop[None, :]).all(dim=1)
    fused_cache = clone(base)
    toks, emitted, nxt, _, act_f, keys_f = pair.fam.decode_fused(
        pair.params, pair.cfg, start, fused_cache, None, num_steps=4,
        sample_fn=sample_fn, sample_state=(keys0, ring0), stop_ids=stop,
        kv_window=32)
    assert torch.equal(toks, torch.stack(seq))
    assert torch.equal(fused_cache.k, cache.k)
    assert torch.equal(fused_cache.lengths, cache.lengths)
    assert torch.equal(keys_f[0], keys[0]) and torch.equal(keys_f[1], keys[1])
    assert torch.equal(act_f, act)
    assert emitted[:, 0].tolist() == [True, True, False, False]
    assert fused_cache.lengths[0] == base.lengths[0] + 2
    # The reference's fused greedy stream (rows 0 and 2 are greedy).
    rc = pair.ref_cache

    def ref_sample(logits, state, emit_pos, a):
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), state

    ref_toks, *_ = pair.ref.decode_fused(
        pair.params_ref, pair.cfg_ref, jnp.asarray(start.numpy(), jnp.int32),
        rc, num_steps=4, sample_fn=ref_sample, sample_state=jnp.int32(0),
        stop_ids=np.asarray(stop.numpy(), np.int32), kv_window=32)
    ref_toks = np.asarray(ref_toks)
    for row in (0, 2):
        n = 2 if row == 0 else 4
        np.testing.assert_array_equal(toks[:n, row].numpy(),
                                      ref_toks[:n, row])


def test_verify_write_past_max_seq_is_dropped():
    """Rows near the end of the cache: positions at or past max_seq write
    nowhere (no clamp onto the last slot, no other row), as the
    reference's ``mode="drop"``; in-range block slots are written."""
    pair = _Pair("tiny", "int8", PROMPTS)
    pair.cache.lengths.copy_(torch.tensor([T - 2, T - 1, 5]))
    pair.ref_cache = pair.ref_cache._replace(
        lengths=jnp.asarray([T - 2, T - 1, 5], jnp.int32))
    before = pair.cache.k.clone()
    tokens = np.random.default_rng(6).integers(3, 500, size=(3, 4))
    ref_l, pair.ref_cache = pair.ref.verify_step(
        pair.params_ref, pair.cfg_ref, jnp.asarray(tokens, jnp.int32),
        pair.ref_cache)
    got, _ = pair.fam.verify_step(pair.params, pair.cfg,
                                  torch.from_numpy(tokens).long(), pair.cache)
    pair.assert_caches_close(TOL["int8"])
    changed = (pair.cache.k != before).any(dim=(0, 3, 4))       # [B, T]
    assert changed[0].nonzero().flatten().tolist() == [T - 2, T - 1]
    assert changed[1].nonzero().flatten().tolist() == [T - 1]
    assert changed[2].nonzero().flatten().tolist() == [5, 6, 7, 8]
    # Logits of the positions inside the cache agree.
    _close(got.float().numpy()[0, :2], np.asarray(ref_l)[0, :2], 1e-4)
    _close(got.float().numpy()[2], np.asarray(ref_l)[2], 1e-4)


@pytest.mark.parametrize("config", ["tiny", "tiny-moe"])
def test_greedy_streams_identical_on_quote_weights(config):
    params = quote_params(ref_config(config), jax.random.PRNGKey(3),
                          quantized=True)
    prompts = [[1, 40, 41, 42], [1, 300, 301, 302, 303, 304, 305, 306]]
    pair = _Pair(config, "int8", prompts, ref_params=params)
    B = len(prompts)
    idx = np.arange(B), pair.lens - 1
    ref_tok = pair.ref_logits[idx].argmax(-1)
    tok = pair.logits[idx].argmax(-1)
    ref_stream, stream = [ref_tok], [tok]
    for _ in range(16):
        ref_l, pair.ref_cache = pair.ref.decode_step(
            pair.params_ref, pair.cfg_ref,
            jnp.asarray(ref_tok[:, None], jnp.int32), pair.ref_cache,
            kv_window=32)
        ref_tok = np.asarray(ref_l)[:, 0].argmax(-1)
        ref_stream.append(ref_tok)
        got, _ = pair.fam.decode_step(pair.params, pair.cfg,
                                      torch.from_numpy(tok[:, None]).long(),
                                      pair.cache, kv_window=32)
        tok = got[:, 0].float().numpy().argmax(-1)
        stream.append(tok)
    np.testing.assert_array_equal(np.stack(stream), np.stack(ref_stream))


@pytest.mark.parametrize("rep,D,max_seq", [
    (1, 64, 64), (4, 32, 60),
    pytest.param(8, 128, 50, marks=pytest.mark.slow)])
def test_plain_versions_and_pool_view(rep, D, max_seq):
    """The plain decode and verify versions against the reference's
    ``attend_gqa`` under its masks; the view shares the cache's storage,
    and kernel B's pool-function plain version over it (identity table)
    equals the dense plain version. NaN past each row's length never
    reaches a row."""
    rng = np.random.default_rng(rep * D + max_seq)
    L, B, Hkv = 2, 3, 2
    Hq = Hkv * rep
    Tp = da.cache_slots(max_seq)        # the slot axis KVCache.create makes
    k = rng.standard_normal((L, B, Tp, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((L, B, Tp, Hkv, D)).astype(np.float32)
    lengths = np.array([max_seq - 10, 1, 17], np.int32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    cache = llama.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(lengths), max_seq)
    W = max_seq - 8
    got = da.dense_attention(torch.from_numpy(q), cache,
                             torch.from_numpy(lengths), 1, window=W)
    mask = (np.arange(W)[None, :] < lengths[:, None])[:, None, None, :]
    want = ref_attend(jnp.asarray(q[:, None]), jnp.asarray(k[1, :, :W]),
                      jnp.asarray(v[1, :, :W]), jnp.asarray(mask))[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    kp, vp, table, ps = da.pool_view(cache.k, cache.v)
    assert kp.data_ptr() == cache.k.data_ptr() and Tp % ps == 0
    assert ps == da.VIEW_PAGE and tuple(table.shape) == (B, Tp // ps)
    with pytest.raises(ValueError, match="not a multiple of 64"):
        da.pool_view(cache.k[:, :, :Tp - 1], cache.v[:, :, :Tp - 1])
    pool = pa.paged_attention_reference(
        torch.from_numpy(q), kp, vp, table, torch.from_numpy(lengths), 1,
        pages=-(-W // ps))
    np.testing.assert_allclose(pool.numpy(), got.numpy(), atol=1e-5)
    # NaN in every slot past a row's length changes nothing.
    nk, nv = cache.k.clone(), cache.v.clone()
    for b, n in enumerate(lengths):
        nk[:, b, n:] = float("nan")
        nv[:, b, n:] = float("nan")
    again = da.dense_attention(torch.from_numpy(q),
                               llama.KVCache(nk, nv, cache.lengths,
                                             max_seq),
                               torch.from_numpy(lengths), 1, window=W)
    assert torch.equal(again, got)
    # Verify: a chain block of S = 3 at lengths, and a tree mask.
    S = 3
    qb = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kb = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vb = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    ln = np.array([max_seq - 12, 0, 9], np.int32)
    tree = np.array([[1, 0, 0], [1, 1, 0], [1, 0, 1]], bool)
    for blk in (None, np.tile(tree, (B, 1, 1))):
        got = da.dense_attention_verify(
            torch.from_numpy(qb), torch.from_numpy(kb), torch.from_numpy(vb),
            cache, torch.from_numpy(ln), 1, window=W,
            block_mask=None if blk is None else torch.from_numpy(blk))
        kw, vw = k[1, :, :W].copy(), v[1, :, :W].copy()
        for b in range(B):
            kw[b, ln[b]:ln[b] + S] = kb[b]
            vw[b, ln[b]:ln[b] + S] = vb[b]
        cols = np.arange(W)[None, None, :]
        pos = ln[:, None, None] + np.arange(S)[None, :, None]
        if blk is None:
            m = cols <= pos
        else:
            m = np.asarray(ref_llama.tree_attention_mask(
                jnp.asarray(ln), jnp.asarray(blk), W))[:, 0]
        want = ref_attend(jnp.asarray(qb), jnp.asarray(kw), jnp.asarray(vw),
                          jnp.asarray(m[:, None]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_write_dense_drops_and_keeps_rows_apart():
    cfg = get_config("tiny")
    cache = llama.KVCache.create(cfg, 3, 8, dtype=torch.float32,
                                 device="cpu")
    pos = torch.tensor([[6, 7, 8, 9], [0, 1, 2, 3], [7, 8, 9, 10]])
    k = torch.arange(3 * 4 * 2 * 32, dtype=torch.float32).reshape(
        3, 4, 2, 32) + 1
    llama.write_dense(cache, 1, k, -k, pos)
    assert torch.equal(cache.k[1, 0, 6:8], k[0, :2])
    assert torch.equal(cache.k[1, 1, :4], k[1])
    assert torch.equal(cache.k[1, 2, 7], k[2, 0])
    assert torch.equal(cache.v[1, 2, 7], -k[2, 0])
    assert not cache.k[0].any() and not cache.k[1, 0, :6].any()
    assert not cache.k[1, 1, 4:].any() and not cache.k[1, 2, :7].any()
    # The slots past max_seq that pad the cache to a page stay untouched.
    assert cache.k.shape[2] == 64 and not cache.k[:, :, 8:].any()
