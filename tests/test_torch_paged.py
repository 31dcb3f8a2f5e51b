"""Paged KV pool writes and decode attention of the port (both modes of
kernel B's plain versions), held against the reference on the same
numpy-seeded inputs.

- ``quant_kv`` and the pool after ``write_prefill_batch`` /
  ``write_decode_burst`` / ``write_decode`` must be BITWISE equal to the
  reference's (int8
  bytes, head-major scales, bf16 pools, page tables, lengths). Page 0 is
  the garbage page by contract (duplicate writes land there in an
  unspecified order) and is excluded.
- kernel B's plain version (``paged_attention_append_reference`` — what
  the wrapper runs for CPU tensors) against the reference's gather path
  and its Pallas ``_paged_attention_flash_append`` in interpret mode,
  over int8 and bf16 pools with ragged lengths. f32 queries and int8
  pools agree to 2e-5 (f32 reduction order only); bf16 pools to 1e-2
  (the p.v product runs in the pool dtype on the gather paths, f32 in
  the interpreted kernel — one bf16 rounding apart).
- pool mode, ``paged_attention`` (write-then-attend): each impl against
  the reference's same impl (``gather``; ``kernel`` = Pallas
  ``_paged_attention_kernel``, ``flash`` = ``_paged_attention_flash``,
  both interpreted) on f32 pools at 1e-5, the int8 gather path at 1e-4,
  and the refusal of an int8 pool under a non-gather impl;
- append mode under ``PAGED_APPEND_IMPL=kernel`` against the Pallas
  ``_paged_append_kernel_call`` at 2e-2 (bf16 roundings inside it).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.ops import paged_kv as ref_kv
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import tensor_from_numpy
from p2p_llm_chat_tpu_torch.ops import paged_kv
from p2p_llm_chat_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_append, paged_attention_append_reference,
    paged_attention_reference)

ref_pa = importlib.import_module("p2p_llm_chat_tpu.ops.paged_attention")
port_pa = importlib.import_module("p2p_llm_chat_tpu_torch.ops.paged_attention")

torch.set_num_threads(2)
pytestmark = pytest.mark.model

PS = 8


def _t(x) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(x), device="cpu")


def _cache_to_torch(c) -> paged_kv.PagedKVCache:
    return paged_kv.PagedKVCache(
        k=_t(c.k), v=_t(c.v), page_table=_t(c.page_table),
        lengths=_t(c.lengths),
        k_scale=None if c.k_scale is None else _t(c.k_scale),
        v_scale=None if c.v_scale is None else _t(c.v_scale))


def _assert_pools_equal(got: paged_kv.PagedKVCache, ref) -> None:
    for name in ("k", "v", "k_scale", "v_scale"):
        r = getattr(ref, name)
        if r is None:
            assert getattr(got, name) is None
            continue
        g = getattr(got, name)[:, 1:]
        r = np.asarray(r)[:, 1:]
        if g.dtype == torch.bfloat16:
            g, r = g.view(torch.int16), r.view(np.int16)
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    np.testing.assert_array_equal(got.page_table.numpy(),
                                  np.asarray(ref.page_table))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))


def test_quant_kv_bitwise():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0                           # amax == 0 -> scale 1
    for dt in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x, dt)
        rq, rs = ref_kv.quant_kv(xj)
        q, s = paged_kv.quant_kv(_t(xj))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


def test_quant_kv_scale_is_the_ieee_quotient():
    """The int8 pool's scale is amax / 127 rounded once (IEEE f32
    division, the reference's), not amax times a rounded 1/127: on
    head rows whose amax makes the two differ, the port's scales and
    bytes equal numpy's f32 quotient and the reference's quant_kv
    bitwise (the card computes the same, chip_smoke.py's step check)."""
    rng = np.random.default_rng(7)
    amax = (rng.random(4096) * 10.0 ** rng.integers(-3, 4, 4096)
            ).astype(np.float32)
    recip = amax * np.float32(1.0 / 127.0)
    quot = amax / np.float32(127.0)
    hard = amax[recip != quot]
    assert hard.size > 50          # rows where a reciprocal would be off
    x = rng.standard_normal((hard.size, 2, 16)).astype(np.float32)
    x[:, 0, 3] = hard * np.sign(x[:, 0, 3] + 0.5)       # the row's amax
    x[:, 0] = np.clip(x[:, 0], -hard[:, None], hard[:, None])
    q, sc = paged_kv.quant_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(sc[:, 0].numpy(), hard / np.float32(127))
    rq, rs = ref_kv.quant_kv(jnp.asarray(x))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))


@pytest.mark.parametrize("quantized,S", [(True, 13), (True, 5),
                                         (False, 13), (False, 16)])
def test_pool_writes_bitwise(quantized, S):
    """Prefill splice (a padding entry, a partial last tile, a sub-page
    chunk) then a decode burst with one parked row."""
    rng = np.random.default_rng(S)
    cfg = ref_config("tiny")
    B, N, mppr, R = 4, 24, 6, 3
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    rc = ref_kv.PagedKVCache.create(cfg, B, N, PS, max_pages_per_row=mppr,
                                    dtype=jnp.bfloat16, quantized=quantized)
    tc = paged_kv.PagedKVCache.create(get_config("tiny"), B, N, PS,
                                      max_pages_per_row=mppr,
                                      dtype=torch.bfloat16,
                                      quantized=quantized, device="cpu")
    ck = rng.normal(size=(L, R, S, Hkv, D)).astype(np.float32)
    cv = rng.normal(size=ck.shape).astype(np.float32)
    rows = np.array([B, 2, 0], np.int32)         # entry 0 is padding
    lens = np.array([1, S, max(1, S - 4)], np.int32)
    tables = np.zeros((R, mppr), np.int32)
    tables[1, :3] = [5, 9, 2]
    tables[2, :2] = [7, 11]
    # bf16 pools take bf16 updates (no implicit f32 -> bf16 scatter cast)
    in_dt = jnp.float32 if quantized else jnp.bfloat16
    ck, cv = jnp.asarray(ck, in_dt), jnp.asarray(cv, in_dt)
    rc = ref_kv.write_prefill_batch(rc, ck, cv,
                                    jnp.asarray(rows), jnp.asarray(lens),
                                    jnp.asarray(tables))
    paged_kv.write_prefill_batch(tc, _t(ck), _t(cv),
                                 torch.from_numpy(rows).long(),
                                 torch.from_numpy(lens),
                                 torch.from_numpy(tables))
    _assert_pools_equal(tc, rc)

    ka = rng.normal(size=(L, B, Hkv, D)).astype(np.float32)
    va = rng.normal(size=ka.shape).astype(np.float32)
    inc = np.array([1, 0, 1, 0], np.int32)
    ka, va = jnp.asarray(ka, in_dt), jnp.asarray(va, in_dt)
    rc = ref_kv.write_decode_burst(rc, ka, va, jnp.asarray(inc))
    paged_kv.write_decode_burst(tc, _t(ka), _t(va), torch.from_numpy(inc))
    _assert_pools_equal(tc, rc)


def _filled(quantized, pool_dtype, lengths, pages, seed):
    """A reference pool whose rows own disjoint page ranges, filled
    through the reference splice op, plus numpy-seeded q / k_cur / v_cur."""
    rng = np.random.default_rng(seed)
    cfg = ref_config("tiny")
    B = len(lengths)
    cache = ref_kv.PagedKVCache.create(
        cfg, B, B * pages + 1, PS, max_pages_per_row=pages,
        dtype=pool_dtype, quantized=quantized)
    S = pages * PS
    ck = rng.normal(size=(cfg.num_layers, B, S, cfg.num_kv_heads,
                          cfg.head_dim)).astype(np.float32)
    cv = rng.normal(size=ck.shape).astype(np.float32)
    tables = np.stack([1 + b * pages + np.arange(pages)
                       for b in range(B)]).astype(np.int32)
    cache = ref_kv.write_prefill_batch(
        cache, jnp.asarray(ck, jnp.float32 if quantized else pool_dtype),
        jnp.asarray(cv, jnp.float32 if quantized else pool_dtype),
        jnp.arange(B),
        jnp.asarray(lengths, jnp.int32), jnp.asarray(tables))
    q = rng.normal(size=(B, cfg.num_heads, cfg.head_dim)).astype(np.float32)
    kc = rng.normal(size=(B, cfg.num_kv_heads,
                          cfg.head_dim)).astype(np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    return cache, q, kc, vc


@pytest.mark.parametrize("quantized,pool_dtype,tol", [
    (True, jnp.float32, 2e-5),
    (False, jnp.float32, 2e-5),
    (False, jnp.bfloat16, 1e-2),
])
def test_append_reference_matches_gather_and_flash(quantized, pool_dtype,
                                                   tol, monkeypatch):
    monkeypatch.setattr(ref_pa, "_APPEND_IMPL", "gather")
    lengths = [1, 7, 16, 33, 39]
    pages = 5
    cache, q, kc, vc = _filled(quantized, pool_dtype, lengths, pages, 0)
    tcache = _cache_to_torch(cache)
    lens = jnp.asarray(lengths, jnp.int32)
    for layer in range(2):
        got = paged_attention_append_reference(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            tcache, tcache.lengths, layer, pages=pages).numpy()
        gather = ref_pa.paged_attention_append(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), cache, lens,
            jnp.asarray(layer), pages=pages, interpret=True)
        np.testing.assert_allclose(got, np.asarray(gather), rtol=tol,
                                   atol=tol, err_msg=f"gather {layer}")
        flash = ref_pa._paged_attention_flash_append(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), cache.k,
            cache.v, cache.k_scale, cache.v_scale, cache.page_table, lens,
            jnp.asarray(layer), pages=pages, quantized=quantized,
            interpret=True)
        np.testing.assert_allclose(got, np.asarray(flash), rtol=tol,
                                   atol=tol, err_msg=f"flash {layer}")


@pytest.mark.parametrize("quantized", [True, False])
def test_append_skips_nan_garbage_page(quantized):
    """Rows whose window reaches past their allocation read page 0; NaN
    there must not leak into any row (positions >= lengths are skipped,
    not multiplied by 0)."""
    lengths = [3, 12]
    cache, q, kc, vc = _filled(quantized, jnp.float32, lengths, 3, 1)
    tcache = _cache_to_torch(cache)
    clean = paged_attention_append(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        tcache, tcache.lengths, 0, pages=3)
    tcache.page_table[0, 1:] = 0                # tail of row 0 -> page 0
    tcache.k[:, 0] = float("nan") if not quantized else 0
    tcache.v[:, 0] = float("nan") if not quantized else 0
    if quantized:
        tcache.k_scale[:, 0] = float("nan")
        tcache.v_scale[:, 0] = float("inf")
    before = paged_attention_append.launches
    dirty = paged_attention_append(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        tcache, tcache.lengths, 0, pages=3)
    assert paged_attention_append.launches == before    # plain path on CPU
    assert torch.isfinite(dirty).all()
    np.testing.assert_allclose(dirty[0].numpy(), clean[0].numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_write_decode_bitwise(pool):
    """One step's k/v written layer by layer (the write-then-attend
    branch): live rows at a slot mid-page, on a page boundary and at 0,
    a released row whose zeroed table routes its write to page 0."""
    rng = np.random.default_rng(4)
    cfg = ref_config("tiny")
    B, N, mppr = 4, 24, 4
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    quantized = pool == "int8"
    dt = jnp.float32 if pool == "f32" else jnp.bfloat16
    rc = ref_kv.PagedKVCache.create(cfg, B, N, PS, max_pages_per_row=mppr,
                                    dtype=dt, quantized=quantized)
    tables = np.zeros((B, mppr), np.int32)
    tables[0, :2] = [3, 4]
    tables[1, :2] = [5, 6]
    tables[2, :3] = [7, 8, 9]
    lens = np.array([5, PS, 0, 6], np.int32)        # row 3: released
    rc = rc._replace(page_table=jnp.asarray(tables),
                     lengths=jnp.asarray(lens))
    tc = _cache_to_torch(rc)
    in_dt = jnp.float32 if quantized else dt
    for layer in range(L):
        k = jnp.asarray(rng.normal(size=(B, Hkv, D)), in_dt)
        v = jnp.asarray(rng.normal(size=(B, Hkv, D)), in_dt)
        rc = ref_kv.write_decode(rc, jnp.asarray(layer), k, v)
        assert paged_kv.write_decode(tc, layer, _t(k), _t(v)) is tc
        _assert_pools_equal(tc, rc)


def _poisoned(quantized, lengths, pages, seed):
    """_filled's pool with every table entry past a row's live pages
    pointing at page 0, which holds 1e4 (int8 pools: 1e4 scales)."""
    cache, q, _, _ = _filled(quantized, jnp.float32, lengths, pages, seed)
    pt = np.asarray(cache.page_table).copy()
    for b, n in enumerate(lengths):
        pt[b, -(-n // PS):] = 0
    cache = cache._replace(page_table=jnp.asarray(pt))
    if quantized:
        return cache._replace(k_scale=cache.k_scale.at[:, 0].set(1e4),
                              v_scale=cache.v_scale.at[:, 0].set(1e4)), q
    return cache._replace(k=cache.k.at[:, 0].set(1e4),
                          v=cache.v.at[:, 0].set(1e4)), q


@pytest.mark.parametrize("impl", ["gather", "kernel", "flash"])
def test_paged_attention_matches_reference_impls(impl):
    """Pool mode (write-then-attend) on f32 pools, each impl against the
    reference's same impl (its Pallas kernels in interpret mode) and the
    index-naive oracles of both packages, at the reference's own 1e-5:
    a single token, a page boundary, a partial page; windows reaching
    past the live pages into page 0."""
    lengths = [1, 16, 27, 8]
    pages = 4
    cache, q = _poisoned(False, lengths, pages, 5)
    tcache = _cache_to_torch(cache)
    lens = jnp.asarray(lengths, jnp.int32)
    before = paged_attention.launches
    for layer in range(2):
        got = paged_attention(
            torch.from_numpy(q), tcache.k, tcache.v, tcache.page_table,
            tcache.lengths, layer, pages=pages, impl=impl).numpy()
        ref = ref_pa.paged_attention(
            jnp.asarray(q), cache.k, cache.v, cache.page_table, lens,
            jnp.asarray(layer), pages=pages, interpret=True, impl=impl)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{impl} {layer}")
        oracle = paged_attention_reference(
            torch.from_numpy(q), tcache.k, tcache.v, tcache.page_table,
            tcache.lengths, layer, pages=pages).numpy()
        ref_oracle = ref_pa.paged_attention_reference(
            jnp.asarray(q), cache.k, cache.v, cache.page_table, lens, layer,
            pages=pages)
        np.testing.assert_allclose(oracle, np.asarray(ref_oracle),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    assert paged_attention.launches == before            # plain on CPU


def test_paged_attention_int8_pool_gather_only(monkeypatch):
    """An int8 pool under impl="gather" (scores x k scales, softmax,
    probabilities x v scales) against the reference's at 1e-4 (f32 q:
    the p.v product runs in f32 on both sides); any other impl raises,
    in the reference and in the port alike, also as the env default."""
    lengths = [3, 16, 21]
    pages = 3
    cache, q = _poisoned(True, lengths, pages, 6)
    tcache = _cache_to_torch(cache)
    lens = jnp.asarray(lengths, jnp.int32)
    tq = torch.from_numpy(q)
    for layer in range(2):
        got = paged_attention(tq, tcache.k, tcache.v, tcache.page_table,
                              tcache.lengths, layer, pages=pages,
                              impl="gather", k_scale=tcache.k_scale,
                              v_scale=tcache.v_scale).numpy()
        ref = ref_pa.paged_attention(
            jnp.asarray(q), cache.k, cache.v, cache.page_table, lens,
            jnp.asarray(layer), pages=pages, impl="gather",
            k_scale=cache.k_scale, v_scale=cache.v_scale)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)
    for impl in ("kernel", "flash"):
        with pytest.raises(ValueError, match="gather"):
            ref_pa.paged_attention(
                jnp.asarray(q), cache.k, cache.v, cache.page_table, lens,
                jnp.asarray(0), pages=pages, impl=impl,
                k_scale=cache.k_scale, v_scale=cache.v_scale)
        with pytest.raises(ValueError, match="gather"):
            paged_attention(tq, tcache.k, tcache.v, tcache.page_table,
                            tcache.lengths, 0, pages=pages, impl=impl,
                            k_scale=tcache.k_scale, v_scale=tcache.v_scale)
        monkeypatch.setattr(port_pa, "_DEFAULT_IMPL", impl)
        with pytest.raises(ValueError, match="gather"):
            paged_attention(tq, tcache.k, tcache.v, tcache.page_table,
                            tcache.lengths, 0, pages=pages,
                            k_scale=tcache.k_scale, v_scale=tcache.v_scale)
    with pytest.raises(ValueError, match="gather|kernel|flash"):
        paged_attention(tq, tcache.k, tcache.v, tcache.page_table,
                        tcache.lengths, 0, pages=pages, impl="pallas")


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "f32"])
def test_append_under_kernel_impl_matches_pallas_block_kernel(quantized,
                                                              monkeypatch):
    """PAGED_APPEND_IMPL=kernel (row 5, the append function over an
    XLA-gathered window) against the reference's
    ``_paged_append_kernel_call`` in interpret mode, at the reference's
    own 2e-2: that kernel rounds q, k, v, p.sv and the numerator to bf16
    inside. A value outside gather|kernel|flash raises."""
    monkeypatch.setattr(port_pa, "_APPEND_IMPL", "kernel")
    lengths = [1, 7, 16, 33, 39]
    pages = 5
    cache, q, kc, vc = _filled(quantized, jnp.float32, lengths, pages, 2)
    tcache = _cache_to_torch(cache)
    lens = jnp.asarray(lengths, jnp.int32)
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            tcache, tcache.lengths)
    for layer in range(2):
        got = paged_attention_append(*args, layer, pages=pages).numpy()
        kern = ref_pa._paged_append_kernel_call(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), cache.k,
            cache.v, cache.k_scale, cache.v_scale, cache.page_table, lens,
            jnp.asarray(layer), pages=pages, quantized=quantized,
            interpret=True)
        np.testing.assert_allclose(got, np.asarray(kern), rtol=2e-2,
                                   atol=2e-2, err_msg=f"layer {layer}")
    monkeypatch.setattr(port_pa, "_APPEND_IMPL", "pallas")
    with pytest.raises(ValueError, match="PAGED_APPEND_IMPL"):
        paged_attention_append(*args, 0, pages=pages)
