"""The port's prefix cache (serve/prefix.py and prefix admission in
serve/scheduler.py), held against the reference.

- ``PrefixStore``: the same id sequences through the port's store and the
  reference's give the same ``observe`` heads, ``match`` results, LRU and
  byte-budget evictions and counters; ``token_hash`` and ``cost_evict``
  agree with the reference's.
- Admission: on the quote-workload weights, prompts that take the
  registered co-pilot template and an auto-promoted head give greedy
  ``context`` ids equal to the JAX engine's with its prefix cache on —
  single-shot, and chunked (C=16, suffix chunks at the prefix's odd
  offset) — and ``serve_prefix_admits_total`` moves (on /metrics too).
"""

import json
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.serve import kv_tier as ref_tier
from p2p_llm_chat_tpu.serve import prefix as ref_prefix
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest,
                                            RequestStats as RefStats,
                                            collect as ref_collect)
from p2p_llm_chat_tpu.serve.engine import SUGGEST_PREFIX as REF_SUGGEST
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.serve import prefix
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats, collect)
from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX, TorchEngine
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)
pytestmark = pytest.mark.model


# -- the store ----------------------------------------------------------------

class _Pair:
    """The same operations on the reference's store and the port's."""

    def __init__(self, **kw) -> None:
        self.ref = ref_prefix.PrefixStore(**kw)
        self.port = prefix.PrefixStore(**kw)

    def put(self, ids, nbytes: int = 8, last_used=None) -> None:
        extra = {} if last_used is None else {"last_used": last_used}
        self.ref.put(ref_prefix.PrefixEntry(
            ids=tuple(ids), k=np.zeros(nbytes // 2, np.int8),
            v=np.zeros(nbytes // 2, np.int8), **extra))
        self.port.put(prefix.PrefixEntry(
            ids=tuple(ids), k=torch.zeros(nbytes // 2, dtype=torch.int8),
            v=torch.zeros(nbytes // 2, dtype=torch.int8), **extra))

    def same(self, op: str, *args):
        a = getattr(self.ref, op)(*args)
        b = getattr(self.port, op)(*args)
        if op == "match":
            a, b = (None if e is None else e.ids for e in (a, b))
        assert a == b, (op, args, a, b)
        return a

    def counters_equal(self) -> None:
        for name in ("hits_total", "misses_total", "evictions_total",
                     "nbytes"):
            assert getattr(self.ref, name) == getattr(self.port, name), name
        assert len(self.ref) == len(self.port)
        assert self.ref.lengths() == self.port.lengths()
        assert ({e.ids for e in self.ref.snapshot()}
                == {e.ids for e in self.port.snapshot()})


def test_store_observe_match_and_lru_match_reference():
    pair = _Pair(grain_ladder=(4, 8, 16), promote_after=2, max_entries=3)
    rng = np.random.default_rng(0)
    heads = [list(rng.integers(0, 50, 20)) for _ in range(5)]
    for rnd in range(3):
        for h in heads:
            ids = h[:12] + list(rng.integers(0, 50, 5))
            got = pair.same("observe", ids)
            if got is not None:
                pair.put(got)
            pair.same("match", ids)
            pair.same("match", h[:3])           # too short for any entry
            pair.counters_equal()
    assert pair.port.evictions_total > 0 and len(pair.port) == 3


def test_store_byte_budget_cost_eviction_matches_reference():
    pair = _Pair(grain_ladder=(4,), max_bytes=1000, max_entries=64)
    now = time.monotonic()
    # (ids, bytes, idle seconds): the big stale entry goes first.
    for i, (n, idle) in enumerate(((600, 100.0), (200, 50.0), (100, 1.0),
                                   (300, 10.0))):
        pair.put([i] * 6, n, last_used=now - idle)
        pair.counters_equal()
    assert pair.port.evictions_total == 1
    assert {len(e.ids) for e in pair.port.snapshot()} == {6}
    assert [0] * 6 not in [list(e.ids) for e in pair.port.snapshot()]


def test_token_hash_and_cost_evict_match_reference():
    ids = [256, 1, 2, 300, 511]
    assert prefix.token_hash(ids) == ref_prefix.token_hash(ids)
    entry = prefix.PrefixEntry(ids=tuple(ids), k=torch.zeros(3),
                               v=torch.zeros(3))
    assert entry.token_hash == ref_prefix.token_hash(ids)
    assert entry.nbytes == 24 and entry.length == 5
    items = [("a", 100, 0.0), ("b", 400, 5.0), ("c", 50, 9.0),
             ("d", 10, 1.0)]
    for over in (0, 60, 420, 1000):
        assert (prefix.cost_evict(items, over, now=10.0)
                == ref_tier.cost_evict(items, over, now=10.0))


# -- admission against the JAX engine -----------------------------------------

TEMPLATE_MSGS = ("are we still on for lunch tomorrow at noon?",
                 "thanks for the notes from the planning call")
HEAD = "z y x w v u t s r q " * 5          # 100 chars: grain 64 promotes


def _ctx(engine, prompt, ref: bool) -> list:
    if ref:
        stats = RefStats()
        ref_collect(engine, RefRequest(prompt=prompt,
                                       options=RefOptions(max_tokens=10)),
                    stats)
    else:
        stats = RequestStats()
        collect(engine, GenerateRequest(
            prompt=prompt, options=GenerateOptions(max_tokens=10)), stats)
    return stats.context


def _wait(pred, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline
        time.sleep(0.02)


def test_prefix_admission_matches_reference_engine():
    assert SUGGEST_PREFIX == REF_SUGGEST
    rcfg = ref_config("tiny")
    params = quote_params(rcfg, jax.random.PRNGKey(5), quantized=True)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    cfg = get_config("tiny")
    common = dict(num_slots=2, max_seq=256, page_size=16, kv_quant=True)
    ref_engine = TPUEngine(params, rcfg, RefByteTokenizer(rcfg.vocab_size),
                           kv_mode="paged", prefix_cache=True,
                           decode_fuse_max=1, prefill_chunk=0, **common)
    engines = {C: TorchEngine(tparams, cfg, ByteTokenizer(cfg.vocab_size),
                              prefill_chunk=C, kv_mode="paged",
                              device="cpu", **common)
               for C in (0, 16)}
    server = OllamaServer(engines[0], addr="127.0.0.1:0").start()
    try:
        P = ref_engine.scheduler.register_prefix(REF_SUGGEST)
        for engine in engines.values():
            engine.warmup((16,))                # registers the template
            _wait(engine.ready)
            assert engine.scheduler._prefix.lengths() == [P]
        prompts = [SUGGEST_PREFIX + m for m in TEMPLATE_MSGS]
        prompts += [HEAD + tail for tail in ("alpha", "beta", "gamma")]
        for i, prompt in enumerate(prompts):
            want = _ctx(ref_engine, prompt, ref=True)
            for engine in engines.values():
                assert _ctx(engine, prompt, ref=False) == want, (i, prompt)
            if i == 3:      # the head's 2nd sighting queued its promotion
                for engine in engines.values():
                    _wait(lambda e=engine: len(e.scheduler._prefix) == 2)
        for C, engine in engines.items():
            snap = engine.metrics_snapshot()
            # 2 template prompts + the 3rd head prompt via its promotion.
            assert snap["serve_prefix_admits_total"] == 3, C
            assert snap["serve_prefix_entries"] == 2
            assert snap["prefix_hits_total"] == 3
            assert (snap["prefill_chunks_total"] > 0) == (C > 0)
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        assert "serve_prefix_admits_total 3" in text
        status = json.loads(urllib.request.urlopen(
            server.url + "/readyz", timeout=30).read().decode())
        assert status["status"] == "ready"
    finally:
        server.stop()
        ref_engine.stop()
        for engine in engines.values():
            engine.stop()
