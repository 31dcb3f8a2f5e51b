"""The port's resident draft model (serve/draft_model.py) against the
reference's, on the CPU.

Weights: the reference's freeform pair (models/synth.quote_params with
``mode="freeform"``): llama ``tiny`` as the target and a 1-layer copy as
the drafter share one 95-token successor cycle, so the drafter predicts
the target and argmax has no near-ties; f32 activations, carried across
through numpy.

- ``draft_batch`` / ``draft_tree_batch``: the same proposals as the
  reference drafter's after the same admission and context (drafts and
  runner-up tokens exactly, top-1/top-2 gaps within 1e-4 of the logit
  scale), for a fresh admission, a long catch-up past one feed and a
  rollback;
- ``observe`` rollback: after a partial acceptance the next proposals
  equal a fresh drafter's fed the whole context;
- greedy output with the drafter on is bitwise the output with it off
  (dense and paged targets, tree and linear), equal to the JAX engine's
  with its drafter, and the model source's drafts are accepted;
- ``SERVE_DRAFT`` from the env: a checkpoint directory loads at
  ``SERVE_QUANT`` (int8 leaves), a config name random-inits at the
  target's vocabulary, and a directory that fails to load or an unknown
  name leaves n-gram-only speculation (the reference's degrade).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest,
                                            RequestStats as RefStats,
                                            collect as ref_collect)
from p2p_llm_chat_tpu.serve.draft_model import ModelDrafter as RefDrafter
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats, collect)
from p2p_llm_chat_tpu_torch.serve.draft_model import ModelDrafter
from p2p_llm_chat_tpu_torch.models.quant import QTensor
from p2p_llm_chat_tpu_torch.serve.engine import (TorchEngine,
                                                 build_engine_from_env)
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
from tests.test_torch_weights import (random_hf_tensors, tiny_cfg,
                                      write_hf_dir)

torch.set_num_threads(2)
pytestmark = pytest.mark.model

K = 4
PROMPT = "Tell me something new about the harbor lights"


@pytest.fixture(scope="module")
def pair():
    rcfg = ref_config("tiny")
    rdcfg = rcfg.with_(num_layers=1, name="tiny-draft", max_seq_len=1024)
    target = quote_params(rcfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                          mode="freeform")
    draft = quote_params(rdcfg, jax.random.PRNGKey(1), dtype=jnp.float32,
                         mode="freeform")
    cfg = get_config("tiny")
    dcfg = cfg.with_(num_layers=1, name="tiny-draft", max_seq_len=1024)

    def port(p):
        return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")

    return dict(rcfg=rcfg, rdcfg=rdcfg, target=target, draft=draft, cfg=cfg,
                dcfg=dcfg, target_t=port(target), draft_t=port(draft))


def _drafters(p, max_seq=512):
    ours = ModelDrafter(p["draft_t"], p["dcfg"], num_slots=3,
                        max_seq=max_seq, k=K)
    ref = RefDrafter(p["draft"], p["rdcfg"], num_slots=3, max_seq=max_seq,
                     k=K)
    return ours, ref


def _same_tree(got, want, scale) -> None:
    assert got.keys() == want.keys()
    for row in got:
        d, sec, gap = got[row]
        rd, rsec, rgap = want[row]
        assert d == [int(t) for t in rd]
        assert sec == [int(t) for t in rsec]
        np.testing.assert_allclose(gap, rgap, rtol=0, atol=1e-4 * scale)


def test_proposals_equal_the_reference_drafter(pair):
    ours, ref = _drafters(pair)
    tok = ByteTokenizer(pair["cfg"].vocab_size)
    prompts = {0: tok.encode(PROMPT, add_bos=True),
               2: tok.encode("a different opening, longer than the first "
                             "one by a good margin", add_bos=True)}
    rows = sorted(prompts)
    ours.prefill(rows, prompts)
    ref.prefill(rows, prompts)
    # Each row's first sampled token is pending (the drafter has fed the
    # prompt only).
    ctxs = {r: (prompts[r], [65 + r]) for r in rows}
    got = ours.draft_tree_batch(rows, ctxs)
    want = ref.draft_tree_batch(rows, ctxs)
    assert sorted(got) == rows
    _same_tree(got, want, 40.0)
    # Accept two of row 0's drafts and none of row 2's; the emitted
    # tokens join the contexts (accepted drafts, then a correction).
    for d in (ours, ref):
        d.observe(0, 2)
        d.observe(2, 0)
    ctxs[0] = (prompts[0], [65] + got[0][0][:2] + [77])
    ctxs[2] = (prompts[2], [67, 33])
    assert ours.draft_batch(rows, ctxs) == {
        r: [int(t) for t in v] for r, v in ref.draft_batch(rows,
                                                           ctxs).items()}
    # Row 1 admitted late with a context longer than one 256-wide feed:
    # the catch-up runs chunked feeds first.
    long_ctx = (prompts[0] * 8)[:300]
    ours.prefill([1], {1: long_ctx[:10]})
    ref.prefill([1], {1: long_ctx[:10]})
    ctx1 = {1: (long_ctx[:10], long_ctx[10:])}
    got = ours.draft_tree_batch([1], ctx1)
    assert list(got) == [1]
    _same_tree(got, ref.draft_tree_batch([1], ctx1), 40.0)
    # Feeds: the two admissions and one 256-wide catch-up.
    assert ours.n_feed_dispatches == 3 and ours.n_draft_dispatches == 3


def test_observe_rollback_equals_a_fresh_drafter(pair):
    ours, _ = _drafters(pair)
    tok = ByteTokenizer(pair["cfg"].vocab_size)
    prompt = tok.encode(PROMPT, add_bos=True)
    ours.prefill([0], {0: prompt})
    first = ours.draft_batch([0], {0: (prompt, [70])})[0]
    ours.observe(0, 1)                 # one draft accepted, then a fix
    ids = [70] + first[:1] + [101]
    again = ours.draft_batch([0], {0: (prompt, ids)})[0]
    fresh, _ = _drafters(pair)
    fresh.prefill([0], {0: prompt + ids[:-1]})
    assert fresh.draft_batch([0], {0: (prompt, ids)})[0] == again
    ours.reset()
    assert ours._fed == [0, 0, 0]


def _context(engine, prompt, max_tokens=48):
    stats = RequestStats()
    collect(engine, GenerateRequest(prompt=prompt, options=GenerateOptions(
        max_tokens=max_tokens)), stats)
    return stats.context


@pytest.mark.parametrize("kv_mode,nodes", [("dense", 8), ("dense", 0),
                                           ("paged", 8)])
def test_greedy_with_the_drafter_equals_without(pair, kv_mode, nodes):
    cfg = pair["cfg"]
    kw = dict(num_slots=2, max_seq=128, kv_mode=kv_mode, prefix_cache=False,
              prefill_chunk=0, device="cpu")
    on = TorchEngine(pair["target_t"], cfg, ByteTokenizer(cfg.vocab_size),
                     spec_k=K, spec_tree_nodes=nodes,
                     draft=(pair["draft_t"], pair["dcfg"]), **kw)
    off = TorchEngine(pair["target_t"], cfg, ByteTokenizer(cfg.vocab_size),
                      **kw)
    rcfg = pair["rcfg"]
    ref = TPUEngine(pair["target"], rcfg, RefByteTokenizer(rcfg.vocab_size),
                    num_slots=2, max_seq=128, kv_mode="dense",
                    prefix_cache=False, prefill_chunk=0, spec_k=K,
                    spec_tree_nodes=nodes, draft=(pair["draft"],
                                                  pair["rdcfg"]))
    try:
        assert on.drafter is not None
        # The warmup builds the drafter's steady-state programs (buckets 4
        # and 8 at every window) through the scheduler's hook.
        on.warmup((16, 32), background=False)
        assert {k for k in on.scheduler._programs if k[0] == "draft"} == {
            ("draft", M, W) for M in (4, 8) for W in (128,)}
        for prompt in (PROMPT, "Another line with nothing repeated in it"):
            got = _context(on, prompt)
            assert got == _context(off, prompt), prompt
            stats = RefStats()
            ref_collect(ref, RefRequest(prompt=prompt, options=RefOptions(
                max_tokens=48)), stats)
            assert got == stats.context, prompt
        snap = on.metrics_snapshot()
        assert snap['serve_spec_accepted_total{source="model"}'] > 0
        assert snap['serve_spec_accepted_per_dispatch{source="model"}'] > 1
    finally:
        on.stop()
        off.stop()
        ref.stop()


def test_serve_draft_from_the_env(tmp_path, monkeypatch):
    for k, v in dict(SERVE_DEVICE="cpu", SERVE_WARMUP="0",
                     MODEL_CONFIG="tiny", SERVE_QUANT="int8",
                     SERVE_SPEC="4").items():
        monkeypatch.setenv(k, v)
    for k in ("SERVE_KV", "SERVE_KV_QUANT", "SERVE_KV_HOST_GB", "CKPT_DIR",
              "SERVE_MODELS"):
        monkeypatch.delenv(k, raising=False)
    dcfg = tiny_cfg().with_(vocab_size=512, num_layers=1)
    ckpt = write_hf_dir(str(tmp_path / "draft"), random_hf_tensors(dcfg),
                        dcfg)
    cases = ((ckpt, "model"), ("tiny-moe", "model"),
             (str(tmp_path / "missing") + "/", None), ("no-such", None))
    for ref, source in cases:
        monkeypatch.setenv("SERVE_DRAFT", ref)
        engine = build_engine_from_env()
        try:
            names = [s.name for s in engine.scheduler._sources]
            assert names == ["ngram"] + ([source] if source else []), ref
            if ref == ckpt:
                d = engine.drafter
                assert d.config.num_layers == 1
                assert isinstance(d._params["layers"]["wqkv"], QTensor)
        finally:
            engine.stop()
