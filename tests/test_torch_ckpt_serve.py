"""The checkpoint path end to end on the CPU: an HF directory written by
the test from quote-workload weights (models/synth.quote_params, whose
greedy margins are clear) and a BPE tokenizer trained with llama3's
specials, served through ``CKPT_DIR``:

- prefill logits of the port's streamed int8 tree within 1e-4 of the
  logit scale (f32 activations; f32 reduction order only) of the JAX
  package's on the same directory;
- greedy ``context`` ids of the ``CKPT_DIR`` engine identical to the JAX
  engine's over the same directory (plain prompts and the llama3 chat
  template), through the Ollama front;
- ``CKPT_DIR`` with ``SERVE_MODELS`` (the checkpoint the default entry),
  the bf16 load (``SERVE_QUANT=""``), and the fallback to load + quantize
  when the streamed loader refuses the family.
"""

import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models import weights as ref_weights
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.llama import KVCache
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest,
                                            RequestStats as RefStats,
                                            collect as ref_collect)
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import load_tokenizer as ref_load_tokenizer
from p2p_llm_chat_tpu_torch.models import llama, weights
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.quant import QTensor
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env
from p2p_llm_chat_tpu_torch.serve.multi import MultiBackend
from p2p_llm_chat_tpu_torch.tokenizer import BPETokenizer
from tests.test_torch_tokenizer import CORPUS, LLAMA3_PATTERN
from tests.test_torch_weights import (assert_trees_bitwise,
                                      hf_tensors_from_tree, write_hf_dir)

tokenizers = pytest.importorskip("tokenizers")

torch.set_num_threads(2)
pytestmark = pytest.mark.model

SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
            "<|end_header_id|>", "<|eot_id|>"]
PROMPTS = ("hello world", "The quick brown fox jumps over 123 dogs.")
CHAT = [{"role": "user", "content": "are we still on for lunch?"}]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(directory, its BPE tokenizer): ``tiny`` widths, quote weights, a
    tokenizer of < 512 ids with llama3's specials after its merges."""
    tk = tokenizers.Tokenizer(tokenizers.models.BPE())
    tk.pre_tokenizer = tokenizers.pre_tokenizers.Sequence([
        tokenizers.pre_tokenizers.Split(
            tokenizers.Regex(LLAMA3_PATTERN), behavior="isolated"),
        tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=False,
                                            use_regex=False)])
    tk.train_from_iterator(CORPUS, tokenizers.trainers.BpeTrainer(
        vocab_size=400, show_progress=False,
        initial_alphabet=tokenizers.pre_tokenizers.ByteLevel.alphabet()))
    tk.add_special_tokens([tokenizers.AddedToken(s, normalized=False,
                                                 special=True)
                           for s in SPECIALS])
    tok_file = str(tmp_path_factory.mktemp("tok") / "tokenizer.json")
    tk.save(tok_file)
    tok = BPETokenizer.from_file(tok_file)
    assert tok.vocab_size <= 512
    cfg = get_config("tiny").with_(
        bos_token_id=tok.bos_id,
        eos_token_ids=(tok.eos_id, tok.encode("<|eot_id|>")[0]))
    params = quote_params(ref_config("tiny"), jax.random.PRNGKey(5),
                          dtype=jnp.float32)
    d = write_hf_dir(tmp_path_factory.mktemp("quote-ckpt"),
                     hf_tensors_from_tree(params, cfg), cfg,
                     dtype=torch.bfloat16, n_shards=2, tokenizer=tok_file)
    return d, tok


def _f32(tree):
    """Plain bf16 leaves as f32 (f32 activations); quantized leaves as
    they are."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, QTensor) or hasattr(tree, "q"):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.float()
    return tree.astype(jnp.float32)


def test_prefill_logits_match_the_jax_package(ckpt):
    d, tok = ckpt
    got, cfg = weights.load_checkpoint_quantized(d, device="cpu")
    want, ref_cfg = ref_weights.load_checkpoint_quantized(d)
    prompts = [tok.encode(p, add_bos=True) for p in PROMPTS]
    S = 32
    toks = np.zeros((len(prompts), S), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    ref_logits, _ = ref_llama.prefill(
        _f32(want), ref_cfg, jnp.asarray(toks), jnp.asarray(lens),
        KVCache.create(ref_cfg, len(prompts), S, dtype=jnp.float32),
        last_only=True)
    logits, _, _ = llama.prefill(_f32(got), cfg,
                                 torch.from_numpy(toks).long(),
                                 torch.from_numpy(lens), last_only=True)
    ref_logits = np.asarray(ref_logits)
    scale = float(np.abs(ref_logits).max())
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-4,
                               atol=1e-4 * scale)
    assert (logits.numpy().argmax(-1) == ref_logits.argmax(-1)).all()


def _env(monkeypatch, **kw):
    base = dict(SERVE_DEVICE="cpu", SERVE_QUANT="int8", SERVE_KV="paged",
                SERVE_KV_QUANT="int8", SERVE_SLOTS="2", SERVE_MAX_SEQ="128",
                SERVE_WARMUP="16", SERVE_PREFILL_CHUNK="0")
    base.update(kw)
    for k, v in base.items():
        monkeypatch.setenv(k, v)
    for k in ("SERVE_MODELS", "MODEL_CONFIG", "SERVE_KV_HOST_GB"):
        if k not in kw:
            monkeypatch.delenv(k, raising=False)


def _wait_ready(backend) -> None:
    deadline = time.monotonic() + 120
    while not backend.ready():
        assert backend.warmup_error is None
        assert time.monotonic() < deadline
        time.sleep(0.02)


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _ref_contexts(d, prompts) -> list:
    params, cfg = ref_weights.load_checkpoint_quantized(d)
    engine = TPUEngine(params, cfg, ref_load_tokenizer(d, cfg.vocab_size),
                       num_slots=2, max_seq=128, kv_mode="paged",
                       page_size=16, kv_quant=True, prefix_cache=False,
                       decode_fuse_max=1, prefill_chunk=0)
    try:
        out = []
        for p in prompts:
            stats = RefStats()
            ref_collect(engine, RefRequest(
                prompt=p, options=RefOptions(max_tokens=16)), stats)
            out.append(stats.context)
        chat = engine.render_chat(CHAT)
        return out, chat
    finally:
        engine.stop()


def test_ckpt_dir_engine_greedy_equals_the_jax_engine(ckpt, monkeypatch):
    d, tok = ckpt
    _env(monkeypatch, CKPT_DIR=d, LLM_MODEL="quote", SERVE_PAGE_SIZE="16")
    engine = build_engine_from_env()
    srv = OllamaServer(engine, addr="127.0.0.1:0").start()
    try:
        _wait_ready(engine)
        assert engine.name == "quote" and engine.load_stats is not None
        assert isinstance(engine.scheduler.tokenizer, BPETokenizer)
        assert "wqkv" in engine.scheduler._params["layers"]
        chat = engine.render_chat(CHAT)
        assert chat.startswith("<|start_header_id|>user<|end_header_id|>")
        got = [_post(srv.url + "/api/generate",
                     {"model": "quote", "prompt": p, "stream": False,
                      "options": {"num_predict": 16}})["context"]
               for p in PROMPTS + (chat,)]
        rec = _post(srv.url + "/api/chat",
                    {"model": "quote", "messages": CHAT, "stream": False,
                     "options": {"num_predict": 4}})
        assert rec["prompt_eval_count"] == len(tok.encode(chat,
                                                          add_bos=True))
    finally:
        srv.stop()
        engine.stop()
    want, ref_chat = _ref_contexts(d, PROMPTS + (chat,))
    assert ref_chat == chat
    assert got == want
    ids = got[-1]
    assert ids[0] == tok.bos_id
    for special in ("<|start_header_id|>", "<|end_header_id|>",
                    "<|eot_id|>"):
        assert tok.encode(special)[0] in ids
    assert len(ids) > len(tok.encode(chat, add_bos=True))


def test_ckpt_dir_beside_serve_models(ckpt, monkeypatch):
    d, tok = ckpt
    _env(monkeypatch, CKPT_DIR=d, LLM_MODEL="main", SERVE_MODELS="small=tiny")
    multi = build_engine_from_env()
    try:
        _wait_ready(multi)
        assert isinstance(multi, MultiBackend)
        assert multi.models() == ["main", "small"] and multi.default == "main"
        main, small = multi.backends["main"], multi.backends["small"]
        assert isinstance(main.scheduler.tokenizer, BPETokenizer)
        assert not isinstance(small.scheduler.tokenizer, BPETokenizer)
        assert main.load_stats is not None and small.load_stats is None
        assert multi.for_model("other") is main
    finally:
        multi.stop()


def test_bf16_load_and_quantize_fallback(ckpt, monkeypatch):
    d, _ = ckpt
    _env(monkeypatch, CKPT_DIR=d, SERVE_QUANT="", SERVE_KV_QUANT="",
         SERVE_WARMUP="0")
    engine = build_engine_from_env()
    try:
        plain, _ = weights.load_checkpoint(d, device="cpu")
        assert_trees_bitwise(engine.scheduler._params,
                             llama.fuse_params(plain))
    finally:
        engine.stop()

    def refuse(*a, **k):
        raise weights.UnsupportedForQuantizedLoad("out of scope")

    monkeypatch.setattr(weights, "load_checkpoint_quantized", refuse)
    _env(monkeypatch, CKPT_DIR=d, SERVE_QUANT="int4", SERVE_WARMUP="0")
    engine = build_engine_from_env()
    try:
        monkeypatch.undo()
        streamed, _ = weights.load_checkpoint_quantized(d, quant="int4",
                                                        device="cpu")
        assert_trees_bitwise(engine.scheduler._params, streamed)
    finally:
        engine.stop()
