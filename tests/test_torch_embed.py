"""The port's embedding path (``/api/embed``) against the reference's.

- ``embed_pooled`` (models/llama.py, models/mixtral.py) on the same
  weights carried across with models/convert: ``tiny`` with bf16 weights
  and with int8 weights, ``tiny-moe`` with int8 weights, over a batch
  with mixed lengths, a 1-token text and a pad row. Tolerances: with f32
  activations (the int8 trees) 1e-4 absolute on the unit vectors — the
  prefill parity tests' f32 tolerance (tests/test_torch_llama.py: f32
  reduction order only; measured ~1e-7); with bf16 activations 2e-2 of
  the largest component — bf16 rounds each op's result at 2^-8 relative
  and the two packages round at different places (measured 1.0e-2).
- ``TorchEngine.embed`` against the JAX engine's ``embed`` over 17 texts
  (two chunks: 16 rows, then one text padded to R = 2), on ``tiny`` and
  on ``tiny-moe`` with a bounding capacity factor, so expert capacity
  comes from the padded R*S and the port must bucket as the reference
  does; 1e-4 absolute (f32 activations), and equal token counts.
- FakeLLM's hash vectors bitwise equal to the reference FakeLLM's.
- Embeds from four threads during a greedy stream change neither the
  stream nor any vector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models import mixtral as ref_mixtral
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.serve.backend import FakeLLM as RefFake
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.models import llama, mixtral
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.serve.backend import FakeLLM
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine, embed_batches
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)
pytestmark = pytest.mark.model

F32_TOL = 1e-4
BF16_TOL = 2e-2

TEXTS = ["hello", "", "how are you doing today?", "a"] + [
    f"message {i}: " + "lunch " * i for i in range(13)]


def _port_params(params):
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def _batch():
    """Lengths 5, 12 and 1 plus a pad row (len 1), right-padded to 16."""
    rng = np.random.default_rng(3)
    lens = np.array([5, 12, 1, 1], np.int32)
    toks = np.zeros((4, 16), np.int32)
    for r, n in enumerate(lens[:3]):
        toks[r, :n] = rng.integers(3, 500, n)
    return toks, lens


@pytest.mark.parametrize("config,weights", [("tiny", "bf16"),
                                            ("tiny", "int8"),
                                            ("tiny-moe", "int8")])
def test_embed_pooled_matches_reference(config, weights):
    cfg_ref = ref_config(config)
    key = jax.random.PRNGKey(0)
    ref_mod, mod = ((ref_mixtral, mixtral) if cfg_ref.is_moe
                    else (ref_llama, llama))
    if weights == "bf16":
        params = ref_mod.init_params(cfg_ref, key, dtype=jnp.bfloat16)
    else:
        params = ref_mod.init_params_quantized(cfg_ref, key,
                                               dtype=jnp.float32)
    toks, lens = _batch()
    want = np.asarray(ref_mod.embed_pooled(params, cfg_ref,
                                           jnp.asarray(toks),
                                           jnp.asarray(lens)))
    got = mod.embed_pooled(mod.fuse_params(_port_params(params)),
                           get_config(config), torch.from_numpy(toks).long(),
                           torch.from_numpy(lens)).numpy()
    assert got.shape == (4, cfg_ref.hidden_size) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    atol = F32_TOL if weights == "int8" else BF16_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_embed_batches_bucket_as_the_reference():
    ids = [[1] * n for n in (3, 17, 1)] + [[1, 2]] * 14
    got = [(n, tuple(t.shape), l.tolist()) for n, t, l in
           embed_batches(ids, 128)]
    assert got[0][:2] == (16, (16, 32))
    assert got[1] == (1, (2, 16), [2, 1])
    assert got[0][2][:3] == [3, 17, 1]


@pytest.mark.parametrize("config", ["tiny", "tiny-moe"])
def test_engine_embed_matches_the_jax_engine(config):
    # tiny-moe with a bounding capacity factor: the expert capacity comes
    # from the padded R*S of each chunk.
    over = {"moe_capacity_factor": 1.0} if config == "tiny-moe" else {}
    cfg_ref = ref_config(config).with_(**over)
    ref_mod = ref_mixtral if cfg_ref.is_moe else ref_llama
    params = ref_mod.init_params_quantized(cfg_ref, jax.random.PRNGKey(1),
                                           dtype=jnp.float32)
    ref_engine = TPUEngine(params, cfg_ref,
                           RefByteTokenizer(cfg_ref.vocab_size), num_slots=2,
                           max_seq=128, kv_mode="paged", page_size=16,
                           prefix_cache=False)
    engine = TorchEngine(_port_params(params), get_config(config).with_(
        **over), ByteTokenizer(cfg_ref.vocab_size), num_slots=2,
        max_seq=128, page_size=16, prefix_cache=False, device="cpu")
    try:
        want, want_n = ref_engine.embed(TEXTS)
        got, got_n = engine.embed(TEXTS)
    finally:
        ref_engine.stop()
        engine.stop()
    assert len(got) == len(TEXTS) == 17 and got_n == want_n
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0,
                               atol=F32_TOL)


def test_fake_llm_vectors_bitwise_equal_the_reference():
    texts = ["hello", "", "héllo wörld", "a b c"]
    assert FakeLLM().embed(texts) == RefFake().embed(texts)


def test_concurrent_embeds_change_no_stream_and_no_vector():
    """Embeds from four threads (more than the two torch threads) while a
    greedy stream decodes, with a short switch interval: the stream and
    every vector equal what each gives alone."""
    import sys
    import threading

    from p2p_llm_chat_tpu_torch.models.llama import init_params_quantized
    from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                      GenerateRequest)
    cfg = get_config("tiny")
    engine = TorchEngine(init_params_quantized(cfg, quant="int8",
                                               device="cpu"), cfg,
                         ByteTokenizer(cfg.vocab_size), num_slots=2,
                         max_seq=128, page_size=16, device="cpu")
    req = GenerateRequest(prompt="the quick brown fox",
                          options=GenerateOptions(max_tokens=32))
    texts = TEXTS[:6]
    saved = sys.getswitchinterval()
    try:
        alone_text = "".join(engine.generate_stream(req))
        alone_vecs = engine.embed(texts)[0]
        sys.setswitchinterval(1e-5)
        out: dict = {}

        def embed(i: int) -> None:
            out[i] = [engine.embed(texts)[0] for _ in range(2)]

        def decode() -> None:
            out["text"] = "".join(engine.generate_stream(GenerateRequest(
                prompt=req.prompt, options=req.options)))

        threads = [threading.Thread(target=embed, args=(i,))
                   for i in range(4)] + [threading.Thread(target=decode)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
        engine.stop()
    assert out["text"] == alone_text
    for i in range(4):
        for vecs in out[i]:
            np.testing.assert_allclose(np.array(vecs), np.array(alone_vecs),
                                       rtol=0, atol=1e-6)
