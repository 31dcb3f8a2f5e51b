"""The port's checkpoint writer (models/weights.save_checkpoint): the
counterpart of the reference's native ``save_checkpoint``, writing an HF
safetensors directory the port's loaders read.

At tiny width, for dense llama (``tiny``) and mixtral (``tiny-moe``), on
the CPU:

1. the JAX package's ``quote_params`` (bf16, the reference's unfused
   layout) as numpy, carried across with models/convert.params_from_numpy
   and written by the writer (small shards, so the walk crosses files);
2. ``load_checkpoint`` of the directory returns the carried tree bitwise;
3. ``load_checkpoint_quantized`` at int8 equals the port's quantization
   of the carried tree (quantize_params, then fuse_params) bitwise;
4. a ``CKPT_DIR`` engine (bf16 weights, paged int8 KV) answers greedy
   ``/api/generate`` requests through the Ollama front with the same
   ``context`` ids as an engine built on the carried tree.

Also: the written ``config.json`` reads back to the same config, a fused
tree writes the same directory bytes as its unfused form, and a quantized
tree is refused.
"""

import filecmp
import json
import os
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.synth import quote_params as ref_quote_params
from p2p_llm_chat_tpu_torch.models import family_for
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.models.quant import QTensor, quantize_params
from p2p_llm_chat_tpu_torch.models.weights import (config_from_hf_json,
                                                   load_checkpoint,
                                                   load_checkpoint_quantized,
                                                   save_checkpoint)
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env

torch.set_num_threads(2)
pytestmark = pytest.mark.model

MODELS = ("tiny", "tiny-moe")
PROMPTS = ("hello world", "are we still on for lunch tomorrow?")


@pytest.fixture(scope="module", params=MODELS)
def carried(request, tmp_path_factory):
    """(config name, the carried tree, its directory)."""
    name = request.param
    rparams = ref_quote_params(ref_config(name), jax.random.PRNGKey(0),
                               dtype=jnp.bfloat16)
    tree = params_from_numpy(jax.tree.map(np.asarray, rparams),
                             device="cpu")
    d = str(tmp_path_factory.mktemp(f"ckpt_{name}"))
    stats = save_checkpoint(d, tree, get_config(name), shard_bytes=300_000)
    assert stats["shards"] > 1
    assert stats["bytes"] == sum(a.nbytes for a in jax.tree.leaves(rparams))
    return name, tree, d


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, QTensor):
        assert type(got) is type(want), path
        _same(got.q, want.q, path + ".q")
        _same(got.s, want.s, path + ".s")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(got.view(torch.uint8) if got.dtype == torch.bfloat16
                       else got,
                       want.view(torch.uint8) if want.dtype == torch.bfloat16
                       else want), path


def test_load_checkpoint_returns_the_carried_tree(carried):
    name, tree, d = carried
    got, cfg = load_checkpoint(d, dtype=torch.bfloat16, device="cpu")
    _same(got, tree)
    want = get_config(name)
    assert cfg == config_from_hf_json(os.path.join(d, "config.json"))
    for field in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_layers", "num_heads", "num_kv_heads", "head_dim",
                  "max_seq_len", "rope_theta", "rope_scaling",
                  "rms_norm_eps", "tie_embeddings", "num_experts",
                  "num_experts_per_tok", "bos_token_id", "eos_token_ids",
                  "name"):
        assert getattr(cfg, field) == getattr(want, field), field


def test_quantized_load_equals_the_ports_quantization(carried):
    name, tree, d = carried
    got, _ = load_checkpoint_quantized(d, quant="int8", device="cpu")
    fam = family_for(get_config(name))
    want = fam.fuse_params(quantize_params(tree, mode="int8"))
    _same(got, want)


def test_a_fused_tree_writes_the_same_directory(carried, tmp_path):
    name, tree, d = carried
    fused = family_for(get_config(name)).fuse_params(tree)
    assert "wqkv" in fused["layers"]
    save_checkpoint(str(tmp_path), fused, get_config(name),
                    shard_bytes=300_000)
    files = sorted(os.listdir(d))
    assert files == sorted(os.listdir(tmp_path))
    match, mismatch, errors = filecmp.cmpfiles(d, str(tmp_path), files,
                                               shallow=False)
    assert mismatch == [] and errors == [], (mismatch, errors)
    with pytest.raises(TypeError, match="plain tree"):
        save_checkpoint(str(tmp_path / "q"),
                        quantize_params(tree, mode="int8"),
                        get_config(name))


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _contexts(monkeypatch, params=None, **env) -> list:
    base = dict(SERVE_DEVICE="cpu", SERVE_QUANT="", SERVE_KV="paged",
                SERVE_KV_QUANT="int8", SERVE_SLOTS="2", SERVE_MAX_SEQ="128",
                SERVE_PAGE_SIZE="16", SERVE_WARMUP="16",
                SERVE_PREFILL_CHUNK="0", SERVE_PREFIX="0")
    base.update(env)
    for k in ("SERVE_MODELS", "MODEL_CONFIG", "CKPT_DIR",
              "SERVE_KV_HOST_GB", "SERVE_SPEC"):
        monkeypatch.delenv(k, raising=False)
    for k, v in base.items():
        monkeypatch.setenv(k, v)
    engine = build_engine_from_env(params=params)
    srv = OllamaServer(engine, addr="127.0.0.1:0").start()
    try:
        deadline = time.monotonic() + 120
        while not engine.ready():
            assert engine.warmup_error is None
            assert time.monotonic() < deadline
            time.sleep(0.02)
        return [_post(srv.url + "/api/generate",
                      {"prompt": p, "stream": False,
                       "options": {"num_predict": 12, "temperature": 0}}
                      )["context"] for p in PROMPTS]
    finally:
        srv.stop()
        engine.stop()


def test_ckpt_dir_engine_answers_as_the_carried_tree(carried, monkeypatch):
    name, tree, d = carried
    got = _contexts(monkeypatch, CKPT_DIR=d, LLM_MODEL=name)
    want = _contexts(monkeypatch, params=tree, MODEL_CONFIG=name)
    assert got == want
    assert all(len(c) > len(p) for c, p in zip(got, PROMPTS))
