"""The system under test: the port's engine, built from a configuration
file and fed the benchmark's seeded weights through the port's own
quantization (``models.quant.quantize_params``), a layer at a time, so
the bf16 model is never resident (Mixtral's is 93 GB).

This is the one module of the benchmark that imports the port besides
the harness's use of the engine it returns.
"""

from __future__ import annotations

import torch

from p2p_llm_chat_tpu_torch.models.configs import ModelConfig
from p2p_llm_chat_tpu_torch.models.quant import quantize_params
from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX, TorchEngine
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

from .reference import weights
from .reference.weights import Shape

__all__ = ["SUGGEST_PREFIX", "model_config", "params", "engine"]


def model_config(name: str, hf: dict, max_seq: int) -> ModelConfig:
    """The port's ``ModelConfig`` of a published ``config.json``."""
    s = Shape.from_hf(hf)
    return ModelConfig(
        name=name, vocab_size=s.vocab, hidden_size=s.hidden,
        intermediate_size=s.intermediate, num_layers=s.layers,
        num_heads=s.heads, num_kv_heads=s.kv_heads, head_dim=s.head_dim,
        max_seq_len=max(max_seq, hf.get("max_position_embeddings", 0)),
        rope_theta=s.rope_theta, rope_scaling=None, rms_norm_eps=s.rms_eps,
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        num_experts=s.experts, num_experts_per_tok=s.experts_per_tok,
        moe_capacity_factor=None, bos_token_id=hf["bos_token_id"],
        eos_token_ids=(hf["eos_token_id"],))


def _put(bufs: dict, name: str, lead: tuple, at: tuple, leaf) -> None:
    """Write a quantized (or plain) leaf of one layer (or expert) at
    ``at`` into its stacked buffer ``[*lead, ...]``, allocated on first
    use."""
    if name not in bufs:
        if hasattr(leaf, "q"):
            bufs[name] = type(leaf)(
                q=torch.empty((*lead, *leaf.q.shape[len(at):]),
                              dtype=leaf.q.dtype, device=leaf.q.device),
                s=torch.empty((*lead, *leaf.s.shape[len(at):]),
                              dtype=leaf.s.dtype, device=leaf.s.device))
        else:
            bufs[name] = torch.empty((*lead, *leaf.shape[len(at):]),
                                     dtype=leaf.dtype, device=leaf.device)
    if hasattr(leaf, "q"):
        bufs[name].q[at] = leaf.q[(0,) * len(at)]
        bufs[name].s[at] = leaf.s[(0,) * len(at)]
    else:
        bufs[name][at] = leaf[(0,) * len(at)]


def _quantized(name: str, w: torch.Tensor, mode: str, lead: int):
    """One leaf through the port's quantization, with ``lead`` size-1
    axes in front (1: a layer of a stacked dense leaf, 2: an expert of a
    stacked expert pool, as ``quantize_params`` tells them apart)."""
    t = w[(None,) * lead]
    return quantize_params({name: t}, mode)[name] if mode else t


def params(hf: dict, mode: str, seed: int, device) -> dict:
    """The port's fused, layer-stacked tree of the seeded weights."""
    s = Shape.from_hf(hf)
    L = s.layers
    bufs: dict = {}
    norms = {k: torch.ones((L, s.hidden), dtype=torch.bfloat16,
                           device=device) for k in ("attn_norm", "mlp_norm")}
    for li in range(L):
        a = weights.attention(s, seed, li, device)
        _put(bufs, "wqkv", (L,), (li,), _quantized(
            "wqkv", torch.cat([a["wq"], a["wk"], a["wv"]], dim=1), mode, 1))
        _put(bufs, "wo", (L,), (li,), _quantized("wo", a["wo"], mode, 1))
        del a
        if s.experts:
            _put(bufs, "router", (L,), (li,),
                 weights.router(s, seed, li, device)[None])
            for e in range(s.experts):
                m = weights.mlp(s, seed, li, device, e)
                _put(bufs, "wgu_e", (L, s.experts), (li, e), _quantized(
                    "wgu_e", torch.cat([m["w_gate"], m["w_up"]], dim=1),
                    mode, 2))
                _put(bufs, "w_down", (L, s.experts), (li, e),
                     _quantized("w_down", m["w_down"], mode, 2))
                del m
        else:
            m = weights.mlp(s, seed, li, device)
            _put(bufs, "wgu", (L,), (li,), _quantized(
                "wgu", torch.cat([m["w_gate"], m["w_up"]], dim=1), mode, 1))
            _put(bufs, "w_down", (L,), (li,),
                 _quantized("w_down", m["w_down"], mode, 1))
            del m
    head = weights.lm_head(s, seed, device)
    return {"embed": weights.embed(s, seed, device),
            "layers": {**norms, **bufs},
            "final_norm": torch.ones((s.hidden,), dtype=torch.bfloat16,
                                     device=device),
            "lm_head": _quantized("lm_head", head, mode, 0)}


def engine(tree: dict, config: ModelConfig, settings: dict,
           device) -> TorchEngine:
    """The engine on the main path's settings (the traffic file may
    override them)."""
    return TorchEngine(tree, config, ByteTokenizer(vocab_size=config.vocab_size),
                       device=device, **settings)
