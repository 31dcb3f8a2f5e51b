"""Model configurations.

Sizes follow the published architectures for the model families named in
BASELINE.json (llama3.1 tags served via Ollama in the reference —
README.md:52, web/streamlit_app.py:28 — and Mixtral-8x7B for config 5).
``tiny``/``tiny-moe`` are test/CI sizes exercising the exact same code.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class RopeScaling:
    """llama3.1-style NTK-by-parts rope scaling."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScaling] = None
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE (0 experts => dense MLP)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    # GShard-style per-expert capacity factor for large prefill chunks:
    # bucket C = factor * tokens * k / num_experts. None = exact/dropless
    # (models/mixtral.py moe_mlp; decode is always exact).
    moe_capacity_factor: Optional[float] = None
    # token ids (llama3 defaults; byte tokenizer overrides)
    bos_token_id: int = 128000
    eos_token_ids: tuple[int, ...] = (128001, 128008, 128009)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


_LLAMA31_SCALING = RopeScaling(factor=8.0, low_freq_factor=1.0,
                               high_freq_factor=4.0, original_max_position=8192)

CONFIGS: dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


# -- llama family ------------------------------------------------------------

_register(ModelConfig(
    name="llama3.1-8b", vocab_size=128256, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=500000.0, rope_scaling=_LLAMA31_SCALING,
))

_register(ModelConfig(
    name="llama3.1-70b", vocab_size=128256, hidden_size=8192,
    intermediate_size=28672, num_layers=80, num_heads=64, num_kv_heads=8,
    head_dim=128, rope_theta=500000.0, rope_scaling=_LLAMA31_SCALING,
))

_register(ModelConfig(
    name="llama3.2-1b", vocab_size=128256, hidden_size=2048,
    intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
    head_dim=64, rope_theta=500000.0, rope_scaling=RopeScaling(factor=32.0),
    tie_embeddings=True,
))

_register(ModelConfig(
    name="llama3.2-3b", vocab_size=128256, hidden_size=3072,
    intermediate_size=8192, num_layers=28, num_heads=24, num_kv_heads=8,
    head_dim=128, rope_theta=500000.0, rope_scaling=RopeScaling(factor=32.0),
    tie_embeddings=True,
))

# -- Mixtral -----------------------------------------------------------------

_register(ModelConfig(
    name="mixtral-8x7b", vocab_size=32000, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=1e6, num_experts=8, num_experts_per_tok=2,
    moe_capacity_factor=2.0,
    bos_token_id=1, eos_token_ids=(2,), max_seq_len=32768,
))

# ~7.3B-total MoE config for single-chip benching at REAL expert scale:
# each expert is 3*4096*11520 ≈ 141.6M params — 16.4x bench-moe's 8.65M,
# Mixtral-8x7B-class expert width at Mixtral's 8-expert top-2 routing —
# with depth cut to 6 layers so the streamed quantized load fits a 16 GB
# chip next to its KV pool (int8 ≈ 7.3 GB, int4 ≈ 3.9 GB incl. group
# scales; 32 layers of these experts would be a 37B model, BASELINE.json
# config-5 territory — multi-chip). The per-layer MoE arithmetic the
# round-18 bench measures (expert weight streaming, wgu_e fusion,
# dispatch overheads) is layer-count-invariant, so 6 honest layers beat
# 32 unloadable ones. intermediate 11520 = 45*256 = 90*128: divisible
# for the expert-stripe kernels in BOTH int4 groupings (group 256 at
# ng=45 — the odd-count segment walk — and group 128 at ng=90), and by
# every w8a16 block candidate via 128.
_register(ModelConfig(
    name="mixtral-large", vocab_size=32000, hidden_size=4096,
    intermediate_size=11520, num_layers=6, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=1e6, num_experts=8, num_experts_per_tok=2,
    moe_capacity_factor=2.0,
    bos_token_id=1, eos_token_ids=(2,), max_seq_len=8192,
))

# -- test sizes (same code paths, CI-sized) ----------------------------------

_register(ModelConfig(
    name="tiny", vocab_size=512, hidden_size=128, intermediate_size=256,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=256,
    rope_theta=10000.0, bos_token_id=1, eos_token_ids=(2,),
))

_register(ModelConfig(
    name="tiny-moe", vocab_size=512, hidden_size=128, intermediate_size=256,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=256,
    rope_theta=10000.0, num_experts=4, num_experts_per_tok=2,
    bos_token_id=1, eos_token_ids=(2,),
))

# Loadgen CPU profile: ``tiny`` dims with a real context window, so the
# e2e long-context scenario (docs/loadtest.md) prefills thousands of
# tokens through chunked admission on CPU-class hosts instead of
# truncating at tiny's 256.
_register(ModelConfig(
    name="tiny-long", vocab_size=512, hidden_size=128,
    intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=32, max_seq_len=4096, rope_theta=10000.0,
    bos_token_id=1, eos_token_ids=(2,),
))

# Like ``tiny`` but every tp-sharded dim (heads, KV heads, mlp, vocab)
# divides a tp=4 mesh: the multi-chip dryrun validates SHARDED wk/wv/KV
# paths with it — `tiny`'s 2 kv heads at tp=4 silently fall back to
# replication (parallel/sharding.constrain), which would leave the
# sharded-KV path unexercised (the production 8B/70B configs' 8 kv heads
# divide their meshes).
_register(ModelConfig(
    name="tiny-tp", vocab_size=512, hidden_size=128, intermediate_size=256,
    num_layers=2, num_heads=4, num_kv_heads=4, head_dim=32, max_seq_len=256,
    rope_theta=10000.0, bos_token_id=1, eos_token_ids=(2,),
))

# ~1B-class dense config used by bench.py on a single v5e chip (fits HBM in
# bf16 with room for KV cache; same architecture family as the 8B).
# max_seq_len 16384: the long-context bench rows (BENCH_CTX 4k-12k,
# round-5) need headroom past the old 2048 cap; rope_theta 500000 (the
# llama3 base) is stable at these lengths, and actual KV allocation is
# sized per run (BENCH_MAX_SEQ / the scheduler's right-sized pool), so
# the cap costs nothing when unused.
_register(ModelConfig(
    name="bench-1b", vocab_size=32768, hidden_size=2048,
    intermediate_size=5632, num_layers=22, num_heads=16, num_kv_heads=8,
    head_dim=128, max_seq_len=16384, rope_theta=500000.0,
    bos_token_id=1, eos_token_ids=(2,),
))

# ~0.4B-param draft model for draft-target speculative decoding: resident
# alongside a big target on the SAME chip (llama3.1-8b int8 ~8.6 GB +
# this config int8 ~0.45 GB + both KV pools fit one 16 GB v5e), it
# proposes K greedy tokens per spec tick that the target verifies in one
# forward (serve/draft_model.py). vocab matches llama3.1-8b — a drafter
# MUST share its target's vocabulary (draft ids feed the target's verify
# forward directly); pair it with a different-vocab target by cloning
# the config at the target's vocab (`get_config("draft-400m").with_(
# vocab_size=target.vocab_size)` — bench.py's freeform spec phase does
# this for bench-1b). Embeddings are untied so the synthetic quote/
# freeform workloads (models/synth.py) can install their successor-map
# lm_head for CPU tests and benches without real checkpoints.
_register(ModelConfig(
    name="draft-400m", vocab_size=128256, hidden_size=1024,
    intermediate_size=4096, num_layers=16, num_heads=8, num_kv_heads=4,
    head_dim=128, max_seq_len=16384, rope_theta=500000.0,
))

# ~1.2B-param MoE config (8 experts, top-2) for single-chip MoE benching:
# measures the scatter/gather expert-dispatch cost of models/mixtral.py on
# real hardware (BASELINE.json config 5's family; ep=1 on one chip).
_register(ModelConfig(
    name="bench-moe", vocab_size=32768, hidden_size=1024,
    intermediate_size=2816, num_layers=16, num_heads=8, num_kv_heads=4,
    # max_seq 8192 for the round-5 long-context MoE rows (rope_theta 1e6
    # covers it; KV is allocated per run, so the cap is free unused).
    head_dim=128, max_seq_len=8192, rope_theta=1e6,
    num_experts=8, num_experts_per_tok=2, moe_capacity_factor=2.0,
    bos_token_id=1, eos_token_ids=(2,),
))


def get_config(name: str) -> ModelConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown model config {name!r}; have {sorted(CONFIGS)}") from None
