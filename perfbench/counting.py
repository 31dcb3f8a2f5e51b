"""Operations, bytes and model FLOPs, worked out from shapes, and the table
of peaks they are held against.

The roofline arithmetic is a frozen copy of ``chip_smoke.py``'s bound
columns (``tools/card.bound_ms``): the least time of a call is the larger
of its operations over the bf16 peak and its bytes over the memory
bandwidth; each input byte is counted once and each output byte once.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3
# bandwidth (700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time of a call: the larger of its two times."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def weight_bytes(K: int, O: int, mode: str, group: int | None = None) -> int:
    """Stored bytes of one ``[K, O]`` weight with its scales: int8 one byte
    a weight and an f32 scale a column; int4 half a byte a weight and an
    f32 scale a (group, column); bf16 two bytes a weight."""
    if mode == "int8":
        return K * O + 4 * O
    if mode == "int4":
        return K * O // 2 + 4 * (K // group) * O
    return 2 * K * O


def matmul(rows: int, K: int, O: int, wbytes: int) -> tuple[float, float]:
    """(operations, bytes) of ``x[rows, K] @ w[K, O]`` in bf16 with the
    weight's stored bytes ``wbytes`` read once."""
    return 2.0 * rows * K * O, wbytes + 2.0 * rows * (K + O)


def expert_rows_read(tokens: int, experts: int, top_k: int) -> int | None:
    """How many experts' weights a dispatch of ``tokens`` rows is counted
    to read: all of them from 16 rows (under top-2 of 8 each expert is
    then missed with a probability of about (6/8)^16, 1%), exactly
    ``top_k`` for one row, and None (left out of both sides of a share)
    between."""
    if tokens >= 16:
        return experts
    if tokens == 1:
        return top_k
    return None


@dataclass(frozen=True)
class Model:
    """The shapes the counts need (from a configuration file)."""

    hidden: int
    intermediate: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    experts: int = 0
    top_k: int = 0

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    def layer_params(self) -> int:
        """Matmul weights one token multiplies by in one layer (the router
        and the experts it is routed to, for an MoE layer)."""
        H, F = self.hidden, self.intermediate
        attn = H * (self.q_dim + 2 * self.kv_dim) + self.q_dim * H
        if self.experts:
            return attn + H * self.experts + self.top_k * 3 * H * F
        return attn + 3 * H * F

    def attention_flops(self, keys: int) -> float:
        """QK^T and PV of one query over ``keys`` keys, every layer."""
        return 4.0 * self.layers * self.heads * self.head_dim * keys

    def decode_flops(self, context: int) -> float:
        """Model FLOPs of one decoded token whose query sees ``context``
        keys (itself included): the layers, the output head, attention."""
        return (2.0 * self.layers * self.layer_params()
                + 2.0 * self.hidden * self.vocab
                + self.attention_flops(context))

    def prefill_flops(self, new: int, cached: int = 0) -> float:
        """Model FLOPs of a prompt's ``new`` tokens after ``cached`` tokens
        served from the prefix cache: the layers for each new token,
        causal attention (token i sees ``cached + i + 1`` keys), and the
        output head once, at the last position."""
        keys = new * cached + new * (new + 1) // 2
        return (2.0 * self.layers * self.layer_params() * new
                + self.attention_flops(keys) + 2.0 * self.hidden * self.vocab)
