"""The benchmark's seeded weights, drawn on the device a leaf at a time.

Every leaf has a generator of its own, seeded from (run seed, leaf name,
layer, expert), so the reference can draw any one layer again without
drawing the ones before it, and the program's feed and the reference see
the same bf16 tensors. Sizes come from a :class:`Shape` (the published
widths of the configuration file).

The output head keeps the published vocabulary width, but only the
columns of printable ASCII bytes (32..126 under the byte tokenizer) are
drawn; the others are zero. Greedy decoding then never picks EOS or a
byte that is no text, so every served token streams as one character and
every request runs to its ``num_predict``: the work a seed asks for is
the work done.

A sparse-MoE model's routing is decided by a seeded hash of the token:
the first ``experts`` hidden dimensions are kept for it. Each token's
embedding holds +A there at the ``top_k`` dimensions the seed picks for
it and -A at the others; no sublayer writes there (the output columns of
``wo`` and of every ``w_down`` are zero); each layer's router reads those
dimensions through a seeded permutation. The router's logits of a token
are then ±A times the norm's common factor, so its top-k lead the rest
by far more than any rounding, and rounding never changes an expert
choice. A router on random weights has near-ties at every few layers,
and under bfloat16 a token's experts then differ from float32's in one of
its 32 layers or another, which moves its logits as far as a step of the
activations to fp8 does: the served-token check could not tell the two
apart. Every expert still sees about ``top_k / experts`` of the tokens.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

PRINTABLE = range(32, 127)


@dataclass(frozen=True)
class Shape:
    """The widths a configuration file states (HF ``config.json`` keys)."""

    vocab: int
    hidden: int
    intermediate: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    experts: int = 0
    experts_per_tok: int = 0
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5

    @classmethod
    def from_hf(cls, hf: dict) -> "Shape":
        heads = hf["num_attention_heads"]
        return cls(vocab=hf["vocab_size"], hidden=hf["hidden_size"],
                   intermediate=hf["intermediate_size"],
                   layers=hf["num_hidden_layers"], heads=heads,
                   kv_heads=hf["num_key_value_heads"],
                   head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
                   experts=hf.get("num_local_experts", 0),
                   experts_per_tok=hf.get("num_experts_per_tok", 0),
                   rope_theta=float(hf.get("rope_theta", 10000.0)),
                   rms_eps=float(hf.get("rms_norm_eps", 1e-5)))

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


def leaf_seed(seed: int, name: str, layer: int = -1, expert: int = -1) -> int:
    digest = hashlib.sha256(f"{seed}:{name}:{layer}:{expert}".encode())
    return int.from_bytes(digest.digest()[:8], "little") & ((1 << 63) - 1)


def draw(shape: tuple, seed: int, name: str, device, layer: int = -1,
         expert: int = -1, std: float = 1.0) -> torch.Tensor:
    """A bf16 N(0, std²) tensor from the leaf's own generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, name, layer, expert))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(torch.bfloat16)


def matrix(shape: tuple, seed: int, name: str, device, layer: int = -1,
           expert: int = -1) -> torch.Tensor:
    """A weight ``[in, out]`` scaled by its fan-in."""
    return draw(shape, seed, name, device, layer, expert,
                std=shape[0] ** -0.5)


ROUTE_A = 2.0           # the routing dimensions' magnitude in an embedding


def embed(s: Shape, seed: int, device) -> torch.Tensor:
    e = draw((s.vocab, s.hidden), seed, "embed", device)
    if s.experts:
        gen = torch.Generator(device=device)
        gen.manual_seed(leaf_seed(seed, "route"))
        u = torch.rand((s.vocab, s.experts), generator=gen, device=device)
        top = u.topk(s.experts_per_tok, dim=-1).indices
        dims = torch.full((s.vocab, s.experts), -ROUTE_A, device=device)
        dims.scatter_(1, top, ROUTE_A)
        e[:, :s.experts] = dims.to(e.dtype)
    return e


def _no_route_writes(s: Shape, w: torch.Tensor) -> torch.Tensor:
    """A matrix writing the residual stream, with the routing dimensions'
    columns zero."""
    if s.experts:
        w[:, :s.experts] = 0
    return w


def lm_head(s: Shape, seed: int, device) -> torch.Tensor:
    """``[H, V]`` with only the printable columns drawn."""
    cols = torch.tensor(list(PRINTABLE), device=device)
    head = torch.zeros((s.hidden, s.vocab), dtype=torch.bfloat16,
                       device=device)
    head[:, cols] = matrix((s.hidden, len(cols)), seed, "lm_head", device)
    return head


def attention(s: Shape, seed: int, li: int, device) -> dict:
    H = s.hidden
    return {"wq": matrix((H, s.q_dim), seed, "wq", device, li),
            "wk": matrix((H, s.kv_dim), seed, "wk", device, li),
            "wv": matrix((H, s.kv_dim), seed, "wv", device, li),
            "wo": _no_route_writes(s, matrix((s.q_dim, H), seed, "wo",
                                             device, li))}


def mlp(s: Shape, seed: int, li: int, device, expert: int = -1) -> dict:
    """One SwiGLU MLP: the layer's dense one, or expert ``expert``'s."""
    H, F = s.hidden, s.intermediate
    return {"w_gate": matrix((H, F), seed, "w_gate", device, li, expert),
            "w_up": matrix((H, F), seed, "w_up", device, li, expert),
            "w_down": _no_route_writes(s, matrix((F, H), seed, "w_down",
                                                 device, li, expert))}


def router(s: Shape, seed: int, li: int, device) -> torch.Tensor:
    """``[H, NE]``: expert e reads routing dimension ``perm[e]``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, "router", li))
    perm = torch.randperm(s.experts, generator=gen, device=device)
    r = torch.zeros((s.hidden, s.experts), dtype=torch.bfloat16,
                    device=device)
    r[perm, torch.arange(s.experts, device=device)] = 1.0
    return r
