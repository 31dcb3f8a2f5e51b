"""The plain reference: the dense (Mistral) and sparse-MoE (Mixtral)
decoders in float32 with TF32 off, over the benchmark's seeded weights.

It follows the published architecture: pre-norm blocks with RMSNorm,
grouped-query attention with rotary embeddings (rotate-half pairs, base
``rope_theta``) under a causal mask, a SwiGLU MLP or, for Mixtral, a
router whose softmax picks the top two of the experts (ties to the lower
index), renormalised, with no token dropped. Departures, all of them the
deployment's: the weights the configuration quantizes are the f32 values
of their int8 or int4 codes (reference/quant.py), k and v go through the
int8 pool's arithmetic, and the norms' weights are ones (the benchmark
draws them so).

The whole sequence runs at once per layer (a full forward: no cache, no
chunks, no batching across sequences), a layer's weights drawn from the
seed and dequantized when the layer runs, so one layer's f32 weights are
resident at a time (two, where a variant computes with weights of
another quantization). The controls are variants one step below what a
configuration states: ``fp8``, the program's bfloat16 rounding with every
matmul's activations in float8_e4m3fn (reference/quant.fp8_rows);
``int4``, the same rounding with the weights of an int8 configuration in
int4 groups (reference/quant.int4_weight).
"""

from __future__ import annotations

import math

import torch

from . import quant, weights
from .weights import Shape

_Q_BLOCK = 512          # query rows a block of the attention


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[n, heads, D]`` at positions 0..n-1."""
    n, D = x.shape[0], x.shape[-1]
    exps = torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D
    inv = 1.0 / (torch.tensor(theta, dtype=torch.float32,
                              device=x.device) ** exps)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """q ``[n, Hq, D]``, k/v ``[n, Hkv, D]`` -> ``[n, Hq, D]``."""
    n, Hq, D = q.shape
    G = k.shape[1]
    qg = q.reshape(n, G, Hq // G, D)
    out = torch.empty_like(qg)
    pos = torch.arange(n, device=q.device)
    for a in range(0, n, _Q_BLOCK):
        b = min(n, a + _Q_BLOCK)
        s = torch.einsum("sgrd,tgd->grst", qg[a:b], k) / math.sqrt(D)
        s = s.masked_fill(pos[None, :] > pos[a:b, None], float("-inf"))
        out[a:b] = torch.einsum("grst,tgd->sgrd", torch.softmax(s, -1), v)
    return out.reshape(n, Hq, D)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


class _Precision:
    """Where a variant rounds: ``act`` the input of every matmul (the
    router's and the norms' outputs included), ``out`` a matmul's output,
    ``keep`` the residual stream after each sublayer's add; ``weights``
    the weights' quantization where it is not the configuration's."""

    def __init__(self, name: str) -> None:
        if name not in ("f32", "bf16", "fp8", "int4"):
            raise ValueError(f"unknown precision {name!r}")
        low = name != "f32"
        self.act = ((lambda x: quant.fp8_rows(_bf16(x))) if name == "fp8"
                    else _bf16 if low else _same)
        self.out = self.keep = self.norm = _bf16 if low else _same
        self.weights = "int4" if name == "int4" else None


class Reference:
    """``logits(seqs, wanted, variants)``: for each token list and range of
    positions, the f32 logits at those positions (each predicting the next
    token), one list per precision in ``variants``: ``"f32"`` the
    reference; ``"bf16"`` the same arithmetic rounded where the program
    keeps bfloat16 (matmul inputs and outputs, the residual stream);
    ``"fp8"`` a control, as ``"bf16"`` with every matmul's input in
    float8_e4m3fn; ``"int4"`` a control, as ``"bf16"`` with the weights in
    int4."""

    def __init__(self, shape: Shape, quant_mode: str, kv_int8: bool,
                 seed: int, device) -> None:
        self.s = shape
        self.quant = quant_mode
        self.kv_int8 = kv_int8
        self.seed = seed
        self.device = torch.device(device)


    @staticmethod
    def _mm(x: torch.Tensor, w: torch.Tensor, p: _Precision
            ) -> torch.Tensor:
        return p.out(p.act(x) @ w)

    def _attention(self, h, w, p: _Precision) -> torch.Tensor:
        s = self.s
        x = p.norm(rms(h, s.rms_eps))
        n = x.shape[0]
        q = self._mm(x, w["wq"], p).reshape(n, s.heads, s.head_dim)
        k = self._mm(x, w["wk"], p).reshape(n, s.kv_heads, s.head_dim)
        v = self._mm(x, w["wv"], p).reshape(n, s.kv_heads, s.head_dim)
        q, k = p.out(rope(q, s.rope_theta)), p.out(rope(k, s.rope_theta))
        if self.kv_int8:
            k, v = quant.int8_kv(k), quant.int8_kv(v)
        a = p.out(causal_gqa(q, k, v).reshape(n, s.q_dim))
        return p.keep(h + self._mm(a, w["wo"], p))

    def _swiglu(self, x, m, p: _Precision) -> torch.Tensor:
        g = self._mm(x, m["w_gate"], p)
        u = self._mm(x, m["w_up"], p)
        return self._mm(p.out(torch.nn.functional.silu(g) * u),
                        m["w_down"], p)

    def _moe(self, x, li: int, experts: list, p: _Precision
             ) -> torch.Tensor:
        s = self.s
        router = weights.router(s, self.seed, li, self.device).float()
        probs = torch.softmax(x @ router, dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True).indices
        top = top[:, :s.experts_per_tok]
        tw = probs.gather(-1, top)
        tw = tw / tw.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(x)
        for e, m in enumerate(experts):
            rows, slot = (top == e).nonzero(as_tuple=True)
            if rows.numel():
                out.index_add_(0, rows, tw[rows, slot, None]
                               * self._swiglu(x[rows], m, p))
        return p.out(out)

    def _layer_weights(self, li: int, modes: set) -> dict:
        """{weight quantization: (attention weights, MLP weights)}, each
        leaf drawn once and dequantized in every mode."""
        s, dev, seed = self.s, self.device, self.seed

        def q(raw: dict, expert: bool = False) -> dict:
            return {m: {k: quant.weight(v, m, expert) for k, v in raw.items()}
                    for m in modes}
        attn = q(weights.attention(s, seed, li, dev))
        if s.experts:
            per = [q(weights.mlp(s, seed, li, dev, e), expert=True)
                   for e in range(s.experts)]
            mlp = {m: [e[m] for e in per] for m in modes}
        else:
            mlp = q(weights.mlp(s, seed, li, dev))
        return {m: (attn[m], mlp[m]) for m in modes}

    def logits(self, seqs: list, wanted: list, variants=("f32",)) -> dict:
        no_tf32()
        s, dev = self.s, self.device
        ps = {v: _Precision(v) for v in variants}
        modes = {p.weights or self.quant for p in ps.values()}
        emb = weights.embed(s, self.seed, dev)
        hs = {v: [emb[torch.tensor(ids, device=dev)].float()
                  for ids in seqs] for v in variants}
        del emb
        for li in range(s.layers):
            lw = self._layer_weights(li, modes)
            for v, p in ps.items():
                attn, mlp = lw[p.weights or self.quant]
                for i, h in enumerate(hs[v]):
                    h = self._attention(h, attn, p)
                    x = p.norm(rms(h, s.rms_eps))
                    hs[v][i] = p.keep(h + (self._moe(x, li, mlp, p)
                                           if s.experts else
                                           self._swiglu(x, mlp, p)))
            del lw, attn, mlp
        raw = weights.lm_head(s, self.seed, dev)
        head = {m: quant.weight(raw, m) for m in modes}
        del raw
        return {v: [(p.act(p.norm(rms(h[list(r)], s.rms_eps)))
                     @ head[p.weights or self.quant])
                    for h, r in zip(hs[v], wanted)]
                for v, p in ps.items()}
