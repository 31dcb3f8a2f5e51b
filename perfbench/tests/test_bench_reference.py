"""The plain reference at a tiny size on the CPU: held against itself under
the seed, its quantization arithmetic against hand-worked values, its
sparse-MoE layer against a per-token sum, and its imports."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench.reference import quant, weights
from perfbench.reference.check import gaps, positions, widest_gaps
from perfbench.reference.model import Reference, _Precision
from perfbench.reference.weights import Shape

from .conftest import REPO, TINY_HF

FORBIDDEN = {"jax", "jaxlib", "flax", "p2p_llm_chat_tpu",
             "p2p_llm_chat_tpu_torch"}


def shape(moe: bool) -> Shape:
    hf = dict(TINY_HF)
    if moe:
        hf.update(num_local_experts=4, num_experts_per_tok=2)
    return Shape.from_hf(hf)


SEQS = [[256] + list(b"hello there, friend"), [256] + list(b"ok")]
WANT = [range(3, 10), range(0, 2)]


@pytest.mark.parametrize("moe,mode", [(False, "int8"), (True, "int4"),
                                      (False, "")])
def test_reference_is_a_function_of_the_seed(moe, mode):
    a = Reference(shape(moe), mode, True, 7, "cpu").logits(SEQS, WANT)
    b = Reference(shape(moe), mode, True, 7, "cpu").logits(SEQS, WANT)
    c = Reference(shape(moe), mode, True, 8, "cpu").logits(SEQS, WANT)
    for x, y, z in zip(a["f32"], b["f32"], c["f32"]):
        assert x.shape[-1] == 512
        assert torch.equal(x, y)
        assert not torch.equal(x, z)


def test_a_prefix_reads_the_same_logits():
    """Causal: the logits at a position do not depend on later tokens."""
    ref = Reference(shape(False), "int8", True, 3, "cpu")
    full = ref.logits([SEQS[0]], [range(0, 5)])["f32"][0]
    cut = ref.logits([SEQS[0][:5]], [range(0, 5)])["f32"][0]
    torch.testing.assert_close(full, cut, rtol=1e-5, atol=1e-5)


def test_int8_and_int4_arithmetic():
    w = torch.tensor([[1.0, -2.0], [0.5, 0.0], [-1.27, 4.0], [0.3, 1.0]],
                     dtype=torch.bfloat16)
    d8 = quant.int8_weight(w)
    s = w.float().abs().amax(0) / 127
    torch.testing.assert_close(d8, torch.round(w.float() / s) * s)
    assert float((d8 / s).abs().max()) == 127.0
    # 192 rows: groups of 64, 7 steps each side.
    w4 = torch.linspace(-1, 1, 192 * 3).reshape(192, 3).bfloat16()
    d4 = quant.int4_weight(w4, expert=False)
    for g in range(3):
        blk = w4.float()[64 * g:64 * (g + 1)]
        sg = blk.abs().amax(0) / 7
        torch.testing.assert_close(d4[64 * g:64 * (g + 1)],
                                   torch.clamp(torch.round(blk / sg), -7, 7)
                                   * sg)
    assert quant.int4_group(14336, True) == 256
    assert quant.int4_group(4096, True) == 128
    assert quant.int4_group(4096, False) == 128
    assert quant.int4_group(96, False) is None


def test_int8_kv_is_per_token_and_head():
    x = torch.randn(5, 2, 16)
    y = quant.int8_kv(x)
    s = x.abs().amax(-1, keepdim=True) / 127
    torch.testing.assert_close(y, torch.round(x / s) * s)


def test_moe_layer_is_the_weighted_sum_of_the_top_two():
    s = shape(True)
    ref = Reference(s, "", False, 5, "cpu")
    x = torch.randn(6, s.hidden)
    experts = [{k: v.float() for k, v in weights.mlp(s, 5, 0, "cpu", e)
                .items()} for e in range(s.experts)]
    f32 = _Precision("f32")
    out = ref._moe(x, 0, experts, f32)
    router = weights.router(s, 5, 0, "cpu").float()
    for t in range(6):
        p = torch.softmax(x[t] @ router, -1)
        top = torch.topk(p, 2).indices
        w = p[top] / p[top].sum()
        want = sum(w[i] * ref._swiglu(x[t:t + 1], experts[int(e)], f32)[0]
                   for i, e in enumerate(top))
        torch.testing.assert_close(out[t], want, rtol=1e-5, atol=1e-5)


def test_the_head_draws_only_printable_columns():
    head = weights.lm_head(shape(False), 1, "cpu")
    live = (head != 0).any(0).nonzero().flatten().tolist()
    assert live == list(range(32, 127))


def test_gaps_read_the_served_token_below_the_best():
    logits = torch.tensor([[1.0, 3.0, 2.0], [0.0, -1.0, 5.0]])
    assert gaps(logits, torch.tensor([1, 0])).tolist() == [0.0, 5.0]
    seq, want = positions([256, 10, 11], [40, 41, 42])
    assert seq == [256, 10, 11, 40, 41] and list(want) == [2, 3, 4]


def test_the_control_reads_wider_gaps_than_the_reference():
    """Served tokens that are the reference's own greedy picks read 0; the
    fp8 control's first choices read wider."""
    s = shape(False)
    ref = Reference(s, "int8", True, 11, "cpu")
    prompt = [256] + list(b"The quick brown fox jumps over it")
    served, seq = [], list(prompt)
    for _ in range(24):
        nxt = int(ref.logits([seq], [range(len(seq) - 1, len(seq))])
                  ["f32"][0][-1].argmax())
        served.append(nxt)
        seq.append(nxt)
    out = widest_gaps(ref, [(prompt, served)], ("bf16", "fp8"))
    assert out["served"][0] == 0.0
    assert out["fp8"][0] > out["bf16"][0]


def test_the_int4_weight_control_reads_wider_gaps_and_leaves_f32_alone():
    """The int4 control computes with the int8 configuration's weights in
    int4 groups: its first choices read wider gaps than bfloat16 rounding
    alone, and the f32 logits beside it are those of a pass without it."""
    s = shape(False)
    ref = Reference(s, "int8", True, 11, "cpu")
    prompt = [256] + list(b"The quick brown fox jumps over it")
    served, seq = [], list(prompt)
    for _ in range(24):
        nxt = int(ref.logits([seq], [range(len(seq) - 1, len(seq))])
                  ["f32"][0][-1].argmax())
        served.append(nxt)
        seq.append(nxt)
    out = widest_gaps(ref, [(prompt, served)], ("bf16", "int4"))
    assert out["served"][0] == 0.0
    assert out["int4"][0] > out["bf16"][0]
    both = ref.logits(SEQS, WANT, ("f32", "int4"))
    alone = ref.logits(SEQS, WANT)
    assert all(torch.equal(a, b) for a, b in zip(both["f32"], alone["f32"]))
    int4 = Reference(s, "int4", True, 11, "cpu").logits(SEQS, WANT, ("bf16",))
    assert all(torch.equal(a, b) for a, b in zip(both["int4"], int4["bf16"]))


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_jax_or_the_program():
    for path in (REPO / "perfbench" / "reference").glob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    code = ("import sys; import perfbench.reference.check, "
            "perfbench.reference.model, perfbench.reference.weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    assert not set(eval(out)) & FORBIDDEN


def test_moe_routing_is_the_seeded_hash_of_the_token_at_every_layer():
    """The routing dimensions carry the embedding's choice unchanged
    through every layer (nothing writes there), so the reference's top-2
    is the token's hashed pair under each layer's permutation, with a
    lead over the third far beyond bfloat16 rounding."""
    s = shape(True)
    emb = weights.embed(s, 4, "cpu").float()
    for li in range(s.layers):
        for w in (weights.attention(s, 4, li, "cpu")["wo"],
                  weights.mlp(s, 4, li, "cpu", 1)["w_down"]):
            assert not w[:, :s.experts].any()
        router = weights.router(s, 4, li, "cpu").float()
        x = emb * torch.rsqrt(emb.square().mean(-1, keepdim=True) + 1e-5)
        logits = x @ router
        top = logits.topk(3, dim=-1).values
        lead = (top[:, 1] - top[:, 2]) / top[:, 0].abs()
        assert float(lead.min()) > 0.5
        chosen = (emb[:, :s.experts] > 0).float() @ router[:s.experts]
        assert torch.equal(chosen.topk(2, -1).indices.sort(-1).values,
                           logits.topk(2, -1).indices.sort(-1).values)
