"""The port's tool twins (p2p_llm_chat_tpu_torch/tools/) on the CPU at tiny
sizes, against the reference's tools/ scripts:

- ``profile_step.step_variant`` against the reference's
  ``tools/profile_step.step_variant`` on the same int8 weights (f32
  activations) and the same f32 pool, for every variant that has a
  counterpart there: the output (logits, or the final-norm hidden states)
  and the pool agree to 1e-4 of the largest value (f32 reduction order
  only), and the lengths exactly; ``mm_scan_only`` against the
  reference's matmul chain (the nested function of its ``main``,
  transcribed with its ``mm``); ``unroll4`` refuses by name;
- ``trace_step``'s grouping by kernel name and its union arithmetic, and
  a CPU ``torch.profiler`` capture through it;
- the shape matrices of ``check_quant_kernel``, ``check_append_kernel``
  and ``time_append_kernel`` equal the reference tools' (read from their
  source);
- the bound arithmetic;
- every CLI raises without a card unless ``--device cpu`` is given, and
  with it prints its rows, each naming the device.
"""

import ast
import inspect
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.llama import KVCache
from p2p_llm_chat_tpu.models.quant import mm as ref_mm
from p2p_llm_chat_tpu.ops import paged_kv as ref_kv
from p2p_llm_chat_tpu_torch.models import llama
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.ops import paged_kv
from p2p_llm_chat_tpu_torch.tools import (card, check_append_kernel,
                                          check_quant_kernel, profile_step,
                                          time_append_kernel, trace_step)
from tools import check_append_kernel as ref_check_append
from tools import check_quant_kernel as ref_check_quant
from tools import profile_step as ref_profile_step

torch.set_num_threads(2)
pytestmark = pytest.mark.model
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS = 8
TOL = 1e-4      # of the largest value: f32 reduction order only

# The reference's step_variant keywords for each variant of its main().
REF_KW = {"full": {}, "no_attn": dict(skip_attn=True),
          "no_write": dict(skip_write=True),
          "no_lm_head": dict(skip_lm_head=True),
          "trunk_only": dict(skip_attn=True, skip_write=True,
                             skip_lm_head=True),
          "mm_only": dict(skip_attn=True, skip_write=True)}


class _Pools:
    """The same prompts prefilled into a reference f32 pool and a port
    f32 pool, on int8 weights with f32 activations."""

    def __init__(self, max_pages: int = 8):
        self.cfg_ref, self.cfg = ref_config("tiny"), get_config("tiny")
        self.params_ref = ref_llama.init_params_quantized(
            self.cfg_ref, jax.random.PRNGKey(0), dtype=jnp.float32)
        self.params = params_from_numpy(
            jax.tree.map(np.asarray, self.params_ref), device="cpu")
        rng = np.random.default_rng(1)
        prompts = [list(rng.integers(3, 500, size=n)) for n in (5, 12, 9)]
        B, S = len(prompts), 16
        toks = np.zeros((B, S), np.int32)
        lens = np.array([len(p) for p in prompts], np.int32)
        for b, p in enumerate(prompts):
            toks[b, :len(p)] = p
        tables = np.stack([1 + b * max_pages + np.arange(max_pages)
                           for b in range(B)]).astype(np.int32)
        N = B * max_pages + 1
        small = KVCache.create(self.cfg_ref, B, S, dtype=jnp.float32)
        _, small = ref_llama.prefill(self.params_ref, self.cfg_ref,
                                     jnp.asarray(toks), jnp.asarray(lens),
                                     small, last_only=True)
        rc = ref_kv.PagedKVCache.create(self.cfg_ref, B, N, PS,
                                        max_pages_per_row=max_pages,
                                        dtype=jnp.float32)
        self.ref_cache = ref_kv.write_prefill_batch(
            rc, small.k, small.v, jnp.arange(B), jnp.asarray(lens),
            jnp.asarray(tables))
        _, k_all, v_all = llama.prefill(
            self.params, self.cfg, torch.from_numpy(toks).long(),
            torch.from_numpy(lens), last_only=True)
        self.cache = paged_kv.PagedKVCache.create(
            self.cfg, B, N, PS, max_pages_per_row=max_pages,
            dtype=torch.float32, device="cpu")
        paged_kv.write_prefill_batch(self.cache, k_all, v_all,
                                     torch.arange(B), torch.from_numpy(lens),
                                     torch.from_numpy(tables))
        self.tokens = rng.integers(3, 500, size=(B, 1)).astype(np.int32)
        self.pages = max_pages


@pytest.fixture(scope="module")
def pools():
    return _Pools


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=TOL,
                               atol=TOL * scale, err_msg=what)


@pytest.mark.parametrize("variant", list(REF_KW))
def test_step_variant_matches_the_reference_tools(pools, variant):
    p = pools()
    ref_out, ref_cache = ref_profile_step.step_variant(
        p.params_ref, p.cfg_ref, jnp.asarray(p.tokens), p.ref_cache,
        pages=p.pages, **REF_KW[variant])
    out, cache = profile_step.step_variant(
        p.params, p.cfg, torch.from_numpy(p.tokens).long(), p.cache,
        pages=p.pages, variant=variant)
    assert tuple(out.shape) == tuple(ref_out.shape)
    _close(out.numpy(), ref_out, f"{variant} output")
    np.testing.assert_array_equal(cache.lengths.numpy(),
                                  np.asarray(ref_cache.lengths))
    for name in ("k", "v"):
        _close(getattr(cache, name).numpy(), getattr(ref_cache, name),
               f"{variant} pool {name}")


def test_full_variant_is_the_decode_step(pools):
    """``full`` is decode_step_paged's gather branch, bitwise."""
    a, b = pools(), pools()
    toks = torch.from_numpy(a.tokens).long()
    out, _ = profile_step.step_variant(a.params, a.cfg, toks, a.cache,
                                       pages=a.pages, variant="full")
    want, _ = llama.decode_step_paged(b.params, b.cfg, toks, b.cache,
                                      pages=b.pages, impl="gather")
    assert torch.equal(out, want)
    assert torch.equal(a.cache.k, b.cache.k)
    assert torch.equal(a.cache.lengths, b.cache.lengths)


def test_mm_scan_only_matches_the_reference_chain(pools):
    p = pools()
    cfg = p.cfg_ref
    params = ref_llama.fuse_params(p.params_ref) if "wqkv" not in \
        p.params_ref["layers"] else p.params_ref
    # The reference's mm_scan_only body (tools/profile_step.main).
    h = params["embed"][jnp.asarray(p.tokens)]
    H, E = h.shape[-1], cfg.intermediate_size
    for li in range(cfg.num_layers):
        lp = ref_llama._layer_view(params["layers"], li)
        a = ref_mm(h, lp["wqkv"])
        h1 = ref_mm(a[..., :cfg.q_dim], lp["wo"])
        g = ref_mm(h1, lp["wgu"])
        h = ref_mm(g[..., :E], lp["w_down"])[..., :H]
    lm_head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    want = ref_mm(h, lm_head).astype(jnp.float32)
    got, _ = profile_step.step_variant(
        p.params, p.cfg, torch.from_numpy(p.tokens).long(), p.cache,
        pages=p.pages, variant="mm_scan_only")
    _close(got.numpy(), want, "mm_scan_only")


def test_unroll4_has_no_counterpart_and_says_so(pools):
    p = pools()
    with pytest.raises(ValueError, match="unroll4: no counterpart"):
        profile_step.step_variant(p.params, p.cfg,
                                  torch.from_numpy(p.tokens).long(), p.cache,
                                  pages=p.pages, variant="unroll4")
    assert set(profile_step.DEFAULT_VARIANTS) == set(
        _ref_default_variants())
    assert "unroll" in inspect.signature(ref_profile_step.step_variant
                                         ).parameters


def _ref_main_source(mod) -> ast.Module:
    return ast.parse(inspect.getsource(mod))


def _ref_default_variants() -> list:
    """The reference main's default variant list."""
    for node in ast.walk(_ref_main_source(ref_profile_step)):
        if (isinstance(node, ast.BoolOp) and len(node.values) == 2
                and isinstance(node.values[1], ast.List)):
            return ast.literal_eval(node.values[1])
    raise AssertionError("no default variant list in the reference")


# -- trace_step ---------------------------------------------------------------

@pytest.mark.parametrize("name,group", [
    ("void qmm_kernel<64, 4>(...)", "kernel A"),
    ("qmm_reduce", "kernel A"),
    ("void qmm4_mma_kernel<16>(...)", "kernel C"),
    ("qmm4_fma_kernel", "kernel C"),
    ("void paged_split_kernel<128, true>(...)", "kernel B"),
    ("paged_combine_kernel", "kernel B"),
    ("paged_verify_merge_kernel", "kernel B"),
    ("void prefill_attn_kernel<128, 4>(...)", "kernel D"),
    ("w8a8_tma_kernel", "kernel E"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "other"),
    ("Memcpy DtoD (Device -> Device)", "other"),
])
def test_kernel_group_by_name(name, group):
    assert trace_step.kernel_group(name).startswith(group)


def test_union_and_group_arithmetic():
    assert trace_step.union_ms([]) == 0.0
    # Overlapping, nested, touching and disjoint intervals (us).
    spans = [(0, 10), (5, 15), (6, 7), (15, 20), (30, 40)]
    assert trace_step.union_ms(spans) == pytest.approx(0.030)
    events = [("qmm_kernel", 0, 10), ("paged_split_kernel", 8, 20),
              ("paged_combine_kernel", 18, 24), ("aten::foo", 30, 34),
              ("qmm_kernel", 40, 50)]
    g = trace_step.group_times(events, 2)
    a = g["kernel A (w8a16, dense and experts)"]
    b = g["kernel B (paged attention, append, pool or verify mode)"]
    assert a == pytest.approx([0.010, 2, 0.010])
    # The combine overlaps its split: the union counts 16 us, the sum 18.
    assert b == pytest.approx([0.008, 2, 0.009])
    assert g["busy"] == pytest.approx((24 + 4 + 10) / 1e3 / 2)
    assert g["other_names"] == {"aten::foo": pytest.approx([0.002, 1])}


def test_attribution_of_a_cpu_profiler_capture(capsys):
    cpu = torch.device("cpu")
    x = torch.randn(64, 64)

    def fn(_i):
        torch.relu(x @ x)
    out = trace_step.attribute("matmul", fn, 4, dev=cpu)
    assert out["busy_ms"] > 0 and out["wall_ms"] > 0
    assert "other" in out["groups"]
    printed = capsys.readouterr().out
    assert "matmul:" in printed and "aten::" in printed


# -- the shape matrices -------------------------------------------------------

def _main_block(mod) -> list:
    tree = _ref_main_source(mod)
    for node in tree.body:
        if isinstance(node, ast.If) and "__main__" in ast.unparse(node.test):
            return node.body
    raise AssertionError("no __main__ block")


def test_check_quant_kernel_shapes_are_the_references():
    loops = [ast.literal_eval(n.iter) for n in _main_block(ref_check_quant)
             if isinstance(n, ast.For)]
    assert loops == [check_quant_kernel.DENSE, check_quant_kernel.EXPERTS]
    assert check_quant_kernel.ROWS == ref_check_quant.ROWS
    assert check_quant_kernel.EXPERT_ROWS == ref_check_quant.EXPERT_ROWS
    ne = inspect.signature(ref_check_quant.run_experts8).parameters["NE"]
    assert check_quant_kernel.NE == ne.default


def test_check_append_kernel_cases_are_the_references():
    run = inspect.signature(ref_check_append.run).parameters
    flash = inspect.signature(ref_check_append.run_flash).parameters
    calls = [n.value for n in _main_block(ref_check_append)
             if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
             and isinstance(n.value.func, ast.Name)
             and n.value.func.id in ("run", "run_flash")]
    want = []
    for c in calls:
        quantized = ast.literal_eval(c.keywords[0].value)
        if c.func.id == "run":
            want.append(("block", quantized, run["pages"].default,
                         run["ps"].default, run["seed"].default))
        else:
            want.append(("flash", quantized, flash["pages"].default,
                         flash["ps"].default, 1))
    assert tuple(want) == check_append_kernel.CASES
    assert run["B"].default == 32 == flash["B"].default
    src = inspect.getsource(ref_check_append.run_flash)
    assert "seed=1" in src and 'label="flash"' in src


def test_time_append_kernel_setup_is_the_references():
    src = open(os.path.join(REPO, "tools", "time_append_kernel.py")).read()
    consts = {}
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Tuple)):
            names = [t.id for t in node.targets[0].elts]
            try:
                consts.update(zip(names, ast.literal_eval(node.value)))
            except ValueError:
                pass
    assert (consts["B"], consts["pages"], consts["ps"]) == (
        32, time_append_kernel.PAGES, time_append_kernel.PAGE_SIZE)
    assert "jnp.full((B,), 150" in src and time_append_kernel.LENGTH == 150
    L = get_config("bench-1b").num_layers
    assert (consts["n1"], consts["n2"]) == (5 * L, 20 * L)


# -- the bounds ---------------------------------------------------------------

def test_bound_arithmetic():
    ms, by = card.bound_ms(3.35e9, 1.0)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = card.bound_ms(1.0, 989e9)
    assert ms == pytest.approx(1.0) and by == "operations"
    cfg = get_config("bench-1b")
    B, n = 32, 150
    per_layer = (2 * B * n * cfg.num_kv_heads * cfg.head_dim
                 + 2 * B * n * cfg.num_kv_heads * 4
                 + 2 * B * cfg.num_kv_heads * cfg.head_dim * 2
                 + 2 * B * cfg.num_heads * cfg.head_dim * 2)
    ms, by = time_append_kernel.walk_bound_ms(cfg, B, n, True)
    assert by == "bytes"
    assert ms == pytest.approx(per_layer * cfg.num_layers / 3.35e12 * 1e3)
    bf16, _ = time_append_kernel.walk_bound_ms(cfg, B, n, False)
    assert bf16 > ms
    assert check_quant_kernel._layers(2 ** 30) == 2
    assert check_quant_kernel._layers(8 * 2 ** 20) == math.ceil(
        3 * 50 / 8)                     # three L2s of 8 MB layers
    assert check_quant_kernel._layers(2 ** 20) == 64      # the cap


# -- the command lines --------------------------------------------------------

CLIS = {
    "profile_step": (profile_step, ["full", "no_attn", "sampling",
                                    "unroll4"]),
    "trace_step": (trace_step, []),
    "check_quant_kernel": (check_quant_kernel, ["--dense", "256x512",
                                                "--experts", "none"]),
    "check_append_kernel": (check_append_kernel, ["--config", "tiny",
                                                  "--batch", "2",
                                                  "--cases", "0,3"]),
    "time_append_kernel": (time_append_kernel, ["--config", "tiny",
                                                "--batch", "2",
                                                "--walks", "1,2"]),
}
PROF_ENV = {"PROF_CONFIG": "tiny", "PROF_SLOTS": "2", "PROF_STEPS": "4"}


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_refuses_without_a_card_and_prints_rows_on_the_cpu(
        name, monkeypatch, capsys):
    mod, args = CLIS[name]
    for k, v in PROF_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("SERVE_DEVICE", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(args)
    out = mod.main(args + ["--device", "cpu"])
    assert out is not None
    rows = [r for r in capsys.readouterr().out.splitlines()
            if r.endswith("[card: cpu]")]
    assert len(rows) >= 2, rows
