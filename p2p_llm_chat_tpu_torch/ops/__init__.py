"""The paged KV pool and the hand-written CUDA kernels of the serving path,
each beside its plain PyTorch version:

- :mod:`.paged_kv` — PagedKVCache, host-side page allocator, pool writes;
- :mod:`.quant_mm` — kernel A, the w8a16 matmul (csrc/quant_mm.cu), and
  kernel C, the w4a16 matmul (csrc/quant_mm4.cu), each also over a batch
  of experts;
- :mod:`.paged_attention` — kernel B, paged decode attention
  (csrc/paged_attention.cu): append mode (pool + current token) and pool
  mode (write-then-attend) and verify mode (S candidate positions per row
  over the pool plus their own k/v under a chain or tree mask);
- :mod:`.dense_attention` — decode and verify attention over the dense
  KV cache (``SERVE_KV=dense``): kernel B's pool and verify modes on a
  zero-copy pool view of the cache under the identity page table;
- :mod:`.prefill_attention` — kernel D, causal GQA prefill attention with
  a query offset (csrc/prefill_attention.cu);
- :mod:`._build` — nvcc build on first use + ctypes binding.
"""


def wrappers() -> dict:
    """Every kernel wrapper of the serving path, by name; each counts the
    launches of its kernel in ``.launches``."""
    from . import quant_mm
    from .dense_attention import dense_attention, dense_attention_verify
    from .paged_attention import (paged_attention, paged_attention_append,
                                  paged_attention_verify_append)
    from .prefill_attention import prefill_attention
    return {"quant_matmul": quant_mm.quant_matmul,
            "quant_matmul4": quant_mm.quant_matmul4,
            "quant_matmul_experts_stacked":
                quant_mm.quant_matmul_experts_stacked,
            "quant_matmul_experts_stacked4":
                quant_mm.quant_matmul_experts_stacked4,
            "paged_attention_append": paged_attention_append,
            "paged_attention": paged_attention,
            "paged_attention_verify_append": paged_attention_verify_append,
            "dense_attention": dense_attention,
            "dense_attention_verify": dense_attention_verify,
            "prefill_attention": prefill_attention}
