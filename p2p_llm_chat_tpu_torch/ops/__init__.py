"""The paged KV pool and the hand-written CUDA kernels of the serving path,
each beside its plain PyTorch version:

- :mod:`.paged_kv` — PagedKVCache, host-side page allocator, pool writes;
- :mod:`.quant_mm` — kernel A, the w8a16 matmul (csrc/quant_mm.cu), and
  kernel C, the w4a16 matmul (csrc/quant_mm4.cu), each also over a batch
  of experts;
- :mod:`.paged_attention` — kernel B, paged decode attention
  (csrc/paged_attention.cu): append mode (pool + current token) and pool
  mode (write-then-attend);
- :mod:`.prefill_attention` — kernel D, causal GQA prefill attention with
  a query offset (csrc/prefill_attention.cu);
- :mod:`._build` — nvcc build on first use + ctypes binding.
"""
