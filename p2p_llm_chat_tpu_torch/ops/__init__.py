"""The paged KV pool and the two hand-written CUDA kernels of the decode
path, each beside its plain PyTorch version:

- :mod:`.paged_kv` — PagedKVCache, host-side page allocator, pool writes;
- :mod:`.quant_mm` — kernel A, the w8a16 matmul (csrc/quant_mm.cu);
- :mod:`.paged_attention` — kernel B, paged decode-append attention
  (csrc/paged_attention.cu);
- :mod:`._build` — nvcc build on first use + ctypes binding.
"""
