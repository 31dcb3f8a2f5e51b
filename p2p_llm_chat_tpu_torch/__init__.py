"""PyTorch + CUDA port of the serving stack, for one NVIDIA H100.

The JAX package ``p2p_llm_chat_tpu`` is the reference this package is held
against (tests/test_torch_*.py). This package imports ``torch`` and never
``jax``, and nothing of the JAX package: it keeps its own copies of the
torch-free modules it needs (configs, tokenizer, HTTP/metrics helpers).

Layout mirrors the reference's module names so each counterpart is easy to
find: ``models/`` (configs, layers, quant, llama, sampling, convert),
``ops/`` (paged KV pool, paged attention, w8a16 matmul, and the CUDA build),
``csrc/`` (hand-written Hopper kernels), ``serve/`` (backend protocol,
scheduler, engine, Ollama-compatible HTTP front).

Device rule: entry points run on ``cuda`` unless the caller asks for the
CPU (``device="cpu"`` or ``SERVE_DEVICE=cpu``); with no GPU and no explicit
CPU request they raise (utils/device.py).
"""
