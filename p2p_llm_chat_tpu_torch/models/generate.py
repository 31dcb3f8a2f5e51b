"""Generation loops over the dense-cache model (the port of
p2p_llm_chat_tpu/models/generate.py).

- :func:`generate` — host-driven: one prefill into a dense
  :class:`~.llama.KVCache`, then one decode step per token, each token
  read back to the host (the loop shape of the serving engine, and its
  correctness oracle);
- :func:`generate_scan` — the reference's fully compiled loop; here the
  same Python loop that keeps its tokens on the device until the end and
  returns a fixed ``[max_new_tokens]`` block padded with the first EOS id.

Both stop on EOS or ``max_new_tokens``. The model family (llama or
mixtral) follows the config; on the card the decode steps run kernel B
over the cache and the prefill kernel D.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import family_for
from .configs import ModelConfig
from .llama import KVCache
from .sampling import sample


def _prefill(params: dict, config: ModelConfig, prompt: torch.Tensor,
             max_seq: int):
    fam = family_for(config)
    S = prompt.shape[0]
    cache = KVCache.create(config, 1, max_seq, dtype=params["embed"].dtype,
                           device=prompt.device)
    lens = torch.tensor([S], device=prompt.device)
    logits, cache = fam.prefill(params, config, prompt[None, :].long(),
                                lens, last_only=True, cache=cache)
    return fam, logits[:, 0, :], cache


def generate(params: dict, config: ModelConfig, prompt: torch.Tensor,
             max_new_tokens: int = 64, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0, seed: int = 0,
             max_seq: Optional[int] = None,
             on_token: Optional[Callable[[int], None]] = None) -> list[int]:
    """Single-sequence host-driven generation. prompt: [S] token ids (on
    the device to run on). Returns the generated ids (without the
    prompt); sampled rows draw from a ``torch.Generator`` seeded with
    ``seed``."""
    S = prompt.shape[0]
    max_seq = max_seq or min(config.max_seq_len, S + max_new_tokens + 1)
    fam, last, cache = _prefill(params, config, prompt, max_seq)
    gen = torch.Generator(device=prompt.device).manual_seed(seed)
    out: list[int] = []
    for _ in range(max_new_tokens):
        nxt = sample(last, gen, temperature, top_k, top_p)
        tok = int(nxt[0])
        if tok in config.eos_token_ids:
            break
        out.append(tok)
        if on_token is not None:
            on_token(tok)
        logits, cache = fam.decode_step(params, config, nxt[:, None].long(),
                                        cache)
        last = logits[:, 0, :]
    return out


def generate_scan(params: dict, config: ModelConfig, prompt: torch.Tensor,
                  max_new_tokens: int, temperature: float = 0.0,
                  seed: int = 0, max_seq: Optional[int] = None
                  ) -> torch.Tensor:
    """Batch-1 generation with no per-token readback: returns
    [max_new_tokens] ids on the prompt's device, padded with the first
    EOS id from the first EOS on (the reference's ``generate_scan``
    contract; its ``while_loop`` becomes a loop whose stop test stays on
    the device, so every step runs and the block is masked after)."""
    S = prompt.shape[0]
    max_seq = max_seq or min(config.max_seq_len, S + max_new_tokens + 1)
    fam, last, cache = _prefill(params, config, prompt, max_seq)
    gen = torch.Generator(device=prompt.device).manual_seed(seed)
    eos = torch.tensor(config.eos_token_ids, device=prompt.device)
    done = torch.zeros((), dtype=torch.bool, device=prompt.device)
    out = torch.full((max_new_tokens,), int(eos[0]), dtype=torch.long,
                     device=prompt.device)
    active = torch.ones((1,), dtype=torch.bool, device=prompt.device)
    for i in range(max_new_tokens):
        tok = sample(last, gen, temperature)
        done = done | (tok[0] == eos).any()
        out[i] = torch.where(done, eos[0], tok[0])
        logits, cache = fam.decode_step(params, config, tok[:, None].long(),
                                        cache, active & ~done)
        last = logits[:, 0, :]
    return out
