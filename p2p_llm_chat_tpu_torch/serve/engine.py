"""The port's inference engine behind the Ollama-compatible API.

:class:`TorchEngine` implements the serve ``Backend`` protocol over the
continuous-batching :class:`~.scheduler.BatchScheduler`, like the
reference's ``TPUEngine`` (p2p_llm_chat_tpu/serve/engine.py).
:func:`build_engine_from_env` reads the same ``SERVE_*`` env surface and
serves random-init weights of ``MODEL_CONFIG`` with the byte tokenizer.

This slice serves one dense llama model on one card from a paged KV pool
(bf16 or int8) with bf16 or int8 weights. Features of the reference that
later slices port fail loudly when asked for explicitly (``SERVE_SPEC>0``,
``SERVE_KV_HOST_GB>0``, ``SERVE_TP>1``, ``SERVE_MODELS``, ``CKPT_DIR``,
``SERVE_QUANT=int4``, ``SERVE_KV=dense``, MoE configs, multi-host). The
reference's defaults ``SERVE_PREFIX=1``, ``SERVE_FUSE=4`` and
``SERVE_PREFILL_CHUNK=256`` do not change its output, so here they are
logged as not run yet.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

import torch

from ..models.configs import get_config
from ..models.llama import init_params_quantized
from ..tokenizer import ByteTokenizer
from ..utils.device import resolve_device
from ..utils.env import env_float, env_int, env_or
from ..utils.log import get_logger
from .backend import Backend, GenerateRequest, RequestStats
from .scheduler import BatchScheduler

log = get_logger("serve.torch_engine")


def default_chat_prompt(messages: list[dict]) -> str:
    """Model-agnostic flattening of an /api/chat messages list."""
    parts = []
    for m in messages:
        role = m.get("role", "user")
        parts.append(f"{role}: {m.get('content', '')}")
    parts.append("assistant:")
    return "\n".join(parts)


class TorchEngine:
    """Backend over the continuous-batching scheduler, on ``device``
    (the card unless the CPU is asked for; see utils/device.py)."""

    def __init__(self, params: dict, config, tokenizer, *,
                 num_slots: int = 8, max_seq: int = 1024,
                 page_size: int = 64, num_pages: Optional[int] = None,
                 queue_timeout_s: Optional[float] = 60.0,
                 queue_max: Optional[int] = None, kv_quant: bool = False,
                 name: Optional[str] = None,
                 device: Optional[torch.device | str] = None) -> None:
        self.name = name or config.name
        self.config = config
        self.scheduler = BatchScheduler(
            params, config, tokenizer, num_slots=num_slots, max_seq=max_seq,
            page_size=page_size, num_pages=num_pages,
            queue_timeout_s=queue_timeout_s, queue_max=queue_max,
            kv_quant=kv_quant, device=device)

    def generate_stream(self, req: GenerateRequest,
                        stats: Optional[RequestStats] = None) -> Iterator[str]:
        return self.scheduler.submit(req, stats)

    def render_chat(self, messages: list[dict]) -> str:
        return default_chat_prompt(messages)

    def warmup(self, buckets: tuple[int, ...] = (128,)) -> None:
        """Run the serving path once before traffic, on a background
        thread (on the card this builds and loads the CUDA kernels);
        /readyz stays not-ready until it is done, and for good if it
        fails (the error is kept in :attr:`warmup_error`)."""
        def run() -> None:
            try:
                self.scheduler.warmup(buckets)
            except Exception:   # noqa: BLE001 — kept as warmup_error
                log.exception("warmup failed")

        self.scheduler.note_warmup_pending()
        threading.Thread(target=run, daemon=True, name="warmup").start()

    def models(self) -> list[str]:
        return [self.name]

    def ready(self) -> bool:
        return self.scheduler.ready

    @property
    def warmup_error(self) -> Optional[BaseException]:
        return self.scheduler.warmup_error

    def metrics_snapshot(self) -> dict[str, float]:
        return self.scheduler.metrics_snapshot()

    def drain(self) -> None:
        self.scheduler.drain()

    def stop(self) -> None:
        self.scheduler.stop()


def _not_in_slice(what: str) -> SystemExit:
    return SystemExit(f"{what} is not ported to the PyTorch engine yet "
                      "(p2p_llm_chat_tpu_torch serves one dense llama "
                      "model on one card in this version)")


def build_engine_from_env(device: Optional[str | torch.device] = None
                          ) -> Backend:
    """Engine from env vars: random-init ``MODEL_CONFIG`` (default
    ``tiny``) weights and the byte tokenizer, on ``device`` — by default
    the card (``SERVE_DEVICE`` or the argument may ask for ``cpu``; with
    neither and no card this raises)."""
    if env_or("SERVE_COORDINATOR", "") or env_or("JAX_COORDINATOR", ""):
        raise _not_in_slice("multi-host serving")
    if env_int("SERVE_SPEC", 0) > 0:
        raise _not_in_slice("speculative decoding (SERVE_SPEC>0)")
    if env_float("SERVE_KV_HOST_GB", 0.0) > 0:
        raise _not_in_slice("KV tiering (SERVE_KV_HOST_GB>0)")
    if env_int("SERVE_TP", 1) > 1:
        raise _not_in_slice("tensor parallelism (SERVE_TP>1)")
    if env_or("SERVE_MODELS", ""):
        raise _not_in_slice("multi-model serving (SERVE_MODELS)")
    if env_or("CKPT_DIR", ""):
        raise _not_in_slice("checkpoint loading (CKPT_DIR)")
    quant = env_or("SERVE_QUANT", "")
    if quant == "int4":
        raise _not_in_slice("int4 weights (SERVE_QUANT=int4)")
    if quant not in ("", "int8"):
        raise SystemExit(f"SERVE_QUANT must be one of '', 'int8', 'int4'; "
                         f"got {quant!r}")
    kv_mode = env_or("SERVE_KV", "paged")
    if kv_mode == "dense":
        raise _not_in_slice("the dense KV cache (SERVE_KV=dense)")
    if kv_mode != "paged":
        raise SystemExit(f"SERVE_KV must be dense|paged, got {kv_mode!r}")
    kv_quant = env_or("SERVE_KV_QUANT", "")
    if kv_quant not in ("", "int8"):
        raise SystemExit(
            f"SERVE_KV_QUANT must be int8 or empty, got {kv_quant!r}")
    config = get_config(env_or("MODEL_CONFIG", "tiny"))
    if config.is_moe:
        raise _not_in_slice(f"the MoE config {config.name}")
    for flag, default, off in (("SERVE_PREFIX", "1", "0"),
                               ("SERVE_FUSE", "4", "1"),
                               ("SERVE_PREFILL_CHUNK", "256", "0")):
        if env_or(flag, default) != off:
            log.info("%s=%s: not run yet by the PyTorch engine (output is "
                     "the same without it)", flag, env_or(flag, default))
    dev = resolve_device(device)
    qt = env_float("SERVE_QUEUE_TIMEOUT", 60.0)
    qm = env_int("SERVE_QUEUE_MAX", -1)
    log.info("serving random-init %s (%s weights, %s KV) on %s", config.name,
             quant or "bf16", kv_quant or "bf16", dev)
    params = init_params_quantized(config, seed=0, quant=quant, device=dev)
    engine = TorchEngine(
        params, config, ByteTokenizer(vocab_size=config.vocab_size),
        num_slots=env_int("SERVE_SLOTS", 8),
        max_seq=env_int("SERVE_MAX_SEQ", 1024),
        page_size=env_int("SERVE_PAGE_SIZE", 64),
        num_pages=env_int("SERVE_PAGES", 0) or None,
        queue_timeout_s=qt if qt > 0 else None,
        queue_max=None if qm < 0 else qm,
        kv_quant=bool(kv_quant),
        name=env_or("LLM_MODEL", config.name), device=dev)
    warm = env_or("SERVE_WARMUP", "128")
    if warm and warm != "0":
        engine.warmup(tuple(int(b) for b in warm.split(",") if b.strip()))
    return engine
