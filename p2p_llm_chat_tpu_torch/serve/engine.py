"""The port's inference engine behind the Ollama-compatible API.

:class:`TorchEngine` implements the serve ``Backend`` protocol over the
continuous-batching :class:`~.scheduler.BatchScheduler`, like the
reference's ``TPUEngine`` (p2p_llm_chat_tpu/serve/engine.py).
:func:`build_engine_from_env` reads the same ``SERVE_*`` env surface.
Two provisioning paths, as in the reference:

- ``CKPT_DIR``: an HF-layout safetensors directory and its
  ``tokenizer.json`` (models/weights.py, tokenizer.py): streamed onto the
  card into the fused int8 / int4 tree (``SERVE_QUANT``) or loaded as the
  bf16 tree (``SERVE_QUANT=""``), served with its BPE tokenizer, whose
  llama3 specials switch ``/api/chat`` to the llama3 chat template;
- no checkpoint: random-init weights of ``MODEL_CONFIG`` (default
  ``tiny``) with the byte tokenizer.

``SERVE_MODELS`` (``tag=ref,...``, a ref being a config name or a
checkpoint directory) builds one independent engine per tag behind one
front (serve/multi.py); ``CKPT_DIR`` beside it becomes the first, default
entry under ``LLM_MODEL``'s tag. The whole spec is checked before any
engine is built, and the engines warm one after another.

Each engine serves one model on one card from a dense KV cache
(``SERVE_KV=dense``, the reference's default: one bf16 ``[L, B,
max_seq, Hkv, D]`` cache, decode and verify through kernel B over a pool
view of it) or a paged KV pool (``SERVE_KV=paged``, bf16 or int8): a
dense llama config or a mixtral (MoE) config, with bf16, int8 or int4
weights, built through ``models.family_for(config)``. ``SERVE_DRAFT``
(with ``SERVE_SPEC>0``) makes a draft model resident beside the target
(serve/draft_model.py): a config name random-inits at seed 101 with the
target's vocabulary, a checkpoint directory loads through
models/weights.py at ``SERVE_QUANT``; a draft that fails to load, or does
not fit the target, leaves n-gram-only speculation, as in the reference.
Features of the reference that later slices port fail loudly when asked
for explicitly (``SERVE_TP>1``, ``SERVE_PROFILE_PORT>0``, multi-host; a
native Orbax ``CKPT_DIR``). ``SERVE_ADMIT_CHUNK`` caps the rows
of each admission prefill, and ``SERVE_WARMUP`` (default ``128,256``)
names the warmup buckets, as in the reference. Prompt
admission runs the reference's defaults: chunked prefill
(``SERVE_PREFILL_CHUNK``, default 256, 0 disables) and the prefix cache
(``SERVE_PREFIX``, default on, with the co-pilot template registered at
warmup; ``SERVE_PREFIX_TEXTS`` adds ``||``-separated templates and
``SERVE_PREFIX_MB`` bounds the store by bytes). ``PAGED_ATTN_IMPL``
(gather | kernel | flash, read anew at each build) picks the decode
branch: ``gather`` attends then writes (kernel B's append mode),
``kernel``/``flash`` write then attend (its pool mode, bf16 pool only:
``SERVE_KV_QUANT=int8`` with them is refused at build, as in the
reference). Decode runs fused K-step ticks as the reference does
(``SERVE_FUSE``, default 4, 1 disables): CUDA graphs per (attention
window, K) on the card, captured by the warmup, and the same functions
run eagerly on the CPU. ``SERVE_LOOP_BUDGET_MS`` (default 5000, 0
disables) is the scheduler loop watchdog's budget. Speculative
decoding with the n-gram source runs as in the reference
(``SERVE_SPEC`` = K draft tokens, default 0 = off;
``SERVE_SPEC_TREE_NODES``, default 8 when ``SERVE_SPEC`` > 0, tree verify
over that many nodes, 0 = linear; ``SERVE_SPEC_TREE_GAP``, default 4.0),
its spec programs CUDA graphs per window beside the decode graphs. The
KV tier runs as in the reference (``SERVE_KV_HOST_GB`` > 0 keeps
finished conversations open as sessions, parked to host memory after
``SERVE_KV_IDLE_S``, default 30, or under pool pressure; over the dense
cache at finish; a follow-up turn wakes them), with the session and
prefix export/import surface the front
serves under ``/admin/session*`` and ``/admin/prefix*``, and
:meth:`TorchEngine.prefill_park` for disaggregated prefill.

:meth:`TorchEngine.embed` serves ``/api/embed``: the family's
``embed_pooled`` over bucketed batches (kernels A or C and D on the
card), outside the scheduler loop, on its own CUDA stream and under the
scheduler's capture lock (see the method).
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, Optional

import torch

from ..models import family_for
from ..models.configs import CONFIGS, get_config
from ..tokenizer import ByteTokenizer, load_tokenizer
from ..utils.device import resolve_device
from ..utils.env import env_bool, env_float, env_int, env_or
from ..utils.log import get_logger
from .backend import Backend, GenerateRequest, RequestStats
from .scheduler import BatchScheduler, _bucket

log = get_logger("serve.torch_engine")


# The head of the reference co-pilot's fixed prompt template (a copy of
# p2p_llm_chat_tpu/serve/engine.py SUGGEST_PREFIX): every suggestion
# request starts with these bytes, so its KV is registered in the prefix
# cache at warmup.
SUGGEST_PREFIX = ("You are a helpful assistant. Draft a concise, friendly "
                  "reply to the following message:\n\n")


def default_chat_prompt(messages: list[dict]) -> str:
    """Model-agnostic flattening of an /api/chat messages list."""
    parts = []
    for m in messages:
        role = m.get("role", "user")
        parts.append(f"{role}: {m.get('content', '')}")
    parts.append("assistant:")
    return "\n".join(parts)


def embed_batches(ids: list[list[int]], max_seq: int
                  ) -> Iterator[tuple[int, torch.Tensor, torch.Tensor]]:
    """The embed path's bucketing (the reference's ``TPUEngine.embed``):
    chunks of at most 16 token lists, each as (texts in it, tokens
    [R, S] right-padded, lens [R] >= 1) on the host, with R = max(2, the
    next power of two) rows and S the scheduler's bucket of the longest.
    Pad rows and positions are part of the MoE capacity, as there."""
    for start in range(0, len(ids), 16):
        chunk = ids[start:start + 16]
        R = max(2, 1 << (len(chunk) - 1).bit_length())
        S = _bucket(max(len(i) for i in chunk), max_seq)
        toks = torch.zeros((R, S), dtype=torch.long)
        lens = torch.ones((R,), dtype=torch.long)
        for r, seq in enumerate(chunk):
            toks[r, :len(seq)] = torch.tensor(seq, dtype=torch.long)
            lens[r] = max(1, len(seq))
        yield len(chunk), toks, lens


class TorchEngine:
    """Backend over the continuous-batching scheduler, on ``device``
    (the card unless the CPU is asked for; see utils/device.py)."""

    def __init__(self, params: dict, config, tokenizer, *,
                 num_slots: int = 8, max_seq: int = 1024,
                 page_size: int = 64, num_pages: Optional[int] = None,
                 queue_timeout_s: Optional[float] = 60.0,
                 queue_max: Optional[int] = None, kv_quant: bool = False,
                 prefix_cache: bool = True,
                 prefix_texts: tuple[str, ...] = (SUGGEST_PREFIX,),
                 prefill_chunk: int = 256,
                 attn_impl: Optional[str] = None,
                 admit_chunk: Optional[int] = None,
                 decode_fuse_max: int = 4,
                 loop_budget_ms: float = 5000.0,
                 spec_k: int = 0, spec_tree_nodes: int = 0,
                 spec_tree_gap: float = 4.0,
                 kv_host_gb: float = 0.0, kv_idle_s: float = 30.0,
                 kv_mode: str = "dense", draft: Optional[tuple] = None,
                 name: Optional[str] = None,
                 device: Optional[torch.device | str] = None) -> None:
        """``kv_mode``: ``dense`` (the default, as the reference's) or
        ``paged`` (serve/scheduler.py).""
        ``draft``: ``(params, config)`` of a small draft model made
        resident beside the target (needs ``spec_k`` > 0, the target's
        vocabulary and a max_seq covering the target's; a pairing that
        does not fit logs a warning and serves n-gram-only, as the
        reference's)."""
        self.name = name or config.name
        self.config = config
        self.prefix_texts = tuple(prefix_texts) if prefix_cache else ()
        drafter = None
        if draft is not None and spec_k:
            dparams, dconfig = draft
            serve_seq = min(max_seq, config.max_seq_len)
            if dconfig.vocab_size != config.vocab_size:
                log.warning(
                    "SERVE_DRAFT model %s (vocab %d) cannot draft for %s "
                    "(vocab %d); falling back to n-gram-only speculation",
                    dconfig.name, dconfig.vocab_size, config.name,
                    config.vocab_size)
            elif min(max_seq, dconfig.max_seq_len) < serve_seq:
                log.warning(
                    "SERVE_DRAFT model %s (max_seq_len %d) cannot cover the "
                    "serving budget %d; falling back to n-gram-only "
                    "speculation", dconfig.name, dconfig.max_seq_len,
                    serve_seq)
            else:
                from .draft_model import ModelDrafter
                drafter = ModelDrafter(dparams, dconfig, num_slots=num_slots,
                                       max_seq=max_seq, k=spec_k)
                log.info("draft model resident: %s (%.2f GB params, %.2f GB "
                         "KV at %d slots x %d) drafting k=%d for %s",
                         dconfig.name, drafter.param_bytes() / 1e9,
                         drafter.kv_bytes() / 1e9, num_slots,
                         drafter.max_seq, spec_k, config.name)
        self.drafter = drafter
        self.scheduler = BatchScheduler(
            params, config, tokenizer, num_slots=num_slots, max_seq=max_seq,
            page_size=page_size, num_pages=num_pages,
            queue_timeout_s=queue_timeout_s, queue_max=queue_max,
            kv_quant=kv_quant, prefix_cache=prefix_cache,
            prefill_chunk=prefill_chunk, attn_impl=attn_impl,
            admit_chunk=admit_chunk, decode_fuse_max=decode_fuse_max,
            loop_budget_ms=loop_budget_ms, spec_k=spec_k,
            spec_tree_nodes=spec_tree_nodes, spec_tree_gap=spec_tree_gap,
            kv_host_gb=kv_host_gb, kv_idle_s=kv_idle_s, kv_mode=kv_mode,
            drafter=drafter, device=device)
        self._embed_lock = threading.Lock()
        self._embed_stream = None
        # The checkpoint load's walls (models/weights.py stats) when the
        # engine was built from one, else None.
        self.load_stats: Optional[dict] = None

    def generate_stream(self, req: GenerateRequest,
                        stats: Optional[RequestStats] = None) -> Iterator[str]:
        return self.scheduler.submit(req, stats)

    def render_chat(self, messages: list[dict]) -> str:
        """/api/chat prompt rendering (the reference's): with a tokenizer
        that has llama3's header and eot specials (an instruct
        checkpoint's), the llama3 chat template; BOS is added at encode
        time, so it is not part of the template. Other tokenizers (bytes)
        get the model-agnostic role flattening."""
        tok = self.scheduler.tokenizer
        has = getattr(tok, "has_special", None)
        if not (callable(has) and has("<|start_header_id|>")
                and has("<|eot_id|>")):
            return default_chat_prompt(messages)
        # Roles and contents are untrusted: encode() maps special strings
        # anywhere in text to control ids, so a message could forge turn
        # structure. Strip them; only the template's own specials stay.
        clean = tok.strip_specials
        parts = []
        for m in messages:
            role = clean(str(m.get("role", "user")))
            parts.append(f"<|start_header_id|>{role}<|end_header_id|>\n\n"
                         f"{clean(str(m.get('content', '')))}<|eot_id|>")
        parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(parts)

    def embed(self, texts: list[str]) -> tuple[list[list[float]], int]:
        """Sequence embeddings for ``/api/embed[dings]`` (the reference's
        ``TPUEngine.embed``): each text encoded with BOS and cut to
        max_seq, bucketed by :func:`embed_batches`, through the family's
        ``embed_pooled`` (unit vectors of the length-masked mean of the
        final-norm hidden states). Returns (vectors, total tokens).

        It runs on the calling thread, outside the scheduler loop, as the
        reference's does: it reads only the params, so it cannot race the
        loop's state, and ``_embed_lock`` runs one embed at a time. On
        the card each chunk runs on the engine's own CUDA stream, so it
        overlaps the loop's decode ticks instead of queueing between them
        (the ticks' results do not depend on it), and under the
        scheduler's ``capture_lock``, so none of its CUDA calls can land
        inside a decode-graph capture (a capture waits for the chunk in
        flight; the warmup captures every graph before traffic)."""
        sched = self.scheduler
        ids = [sched.tokenizer.encode(t, add_bos=True)[:sched.max_seq]
               for t in texts]
        n_tokens = sum(len(i) for i in ids)
        out: list[list[float]] = []
        with self._embed_lock:
            for n, toks, lens in embed_batches(ids, sched.max_seq):
                vecs = self._embed_chunk(toks, lens)
                out.extend(vecs[r].tolist() for r in range(n))
        return out, n_tokens

    def _embed_chunk(self, toks: torch.Tensor, lens: torch.Tensor
                     ) -> torch.Tensor:
        """One bucketed chunk's [R, H] vectors, on the host."""
        sched = self.scheduler
        dev = sched.device

        def run() -> torch.Tensor:
            return sched._family.embed_pooled(
                sched._params, self.config, toks.to(dev), lens.to(dev)).cpu()

        if dev.type != "cuda":
            return run()
        if self._embed_stream is None:
            self._embed_stream = torch.cuda.Stream(dev)
        with sched.capture_lock:
            # After everything already queued on the serving stream (the
            # weights' build included); the readback syncs this stream only.
            self._embed_stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._embed_stream):
                return run()

    def warmup(self, buckets: tuple[int, ...] = (128, 256),
               background: bool = True) -> None:
        """Run the serving path once before traffic (on the card this
        builds and loads the CUDA kernels and captures the decode graphs
        of every window and K) and register the prefix templates; /readyz
        stays not-ready until it is done, and for good if it fails (the
        error is kept in :attr:`warmup_error`). ``background``: on a
        thread of its own, else on the caller's, raising what the warmup
        raised (serve/multi.py walks its engines so)."""
        if not background:
            self.scheduler.warmup(buckets, self.prefix_texts)
            return

        def run() -> None:
            try:
                self.scheduler.warmup(buckets, self.prefix_texts)
            except Exception:   # noqa: BLE001 — kept as warmup_error
                log.exception("warmup failed")

        self.scheduler.note_warmup_pending()
        threading.Thread(target=run, daemon=True, name="warmup").start()

    def note_warmup_pending(self) -> None:
        """Report not-ready until a warmup to come has run."""
        self.scheduler.note_warmup_pending()

    def models(self) -> list[str]:
        return [self.name]

    def ready(self) -> bool:
        return self.scheduler.ready

    @property
    def warmup_error(self) -> Optional[BaseException]:
        return self.scheduler.warmup_error

    def metrics_snapshot(self) -> dict[str, float]:
        return self.scheduler.metrics_snapshot()

    # -- grafttrace (obs/) ----------------------------------------------------

    def set_trace_store(self, store) -> None:
        """The front injects its span store, so the scheduler's
        queue-wait / prefill / decode spans land beside the front's
        ``api.request`` span under one trace id."""
        self.scheduler.set_trace_store(store)

    def flight_snapshot(self) -> list:
        return self.scheduler.flight_snapshot()

    def flight_dump(self, reason: str = "on_demand") -> str:
        return self.scheduler.flight_dump(reason)

    # -- the shared prefix tier (serve/prefix.py) ----------------------------

    def prefix_hashes(self) -> Optional[dict]:
        """{token_hash: {len, hits}} of cached prefixes, or None with the
        prefix cache off (the front answers 501)."""
        store = self.scheduler._prefix
        return None if store is None else store.hashes()

    def prefix_export(self, h: str) -> Optional[bytes]:
        """One entry's wire payload. Its k/v copy off the card on this
        (HTTP) thread, under the scheduler's capture lock, as an embed's
        work does, so no copy lands inside a decode-graph capture."""
        sched = self.scheduler
        if sched._prefix is None:
            return None
        with sched.capture_lock:
            return sched._prefix.export_payload(h)

    def prefix_import(self, data: bytes):
        """Install a peer's exported prefix entry on this engine's device
        (the store locks; the loop reads entries between admissions; the
        copy onto the card holds the capture lock, as in
        :meth:`prefix_export`). None on a malformed payload or one of
        another geometry."""
        sched = self.scheduler
        if sched._prefix is None:
            return None
        cfg = self.config
        with sched.capture_lock:
            return sched._prefix.import_payload(
                data, device=sched.device,
                geometry=(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim))

    # -- sessions: migration and disaggregated prefill (serve/kv_tier.py) ---

    def session_list(self) -> Optional[dict]:
        return self.scheduler.session_list()

    def session_export(self, key: str) -> Optional[bytes]:
        return self.scheduler.session_export(key)

    def session_import(self, data: bytes):
        return self.scheduler.session_import(data)

    def session_forget(self, key: str) -> Optional[bool]:
        return self.scheduler.session_forget(key)

    def session_park_all(self) -> None:
        self.scheduler.park_all()

    def prefill_park(self, req: GenerateRequest) -> Optional[dict]:
        """The prefill side of a disaggregated handoff: prefill the prompt
        minus its last token and retain it as an exportable session
        (scheduler.prefill_park). None = the request cannot ride it."""
        return self.scheduler.prefill_park(req)

    def drain(self) -> None:
        self.scheduler.drain()

    def undrain(self) -> None:
        self.scheduler.undrain()

    def draining(self) -> bool:
        return self.scheduler.draining

    def stop(self) -> None:
        self.scheduler.stop()


def _not_in_slice(what: str) -> SystemExit:
    return SystemExit(f"{what} is not ported to the PyTorch engine yet "
                      "(p2p_llm_chat_tpu_torch serves llama and mixtral "
                      "models from a dense KV cache or a paged KV pool on "
                      "one card in this version)")


def is_ckpt_ref(ref: str) -> bool:
    """A ``SERVE_MODELS`` ref is a checkpoint directory only when it looks
    like a path (holds a separator) or is not a registered config name: a
    config name that happens to name a directory in the working directory
    still serves the config (the reference's rule)."""
    if os.sep in ref:
        return True
    if ref in CONFIGS:
        return False
    return os.path.isdir(ref)


def parse_serve_models(spec: str, ckpt_dir: str = "",
                       default_tag: str = "default") -> list[tuple[str, str]]:
    """``SERVE_MODELS`` as ``[(tag, ref), ...]``, ``ckpt_dir`` (when set)
    first under ``default_tag``; the whole spec is checked here, before
    any engine starts (an engine runs a live scheduler thread, so a bad
    later entry must not leak earlier ones): an empty or duplicate tag,
    an unknown config or a missing directory exits."""
    specs: list[tuple[str, str]] = []
    if ckpt_dir:
        specs.append((default_tag, ckpt_dir))
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        tag, _, ref = part.partition("=")
        if not tag:
            raise SystemExit(f"SERVE_MODELS entry {part!r} has an empty "
                             "tag")
        if any(t == tag for t, _ in specs):
            raise SystemExit(f"SERVE_MODELS has duplicate tag {tag!r}")
        specs.append((tag, ref or tag))
    for tag, ref in specs:
        if is_ckpt_ref(ref):
            if not os.path.isdir(ref):
                raise SystemExit(f"SERVE_MODELS entry {tag}={ref}: no such "
                                 "checkpoint directory")
        else:
            try:
                get_config(ref)
            except KeyError as e:
                raise SystemExit(f"SERVE_MODELS entry {tag}={ref}: "
                                 f"{e}") from None
    return specs


def build_engine_from_env(device: Optional[str | torch.device] = None,
                          params: Optional[dict] = None) -> Backend:
    """Engine (or a multi-model front) from env vars, on ``device`` — by
    default the card (``SERVE_DEVICE`` or the argument may ask for
    ``cpu``; with neither and no card this raises). ``CKPT_DIR`` serves a
    checkpoint directory; without it, random-init ``MODEL_CONFIG``
    (default ``tiny``) weights and the byte tokenizer. ``params``:
    weights of ``MODEL_CONFIG`` to serve instead of the random init,
    already on the device (e.g. models/synth.quote_params, whose output
    n-gram drafts match)."""
    if env_or("SERVE_COORDINATOR", "") or env_or("JAX_COORDINATOR", ""):
        raise _not_in_slice("multi-host serving")
    # Speculative decoding (the reference's engine.py:399-418): K n-gram
    # draft tokens per spec tick; tree verify over SERVE_SPEC_TREE_NODES
    # nodes (default 8 with speculation on; the scheduler snaps it).
    spec_k = max(0, env_int("SERVE_SPEC", 0))
    # Draft-model speculation (serve/draft_model.py): a config name or a
    # checkpoint directory of a small model resident beside the target.
    draft_ref = env_or("SERVE_DRAFT", "")
    if draft_ref and not spec_k:
        log.warning("SERVE_DRAFT set but SERVE_SPEC=0 — no speculative "
                    "ticks will run; set SERVE_SPEC (e.g. 4) to enable "
                    "the drafter")
    spec_tree_nodes = env_int("SERVE_SPEC_TREE_NODES", 8) if spec_k else 0
    spec_tree_gap = env_float("SERVE_SPEC_TREE_GAP", 4.0)
    if env_int("SERVE_TP", 1) > 1:
        raise _not_in_slice("tensor parallelism (SERVE_TP>1)")
    if env_int("SERVE_PROFILE_PORT", 0) > 0:
        raise _not_in_slice("the live profiler server (SERVE_PROFILE_PORT)")
    quant = env_or("SERVE_QUANT", "")
    if quant not in ("", "int8", "int4"):
        raise SystemExit(f"SERVE_QUANT must be one of '', 'int8', 'int4'; "
                         f"got {quant!r}")
    kv_mode = env_or("SERVE_KV", "dense")
    if kv_mode not in ("dense", "paged"):
        raise SystemExit(f"SERVE_KV must be dense|paged, got {kv_mode!r}")
    kv_quant = env_or("SERVE_KV_QUANT", "")
    if kv_quant not in ("", "int8"):
        raise SystemExit(
            f"SERVE_KV_QUANT must be int8 or empty, got {kv_quant!r}")
    if kv_quant and kv_mode != "paged":
        raise SystemExit("SERVE_KV_QUANT=int8 requires SERVE_KV=paged")
    ckpt_dir = env_or("CKPT_DIR", "")
    models_spec = env_or("SERVE_MODELS", "")
    specs = (parse_serve_models(models_spec, ckpt_dir,
                                env_or("LLM_MODEL", "default"))
             if models_spec else [])
    # Fused multi-step decode: up to this many decode steps per tick
    # (adaptive, scheduler._choose_fuse_k). 1 disables.
    decode_fuse_max = max(1, env_int("SERVE_FUSE", 4))
    # Read at each build (not the module's import-time default), so one
    # process can build engines with either branch; BatchScheduler checks
    # it and refuses an int8 pool under a non-gather impl.
    attn_impl = env_or("PAGED_ATTN_IMPL", "gather")
    prefill_chunk = max(0, env_int("SERVE_PREFILL_CHUNK", 256))
    # The KV tier (serve/kv_tier.py): > 0 GB of host memory keeps
    # finished conversations open as sessions.
    kv_host_gb = env_float("SERVE_KV_HOST_GB", 0.0)
    kv_idle_s = env_float("SERVE_KV_IDLE_S", 30.0)
    prefix_cache = env_bool("SERVE_PREFIX", True)
    prefix_texts = (SUGGEST_PREFIX,) + tuple(
        t for t in env_or("SERVE_PREFIX_TEXTS", "").split("||") if t)
    dev = resolve_device(device)
    qt = env_float("SERVE_QUEUE_TIMEOUT", 60.0)
    qm = env_int("SERVE_QUEUE_MAX", -1)
    log.info("serving %s weights, %s %s KV on %s; paged attention impl %s "
             "(%s); prefill chunk %d, prefix cache %s, fused decode up to "
             "%d steps a tick; speculation K=%d, tree nodes %d; KV tier "
             "%.1f GB of host memory", quant or "bf16", kv_quant or "bf16",
             kv_mode, dev, attn_impl, "attend-then-write"
             if attn_impl == "gather" else "write-then-attend", prefill_chunk,
             "on" if prefix_cache else "off", decode_fuse_max, spec_k,
             spec_tree_nodes, kv_host_gb)

    def load_draft_for(config) -> Optional[tuple]:
        """(params, config) for SERVE_DRAFT against this target, or None
        (the reference's ``load_draft_for``). A directory loads through
        models/weights.py, then quantizes at SERVE_QUANT; a config name
        random-inits at seed 101 with the TARGET's vocabulary. Only a
        failed LOAD degrades to n-gram-only (the drafter is an optimizer
        and must not take serving down); kernel builds and launches are
        never caught here."""
        if not draft_ref or not spec_k:
            return None
        if os.sep in draft_ref or os.path.isdir(draft_ref):
            from ..models.quant import quantize_params
            from ..models.weights import load_checkpoint
            try:
                dparams, dconfig = load_checkpoint(draft_ref, device=dev)
            except Exception:   # noqa: BLE001 — degrade, don't fail boot
                log.exception("SERVE_DRAFT checkpoint %r failed to load; "
                              "falling back to n-gram-only speculation",
                              draft_ref)
                return None
            if quant:
                dparams = family_for(dconfig).fuse_params(
                    quantize_params(dparams, mode=quant))
            return dparams, dconfig
        try:
            dconfig = get_config(draft_ref)
        except KeyError:
            log.warning("SERVE_DRAFT %r is neither a checkpoint dir nor a "
                        "registered config; falling back to n-gram-only "
                        "speculation", draft_ref)
            return None
        if dconfig.vocab_size != config.vocab_size:
            dconfig = dconfig.with_(vocab_size=config.vocab_size)
        return (family_for(dconfig).init_params_quantized(
            dconfig, seed=101, quant=quant, device=dev), dconfig)

    def make_engine(params, config, tokenizer, name: str) -> TorchEngine:
        return TorchEngine(
            params, config, tokenizer,
            num_slots=env_int("SERVE_SLOTS", 8),
            max_seq=env_int("SERVE_MAX_SEQ", 1024),
            page_size=env_int("SERVE_PAGE_SIZE", 64),
            num_pages=env_int("SERVE_PAGES", 0) or None,
            queue_timeout_s=qt if qt > 0 else None,
            queue_max=None if qm < 0 else qm,
            kv_quant=bool(kv_quant), prefix_cache=prefix_cache,
            prefix_texts=prefix_texts, prefill_chunk=prefill_chunk,
            attn_impl=attn_impl,
            admit_chunk=env_int("SERVE_ADMIT_CHUNK", 0) or None,
            decode_fuse_max=decode_fuse_max,
            loop_budget_ms=env_float("SERVE_LOOP_BUDGET_MS", 5000.0),
            spec_k=spec_k, spec_tree_nodes=spec_tree_nodes,
            spec_tree_gap=spec_tree_gap, kv_host_gb=kv_host_gb,
            kv_idle_s=kv_idle_s, kv_mode=kv_mode,
            draft=load_draft_for(config), name=name, device=dev)

    def random_engine(config, seed: int, name: str) -> TorchEngine:
        log.info("%s: random-init %s (seed %d) with the byte tokenizer",
                 name, config.name, seed)
        return make_engine(
            family_for(config).init_params_quantized(
                config, seed=seed, quant=quant, device=dev),
            config, ByteTokenizer(vocab_size=config.vocab_size), name)

    def load_ckpt_engine(tag: Optional[str], path: str) -> TorchEngine:
        """One fully independent engine from a checkpoint directory: its
        own params, tokenizer, scheduler and KV pool. The single-model
        CKPT_DIR path uses it too (``tag`` None names the engine
        LLM_MODEL or the config's name)."""
        from ..models.quant import quantize_params
        from ..models.weights import (UnsupportedForQuantizedLoad,
                                      load_checkpoint,
                                      load_checkpoint_quantized)
        stats: dict = {}
        params = None
        if quant:
            # Stream straight into the fused quantized tree: the bf16
            # model never exists on the card.
            try:
                params, config = load_checkpoint_quantized(
                    path, quant=quant, device=dev, stats=stats)
            except UnsupportedForQuantizedLoad:
                # Family out of scope: the standard path below. Real load
                # errors (corrupt shards) propagate.
                params = None
        if params is None:
            params, config = load_checkpoint(path, device=dev)
            if quant:
                params = family_for(config).fuse_params(
                    quantize_params(params, mode=quant))
                log.info("weights quantized to %s after a bf16 load", quant)
        tokenizer = load_tokenizer(path, vocab_size=config.vocab_size)
        engine = make_engine(params, config, tokenizer,
                             name=tag or env_or("LLM_MODEL", config.name))
        engine.load_stats = stats or None
        return engine

    if specs:
        from .multi import MultiBackend
        backends: dict = {}
        try:
            for i, (tag, ref) in enumerate(specs):
                backends[tag] = (load_ckpt_engine(tag, ref)
                                 if is_ckpt_ref(ref) else
                                 random_engine(get_config(ref), i, tag))
        except BaseException:
            for b in backends.values():
                b.stop()
            raise
        engine: Backend = MultiBackend(backends, default=specs[0][0])
        log.info("multi-model serving: %s", ", ".join(engine.models()))
    elif ckpt_dir:
        engine = load_ckpt_engine(None, ckpt_dir)
    else:
        config = get_config(env_or("MODEL_CONFIG", "tiny"))
        name = env_or("LLM_MODEL", config.name)
        if params is None:
            engine = random_engine(config, 0, name)
        else:
            engine = make_engine(
                params, config, ByteTokenizer(vocab_size=config.vocab_size),
                name)
    warm = env_or("SERVE_WARMUP", "128,256")
    if warm and warm != "0":
        engine.warmup(tuple(int(b) for b in warm.split(",") if b.strip()))
    return engine
