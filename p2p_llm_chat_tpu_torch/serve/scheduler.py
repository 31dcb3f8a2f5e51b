"""Continuous-batching scheduler over the dense KV cache or the paged KV
pool — a lean port of p2p_llm_chat_tpu/serve/scheduler.py's core.

``kv_mode`` picks the KV layout as the reference's does: ``dense`` (the
default here and in ``build_engine_from_env``, as in the reference) keeps
one ``[L, B, max_seq, Hkv, D]`` cache whose row b is batch row b
(models/llama.KVCache): admission copies the prefill's KV into the
rows' first slots, decode is the family's dense ``decode_step`` (kernel
B's pool mode over an identity pool view of the cache,
ops/dense_attention.py) and speculation its ``verify_step`` /
``verify_tree`` (kernel B's verify mode over the same view), with the
resident draft model (serve/draft_model.py) as a second draft source.
``paged`` (the port's earlier path, described below) keeps a page pool
with per-row page tables.

One background thread owns the device state (params, pool, per-row
sampling state) and runs the loop; HTTP threads talk to it through
queues only:

- ``submit`` enqueues a request (a bounded queue: at ``queue_max`` queued
  requests it raises :class:`OverloadError`, the front's 503);
- admission groups pending requests by (cached prefix, power-of-two
  prompt bucket), reserves each request's page budget from the
  :class:`PageAllocator`, prefills the group together (the family's
  ``prefill``: models/llama.py or models/mixtral.py, chosen by
  ``models.family_for``), splices its KV into the pool
  (ops/paged_kv.write_prefill_batch) and samples each row's first token;
- chunked prefill: a bucket larger than ``prefill_chunk`` (which divides
  it) admits through a carry in chunks of that width, ONE chunk per loop
  iteration with decode ticks in between; each chunk's KV lands in the
  rows' pages as it is computed (write_prefill_chunk), and the rows'
  tables and lengths install only with the final chunk, which samples
  from the carried logits;
- the prefix cache (serve/prefix.py): a prompt that begins with a cached
  prefix (a registered template such as the co-pilot's, or a head
  auto-promoted after repeated sightings) prefills only its suffix, at
  positions P.. over the prefix KV broadcast into each row's carry; the
  combined KV is copied into the row's own pages;
- decode runs as fused K-step ticks (the reference's ``SERVE_FUSE``,
  default 4): one tick is ``decode_fused`` over K steps of
  ``decode_step_paged`` (every row; parked rows ride along, their writes
  land in the garbage page or past their trusted length), each step
  sampling on the device — per-row options, keys, penalty rings, the
  next-token feed and EOS parking live in tensors allocated once. On the
  card each (attention window, K) program is a CUDA graph captured at
  warmup and replayed with one host launch; on the CPU the same function
  runs eagerly. K follows the reference's adaptive ramp
  (:meth:`BatchScheduler._choose_fuse_k`) and the window its power-of-two
  ladder (:meth:`BatchScheduler._window`), covering every live row's
  context under either attention branch;
- dispatch is pipelined one tick deep: tick N+1 is launched before tick
  N's ``[K, B]`` token block is read back (copied behind a CUDA event),
  so the host's bookkeeping and streaming overlap the device's work;
  every device operation runs on one stream, which keeps a released
  row's pages safe to reuse;
- a request stops on EOS, ``num_predict``, a ``stop`` string or its
  context budget; its row's page table is zeroed and its pages freed;
- detokenization is incremental and UTF-8 safe, and holds back text that
  may be the start of a stop string;
- speculative decoding (the reference's ``SERVE_SPEC``): with ``spec_k``
  > 0 the n-gram source (utils/draft.py) proposes up to K tokens per row
  from the row's own context, and a spec tick verifies [pending token,
  drafts] in ONE forward (the family's ``verify_step_paged``, or
  ``verify_tree_paged`` over ``spec_tree_nodes`` node positions), accepts
  an exactly distributed prefix on the device
  (models/sampling.spec_verify_batched / spec_verify_tree), advances the
  lengths by accepted + 1 and reads back (accepted, correction, used
  sibling) per row. Each source is throttled on its own acceptance EMA
  (the reference's constants). On the card each spec program is a CUDA
  graph per window, captured at warmup beside the decode graphs, fed
  from static device buffers that one pinned host copy fills per tick.

- the KV tier (serve/kv_tier.py, the reference's ``SERVE_KV_HOST_GB``):
  a finished request's KV stays open as a session keyed by its
  ``session`` id (or its prompt head) — resident pages, or parked to host
  tensors (one gather of the raw pool words, one readback) on idle
  timeout, page-pool pressure or :meth:`BatchScheduler.park_all`. A
  follow-up whose prompt extends a session's tokens WAKES: the parked
  payload uploads (from match time on) and scatters into new pages, or
  the resident pages re-enter a row's table, and only the suffix runs
  ONE verify-shaped forward at the session's length (the family's
  ``verify_step_paged`` with ``last_idx``: kernel B's verify mode on the
  card, S up to ``_WAKE_MAX_SUFFIX``), then the first token samples as in
  a cold admission. The wake forward runs over the waking rows only (a
  row's output depends on no other row), eagerly, as admission does.
  Sessions export and import in the reference's wire format (migration,
  disaggregated prefill: :meth:`BatchScheduler.prefill_park`).
  Over the dense cache, as in the reference, a session has no resident
  phase: a finished row's first ``W`` slots (W = the power-of-two bucket
  of its trusted length) are copied to host tensors at finish, and a
  wake copies them back into a free row in place and runs the same
  verify-shaped forward on that row of the cache's identity pool view
  (ops/dense_attention.rows_view).

Every prefill attention (whole prompt, chunk, prefix suffix) runs kernel
D on the card.

The robustness plane is the reference's: the failpoint sites
``serve.scheduler.admit`` (both admission legs), ``.dispatch``,
``.promote`` and ``serve.engine.readback`` (utils/failpoints.py), a
loop watchdog (``loop_budget_ms``), an always-on flight recorder of
loop events dumped on a stall, a reset or on demand (obs/flight.py), the
``sched.queue_wait`` / ``sched.prefill`` / ``sched.decode`` spans of
sampled requests (obs/trace.py), and the warmup's device-step probe
behind ``decode_device_ms``.

Tensor parallelism (``mesh``, the reference's ``SERVE_TP`` inside this
engine): every device call the loop makes goes through :meth:`BatchScheduler.
_dev` as one op of host values (serve/tp.py): the leader (rank 0) sends it
to the follower ranks over the gloo control group, then runs it; each
follower runs the same op on its own scheduler (built the same way, with
no loop thread), so every rank issues the same kernels and collectives in
the same order on its shard (the pool and the dense cache cut over kv
heads, parallel/sharding.py). Host decisions (queue, allocator, prefix
lookup, drafts, streaming) are the leader's alone. Sampling runs on every
rank from the gathered logits, the same bytes everywhere, so no follower
reads a token back; each rank folds what it sampled into a running
digest, compared at shutdown. Under tp the decode and spec programs run
eagerly (gloo's host staging cannot be captured in a CUDA graph), and the
draft model is refused (the engine's build ignores ``SERVE_DRAFT``).

The KV tier runs under tp as on one card: its index, policies and host
bytes are the leader's, and every payload keeps the one-card wire format
with every kv head. A park gathers each rank's pages (or dense row) and
all-gathers the kv-head axis over ``tp`` in rank order; only the leader
reads the result back. A wake, an import or a prefix import broadcasts the
leader's arrays over ``tp`` as tensors (never in the op blob), and each
rank scatters its own heads; the wake's forward then runs as an op like
a tick. Page ids are host values in every op, so every rank's pool
agrees; freeing pages and forgetting a session change host state only.

Every op runs under ``torch.profiler.record_function("sched.<op>")``, so
a capture of the loop (obs/profile_server.py) names the scheduler's work.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch

from .. import ops
from ..models import family_for
from ..models.configs import ModelConfig
from ..models.llama import KVCache
from ..models.quant import param_bytes, quant_mode
from ..models.sampling import (sample_step_batched, spec_verify_batched,
                               spec_verify_tree)
from ..obs.flight import FlightRecorder
from ..ops import paged_attention as pa
from ..ops.dense_attention import VIEW_PAGE, rows_view
from ..ops.paged_kv import (PageAllocator, PagedKVCache, copy_slot,
                            gather_pages, scatter_pages, write_prefill_batch,
                            write_prefill_chunk, zero_row)
from ..tokenizer import Tokenizer
from ..utils.device import resolve_device
from ..utils.draft import NGramSource
from ..utils.env import env_float
from ..utils.failpoints import failpoint
from ..utils.log import get_logger
from ..utils.metrics import Histogram
from .backend import (GenerateOptions, GenerateRequest, OverloadError,
                      RequestStats, normalize_request)
from .kv_tier import (HEAD_GRAIN, KVTier, SessionKV, deserialize_session,
                      head_key, tensor_nbytes)
from .prefix import DEFAULT_GRAIN_LADDER, PrefixEntry, PrefixStore

log = get_logger("serve.torch_scheduler")

_MIN_BUCKET = 16
# Cap on one admission group's R x S prefill footprint (the dense
# per-request cache and scores it materialises).
_ADMIT_TOKEN_BUDGET = 16384
# Repeat-penalty recent-token window (Ollama repeat_last_n default).
_RING = 64
# A registered template shorter than this is not cached (it would save
# almost nothing).
_MIN_REGISTER_PREFIX = 8
# Under sustained load (never idle), build a queued prefix promotion at
# most once per this many decode ticks.
_PROMOTE_EVERY_TICKS = 256
# Adaptive speculation (the reference's constants): below this EMA of
# accepted drafts per spec tick a source's verify costs more than it
# saves, and it only probes every _SPEC_PROBE_EVERY ticks. Each source
# seeds at twice the floor; zero-acceptance ticks decay it faster.
_SPEC_EMA_FLOOR = 0.5
_SPEC_EMA_ALPHA = 0.1
_SPEC_EMA_SEED = 2 * _SPEC_EMA_FLOOR
_SPEC_EMA_ZERO_ALPHA = 0.3
_SPEC_PROBE_EVERY = 8
# Widest suffix bucket a session wake admits (one verify-shaped forward,
# kernel B's verify mode on the card); longer new turns admit cold,
# through the chunked path.
_WAKE_MAX_SUFFIX = 256


class _DecodeProgram:
    """K decode steps, or a spec tick, at one attention window. On the
    card, a CUDA graph captured over the step function: a call replays
    it and adds to each kernel wrapper's launch counter what the capture
    recorded, so the counters go on counting what ran. On the CPU, the
    step function itself."""

    __slots__ = ("fn", "graph", "launches")

    def __init__(self, fn, graph=None, launches=()) -> None:
        self.fn = fn
        self.graph = graph
        self.launches = launches

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
            return
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n


def _bucket(n: int, max_seq: int) -> int:
    """Smallest power-of-two >= n (>= _MIN_BUCKET), capped at max_seq."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return min(b, max_seq)


@dataclass
class _Slot:
    """Host-side state of one request. Touched only by the scheduler
    thread after submit()."""

    req: GenerateRequest
    stats: Optional[RequestStats]
    out_q: "queue.Queue[Optional[str]]"
    seed: int
    ids: list[int] = field(default_factory=list)      # generated ids
    prompt_ids: list[int] = field(default_factory=list)
    text: str = ""
    decoded_upto: int = 0
    streamed: int = 0
    max_new: int = 0
    ctx_len: int = 0                                   # tokens in the pool
    ctx_budget: int = 0
    pages: Optional[list[int]] = None
    prefix: Optional[PrefixEntry] = None               # matched cached prefix
    prefix_checked: bool = False                       # match() ran
    # Session wake (the KV tier): the matched open session's key, and for
    # a parked one (session, payload on the device) — the upload started
    # at match time.
    wake_key: Optional[str] = None
    wake_dev: Optional[tuple] = None
    cancelled: threading.Event = field(default_factory=threading.Event)
    error: Optional[str] = None
    last_emit_t: float = 0.0
    admit_t: float = 0.0                               # admission dispatch
    on_depart: Optional[object] = None
    departed: bool = False
    done: bool = False

    def push(self, delta: str) -> None:
        if delta:
            self.out_q.put(delta)

    def depart(self) -> None:
        if not self.departed:
            self.departed = True
            if self.on_depart is not None:
                self.on_depart()

    def finish(self) -> None:
        self.depart()
        self.done = True
        if self.stats is not None and self.stats.total_s is None:
            self.stats.total_s = time.monotonic() - self.req.arrival_time
        if self.stats is not None and self.stats.context is None:
            self.stats.context = list(self.prompt_ids) + list(self.ids)
        self.out_q.put(None)

    def fail(self, msg: str) -> None:
        self.error = msg
        self.finish()


@dataclass
class _PrefillCarry:
    """A half-prefilled admission chunk (chunked prefill): its host
    arrays. Touched only by the scheduler thread; the device carry lives
    in ``BatchScheduler._pc_dev`` on every rank (:meth:`BatchScheduler.
    _dev_chunk`)."""

    chunk: list[_Slot]
    rows: list[int]
    S: int                         # suffix bucket, a multiple of C
    C: int                         # chunk width
    off: int                       # suffix tokens already prefilled
    prefix: Optional[PrefixEntry]
    tokens: torch.Tensor           # [R, S] right-padded suffix tokens
    suf_lens: torch.Tensor         # [R] suffix lengths
    total_lens: torch.Tensor       # [R] prefix + suffix lengths
    tables: torch.Tensor           # [R, max_pages_per_row] page maps


class _SlotStream:
    """Iterator over a submitted request's deltas; closing it (client
    gone) cancels the request even if iteration never started."""

    __slots__ = ("_gen", "_slot")

    def __init__(self, gen, slot) -> None:
        self._gen = gen
        self._slot = slot

    def __iter__(self) -> "_SlotStream":
        return self

    def __next__(self) -> str:
        return next(self._gen)

    def close(self) -> None:
        self._slot.cancelled.set()
        self._gen.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:   # noqa: BLE001 — interpreter-shutdown GC
            pass


_capture_locks: dict[str, threading.Lock] = {}
_capture_locks_mu = threading.Lock()


def capture_lock_for(device: torch.device) -> threading.Lock:
    """The capture lock of ``device``: one per device in the process,
    shared by every scheduler on it, so a CUDA-graph capture of one engine
    never overlaps device work another thread launches under the lock
    (an embed, a prefix copy) for any engine on that card."""
    index = device.index
    if index is None and device.type == "cuda":
        index = torch.cuda.current_device()
    with _capture_locks_mu:
        return _capture_locks.setdefault(f"{device.type}:{index}",
                                         threading.Lock())


class _WarmupJob:
    """A closure run ON the scheduler thread (only it may touch the
    device state) at the top of a loop iteration
    (:meth:`BatchScheduler.post_on_loop`): the warmup, an embed under
    tensor parallelism; ``result`` is what it returned."""

    __slots__ = ("fn", "done", "err", "result")

    def __init__(self, fn) -> None:
        self.fn = fn
        self.done = threading.Event()
        self.err: Optional[BaseException] = None
        self.result = None

    def run(self) -> None:
        try:
            self.result = self.fn()
        except BaseException as e:   # noqa: BLE001 — re-raised by caller
            self.err = e
        finally:
            self.done.set()


class _Payload:
    """Host or device arrays the leader hands every rank inside an op (a
    parked session, a prefix entry). In the op blob they ride as their
    (shape, dtype) only; the arrays follow as broadcasts over ``tp``
    (:meth:`BatchScheduler._receive`), so a 100 MB session is never
    pickled."""

    __slots__ = ("arrays", "spec")

    def __init__(self, arrays: tuple) -> None:
        self.arrays = arrays
        self.spec = tuple(None if a is None else (tuple(a.shape), a.dtype)
                          for a in arrays)

    def __getstate__(self) -> tuple:
        return self.spec

    def __setstate__(self, spec: tuple) -> None:
        self.spec = spec
        self.arrays = None


# Device ops (serve/tp.py's op names) -> the BatchScheduler method each
# runs; every argument is a host value (a _Payload's arrays follow it).
_OPS = {
    "reset": "_reset_device_state",
    "warm_prefill": "_dev_warm_prefill",
    "prefix": "_dev_prefix",
    "warm_window": "_warm_window",
    "probe": "_probe_device_step",
    "admit": "_dev_admit",
    "chunk": "_dev_chunk",
    "tick": "_dev_tick",
    "spec": "_dev_spec",
    "release": "_dev_release",
    "embed": "_dev_embed",
    "park": "_dev_park",
    "park_row": "_dev_park_row",
    "wake_kv": "_dev_wake_kv",
    "wake_row": "_dev_wake_row",
    "wake": "_dev_wake",
    "prefix_gather": "_dev_prefix_gather",
    "prefix_place": "_dev_prefix_place",
}


class BatchScheduler:
    """Owns the device state and the serving loop, on ``device`` (the card
    unless the CPU is asked for; see utils/device.py)."""

    def __init__(self, params: dict, config: ModelConfig,
                 tokenizer: Tokenizer, *, num_slots: int = 8,
                 max_seq: int = 1024, page_size: int = 64,
                 num_pages: Optional[int] = None,
                 queue_timeout_s: Optional[float] = 60.0,
                 queue_max: Optional[int] = None, kv_quant: bool = False,
                 prefix_cache: bool = False, prefill_chunk: int = 256,
                 attn_impl: Optional[str] = None,
                 admit_chunk: Optional[int] = None,
                 decode_fuse_max: int = 4,
                 loop_budget_ms: float = 5000.0,
                 spec_k: int = 0, spec_tree_nodes: int = 0,
                 spec_tree_gap: float = 4.0,
                 kv_host_gb: float = 0.0, kv_idle_s: float = 30.0,
                 kv_mode: str = "dense", drafter=None,
                 device: Optional[torch.device | str] = None,
                 mesh=None, follower: bool = False, tp_channel=None,
                 tp_index: int = 0) -> None:
        """``kv_mode``: ``dense`` (one ``[L, B, max_seq, Hkv, D]`` cache,
        the reference's default layout; bf16 only) or ``paged`` (the page
        pool, bf16 or int8).

        ``drafter``: a resident draft model (serve/draft_model.
        ModelDrafter) proposing after the n-gram source on rows it misses
        (with ``spec_k`` > 0; it must share the target's vocabulary and
        cover its rows and max_seq, with ``k == spec_k``, as the
        reference checks).

        ``kv_host_gb``: the KV tier (serve/kv_tier.py, the reference's
        ``SERVE_KV_HOST_GB``); > 0 keeps finished conversations' KV open
        as sessions — resident pages, parked to host tensors after
        ``kv_idle_s`` idle seconds or under page-pool pressure, and
        dropped past this many GB of host memory — so a follow-up turn
        wakes instead of re-prefilling. Over the dense cache a session
        parks to the host as its request finishes (no resident phase, as
        in the reference). 0 = off.

        ``spec_k``: speculative decoding with up to this many n-gram
        draft tokens per row and spec tick (0 = off; the reference's
        ``SERVE_SPEC``). ``spec_tree_nodes``: tree verify over this many
        node positions, snapped up to a power of two and dropped to 0
        (linear verify) below ``spec_k + 2``, as in the reference;
        ``spec_tree_gap``: a source's top-1/top-2 score gap below which a
        main-chain position gets a sibling (the n-gram source proposes
        none). Greedy output is the same with speculation on or off.

        ``loop_budget_ms``: the loop watchdog's budget (the
        reference's ``SERVE_LOOP_BUDGET_MS``, which build_engine_from_env
        reads; 0 disables). A loop iteration past it raises the
        ``loop_stall_ms`` / ``loop_stall_last_ms`` gauges, logs once per
        stall episode and dumps the flight recorder (obs/flight.py).

        ``decode_fuse_max``: fused multi-step decode (the reference's
        ``SERVE_FUSE``) — one tick runs up to this many decode steps
        (adaptive: :meth:`_choose_fuse_k`), each exactly the plain step,
        so the output does not change. 1 disables.

        ``admit_chunk``: burst-admission width (the reference's
        ``SERVE_ADMIT_CHUNK``). None admits as many rows per prefill as
        the admission token budget allows; a fixed width caps each
        prefill's rows, so a burst's first tokens land before the whole
        burst is prefilled.

        ``attn_impl``: the paged decode attention impl (gather |
        kernel | flash; None = ``PAGED_ATTN_IMPL``'s default in
        ops/paged_attention), which picks decode_step_paged's branch. An
        int8 pool (``kv_quant``) is served under ``gather`` only, as in the
        reference, and a non-gather impl with it is refused here, not at
        the first decode tick.

        ``prefill_chunk``: chunked prefill — a prompt whose bucket
        exceeds this budget (power-of-two snapped; it must divide the
        bucket, else the bucket admits in one piece) prefills in chunks
        the loop interleaves with decode ticks. 0 disables.

        ``prefix_cache``: shared-prefix KV caching (serve/prefix.py).
        Register templates with :meth:`register_prefix` / warmup
        ``prefix_texts``; a head seen twice auto-promotes.
        ``SERVE_PREFIX_MB`` > 0 bounds the store by bytes (cost eviction)
        instead of 8 entries.

        ``mesh``: tensor parallelism over the mesh's ranks (``params`` is
        this rank's shard, parallel/sharding.py; see the module's
        docstring). Rank 0 runs the loop and sends its device ops to the
        others; ``follower``: this rank mirrors them instead
        (:meth:`run_op`, serve/tp.tp_follower_loop) and runs no loop.
        ``tp_channel``: the leader's op stream (serve/tp.TPChannel) when
        several engines share the plane, each under its own ``tp_index``
        (the op header names it); None makes one for this engine alone."""
        if queue_max is not None and queue_max < 0:
            raise ValueError(f"queue_max must be >= 0, got {queue_max}")
        if prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}")
        if admit_chunk is not None and admit_chunk < 1:
            raise ValueError(f"admit_chunk must be >= 1, got {admit_chunk}")
        if decode_fuse_max < 1:
            raise ValueError(
                f"decode_fuse_max must be >= 1, got {decode_fuse_max}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if kv_mode not in ("dense", "paged"):
            raise ValueError(f"kv_mode must be dense|paged, got {kv_mode!r}")
        if kv_quant and kv_mode != "paged":
            raise ValueError("kv_quant=True needs kv_mode='paged' (the "
                             "dense cache is bf16)")
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._tp = self.mesh is not None
        if self._tp and drafter is not None:
            raise ValueError("the draft model does not run under tensor "
                             "parallelism")
        self._follower = self._tp and follower
        # Ways the KV cache's kv heads are cut over tp (1: whole on every
        # rank): what a park all-gathers and a wake slices.
        self._kv_ways = 1
        if self._tp:
            from ..parallel.sharding import Split
            split = Split.of(config, self.mesh)
            self._kv_ways = split.layers if split is not None else 1
            if self._kv_ways == 1 and not self._follower:
                log.info("tp=%d does not divide %s's heads, kv heads and "
                         "FFN: every rank computes the whole layers",
                         self.mesh.shape["tp"], config.name)
        self.kv_mode = kv_mode
        self.decode_fuse_max = decode_fuse_max
        self._fuse_ramp = 1
        self.spec_k = spec_k
        nodes = int(spec_tree_nodes or 0)
        if nodes > 0 and spec_k > 0:
            snapped = 1 << max(0, nodes - 1).bit_length()
            if snapped != nodes:
                log.info("spec_tree_nodes %d snapped to %d", nodes, snapped)
            nodes = snapped
            if nodes < spec_k + 2:
                log.info("spec_tree_nodes %d < spec_k+2 (%d): no sibling "
                         "budget — tree speculation off (linear spec)",
                         nodes, spec_k + 2)
                nodes = 0
        else:
            nodes = 0
        self.spec_tree_nodes = nodes
        self.spec_tree_gap = float(spec_tree_gap)
        # Draft sources in priority order, each with its own acceptance
        # EMA, probe counter and proposed / accepted / dispatch counters
        # (owned by the loop; /metrics reads them).
        self._sources: list = []
        self._spec_ema: dict[str, float] = {}
        self._spec_cooldown: dict[str, int] = {}
        self._n_spec_proposed_src: dict[str, int] = {}
        self._n_spec_accepted_src: dict[str, int] = {}
        self._n_spec_dispatch_src: dict[str, int] = {}
        self._n_spec_ticks = 0
        self._n_spec_accepted = 0
        self._n_spec_tree_nodes = 0
        self._n_spec_tree_rows = 0
        self._n_spec_tree_accepted = 0
        self._tree_base_np: Optional[tuple] = None
        if spec_k:
            self._add_source(NGramSource(spec_k))
        self._draft_model = drafter if spec_k else None
        if self._draft_model is not None:
            d = self._draft_model
            if d.config.vocab_size != config.vocab_size:
                raise ValueError(
                    f"drafter vocab {d.config.vocab_size} != target "
                    f"vocab {config.vocab_size}: a draft model must "
                    "share its target's vocabulary")
            if (d.num_slots != num_slots
                    or d.max_seq < min(max_seq, config.max_seq_len)):
                raise ValueError(
                    f"drafter geometry (slots={d.num_slots}, "
                    f"max_seq={d.max_seq}) does not cover the target's "
                    f"(slots={num_slots}, max_seq="
                    f"{min(max_seq, config.max_seq_len)})")
            if d.k != spec_k:
                raise ValueError(f"drafter k={d.k} != spec_k={spec_k}")
            d.program = self._drafter_program
            self._add_source(d)
        self.admit_chunk = admit_chunk
        self.attn_impl = pa.check_impl(
            pa._DEFAULT_IMPL if attn_impl is None else attn_impl)
        if kv_quant and self.attn_impl != "gather":
            raise ValueError(
                "kv_quant=True requires the gather attention impl; "
                f"PAGED_ATTN_IMPL={self.attn_impl!r} is set")
        self.device = resolve_device(device)
        self.config = config
        self.tokenizer = tokenizer
        self.num_slots = num_slots
        self.max_seq = min(max_seq, config.max_seq_len)
        self.page_size = page_size
        self.num_pages = (num_pages if num_pages is not None else
                          num_slots * -(-self.max_seq // page_size) + 1)
        self.kv_quant = kv_quant
        self.queue_timeout_s = queue_timeout_s
        self.queue_max = 8 * num_slots if queue_max is None else queue_max
        self._family = family_for(config)
        self._params = self._family.fuse_params(params)
        self._dtype = self._params["embed"].dtype
        self._weight_bytes = param_bytes(self._params)
        self._quant_mode = quant_mode(self._params)
        log.info("model weights: %.3f GB (%s) on %s",
                 self._weight_bytes / 1e9, self._quant_mode or "bf16",
                 self.device)
        self._stop_ids = set(config.eos_token_ids)
        eos = getattr(tokenizer, "eos_id", None)
        if eos is not None and 0 <= eos < config.vocab_size:
            self._stop_ids.add(eos)

        self._depth_mu = threading.Lock()
        self._queued_requests = 0     # guarded-by: _depth_mu
        self._n_shed = 0              # guarded-by: _depth_mu
        self._draining = threading.Event()
        self.loop_budget_ms = loop_budget_ms
        self._loop_stall_ms = 0.0       # owned-by: _loop (high-water max)
        self._loop_stalled = False      # owned-by: _loop
        self._loop_stall_last_ms = 0.0  # owned-by: _loop (last episode)
        # Start of the current loop iteration, read by metrics_snapshot
        # so an iteration that is still stalling shows on /metrics.
        self._loop_beat: Optional[float] = None
        # Flight recorder: loop-iteration counter for its events, the
        # always-on event ring, and the span store set_trace_store
        # installs (None = tracing off).
        self._loop_iter = 0
        self._last_fuse_k = 0
        self._flight = FlightRecorder()
        self._trace = None
        # Device time of one K = 1 decode step at the smallest window,
        # measured once at warmup's tail (_probe_device_step).
        self._decode_device_ms = 0.0
        # Held while a decode graph is captured. Work launched on the
        # card from another thread (TorchEngine.embed) holds it too, so
        # no CUDA call of that thread can land inside a capture. One lock
        # per device, shared by every scheduler on it (several engines
        # behind one front, serve/multi.py).
        self.capture_lock = capture_lock_for(self.device)
        self._warmup_started = False
        self._warmup_done_at: Optional[float] = 0.0
        # Set when warmup raised: the engine then never turns ready, and
        # callers waiting on ready() read why here.
        self.warmup_error: Optional[BaseException] = None
        self._slots: list[Optional[_Slot]] = [None] * num_slots
        self._waiting: list[_Slot] = []     # page-starved, FIFO
        self._admit_carry: list[_Slot] = []
        self._n_admitted = 0
        self._n_decode_ticks = 0
        self._n_decode_steps = 0
        self._n_fused_ticks = 0
        self._n_fused_steps = 0
        self._n_expired = 0
        self._tbt_hist = Histogram("inter_token_ms")
        # Steady-state wall per decode step: the interval between two
        # dispatches over the earlier one's K.
        self._wall_hist = Histogram("decode_wall_ms")
        self._last_dispatch: Optional[tuple[float, int]] = None
        # The longest decode-dispatch gap across admission work.
        self._decode_stall_ms = 0.0
        self._last_decode_t: Optional[float] = None
        self._admit_since_tick = False
        self.prefill_chunk = (_bucket(prefill_chunk, self.max_seq)
                              if prefill_chunk else 0)
        self._prefill_carry: Optional[_PrefillCarry] = None
        self._n_prefill_chunks = 0
        # Ladder grains that could never pass the admission guard (P +
        # the smallest suffix bucket > max_seq) are left out up front.
        self._prefix: Optional[PrefixStore] = None
        ladder = tuple(g for g in DEFAULT_GRAIN_LADDER
                       if g + _MIN_BUCKET <= self.max_seq)
        if prefix_cache and ladder:
            mb = env_float("SERVE_PREFIX_MB", 0.0)
            self._prefix = PrefixStore(grain_ladder=ladder,
                                       max_bytes=int(mb * 1e6),
                                       max_entries=64 if mb > 0 else 8)
        self._n_prefix_admits = 0
        self._n_prefix_tokens = 0
        self._promote_q: list[tuple[int, ...]] = []
        self._last_promote_tick = 0
        # The KV tier: the session index (its transitions run on the loop,
        # which owns the buffers they copy), the wake-latency histogram,
        # the (window, suffix bucket) wakes run so far (a shape not run
        # yet admits cold under live traffic, as in the reference), the
        # warmed prompt buckets a wake's suffix rounds up to, and the
        # park_all handshake.
        self._tier: Optional[KVTier] = None
        if kv_host_gb and kv_host_gb > 0:
            self._tier = KVTier(kv_host_gb * 1e9, idle_s=kv_idle_s)
            self._tier.observer = self._tier_event
            log.info("KV tier on: %.1f GB of host memory, idle park after "
                     "%.1f s", kv_host_gb, kv_idle_s)
        self._wake_hist = Histogram("kv_wake_ms")
        self._last_tier_sweep = 0.0
        self._wake_shapes_run: set[tuple[int, int]] = set()
        self._warmed_buckets: tuple[int, ...] = ()
        self._wake_rr_cold = False
        self._park_all_req = threading.Event()
        self._park_all_ack = threading.Event()
        self._park_all_key: Optional[str] = None
        # Tensor parallelism: the leader's op channel (serve/tp.py), a
        # follower's prefix KV by token ids (the leader's entries hold
        # theirs), the chunked admission's device carry (k, v, logits),
        # the running digest of sampled tokens, and per decode tick the
        # step's wall and its time in collectives.
        self._channel = None
        self._tp_index = tp_index
        if self._tp and not self._follower:
            if tp_channel is None:
                from .tp import TPChannel
                tp_channel = TPChannel(self.mesh)
            tp_channel.attach(tp_index, self)
            self._channel = tp_channel
        self._prefix_dev: dict[tuple, tuple] = {}
        self._pc_dev: Optional[list] = None
        self._digest = (torch.zeros((), dtype=torch.long, device=self.device)
                        if self._tp else None)
        self.digests: Optional[list] = None
        self._tp_step_ms: list[float] = []
        self._tp_coll_ms: list[float] = []
        self._alloc_device_state()
        self._admit_q: "queue.Queue[Optional[object]]" = queue.Queue()
        self._jobs: "queue.Queue[_WarmupJob]" = queue.Queue()
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if not self._follower:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="torch-scheduler")
            self._thread.start()

    # -- device state ------------------------------------------------------

    def _alloc_device_state(self) -> None:
        """The pool, the per-row sampling state and the decode programs'
        inputs and outputs, allocated ONCE: every captured CUDA graph
        holds their addresses, so later writes go into them in place
        (admission and release index-write them between ticks, and
        :meth:`_reset_device_state` clears them in place)."""
        B, dev = self.num_slots, self.device
        if self.kv_mode == "dense":
            self._cache = KVCache.create(self.config, B, self.max_seq,
                                         dtype=self._dtype, device=dev,
                                         mesh=self.mesh)
        else:
            self._cache = PagedKVCache.create(
                self.config, B, self.num_pages, self.page_size,
                max_pages_per_row=-(-self.max_seq // self.page_size),
                dtype=self._dtype, quantized=self.kv_quant, device=dev,
                mesh=self.mesh)
        self._next = torch.zeros((B, 1), dtype=torch.long, device=dev)
        # Per-row sampling options, keys ([seed, counter]) and penalty
        # ring (the token at context position p sits at p % _RING; ids >=
        # vocab are empty), installed at admission.
        self._temps_dev = torch.zeros((B,), dtype=torch.float32, device=dev)
        self._top_ks_dev = torch.zeros((B,), dtype=torch.long, device=dev)
        self._top_ps_dev = torch.ones((B,), dtype=torch.float32, device=dev)
        self._rps_dev = torch.ones((B,), dtype=torch.float32, device=dev)
        self._keys_dev = torch.zeros((B, 2), dtype=torch.long, device=dev)
        self._ring_dev = torch.full((B, _RING), self.config.vocab_size,
                                    dtype=torch.long, device=dev)
        self._active_dev = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._active_host: Optional[tuple[bool, ...]] = None
        self._stop_dev = torch.tensor(sorted(self._stop_ids),
                                      dtype=torch.long, device=dev)
        # Each program's token block, and two host buffers its copies
        # alternate between (pinned on the card: the copy runs behind an
        # event while the next tick is queued).
        self._toks_out = {K: torch.zeros((K, B), dtype=torch.long,
                                         device=dev)
                          for K in (1,) + self._fuse_ladder}
        cuda = dev.type == "cuda"
        self._host_toks = [torch.zeros((self.decode_fuse_max, B),
                                       dtype=torch.long, pin_memory=cuda)
                           for _ in range(2)]
        self._flip = 0
        self._programs: dict[tuple, _DecodeProgram] = {}
        # Spec ticks: one int64 input block [B, columns] (tokens, drafts,
        # max_acc; tree verify adds depths, sibling tokens and nodes and
        # the flattened ancestor matrix) on the device, filled from a
        # pinned host twin by one copy per tick; and the outputs [3, B]
        # (accepted, correction, used sibling) with their pinned twin.
        self._spec_cols = self._spec_layout() if self.spec_k else {}
        width = max((c.stop for c in self._spec_cols.values()), default=0)
        self._spec_host = torch.zeros((B, width), dtype=torch.long,
                                      pin_memory=cuda)
        if self.spec_k:
            self._fill_spec_base()
        self._spec_in = self._spec_host.to(dev, copy=True)
        self._spec_out = torch.zeros((3, B), dtype=torch.long, device=dev)
        self._spec_out_host = torch.zeros((3, B), dtype=torch.long,
                                          pin_memory=cuda)
        # The graphs share one memory pool: every result a graph leaves
        # behind is copied into the tensors above, and all replays run
        # on one stream, so no graph's scratch outlives its replay.
        self._graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        self._capture_stream = torch.cuda.Stream(dev) if cuda else None
        self._alloc = (PageAllocator(self.num_pages, self.page_size)
                       if self.kv_mode == "paged" else None)

    def _reset_device_state(self) -> None:
        """Back to no live row, in place (the captured graphs stay
        valid): lengths (and the pool's tables) zeroed — cache contents
        past a zero length are never read —, options, keys, rings, feed
        and mask cleared, and a fresh page allocator."""
        if self.kv_mode == "paged":
            self._alloc = PageAllocator(self.num_pages, self.page_size)
            self._cache.page_table.zero_()
        self._cache.lengths.zero_()
        self._next.zero_()
        self._temps_dev.zero_()
        self._top_ks_dev.zero_()
        self._top_ps_dev.fill_(1.0)
        self._rps_dev.fill_(1.0)
        self._keys_dev.zero_()
        self._ring_dev.fill_(self.config.vocab_size)
        self._active_dev.zero_()
        self._active_host = None
        self._pc_dev = None

    # -- tensor parallelism: the device ops (serve/tp.py) -----------------

    def _dev(self, op: str, *args):
        """Run device op ``op`` (:data:`_OPS`) with host arguments; under
        tensor parallelism the leader first sends it to the follower
        ranks (a prefix entry rides as its token ids). An op never calls
        another op: the followers run each one whole. Under tensor
        parallelism an op that raises marks the channel down: the ranks
        may have stopped at different collectives of it, so no later op
        may run (the loop ends the plane, :meth:`_end_plane`). The
        plane's op lock is held from the send to the end of the run, so
        the ops of engines sharing the plane never interleave
        (serve/tp.py)."""
        ch = self._channel
        with torch.profiler.record_function(f"sched.{op}"):
            if ch is None:
                return getattr(self, _OPS[op])(*args)
            with ch.lock:
                if ch.down:
                    raise RuntimeError("the tensor-parallel plane is down")
                try:
                    ch.send(op, tuple(
                        a.ids if isinstance(a, PrefixEntry) else a
                        for a in args), self._tp_index)
                    return getattr(self, _OPS[op])(*args)
                except BaseException:
                    ch.down = True
                    raise

    def run_op(self, op: str, args: tuple) -> None:
        """A follower's mirror of one leader op (serve/tp.py)."""
        with torch.profiler.record_function(f"sched.{op}"):
            getattr(self, _OPS[op])(*args)

    # The kv-head axis of the tier's payloads (tensor parallelism): a
    # payload holds every head; this rank's cache holds 1 / _kv_ways of
    # them, heads [r·H/t, (r+1)·H/t) on the rank at tp index r.

    def _heads_whole(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's ``x`` with every kv head along ``dim``: the ranks'
        heads all-gathered over tp in rank order (collective)."""
        if self._kv_ways == 1:
            return x
        return self.mesh.all_gather(x, "tp", dim)

    def _heads_mine(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's heads of a whole ``x`` along ``dim``."""
        if self._kv_ways == 1:
            return x
        n = x.shape[dim] // self._kv_ways
        return x.narrow(dim, self.mesh.index("tp") * n, n)

    def _whole_shape(self, t: torch.Tensor, dim: int) -> tuple:
        """``t``'s shape with every kv head along ``dim``."""
        shape = list(t.shape)
        shape[dim] *= self._kv_ways
        return tuple(shape)

    def _receive(self, payload: _Payload) -> tuple:
        """A payload's arrays on this rank's device: the upload on one
        card; under tensor parallelism the leader's arrays broadcast over
        tp (collective; the leader passes host or device arrays, a
        follower only their spec)."""
        out = []
        for i, spec in enumerate(payload.spec):
            if spec is None:
                out.append(None)
            elif payload.arrays is not None:
                t = payload.arrays[i].to(self.device, non_blocking=True)
                out.append(self.mesh.broadcast(t.contiguous(), "tp")
                           if self._tp else t)
            else:
                t = torch.empty(spec[0], dtype=spec[1], device=self.device)
                out.append(self.mesh.broadcast(t, "tp"))
        return tuple(out)

    def post_on_loop(self, fn) -> _WarmupJob:
        """Queue ``fn()`` for the scheduler thread, which runs it at the
        top of its next loop iteration, between ticks (under tensor
        parallelism an embed's collectives must not interleave with a
        tick's on the same groups); returns the job to wait on."""
        if self._closed.is_set():
            raise RuntimeError("scheduler is stopped")
        job = _WarmupJob(fn)
        self._jobs.put(job)
        self._admit_q.put(None)       # ends an idle loop's admission wait
        return job

    def run_on_loop(self, fn):
        """:meth:`post_on_loop` and wait: returns what ``fn`` returned,
        raises what it raised. Never from inside a tensor-parallel op."""
        if self._channel is not None:
            self._channel.check_not_holding("run_on_loop")
        job = self.post_on_loop(fn)
        job.done.wait()
        if job.err is not None:
            raise job.err
        return job.result

    def _run_jobs(self) -> None:
        while True:
            try:
                job = self._jobs.get_nowait()
            except queue.Empty:
                return
            job.run()
            if self._channel is not None and self._channel.down:
                raise RuntimeError("an op of a job on the loop failed "
                                   "under tensor parallelism")

    def _fold(self, toks: torch.Tensor) -> None:
        """Fold a block of sampled tokens into this rank's running digest
        (on the device; every rank folds the same blocks in the same
        order, so equal digests at shutdown mean the ranks sampled the
        same tokens)."""
        t = toks.reshape(-1).long()
        w = torch.arange(1, t.numel() + 1, device=t.device)
        self._digest.copy_((self._digest * 1000003 + (t * w).sum())
                           % 2147483647)

    def token_digest(self) -> Optional[int]:
        return None if self._digest is None else int(self._digest)

    def tp_timings(self) -> dict:
        """p50 decode step (ms, the tick's wall over its K) and its time
        in collectives under tensor parallelism, with the tick count."""
        def p50(xs) -> Optional[float]:
            return float(np.median(xs)) if xs else None
        return {"steps": len(self._tp_step_ms),
                "step_ms_p50": p50(self._tp_step_ms),
                "collective_ms_p50": p50(self._tp_coll_ms)}

    def _prefix_kv(self, prefix) -> tuple:
        """(k, v) of a prefix: the leader's entry, or on a follower its
        own copy under the entry's token ids."""
        if isinstance(prefix, PrefixEntry):
            return prefix.k, prefix.v
        return self._prefix_dev[prefix]

    def _prefix_keep(self) -> Optional[list]:
        """The prefix ids a follower must keep (tensor parallelism): the
        store's entries and those queued requests matched."""
        if not self._tp:
            return None
        keep = [e.ids for e in self._prefix.snapshot()]
        return keep + [s.prefix.ids for s in self._admit_carry + self._waiting
                       if s.prefix is not None]

    def _dev_warm_prefill(self, S: int) -> None:
        toks = torch.zeros((1, S), dtype=torch.long, device=self.device)
        lens = torch.full((1,), S, dtype=torch.long, device=self.device)
        self._family.prefill(self._params, self.config, toks, lens,
                             last_only=True, mesh=self.mesh)

    def _dev_prefix(self, ids: tuple, keep: Optional[list]) -> tuple:
        """The KV [L, P, Hkv, D] of prefix ``ids`` by a whole-prompt
        prefill; a follower keeps it under ``ids`` and drops the entries
        outside ``keep``."""
        toks = torch.tensor([list(ids)], dtype=torch.long,
                            device=self.device)
        lens = torch.full((1,), len(ids), dtype=torch.long,
                          device=self.device)
        _, k_all, v_all = self._family.prefill(
            self._params, self.config, toks, lens, last_only=True,
            mesh=self.mesh)
        return self._keep_prefix(ids, keep, (k_all[:, 0].contiguous(),
                                             v_all[:, 0].contiguous()))

    def _keep_prefix(self, ids: tuple, keep: Optional[list],
                     kv: tuple) -> tuple:
        """A follower keeps prefix ``kv`` under ``ids`` and drops the
        entries outside ``keep``; returns ``kv``."""
        if self._follower:
            live = set(keep or ()) | {ids}
            for key in [k for k in self._prefix_dev if k not in live]:
                del self._prefix_dev[key]
            self._prefix_dev[ids] = kv
        return kv

    def _dev_prefix_gather(self, prefix) -> tuple:
        """A cached prefix's (k, v) [L, P, Hkv, D] with every kv head, for
        the prefix wire (the leader reads it back)."""
        k, v = self._prefix_kv(prefix)
        return self._heads_whole(k, 2), self._heads_whole(v, 2)

    def _dev_prefix_place(self, ids: tuple, payload: _Payload,
                          keep: Optional[list]) -> tuple:
        """An imported prefix entry's (k, v) with every kv head (the
        leader's arrays, broadcast): this rank's heads, kept by a
        follower under ``ids``."""
        k, v = self._receive(payload)
        return self._keep_prefix(ids, keep, (
            self._heads_mine(k, 2).contiguous(),
            self._heads_mine(v, 2).contiguous()))

    def _dev_release(self, row: int) -> None:
        zero_row(self._cache, row)

    def _dev_embed(self, toks: torch.Tensor, lens: torch.Tensor
                   ) -> torch.Tensor:
        return self._family.embed_pooled(
            self._params, self.config, toks.to(self.device),
            lens.to(self.device), mesh=self.mesh)

    # -- client side (HTTP threads) ----------------------------------------

    def note_warmup_pending(self) -> None:
        self._warmup_done_at = None
        self._warmup_started = True

    @property
    def ready(self) -> bool:
        if (self._closed.is_set() or self._thread is None
                or not self._thread.is_alive()
                or (self._channel is not None and self._channel.down)):
            return False
        if self._draining.is_set() or self.warmup_error is not None:
            return False
        return not self._warmup_started or self._warmup_done_at is not None

    def drain(self) -> None:
        """Stop taking new work (submit sheds, /readyz turns 503); what is
        queued or running finishes. Reversible with :meth:`undrain`."""
        self._draining.set()

    def undrain(self) -> None:
        self._draining.clear()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def submit(self, req: GenerateRequest,
               stats: Optional[RequestStats] = None) -> Iterator[str]:
        """Enqueue a request; return an iterator of text deltas. The
        overload check runs here, eagerly."""
        if self._closed.is_set():
            raise RuntimeError("scheduler is stopped")
        if self._draining.is_set():
            with self._depth_mu:
                self._n_shed += 1
            raise OverloadError("server is draining; retry elsewhere",
                                retry_after_s=5.0)
        on_depart = None
        if self.queue_max:
            with self._depth_mu:
                shed = self._queued_requests >= self.queue_max
                if shed:
                    self._n_shed += 1
                else:
                    self._queued_requests += 1
            if shed:
                raise OverloadError(
                    f"server at capacity: {self.queue_max} requests "
                    "already queued; retry later")
            on_depart = self._note_depart
        opts = req.options
        seed = opts.seed if opts.seed is not None else time.monotonic_ns()
        slot = _Slot(req=req, stats=stats, out_q=queue.Queue(),
                     seed=int(seed) % (2 ** 31), on_depart=on_depart)
        self._admit_q.put(slot)
        if self._closed.is_set():
            slot.finish()
        return _SlotStream(self._consume(slot), slot)

    def _note_depart(self) -> None:
        with self._depth_mu:
            self._queued_requests -= 1

    def _consume(self, slot: _Slot) -> Iterator[str]:
        try:
            while True:
                delta = slot.out_q.get()
                if delta is None:
                    if slot.error is not None:
                        raise RuntimeError(slot.error)
                    return
                parts = [delta]
                done = False
                while True:
                    try:
                        nxt = slot.out_q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        done = True
                        break
                    parts.append(nxt)
                yield "".join(parts)
                if done:
                    if slot.error is not None:
                        raise RuntimeError(slot.error)
                    return
        finally:
            slot.cancelled.set()

    def warmup(self, prompt_buckets: tuple[int, ...] = (128,),
               prefix_texts: tuple[str, ...] = ()) -> None:
        """Run the serving path once before traffic: on the card this
        builds and loads the CUDA kernels and launches them at the
        serving shapes (a prefill per bucket, the registration of each
        prefix template), then, per window of the ladder, one plain
        decode step with every row parked and the capture of the
        window's decode graphs (:meth:`_warm_window`), with the KV tier
        on a wake forward per (window, bucket <= ``_WAKE_MAX_SUFFIX``)
        (:meth:`_warm_wake`), and last the device-step probe behind
        ``decode_device_ms`` (:meth:`_probe_device_step`). A capture that
        fails fails the warmup. Blocks until the scheduler thread has run
        it."""
        self.note_warmup_pending()
        buckets = tuple(sorted({_bucket(b, self.max_seq)
                                for b in prompt_buckets}))

        def run() -> None:
            for S in buckets:
                self._dev("warm_prefill", S)
            for text in prefix_texts:
                self.register_prefix(text)
            for w in self._window_ladder():
                self._dev("warm_window", w)
            if self._draft_model is not None:
                self._draft_model.warm(buckets, self._window_ladder())
            if self._tier is not None:
                for S in buckets:
                    if S <= _WAKE_MAX_SUFFIX:
                        for w in self._window_ladder():
                            self._warm_wake(w, S)
            self._dev("probe")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            # A wake's suffix rounds up to the smallest warmed bucket
            # (the reference's _serving_bucket) from here on.
            self._warmed_buckets = buckets

        try:
            self.run_on_loop(run)
        except BaseException as e:
            self.warmup_error = e
            raise
        self._warmup_done_at = time.monotonic()

    # -- decode programs (scheduler thread) ---------------------------------

    def _window_ladder(self) -> tuple[int, ...]:
        """Every window :meth:`_window` can return: powers of two from
        128, capped at max_seq."""
        w, out = min(128, self.max_seq), []
        while True:
            out.append(w)
            if w >= self.max_seq:
                return tuple(out)
            w = min(2 * w, self.max_seq)

    def _window(self, extra: int = 0) -> int:
        """Smallest power-of-two (>= 128, <= max_seq) attention window
        covering every live row's context plus ``1 + extra`` slots (the
        reference's ladder, scheduler.py:1717-1725)."""
        need = 1 + extra + max(s.ctx_len for s in self._slots
                               if s is not None)
        w = min(128, self.max_seq)
        while w < need:
            w *= 2
        return min(w, self.max_seq)

    @property
    def _fuse_ladder(self) -> tuple[int, ...]:
        """Fused-K sizes: powers of two up to decode_fuse_max (plus the
        cap itself) — the ramp climbs this ladder, so each window holds a
        handful of programs, not one per possible K."""
        ks, k = [], 2
        while k < self.decode_fuse_max:
            ks.append(k)
            k *= 2
        if self.decode_fuse_max > 1:
            ks.append(self.decode_fuse_max)
        return tuple(ks)

    def _choose_fuse_k(self, inflight: int) -> int:
        """Adaptive fused-K for this tick (the reference's decision
        table, scheduler.py:1641-1695). Collapses to 1 whenever fusing
        could overrun a budget THIS tick:

        - any live row within K tokens of its ``max_new`` or KV budget —
          the device must never write a slot past a row's allocation, and
          ``inflight`` unprocessed pipelined steps count against the
          headroom (the device's lengths run ahead of the host's ctx_len
          by up to that many slots);
        - admissions pending while chunking is disabled or cannot cover
          every bucket (``max_seq % prefill_chunk != 0``): a pending
          admission may then put an unbounded prefill after this tick.
          With chunking covering every bucket, pending admissions do not
          collapse K: each admission step is bounded to one chunk;

        otherwise K doubles along the ladder up to ``decode_fuse_max``,
        so a stream that just admitted ramps 1 -> 2 -> 4."""
        kmax = self.decode_fuse_max
        if kmax <= 1:
            return 1
        C = self.prefill_chunk
        if ((not C or self.max_seq % C)
                and (self._admit_carry or self._waiting
                     or not self._admit_q.empty())):
            self._fuse_ramp = 1
            return 1
        cap = kmax
        for s in self._slots:
            if s is None:
                continue
            cap = min(cap,
                      s.max_new - len(s.ids) - inflight,
                      s.ctx_budget - s.ctx_len - inflight)
            if cap < 2:
                self._fuse_ramp = 1
                return 1
        k = 1
        target = min(cap, self._fuse_ramp * 2)
        for cand in self._fuse_ladder:
            if cand <= target:
                k = cand
        self._fuse_ramp = max(k, 1)
        return max(k, 1)

    def _step_fn(self, window: int, K: int):
        """The function of one decode tick: ``decode_fused`` over K steps
        at ``window`` on the persistent state (the live-row mask
        ``_active_dev`` unless ``active`` is given), each step sampling
        with the rows' options, keys and rings on the device; the token
        block lands in ``_toks_out[K]`` and the feed, keys and ring are
        written back in place. K = 1 is the plain step. The dense cache
        runs the family's dense ``decode_step`` at ``window``, the pool
        ``decode_step_paged`` over the window's pages."""
        kv = (dict(kv_window=window) if self.kv_mode == "dense" else
              dict(pages=-(-window // self.page_size), impl=self.attn_impl))

        def sample_fn(logits, state, emit_pos, act):
            keys, ring = state
            toks, keys, ring = sample_step_batched(
                logits, keys, self._temps_dev, self._top_ks_dev,
                self._top_ps_dev, ring=ring, rp=self._rps_dev,
                emit_pos=emit_pos, active=act)
            return toks, (keys, ring)

        def run(active: Optional[torch.Tensor] = None) -> None:
            toks, _, nxt, _, _, (keys, ring) = self._family.decode_fused(
                self._params, self.config, self._next, self._cache,
                self._active_dev if active is None else active,
                num_steps=K, sample_fn=sample_fn,
                sample_state=(self._keys_dev, self._ring_dev),
                stop_ids=self._stop_dev, mesh=self.mesh, **kv)
            self._toks_out[K].copy_(toks)
            self._next.copy_(nxt)
            self._keys_dev.copy_(keys)
            self._ring_dev.copy_(ring)

        return run

    def _decode_fused_for(self, window: int, K: int) -> _DecodeProgram:
        """The program of K steps at ``window`` (:meth:`_program`)."""
        return self._program((window, K), lambda: self._step_fn(window, K))

    def _program(self, key: tuple, make) -> _DecodeProgram:
        """The program under ``key``, built from ``make()``'s function:
        on the card a CUDA graph, captured on first use (warmup captures
        every window's) on the scheduler's capture stream into the shared
        pool — capture only, nothing runs on live rows. The wrappers'
        launch counts that the capture recorded are taken back and
        re-added at each replay. Under tensor parallelism the function
        itself (gloo stages the collectives through the host, which a
        graph cannot capture)."""
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        fn = make()
        if self.device.type != "cuda" or self._tp:
            prog = _DecodeProgram(fn)
        else:
            wrappers = ops.wrappers()
            before = {n: w.launches for n, w in wrappers.items()}
            graph = torch.cuda.CUDAGraph()
            # No garbage collection inside the capture: collecting a dead
            # object that owns a CUDA graph or event (a stopped engine's,
            # say) destroys it, an operation a capturing process may not
            # make, and the capture is lost.
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with self.capture_lock, torch.cuda.graph(
                        graph, pool=self._graph_pool,
                        stream=self._capture_stream):
                    fn()
            finally:
                if gc_on:
                    gc.enable()
                launches = []
                for name, w in wrappers.items():
                    if w.launches != before[name]:
                        launches.append((w, w.launches - before[name]))
                        w.launches = before[name]
            prog = _DecodeProgram(fn, graph, tuple(launches))
        self._programs[key] = prog
        return prog

    def _drafter_program(self, key: tuple, make) -> _DecodeProgram:
        """The resident drafter's program under ``("draft",) + key``
        (serve/draft_model.py's ``program`` hook): on the card its
        function runs once on the capture stream (so every lazily built
        state exists), then :meth:`_program` captures it; the function
        sets its own inputs from static buffers, so that first run is a
        real dispatch the replay repeats. On the CPU, the function."""
        full = ("draft",) + key
        prog = self._programs.get(full)
        if prog is not None:
            return prog
        fn = make()
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            self._capture_stream.wait_stream(cur)
            with torch.cuda.stream(self._capture_stream):
                fn()
            cur.wait_stream(self._capture_stream)
        return self._program(full, lambda: fn)

    def _decode_for(self, window: int) -> _DecodeProgram:
        """The plain (K = 1) program at ``window``."""
        return self._decode_fused_for(window, 1)

    def _warm_window(self, w: int) -> None:
        """One plain step (and, with speculation on, one spec tick) at
        window ``w`` with every row parked, then the capture of the
        window's programs for K in {1} and the fuse ladder, and of its
        spec program (the reference's warmup, scheduler.py:2219-2250, so
        no capture ever runs over live rows). Parked rows write only to
        the garbage page or past their trusted length, and keep their
        lengths, feed and rings; their keys advance, so the keys are
        saved and restored around the step
        (a warmup between live ticks must not move seeded streams). On
        the card the step runs on the capture stream, so the lazy state
        of every library call it makes exists before the capture."""
        fns = [self._step_fn(w, 1)]
        if self.spec_k:
            fns.append(self._spec_fn(w))
        keys = self._keys_dev.clone()
        parked = torch.zeros_like(self._active_dev)
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            self._capture_stream.wait_stream(cur)
            with torch.cuda.stream(self._capture_stream):
                for fn in fns:
                    fn(parked)
            cur.wait_stream(self._capture_stream)
        else:
            for fn in fns:
                fn(parked)
        self._keys_dev.copy_(keys)
        for K in (1,) + self._fuse_ladder:
            self._decode_fused_for(w, K)
        if self.spec_k:
            self._spec_for(w)

    # -- speculative decoding (scheduler thread) ----------------------------

    def _spec_layout(self) -> dict[str, slice]:
        """Columns of a spec tick's input block: tokens [S] (S = K + 1,
        or N tree nodes), drafts [K], max_acc [1]; tree verify adds
        depths [N], sib_tok [K], sib_node [K] and the ancestor matrix
        [N * N]."""
        K, N = self.spec_k, self.spec_tree_nodes
        widths = [("tokens", N or K + 1), ("drafts", K), ("max_acc", 1)]
        if N:
            widths += [("depths", N), ("sib_tok", K), ("sib_node", K),
                       ("anc", N * N)]
        out, at = {}, 0
        for name, n in widths:
            out[name] = slice(at, at + n)
            at += n
        return out

    def _tree_base(self) -> tuple[np.ndarray, np.ndarray]:
        """The node tree's per-(N, K) base (the reference's
        ``_tree_base``): depths and ancestor sets of the main chain (node
        0 the pending token, nodes 1..K the draft), sibling slots at depth
        0 and self-only until a tick budgets them."""
        if self._tree_base_np is None:
            N, K = self.spec_tree_nodes, self.spec_k
            depths = np.zeros((N,), np.int64)
            depths[: K + 1] = np.arange(K + 1)
            anc = np.zeros((N, N), bool)
            for i in range(K + 1):
                anc[i, : i + 1] = True
            for j in range(K + 1, N):
                anc[j, j] = True
            self._tree_base_np = (depths, anc)
        return self._tree_base_np

    def _fill_spec_base(self) -> np.ndarray:
        """Reset the pinned input block to an empty tick (no drafts, the
        tree's base topology) and return its numpy view."""
        host = self._spec_host.numpy()
        cols = self._spec_cols
        host[:] = 0
        if self.spec_tree_nodes:
            depths, anc = self._tree_base()
            host[:, cols["depths"]] = depths
            host[:, cols["anc"]] = anc.reshape(-1)
            host[:, cols["sib_tok"]] = -1
            host[:, cols["sib_node"]] = -1
        return host

    def _add_source(self, src) -> None:
        """Append a draft source after its throttle and counter state
        (the reference's ``_ensure_sources``; the port has the n-gram
        source), so /metrics never sees a source without its state."""
        self._spec_ema[src.name] = _SPEC_EMA_SEED
        self._spec_cooldown[src.name] = 0
        self._n_spec_proposed_src[src.name] = 0
        self._n_spec_accepted_src[src.name] = 0
        self._n_spec_dispatch_src[src.name] = 0
        self._sources.append(src)

    def _spec_sources_allowed(self) -> dict[str, bool]:
        """Per-source acceptance throttle (the reference's): a source
        whose EMA is below the floor proposes only every
        ``_SPEC_PROBE_EVERY``-th call; the others always may. Called once
        per loop iteration, before the pipeline flush."""
        out: dict[str, bool] = {}
        for src in self._sources:
            if self._spec_ema[src.name] >= _SPEC_EMA_FLOOR:
                out[src.name] = True
            else:
                self._spec_cooldown[src.name] += 1
                out[src.name] = not (self._spec_cooldown[src.name]
                                     % _SPEC_PROBE_EVERY)
        return out

    def _spec_fn(self, window: int):
        """The function of one spec tick at ``window`` (the reference's
        ``_make_spec`` / ``_make_spec_tree``), on the persistent state:
        the verify forward over the input block (pages covering the window
        plus the block), exact acceptance with the rows' options, keys and
        rings, for the tree the sibling's kv moved onto the accepted path
        (copy_slot; rows without one copy a slot onto itself), lengths
        advanced by accepted + 1 on live rows, the emitted tokens written
        into the rings at their context positions, the keys advanced, the
        feed set to the correction (parked rows keep theirs), and
        (accepted, correction, used sibling) in ``_spec_out``."""
        K, B, N = self.spec_k, self.num_slots, self.spec_tree_nodes
        S = N or K + 1
        dense = self.kv_mode == "dense"
        pages = (0 if dense else
                 min(-(-(window + S) // self.page_size),
                     self._cache.max_pages_per_row))
        cols, buf = self._spec_cols, self._spec_in
        fam, cache = self._family, self._cache

        def run(active: Optional[torch.Tensor] = None) -> None:
            act = self._active_dev if active is None else active
            tokens, drafts = buf[:, cols["tokens"]], buf[:, cols["drafts"]]
            max_acc = buf[:, cols["max_acc"]][:, 0]
            pre = cache.lengths.long()
            opts = (self._keys_dev, self._temps_dev, self._top_ks_dev,
                    self._top_ps_dev, max_acc)
            ring = dict(ring=self._ring_dev, rp=self._rps_dev, ctx_len=pre)
            if N:
                anc = buf[:, cols["anc"]].reshape(B, N, N) != 0
                sib_tok = buf[:, cols["sib_tok"]]
                sib_node = buf[:, cols["sib_node"]]
                if dense:
                    logits, _ = fam.verify_tree(
                        self._params, self.config, tokens,
                        buf[:, cols["depths"]], anc, cache,
                        kv_window=window, mesh=self.mesh)
                else:
                    logits, _ = fam.verify_tree_paged(
                        self._params, self.config, tokens,
                        buf[:, cols["depths"]], anc, cache, pages=pages,
                        mesh=self.mesh)
                accepted, used, corr, keys = spec_verify_tree(
                    logits, drafts, sib_tok, sib_node, *opts, **ring)
                sel = (accepted - 1).clamp(0, K - 1)[:, None]
                sib = sib_tok.gather(1, sel)[:, 0]
                dst = pre + accepted
                src = torch.where(act & (used > 0),
                                  pre + sib_node.gather(1, sel)[:, 0], dst)
                (fam.copy_slot_dense if dense else copy_slot)(cache, src,
                                                              dst)
            else:
                logits, _ = (fam.verify_step(
                    self._params, self.config, tokens, cache,
                    kv_window=window, mesh=self.mesh) if dense else
                    fam.verify_step_paged(
                        self._params, self.config, tokens, cache,
                        pages=pages, impl=self.attn_impl, mesh=self.mesh))
                accepted, corr, keys = spec_verify_batched(logits, drafts,
                                                           *opts, **ring)
                used = torch.zeros_like(accepted)
            cache.lengths += torch.where(act, accepted + 1, 0).to(
                cache.lengths.dtype)
            # Emitted token i (after input i) sits at context position
            # pre + i + 1; rows' writes past `accepted` or parked drop.
            ar = torch.arange(K + 1, device=pre.device)[None, :]
            ok = (ar <= accepted[:, None]) & act[:, None]
            idx = torch.where(ok, (pre[:, None] + 1 + ar) % _RING, _RING)
            emitted = torch.where(
                ar < accepted[:, None],
                torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1),
                corr[:, None])
            if N:
                emitted = torch.where(
                    (used > 0)[:, None] & (ar == (accepted - 1)[:, None]),
                    sib[:, None], emitted)
            ext = torch.cat([self._ring_dev,
                             self._ring_dev.new_zeros((B, 1))], dim=1)
            ext.scatter_(1, idx, emitted)
            self._ring_dev.copy_(ext[:, :_RING])
            self._keys_dev.copy_(keys)
            self._next.copy_(torch.where(act[:, None], corr[:, None],
                                         self._next))
            self._spec_out.copy_(torch.stack([accepted, corr, used]))

        return run

    def _spec_for(self, window: int) -> _DecodeProgram:
        """The spec program at ``window`` (:meth:`_program`)."""
        return self._program(("spec", window),
                             lambda: self._spec_fn(window))

    def _probe_device_step(self) -> None:
        """Measure the device's decode step once, at warmup's tail (the
        reference's ``_probe_device_step``): the K = 1 program of the
        smallest window with every row parked, run once to warm the path,
        then ``n1 = 4`` and ``n2 = 12`` times, each run ended by one
        readback of the tokens. wall(n) = n * step + the readback's
        constant, so ``(n2*w2 - n1*w1) / (n2 - n1)`` cancels the constant
        (``w2`` itself when the solve falls under 5% of it). The solve is
        made three times and the median published as ``decode_device_ms``
        (the reference solves once): a host stall inside one of the short
        runs moves that solve by half the stall or more, and one solve
        alone has missed the device step by 20%. Under tensor parallelism
        it solves once, as the reference does: a step there is an eager
        tick through the ranks' collectives, many times a graph replay's
        time, so its runs are long and a stall moves a solve little, while
        two more solves would add 32 such steps to every engine's warmup.
        Parked rows keep their
        lengths, feed and rings, and write only past their trusted length
        or into the garbage page; their keys advance, so the keys and the
        live-row mask are restored in place afterwards — the graphs stay
        valid and seeded streams do not move. On the CPU the program runs
        eagerly."""
        prog = self._decode_for(min(128, self.max_seq))
        keys = self._keys_dev.clone()
        active = self._active_dev.clone()
        self._active_dev.zero_()

        def loop(n: int) -> float:
            t = time.monotonic()
            for _ in range(n):
                prog()
            self._toks_out[1].tolist()       # the readback ends the run
            return (time.monotonic() - t) / n

        def solve(n1: int = 4, n2: int = 12) -> float:
            w1, w2 = loop(n1), loop(n2)
            d = (n2 * w2 - n1 * w1) / (n2 - n1)
            return d if d > 0.05 * w2 else w2

        try:
            loop(1)
            solves = sorted(solve() for _ in range(1 if self._tp else 3))
        finally:
            self._keys_dev.copy_(keys)
            self._active_dev.copy_(active)
        self._decode_device_ms = round(solves[len(solves) // 2] * 1e3, 4)

    # -- shared-prefix KV cache (scheduler thread) --------------------------

    def _registered_prefix_len(self, text: str) -> int:
        """Cached length for a registered template (0 = not cached): its
        token head minus ONE, since match() needs a proper prefix (a prompt
        that IS the template must still have a suffix token to prefill)."""
        ids = self.tokenizer.encode(text, add_bos=True)
        if len(ids) < _MIN_REGISTER_PREFIX:
            log.warning("prefix_text %r encodes to %d tokens — below the "
                        "%d-token minimum, not cached", text[:40], len(ids),
                        _MIN_REGISTER_PREFIX)
            return 0
        P = len(ids) - 1
        if P + _MIN_BUCKET > self.max_seq:
            log.warning("prefix_text %r encodes to %d tokens — too long to "
                        "ever admit under max_seq=%d, not cached",
                        text[:40], len(ids), self.max_seq)
            return 0
        return P

    def register_prefix(self, text: str) -> int:
        """Cache the KV of ``text``'s token head at its exact length (minus
        one; see :meth:`_registered_prefix_len`), built by a whole-prompt
        prefill (kernel D on the card). Returns the cached length (0 = not
        cached). Runs on the scheduler thread (warmup jobs)."""
        if self._prefix is None:
            return 0
        P = self._registered_prefix_len(text)
        if P <= 0:
            return 0
        ids = self.tokenizer.encode(text, add_bos=True)[:P]
        self._install_prefix(ids)
        return P

    def _install_prefix(self, ids) -> None:
        ids = tuple(ids)
        k, v = self._dev("prefix", ids, self._prefix_keep())
        self._prefix.put(PrefixEntry(ids=ids, k=k, v=v))
        log.info("cached prefix KV: %d tokens (%d entries)", len(ids),
                 len(self._prefix))

    def _build_promotion(self) -> None:
        """Build one queued auto-promoted head (a prefill of P tokens)
        between decode ticks. A failed build is dropped (promotion is an
        optimization): serving is untouched."""
        self._last_promote_tick = self._n_decode_ticks
        head = self._promote_q.pop(0)
        try:
            failpoint("serve.scheduler.promote")
            self._install_prefix(head)
        except Exception:   # noqa: BLE001 — promotion is optional
            log.exception("prefix promotion build failed")

    # -- the prefix wire (serve/prefix.py) ----------------------------------

    def prefix_export(self, h: str) -> Optional[bytes]:
        """One cached prefix's wire payload (None: not cached, or the
        prefix cache is off). On one card its k/v copy off the device on
        the calling (HTTP) thread under the capture lock, as an embed's
        work does, so no copy lands inside a decode-graph capture; under
        tensor parallelism the ranks' heads are all-gathered by an op on
        the loop, between ticks."""
        store = self._prefix
        if store is None:
            return None
        if not self._tp:
            with self.capture_lock:
                return store.export_payload(h)
        return self.run_on_loop(lambda: store.export_payload(
            h, gather=lambda e: self._dev("prefix_gather", e)))

    def prefix_import(self, data: bytes) -> Optional[PrefixEntry]:
        """Install a peer's exported prefix entry (every kv head on the
        wire; under tensor parallelism each rank keeps its own, by an op
        on the loop). None on a malformed payload or one of another
        geometry."""
        store = self._prefix
        if store is None:
            return None
        cfg = self.config
        geometry = (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim)
        if not self._tp:
            with self.capture_lock:
                return store.import_payload(data, device=self.device,
                                            geometry=geometry)
        return self.run_on_loop(lambda: store.import_payload(
            data, geometry=geometry, place=lambda ids, k, v: self._dev(
                "prefix_place", ids, _Payload((k, v)),
                self._prefix_keep())))

    # -- the KV tier: park_all, migration, disaggregated prefill -----------

    def park_all(self, timeout_s: float = 30.0,
                 key: Optional[str] = None) -> None:
        """Park RESIDENT sessions to host memory (HTTP threads; a parked
        payload is the only exportable form). ``key`` parks that one
        session only (the per-key export); None parks every one (the
        drain path). The loop owns the pages, so this is an event
        handshake it services at the top of every iteration; returns once
        it has. No-op without a tier; the handshake parks nothing over
        the dense cache, whose sessions park at finish."""
        if self._tier is None:
            return
        if self._closed.is_set():
            raise RuntimeError("scheduler is stopped")
        if self._channel is not None:
            self._channel.check_not_holding("park_all")
        self._park_all_key = key
        self._park_all_ack.clear()
        self._park_all_req.set()
        if not self._park_all_ack.wait(timeout=timeout_s):
            raise TimeoutError("park_all: scheduler loop did not service "
                               "the park request")

    def _drain_park_all(self) -> None:
        """Service a pending park_all (scheduler thread); the ack is set
        in a finally, so a park that fails (the loop's recovery envelope)
        never strands the caller."""
        if not self._park_all_req.is_set():
            return
        self._park_all_req.clear()
        key = self._park_all_key
        try:
            if self._tier is not None and self.kv_mode == "paged":
                for sess in self._tier.park_candidates(force=True):
                    if key is None or sess.key == key:
                        self._park_session(sess)
        finally:
            self._park_all_ack.set()

    def session_list(self) -> Optional[dict]:
        """{key: meta} of open sessions, or None with the tier off (the
        front then answers 501)."""
        if self._tier is None:
            return None
        return self._tier.sessions_meta()

    def session_export(self, key: str) -> Optional[bytes]:
        """The session's wire payload for a peer, or None when unknown. A
        resident session parks first (only this one); the session is
        retained either way — the peer's ack forgets it."""
        if self._tier is None:
            return None
        meta = self._tier.sessions_meta().get(key)
        if meta is None:
            return None
        if not meta["parked"]:
            self.park_all(key=key)
        return self._tier.export_payload(key)

    def session_import(self, data: bytes) -> Optional[SessionKV]:
        """Install a peer's exported session (parked). None on a malformed
        payload, one this pool cannot hold, or a fresher resident local
        copy. The next prompt extending its tokens wakes it."""
        if self._tier is None:
            return None
        failpoint("serve.kv_tier.import")
        sess = deserialize_session(data)
        if sess is None or not self._session_payload_compatible(sess):
            return None
        if not self._tier.adopt(sess):
            log.info("session %s import skipped: a resident local copy "
                     "is fresher", sess.key)
            return None
        return sess

    def session_forget(self, key: str) -> Optional[bool]:
        """The migration ack: drop the parked source copy. None = no tier;
        False = unknown key or still resident."""
        if self._tier is None:
            return None
        return self._tier.forget(key)

    def prefill_park(self, req: GenerateRequest,
                     timeout_s: float = 10.0) -> Optional[dict]:
        """The prefill side of a prefill->decode handoff: prefill this
        request's prompt minus its last token and retain it as a session,
        without sampling its first real token (the reference's
        ``prefill_park``). The prompt normalizes exactly as a real
        admission's; a one-token throwaway generation over ``ids[:-1]``
        retains exactly ``ids[:-1]``, so the decode replica's wake
        forwards the last prompt token and samples the first token there,
        as a cold admission would. Returns ``{"key", "len", "parked"}``,
        or None when the request cannot ride the handoff (no tier, too
        short, anonymous below HEAD_GRAIN, or the prefill failed).
        OverloadError propagates."""
        if self._tier is None:
            return None
        try:
            ids, _, _ = normalize_request(
                self.tokenizer, self.config.vocab_size, self.max_seq,
                req, min_bucket=_MIN_BUCKET)
        except ValueError:
            return None
        if len(ids) < 2:
            return None
        if req.session:
            key = f"sid:{req.session}"
        elif len(ids) - 1 >= HEAD_GRAIN:
            key = head_key(ids)
        else:
            return None
        throwaway = GenerateRequest(
            prompt="", model=req.model,
            options=GenerateOptions(max_tokens=1, temperature=0.0,
                                    seed=1, num_ctx=req.options.num_ctx),
            context=tuple(ids[:-1]), session=req.session)
        try:
            for _ in self.submit(throwaway):
                pass
        except OverloadError:
            raise
        except RuntimeError as e:
            log.warning("disagg prefill failed (%s); the request runs "
                        "un-disaggregated", e)
            return None
        # Retention runs on the loop as the slot finishes, after the
        # stream closes: wait for THIS prefill's session (length exactly
        # len(ids) - 1), not an older one under the same key.
        want_len = len(ids) - 1
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            meta = self._tier.sessions_meta().get(key)
            if meta is not None and meta["len"] == want_len:
                return {"key": key, "len": meta["len"],
                        "parked": meta["parked"]}
            time.sleep(0.01)
        log.warning("disagg prefill for %s finished but the fresh "
                    "session (len %d) never appeared in the tier index",
                    key, want_len)
        return None

    def _session_payload_compatible(self, sess: SessionKV) -> bool:
        """May this imported payload land in this cache? Its kind (four
        arrays: a paged pool's pages; two: a dense row) against
        ``kv_mode``, dtype and geometry against the live cache, token ids
        against the vocab, the span against the row's page budget (paged)
        or max_seq (dense), as the reference checks."""
        try:
            arrays, span = sess.host
            kind = "paged" if len(arrays) == 4 else "dense"
            if kind != self.kv_mode or sess.length > self.max_seq:
                return False
            if any(t < 0 or t >= self.config.vocab_size
                   for t in sess.tokens):
                return False
            k, v = arrays[0], arrays[1]
            # The cache's shape with every kv head (a tp rank holds a
            # share; the wire carries them all).
            ck = self._whole_shape(self._cache.k, 3)
            if (k is None or v is None or v.shape != k.shape
                    or v.dtype != k.dtype or k.dtype != self._cache.k.dtype
                    or k.dim() != len(ck) - (kind == "dense")
                    or k.shape[0] != ck[0]):
                return False
            if kind == "dense":
                # A row [L, W, Hkv, D] against the cache [L, B, T, Hkv, D].
                return (k.shape[1] == span and span <= self.max_seq
                        and tuple(k.shape[2:]) == ck[3:]
                        and sess.length <= span)
            ks, vs = arrays[2], arrays[3]
            if tuple(k.shape[2:]) != ck[2:]:
                return False
            if (ks is not None) != bool(self.kv_quant):
                return False
            if ks is not None:
                cs = self._cache.k_scale
                want = (ck[0], k.shape[1],
                        *self._whole_shape(cs, 2)[2:])
                if (vs is None or tuple(ks.shape) != want
                        or tuple(vs.shape) != want
                        or ks.dtype != cs.dtype or vs.dtype != cs.dtype):
                    return False
            if span > k.shape[1] or span > self._cache.max_pages_per_row:
                return False
            if -(-sess.length // self.page_size) > span:
                return False
            return True
        except Exception:   # noqa: BLE001 — incompatible payloads reject
            return False

    def _tier_event(self, kind: str, **meta) -> None:
        """KVTier observer -> the flight ring (park / wake / adopt /
        forget / evict; adopt and forget arrive from HTTP threads)."""
        self._flight.note(f"tier_{kind}", self._loop_iter, **meta)

    # -- grafttrace (obs/): span store wiring + the flight surface ----------

    def set_trace_store(self, store) -> None:
        """Install the front's span store (obs/trace.py) once, before
        traffic; the loop reads the reference per use (None = off)."""
        self._trace = store

    def flight_snapshot(self) -> list:
        """The flight recorder's event ring, oldest first."""
        return self._flight.snapshot()

    def flight_dump(self, reason: str = "on_demand") -> str:
        """Write the ring to its JSON file and return the path (the
        ``POST /admin/trace/dump`` surface)."""
        return self._flight.dump(reason)

    def stop(self) -> None:
        if self._follower:
            return
        self._closed.set()
        self._admit_q.put(None)
        self._thread.join(timeout=10.0)
        for i, s in enumerate(self._slots):
            if s is not None:
                s.finish()
                self._slots[i] = None
        pc, self._prefill_carry = self._prefill_carry, None
        for s in self._waiting + self._admit_carry + (pc.chunk if pc else []):
            s.finish()
        self._waiting, self._admit_carry = [], []
        while True:
            try:
                job = self._jobs.get_nowait()
            except queue.Empty:
                break
            job.err = RuntimeError("scheduler stopped")
            job.done.set()
        if self._channel is not None:
            # Once every engine of the plane has stopped, the shutdown op
            # (not while a loop is stuck in an op: it cannot be joined,
            # and a second sender would mix ops on the control group).
            self._channel.shutdown(self, clean=not self._thread.is_alive())
        while True:
            try:
                s = self._admit_q.get_nowait()
            except queue.Empty:
                break
            if s is not None:
                s.finish()

    def metrics_snapshot(self) -> dict[str, float]:
        """Serving-plane series, under the reference's names for the
        series this slice has."""
        with self._depth_mu:
            shed = self._n_shed
        out = {
            "serve_batch_occupancy": sum(s is not None for s in self._slots),
            "serve_batch_slots": self.num_slots,
            f'model_weight_bytes{{quant="{self._quant_mode or "bf16"}"}}':
                self._weight_bytes,
            "serve_queue_depth": (self._admit_q.qsize() + len(self._waiting)
                                  + len(self._admit_carry)),
            "serve_admitted_total": self._n_admitted,
            "serve_decode_ticks_total": self._n_decode_ticks,
            "serve_queue_expired_total": self._n_expired,
            "requests_shed_total": shed,
            "serve_draining": int(self._draining.is_set()),
            # Loop watchdog: the longest over-budget iteration (the one
            # in progress included), the last stall episode's, and the
            # flight-recorder dumps written.
            "loop_stall_ms": round(self._live_loop_stall_ms(), 3),
            "loop_stall_last_ms": round(self._loop_stall_last_ms, 3),
            "serve_flight_dumps_total": self._flight.dumps_total(),
            # Fused multi-step decode: ticks that fused K > 1 steps, their
            # steps, and the mean K over every decode tick.
            "decode_fused_ticks_total": self._n_fused_ticks,
            "decode_fused_steps_total": self._n_fused_steps,
            # Over non-speculative ticks: a spec tick has no fused K.
            "decode_fused_mean_k": round(
                self._n_decode_steps
                / max(1, self._n_decode_ticks - self._n_spec_ticks), 3),
            # p50 of the steady-state interval between dispatches, per
            # step; and the longest dispatch gap across admission work.
            "decode_wall_ms": round(self._wall_hist.percentile(50) or 0.0,
                                    4),
            # The warmup probe's device step (_probe_device_step).
            "decode_device_ms": self._decode_device_ms,
            "decode_stall_ms": round(self._decode_stall_ms, 3),
            "inter_token_p50_ms": round(
                self._tbt_hist.percentile(50) or 0.0, 4),
            "inter_token_p95_ms": round(
                self._tbt_hist.percentile(95) or 0.0, 4),
            "prefill_chunks_total": self._n_prefill_chunks,
        }
        if self.kv_mode == "paged":
            out["serve_kv_free_pages"] = self._alloc.free_pages
            out["serve_kv_total_pages"] = self.num_pages - 1
            # The reference's flash-append boundary as one number: 1 =
            # every window (the gather branch: kernel B's append mode, a
            # split-and-combine walk, serves every window), 0 = never
            # (the write-then-attend branch runs kernel B's pool mode).
            out["paged_flash_min_w"] = int(self.attn_impl == "gather")
        if self.spec_k:
            out.update(self._spec_metrics())
        if self._prefix is not None:
            out["serve_prefix_entries"] = len(self._prefix)
            out["serve_prefix_admits_total"] = self._n_prefix_admits
            out["serve_prefix_tokens_saved_total"] = self._n_prefix_tokens
            out["prefix_hits_total"] = self._prefix.hits_total
            out["prefix_misses_total"] = self._prefix.misses_total
            out["prefix_evictions_total"] = self._prefix.evictions_total
            out["prefix_bytes"] = self._prefix.nbytes
        if self._tier is not None:
            # Open sessions = resident (pages in the pool) + parked (host
            # copies); the counters are one locked snapshot.
            res, parked = self._tier.counts()
            out["kv_resident_sessions"] = res
            out["kv_parked_sessions"] = parked
            out["kv_open_sessions"] = res + parked
            st = self._tier.stats()
            out["kv_host_bytes"] = st["host_bytes"]
            out["kv_parked_total"] = st["parked_total"]
            out["kv_waked_total"] = st["waked_total"]
            out["kv_wake_cold_total"] = st["wake_cold_total"]
            out["kv_wake_tokens_saved_total"] = st["wake_tokens_total"]
            out["kv_evicted_total"] = st["evicted_total"]
            out["kv_pages_freed_total"] = st["pages_freed_total"]
            out["kv_wake_p50_ms"] = round(
                self._wake_hist.percentile(50) or 0.0, 3)
            out["kv_wake_p95_ms"] = round(
                self._wake_hist.percentile(95) or 0.0, 3)
        return out

    def _spec_metrics(self) -> dict[str, float]:
        """The reference's ``serve_spec_*`` series (scheduler.py:3165-3204):
        accepted drafts, the most optimistic source's EMA, per source its
        proposed / accepted tokens, acceptance rate, EMA and accepted
        tokens per verify dispatch it drafted into, the aggregate per
        dispatch, and for tree ticks the nodes verified and the mean
        accepted path length (root included)."""
        out: dict[str, float] = {
            "serve_spec_accepted_total": self._n_spec_accepted,
            "serve_spec_accept_ema": round(
                max(self._spec_ema.values(), default=0.0), 4)}
        for src in self._sources:
            n = src.name
            prop = self._n_spec_proposed_src[n]
            acc = self._n_spec_accepted_src[n]
            disp = self._n_spec_dispatch_src[n]
            out[f'serve_spec_proposed_total{{source="{n}"}}'] = prop
            out[f'serve_spec_accepted_total{{source="{n}"}}'] = acc
            out[f'serve_spec_accept_rate{{source="{n}"}}'] = (
                round(acc / prop, 4) if prop else 0.0)
            out[f'serve_spec_accept_ema{{source="{n}"}}'] = round(
                self._spec_ema[n], 4)
            out[f'serve_spec_accepted_per_dispatch{{source="{n}"}}'] = (
                round(acc / disp, 3) if disp else 0.0)
        out["serve_spec_accepted_per_dispatch"] = round(
            self._n_spec_accepted / max(1, self._n_spec_ticks), 3)
        if self.spec_tree_nodes:
            out["serve_spec_tree_nodes_total"] = self._n_spec_tree_nodes
            out["serve_spec_tree_accepted_path_len"] = round(
                1 + self._n_spec_tree_accepted
                / max(1, self._n_spec_tree_rows), 3)
        return out

    # -- scheduler thread --------------------------------------------------

    def _loop(self) -> None:
        """Serving loop with one-tick pipelining (the reference's,
        scheduler.py:2549-2640): tick N+1 is dispatched BEFORE tick N's
        tokens are read back, so the readback and the host's per-row
        work overlap N+1's device time. The device carries its own
        next-token feed, so the host's one-tick lag only delays streaming
        and stop detection: a stopped row decodes one more tick, whose
        writes land past its trusted length or in the garbage page."""
        pending: Optional[tuple] = None   # (toks, event, snapshot, K)
        while not self._closed.is_set():
            it_start = time.monotonic()
            self._loop_beat = it_start
            self._loop_iter += 1
            try:
                self._run_jobs()
                self._drain_park_all()
                self._admit_pending(block=not self._any_active()
                                    and pending is None
                                    and self._prefill_carry is None)
                if self._closed.is_set():
                    return
                self._tier_sweep()
                if self._prefill_carry is not None:
                    # ONE continuation chunk per iteration: live streams
                    # stall at most one chunk's compute.
                    self._prefill_step()
                if not self._any_active():
                    # Idle gaps are not admission stalls.
                    self._last_decode_t = None
                    if pending is not None:
                        self._process_tick(*pending)
                        pending = None
                    elif self._promote_q and self._prefill_carry is None:
                        self._build_promotion()     # idle: nobody to stall
                    continue
                # A spec tick needs the rows' current ids, so the pending
                # tick is flushed first — only on iterations where some
                # source may propose (the throttle keeps pipelining while
                # every source backs off); such iterations' plain ticks
                # run unfused (K = 1: a fused tick would emit K tokens
                # with no draft chance).
                spec_allowed = (self._spec_sources_allowed()
                                if self.spec_k else {})
                spec_now = any(spec_allowed.values())
                if spec_now:
                    if pending is not None:
                        self._process_tick(*pending)
                        pending = None
                    if not self._any_active():
                        continue
                    if self._spec_tick(spec_allowed):
                        continue
                new = self._dispatch_tick(
                    allow_fuse=not spec_now,
                    inflight=pending[3] if pending is not None else 0)
                if pending is not None:
                    self._process_tick(*pending)
                pending = new
                if (self._promote_q and self._n_decode_ticks
                        - self._last_promote_tick > _PROMOTE_EVERY_TICKS):
                    self._build_promotion()
            except Exception:   # noqa: BLE001 — fail requests, keep serving
                log.exception("serving tick failed; failing in-flight "
                              "requests")
                pending = None
                self._recover()
            finally:
                self._watchdog(it_start)

    def _recover(self) -> None:
        """After a failed loop iteration: fail the requests and reset the
        state (:meth:`_fail_all_and_reset`; its reset is an op, so every
        rank resets). Under tensor parallelism, once an op has failed,
        end the plane instead (:meth:`_end_plane`)."""
        ch = self._channel
        if ch is None:
            self._fail_all_and_reset()
            return
        if not ch.down:
            try:
                self._fail_all_and_reset()
                return
            except Exception:   # noqa: BLE001
                if not ch.down:
                    raise
                log.exception("the reset op failed")
        self._end_plane()

    def _end_plane(self) -> None:
        """The leader's end of a tensor-parallel plane after an op failed
        on it, or its collectives failed because a follower left: a rank
        that stopped partway through an op cannot rejoin the stream (its
        peers wait in that op's collectives, or would pair their next
        ones with its leftovers), so every request fails, the scheduler
        takes no more (``ready`` turns false, ``submit`` raises), and
        this rank leaves the world, which ends the followers' waits with
        an error: they exit non-zero. Every other engine on the plane ends
        its part the same way, woken here (serve/tp.TPChannel.end_plane)."""
        log.error("an op failed under tensor parallelism; the plane stops "
                  "and this rank leaves the world (%s)", self.config.name)
        self._closed.set()
        msg = "internal error: the tensor-parallel plane stopped"
        self._fail_rows(msg)
        while True:
            try:
                s = self._admit_q.get_nowait()
            except queue.Empty:
                break
            if s is not None:
                s.fail(msg)
        while True:
            try:
                job = self._jobs.get_nowait()
            except queue.Empty:
                break
            job.err = RuntimeError(msg)
            job.done.set()
        if self._channel.end_plane():
            from ..parallel.distributed import leave_world
            leave_world()

    def _watchdog(self, it_start: float) -> None:
        """Loop-iteration watchdog (the reference's): an iteration past
        ``loop_budget_ms`` (a lazy graph capture, a wedged device call, a
        host stall) raises the ``loop_stall_ms`` high-water gauge and
        re-stamps ``loop_stall_last_ms``, and logs ONE line per stall
        episode on entry and one on recovery. At episode entry the flight
        recorder notes ``stall_enter`` under the stalling iteration's
        number and dumps its ring, whose last events name what that
        iteration did. Blocked-idle iterations end at the admission
        poll's 0.2 s, so idleness never reads as a stall."""
        budget = self.loop_budget_ms
        if not budget:
            return
        dur_ms = (time.monotonic() - it_start) * 1e3
        if dur_ms > budget:
            self._loop_stall_ms = max(self._loop_stall_ms, dur_ms)
            self._loop_stall_last_ms = dur_ms
            if not self._loop_stalled:
                self._loop_stalled = True
                log.warning("scheduler loop iteration took %.0f ms "
                            "(budget %.0f ms)", dur_ms, budget)
                self._flight.note("stall_enter", self._loop_iter,
                                  over_ms=round(dur_ms, 1),
                                  budget_ms=budget)
                try:
                    path = self._flight.dump("watchdog_stall")
                    log.warning("flight recorder dumped to %s", path)
                except OSError as e:
                    log.warning("flight-recorder dump failed: %s", e)
        elif self._loop_stalled:
            self._loop_stalled = False
            self._flight.note("stall_recover", self._loop_iter,
                              last_ms=round(dur_ms, 1))
            log.info("scheduler loop recovered (last iteration %.0f ms)",
                     dur_ms)

    def _live_loop_stall_ms(self) -> float:
        """The completed iterations' max folded with the age of the
        iteration in progress when that is over budget, so a wedged
        iteration shows on /metrics while it is wedged (readable from
        any thread; a torn float read is harmless for a gauge)."""
        stall = self._loop_stall_ms
        beat, budget = self._loop_beat, self.loop_budget_ms
        if beat is not None and budget and not self._closed.is_set():
            cur = (time.monotonic() - beat) * 1e3
            if cur > budget:
                stall = max(stall, cur)
        return stall

    def _any_active(self) -> bool:
        return any(s is not None for s in self._slots)

    def _free_rows(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _collect_pending(self, limit: int, block: bool) -> list[_Slot]:
        """Pull up to ``limit`` requests off the queue and normalise them
        (a short arrival gap lets a concurrent burst admit together)."""
        out: list[_Slot] = []
        while len(out) < limit:
            try:
                timeout = 0.2 if (block and not out) else (
                    0.003 if out else None)
                slot = self._admit_q.get(block=timeout is not None,
                                         timeout=timeout)
            except queue.Empty:
                break
            if slot is None and not self._closed.is_set():
                if not self._jobs.empty():
                    break             # post_on_loop's wake: run the job
                continue              # a wake whose job already ran
            if slot is None or self._closed.is_set():
                if slot is not None:
                    slot.finish()
                break
            if slot.cancelled.is_set():
                slot.depart()
                continue
            if self._expired(slot):
                continue
            try:
                ids, slot.max_new, ctx_limit = normalize_request(
                    self.tokenizer, self.config.vocab_size, self.max_seq,
                    slot.req, min_bucket=_MIN_BUCKET)
            except ValueError as e:
                slot.fail(str(e))
                continue
            slot.prompt_ids = ids
            slot.ctx_budget = ctx_limit
            if slot.stats is not None:
                slot.stats.prompt_tokens = len(ids)
            if self._prefix is not None:
                # Auto-promotion: a head seen promote_after times is built
                # later, between ticks (a bounded, deduped queue; a queued
                # longer head covers a shorter one).
                head = self._prefix.observe(ids)
                if (head is not None and len(self._promote_q) < 8
                        and not any(len(q) >= len(head)
                                    and q[:len(head)] == head
                                    for q in self._promote_q)):
                    self._promote_q.append(head)
            out.append(slot)
        return out

    def _expired(self, slot: _Slot) -> bool:
        if self.queue_timeout_s is None or self._warmup_done_at is None:
            return False
        age = time.monotonic() - max(slot.req.arrival_time,
                                     self._warmup_done_at)
        if age <= self.queue_timeout_s:
            return False
        slot.fail(f"not admitted within {self.queue_timeout_s:.0f}s "
                  "(server at capacity)")
        self._n_expired += 1
        return True

    def _try_reserve(self, slot: _Slot) -> bool:
        """Claim the slot's page budget (prompt + generation room + the
        next-write slot), all or nothing. A dense row owns its max_seq
        slots: nothing to claim (the budget stays the request's context
        limit)."""
        if self.kv_mode == "dense":
            slot.pages = []
            return True
        need = self._alloc.pages_for(len(slot.prompt_ids) + slot.max_new + 1)
        need = min(need, self._cache.max_pages_per_row)
        pages = self._alloc.alloc(need)
        if pages is None and self._tier is not None:
            # Pool pressure: resident sessions are the reclaimable tier —
            # park them before making the request wait.
            self._reclaim_pages(need)
            pages = self._alloc.alloc(need)
        if pages is None:
            return False
        slot.pages = pages
        slot.ctx_budget = min(need * self.page_size, self.max_seq)
        return True

    def _wait_or_fail(self, slot: _Slot) -> None:
        need = self._alloc.pages_for(len(slot.prompt_ids) + slot.max_new + 1)
        if need > self.num_pages - 1:
            slot.fail(f"request needs {need} KV pages; the pool has "
                      f"{self.num_pages - 1}")
        else:
            self._waiting.append(slot)

    def _admit_pending(self, block: bool) -> None:
        """Admit pending requests into free rows: session wakes first (one
        verify-shaped forward per suffix bucket, :meth:`_admit_wake`),
        then one prefill per (prefix, bucket, chunk). With live streams,
        at most one wake or one chunk per call (the rest carries), so a
        burst cannot stall decoding for long, and a round whose wake made
        cold requests wait puts the cold ones first next time (the
        reference's ``_wake_rr_cold``). A chunked admission in progress
        owns its rows (they are not in ``_slots`` until its final chunk)
        and everything else waits behind it."""
        if self._prefill_carry is not None:
            return
        free = self._free_rows()
        if not free:
            return
        had_active = len(free) < self.num_slots
        pending: list[_Slot] = []
        # Session wakes by suffix bucket, classified wherever a slot holds
        # no page reservation yet (fresh arrivals, carried wakes).
        wakes: dict[int, list[_Slot]] = {}

        def classify(s: _Slot) -> bool:
            if self._tier is None or s.pages is not None or self._waiting:
                return False
            S = self._wake_candidate(s)
            if S is None:
                return False
            wakes.setdefault(S, []).append(s)
            return True

        for s in self._admit_carry:
            if s.cancelled.is_set() or s.done or self._expired(s):
                s.depart()
                s.wake_dev = None
                if s.pages:
                    self._alloc.free(s.pages)
                    s.pages = None
                continue
            if classify(s):
                continue
            if s.pages is None:
                # A carried wake whose session vanished: a cold
                # reservation, behind any waiter.
                if self._waiting or not self._try_reserve(s):
                    self._wait_or_fail(s)
                else:
                    pending.append(s)
            else:
                pending.append(s)
        self._admit_carry = []
        still: list[_Slot] = []
        for s in self._waiting:
            if s.cancelled.is_set():
                s.depart()
                continue
            if self._expired(s):
                continue
            # Strict FIFO: the first waiter that cannot reserve blocks
            # everyone behind it.
            if not still and len(pending) < len(free) and self._try_reserve(s):
                pending.append(s)
            else:
                still.append(s)
        self._waiting = still
        room = len(free) - len(pending) - sum(len(g) for g in wakes.values())
        if room > 0:
            for s in self._collect_pending(
                    room, block and not pending and not wakes
                    and not self._waiting):
                if classify(s):
                    continue
                if self._waiting or not self._try_reserve(s):
                    self._wait_or_fail(s)
                else:
                    pending.append(s)
        if not pending and not wakes:
            return
        if wakes and pending and had_active and self._wake_rr_cold:
            # The last contended round put a wake ahead of cold work:
            # this round the cold requests go first, the wakes carry.
            self._wake_rr_cold = False
            self._admit_carry = [x for S in sorted(wakes) for x in wakes[S]]
            wakes = {}
        if wakes:
            if not self._dispatch_wakes(wakes, free, pending, had_active):
                return
            if not pending:
                return
        # Group by (cached prefix, bucket): a chunk's rows share one prefix
        # entry, and the bucket covers only the suffix of a matched slot.
        groups: dict[tuple, list[_Slot]] = {}
        for s in pending:
            if self._prefix is not None and not s.prefix_checked:
                s.prefix = self._prefix.match(s.prompt_ids)
                s.prefix_checked = True
                # The spliced carry is P + suffix-bucket wide; a prompt
                # whose suffix bucket rounds past max_seq admits plainly.
                if s.prefix is not None and s.prefix.length + _bucket(
                        len(s.prompt_ids) - s.prefix.length,
                        self.max_seq) > self.max_seq:
                    s.prefix = None
            P = s.prefix.length if s.prefix is not None else 0
            key = (s.prefix.ids if s.prefix is not None else (),
                   _bucket(len(s.prompt_ids) - P, self.max_seq))
            groups.setdefault(key, []).append(s)
        order = [(pkey, S, g) for (pkey, S), g in sorted(groups.items())]
        for gi, (pkey, S, group) in enumerate(order):
            while group:
                R = max(1, min(len(group),
                               _ADMIT_TOKEN_BUDGET // (S + len(pkey)),
                               self.admit_chunk or len(group)))
                chunk, group = group[:R], group[R:]
                rows = [free.pop(0) for _ in chunk]
                C = self.prefill_chunk
                try:
                    if C and S > C and S % C == 0:
                        # Chunked admission: the loop runs one chunk per
                        # iteration; everything else queues behind it.
                        self._start_prefill_carry(chunk, rows, S, C)
                        # Appended: wakes the rotation deferred may sit
                        # in the carry already.
                        self._admit_carry = group + [
                            x for _, _, g in order[gi + 1:] for x in g
                        ] + self._admit_carry
                        return
                    self._admit_chunk(chunk, rows, S)
                except Exception:   # noqa: BLE001
                    log.exception("admission failed for %d request(s)",
                                  len(chunk))
                    for s in chunk + group + [
                            x for _, _, g in order[gi + 1:] for x in g]:
                        s.fail("internal error: admission failed")
                    self._fail_all_and_reset()
                    return
                if had_active and (group or gi + 1 < len(order)):
                    self._admit_carry = group + [
                        x for _, _, g in order[gi + 1:] for x in g
                    ] + self._admit_carry
                    return

    def _dispatch_wakes(self, wakes: dict[int, list[_Slot]], free: list[int],
                        pending: list[_Slot], had_active: bool) -> bool:
        """Run the session wakes of an admission round, one
        :meth:`_admit_wake` per suffix bucket (with live streams, one
        bucket a round; the rest carries). Rows a wake did not use return
        to ``free``; demoted slots (the session vanished, or its pages
        could not be reserved) take a cold reservation into ``pending``.
        False = the round is over (work carried, or a failed wake reset
        the state); True = go on to the cold admissions."""
        one_wake = False
        carry_tail: list[_Slot] = []
        keys = sorted(wakes)
        for wi, S in enumerate(keys):
            group = wakes[S]
            if (had_active and one_wake) or not free:
                carry_tail.extend(group)
                continue
            batch = group[:len(free)]
            carry_tail.extend(group[len(batch):])
            rows = [free.pop(0) for _ in batch]
            try:
                demoted, unused = self._admit_wake(batch, rows, S)
            except Exception:   # noqa: BLE001
                log.exception("wake admission failed for %d request(s)",
                              len(batch))
                # Tables and pages may be half-installed: fail the round
                # and reset, as a failed prefill does.
                for s in (batch + carry_tail + pending
                          + [x for S2 in keys[wi + 1:] for x in wakes[S2]]):
                    s.fail("internal error: admission failed")
                self._fail_all_and_reset()
                return False
            one_wake = True
            free.extend(unused)
            for s in demoted:
                if self._waiting or not self._try_reserve(s):
                    self._wait_or_fail(s)
                else:
                    pending.append(s)
        if carry_tail or (had_active and one_wake):
            rest = carry_tail + pending
            if rest:
                self._admit_carry = rest + self._admit_carry
            if one_wake and pending:
                self._wake_rr_cold = True
            return False
        return True

    def _host_arrays(self, chunk: list[_Slot], S: int) -> tuple:
        """(tokens [R, S] right-padded suffixes, suffix lens [R], total
        lens [R], tables [R, max_pages_per_row]) on the host, for a chunk
        whose slots share ``chunk[0].prefix``."""
        prefix = chunk[0].prefix
        P = prefix.length if prefix is not None else 0
        R = len(chunk)
        tokens = torch.zeros((R, S), dtype=torch.long)
        suf = torch.zeros((R,), dtype=torch.long)
        total = torch.zeros((R,), dtype=torch.long)
        tables = torch.zeros((R, self._cache.max_pages_per_row
                              if self.kv_mode == "paged" else 1),
                             dtype=torch.int32)
        for i, slot in enumerate(chunk):
            ids = slot.prompt_ids[P:]
            tokens[i, :len(ids)] = torch.tensor(ids, dtype=torch.long)
            suf[i] = len(ids)
            total[i] = len(slot.prompt_ids)
            tables[i, :len(slot.pages)] = torch.tensor(slot.pages,
                                                       dtype=torch.int32)
        return tokens, suf, total, tables

    def _admit_chunk(self, chunk: list[_Slot], rows: list[int],
                     S: int) -> None:
        """Prefill ``chunk`` together in one piece, splice its KV into the
        pool at ``rows``, install per-row sampling state and sample each
        row's first token. A prefix-matched chunk prefills only its
        suffixes, at positions P.. over the prefix broadcast into a
        P + S carry, and splices prefix + suffix into each row's pages."""
        # Failpoint: an injected admission fault fails this round's
        # requests through _admit_pending's recovery envelope and leaves
        # the loop serving.
        failpoint("serve.scheduler.admit")
        t_admit = time.monotonic()
        for s in chunk:
            s.admit_t = t_admit
        prefix = chunk[0].prefix
        tokens, suf, total, tables = self._host_arrays(chunk, S)
        toks = self._dev("admit", rows, tokens, suf, total, tables, prefix,
                         self._sample_args(chunk))
        if prefix is not None:
            self._n_prefix_admits += len(chunk)
            self._n_prefix_tokens += prefix.length * len(chunk)
        self._admit_since_tick = True
        self._install_admitted(chunk, rows, toks)

    def _dev_admit(self, rows: list[int], tokens: torch.Tensor,
                   suf: torch.Tensor, total: torch.Tensor,
                   tables: torch.Tensor, prefix, samp: tuple
                   ) -> torch.Tensor:
        """The device half of :meth:`_admit_chunk` (host arrays in): the
        prefill (over the prefix's KV when ``prefix`` is given), the KV
        into the rows, and the first tokens sampled (returned, on the
        device)."""
        dev = self.device
        if prefix is None:
            logits, k_all, v_all = self._family.prefill(
                self._params, self.config, tokens.to(dev), total.to(dev),
                last_only=True, mesh=self.mesh)
        else:
            pk, pv = self._prefix_kv(prefix)
            P = pk.shape[1]
            k_all, v_all = self._family.new_carry(
                self.config, len(rows), P + tokens.shape[1], self._dtype,
                dev, pk, pv, mesh=self.mesh)
            logits = self._family.prefill_chunk(
                self._params, self.config, tokens.to(dev), k_all, v_all, P,
                (suf - 1).to(dev), mesh=self.mesh)
        if self.kv_mode == "dense":
            self._write_rows(rows, k_all, v_all, 0)
            self._cache.lengths[torch.tensor(rows, device=dev)] = total.to(
                device=dev, dtype=torch.int32)
        else:
            write_prefill_batch(self._cache, k_all, v_all,
                                torch.tensor(rows, dtype=torch.long), total,
                                tables)
        del k_all, v_all
        return self._sample_first(rows, logits[:, 0, :], samp)

    def _write_rows(self, rows: list[int], k: torch.Tensor, v: torch.Tensor,
                    start: int) -> None:
        """Copy a prefill's k/v [L, R, C, Hkv, D] into slots ``start ..
        start + C`` of the dense cache's ``rows`` (the reference's
        ``cache.k.at[:, rows, :S].set``)."""
        idx = torch.tensor(rows, dtype=torch.long, device=self.device)
        C = k.shape[2]
        self._cache.k[:, idx, start:start + C] = k
        self._cache.v[:, idx, start:start + C] = v

    def _start_prefill_carry(self, chunk: list[_Slot], rows: list[int],
                             S: int, C: int) -> None:
        """Begin a chunked admission: the host arrays are built once here,
        the chunks run in :meth:`_prefill_step`, one per loop
        iteration."""
        t_admit = time.monotonic()
        for s in chunk:
            s.admit_t = t_admit
        tokens, suf, total, tables = self._host_arrays(chunk, S)
        self._prefill_carry = _PrefillCarry(
            chunk=chunk, rows=rows, S=S, C=C, off=0, prefix=chunk[0].prefix,
            tokens=tokens, suf_lens=suf, total_lens=total, tables=tables)

    def _prefill_step(self) -> None:
        """Run ONE continuation chunk of the admission in progress: the
        chunk's forward over the carry (kernel D at offset P0 + off), the
        logits of rows whose last prompt position falls in it merged into
        the carried logits, and its KV spliced into the rows' pages. The
        final chunk installs the rows' tables and lengths and samples
        their first tokens (TTFT lands there)."""
        failpoint("serve.scheduler.admit")   # the chunked leg of the site
        pc = self._prefill_carry
        C, off = pc.C, pc.off
        self._flight.note("prefill_chunk", self._loop_iter, off=off, C=C,
                          S=pc.S, n=len(pc.chunk))
        P0 = pc.prefix.length if pc.prefix is not None else 0
        R = len(pc.chunk)
        final = off + C >= pc.S
        toks = self._dev(
            "chunk", pc.rows, off, C, pc.S, P0,
            pc.prefix if off == 0 else None, pc.tokens[:, off:off + C],
            pc.suf_lens, pc.tables, pc.total_lens,
            self._sample_args(pc.chunk) if final else None)
        self._n_prefill_chunks += 1
        self._admit_since_tick = True
        pc.off = off + C
        if not final:
            return
        self._prefill_carry = None
        if pc.prefix is not None:
            self._n_prefix_admits += R
            self._n_prefix_tokens += P0 * R
        self._install_admitted(pc.chunk, pc.rows, toks)

    def _dev_chunk(self, rows: list[int], off: int, C: int, S: int, P0: int,
                   prefix, tokens: torch.Tensor, suf_lens: torch.Tensor,
                   tables: torch.Tensor, total_lens: torch.Tensor,
                   samp: Optional[tuple]) -> Optional[torch.Tensor]:
        """The device half of :meth:`_prefill_step`: chunk ``tokens``
        [R, C] at suffix offset ``off`` over the carry ``_pc_dev`` (made
        at ``off`` 0, the prefix's KV in its first P0 slots), the logits
        of rows whose last prompt position falls in it merged into the
        carried ones, the chunk's KV into the rows; the final chunk
        (``samp`` given) installs the rows' tables and lengths and
        returns their first tokens."""
        dev = self.device
        R = len(rows)
        base = P0 + off
        if off == 0:
            k, v = self._family.new_carry(
                self.config, R, P0 + S, self._dtype, dev,
                *(self._prefix_kv(prefix) if prefix is not None else ()),
                mesh=self.mesh)
            self._pc_dev = [k, v, torch.zeros(
                (R, self.config.vocab_size), dtype=torch.float32,
                device=dev)]
        k, v, carried = self._pc_dev
        local_last = (suf_lens - 1 - off).to(dev)
        logits = self._family.prefill_chunk(
            self._params, self.config, tokens.to(dev), k, v, base,
            local_last.clamp(0, C - 1), mesh=self.mesh)
        keep = (local_last >= 0) & (local_last < C)
        carried = torch.where(keep[:, None], logits[:, 0, :], carried)
        self._pc_dev[2] = carried
        lo = 0 if off == 0 else base       # the first chunk carries the prefix
        if self.kv_mode == "dense":
            if off == 0:
                # The rows are parked while their chunks land, and a
                # parked row writes slot lengths[b] each tick: at max_seq
                # that write drops (the reference's move).
                self._cache.lengths[torch.tensor(rows, device=dev)] = \
                    self.max_seq
            self._write_rows(rows, k[:, :, lo:base + C], v[:, :, lo:base + C],
                             lo)
        else:
            write_prefill_chunk(self._cache, k[:, :, lo:base + C],
                                v[:, :, lo:base + C], tables, lo)
        if samp is None:
            return None
        self._pc_dev = None
        idx = torch.tensor(rows, dtype=torch.long, device=dev)
        if self.kv_mode == "paged":
            self._cache.page_table[idx] = tables.to(dev)
        self._cache.lengths[idx] = total_lens.to(device=dev,
                                                 dtype=torch.int32)
        return self._sample_first(rows, carried, samp)

    def _sample_args(self, chunk: list[_Slot]) -> tuple:
        """Host arrays of the rows' sampling state for
        :meth:`_sample_first`: temperatures, top-k, top-p, repeat
        penalties, keys ``[seed, 0]``, the penalty rings holding the
        prompts' tails, and each first token's context position
        (len(prompt))."""
        R = len(chunk)
        opts = [slot.req.options for slot in chunk]
        rings = torch.full((R, _RING), self.config.vocab_size,
                           dtype=torch.long)
        for i, slot in enumerate(chunk):
            n = len(slot.prompt_ids)
            for p in range(max(0, n - _RING), n):    # the prompt's tail
                rings[i, p % _RING] = slot.prompt_ids[p]
        return (torch.tensor([o.temperature for o in opts],
                             dtype=torch.float32),
                torch.tensor([o.top_k for o in opts], dtype=torch.long),
                torch.tensor([o.top_p for o in opts], dtype=torch.float32),
                torch.tensor([o.repeat_penalty for o in opts],
                             dtype=torch.float32),
                torch.tensor([[slot.seed, 0] for slot in chunk],
                             dtype=torch.long),
                rings,
                torch.tensor([len(s.prompt_ids) for s in chunk],
                             dtype=torch.long))

    def _sample_first(self, rows: list[int], logits: torch.Tensor,
                      samp: tuple) -> torch.Tensor:
        """Write the rows' options, keys and rings (:meth:`_sample_args`)
        into the persistent device state in place and sample each row's
        first token from ``logits`` ([R, V]) with the device sampler; the
        tokens [R] (on the device) also become the rows' feed."""
        dev = self.device
        idx = torch.tensor(rows, dtype=torch.long, device=dev)
        temps, top_ks, top_ps, rps, keys, rings, emit = (
            t.to(dev) for t in samp)
        self._temps_dev[idx] = temps
        self._top_ks_dev[idx] = top_ks
        self._top_ps_dev[idx] = top_ps
        self._rps_dev[idx] = rps
        self._keys_dev[idx] = keys
        self._ring_dev[idx] = rings
        toks, keys, ring = sample_step_batched(
            logits, self._keys_dev[idx], self._temps_dev[idx],
            self._top_ks_dev[idx], self._top_ps_dev[idx],
            ring=self._ring_dev[idx], rp=self._rps_dev[idx], emit_pos=emit,
            active=torch.ones((len(rows),), dtype=torch.bool, device=dev))
        self._keys_dev[idx] = keys
        self._ring_dev[idx] = ring
        self._next[idx, 0] = toks
        if self._tp:
            self._fold(toks)
        return toks

    def _install_admitted(self, chunk: list[_Slot], rows: list[int],
                          toks: torch.Tensor,
                          wake: Optional[tuple[float, list[int]]] = None
                          ) -> None:
        """Admission epilogue shared by the one-piece, the chunked and the
        wake paths, on the host: read the rows' first tokens (``toks``
        [R], :meth:`_sample_first`), install the slots and stream.
        ``wake``: (the wake's start, each row's session length) — the
        first token of a woken session is sampled exactly as a cold
        admission's; the wake is counted, timed (``kv_wake_ms``) and
        traced (``sched.wake``) instead."""
        R = len(chunk)
        first = toks.tolist()
        # Draft sources index each row's prompt before its first token is
        # appended (release never precedes admit); the model drafter
        # prefills every admitted row's prompt in one batched call. With
        # speculation toggled off nothing drafts: sources late-bind (the
        # drafter's catch-up feeds) when it is back on.
        for src in (self._sources if self.spec_k else ()):
            prefill = getattr(src, "prefill", None)
            if prefill is not None:
                prefill(list(rows), {row: slot.prompt_ids
                                     for slot, row in zip(chunk, rows)})
                continue
            for slot, row in zip(chunk, rows):
                src.admit(row, slot.prompt_ids)
        now = time.monotonic()
        self._n_admitted += R
        if wake is None:
            self._flight.note("admit", self._loop_iter, n=R)
        else:
            t0, saved = wake
            # Prompt tokens whose prefill the wake skipped.
            self._tier.note_waked(R, tokens_saved=sum(saved))
        tr = self._trace
        for i, (slot, row, tok) in enumerate(zip(chunk, rows, first)):
            slot.depart()
            if slot.stats is not None:
                slot.stats.ttft_s = now - slot.req.arrival_time
            if wake is not None:
                self._wake_hist.observe((now - t0) * 1e3)
                if tr is not None and slot.req.trace_sampled:
                    tr.add(slot.req.trace_id, "sched.queue_wait",
                           slot.req.arrival_time, t0 - slot.req.arrival_time)
                    tr.add(slot.req.trace_id, "sched.wake", t0, now - t0,
                           tokens_saved=saved[i], row=row)
            elif tr is not None and slot.req.trace_sampled:
                # The wall before the first token, split at the admission
                # dispatch: queue wait, then the prefill (every chunk of
                # a chunked admission and the first sample included).
                t_admit = slot.admit_t or now
                tr.add(slot.req.trace_id, "sched.queue_wait",
                       slot.req.arrival_time,
                       t_admit - slot.req.arrival_time)
                tr.add(slot.req.trace_id, "sched.prefill", t_admit,
                       now - t_admit, tokens=len(slot.prompt_ids), row=row)
            slot.ctx_len = len(slot.prompt_ids)
            self._slots[row] = slot
            if not self._append_token(slot, row, tok):
                self._release(row)

    def _note_admission_gap(self, now: float) -> None:
        """The decode_stall_ms tracker: the dispatch-to-dispatch interval
        across an iteration that did admission work (a prefill or a
        continuation chunk) is the stall live streams saw."""
        if self._last_decode_t is not None and self._admit_since_tick:
            self._decode_stall_ms = max(self._decode_stall_ms,
                                        (now - self._last_decode_t) * 1e3)
        self._last_decode_t = now
        self._admit_since_tick = False

    def _dispatch_tick(self, allow_fuse: bool = True,
                       inflight: int = 0) -> tuple:
        """Launch one decode tick without reading anything back (the
        reference's ``_dispatch_tick``, scheduler.py:3904-3966): K from
        :meth:`_choose_fuse_k`, the window covering every live row's
        deepest attended position (``ctx_len + inflight + K - 1``:
        under pipelining the device runs up to ``inflight`` slots ahead
        of the host's ctx_len; K = 1 unless ``allow_fuse``), the live-row
        mask re-uploaded only when the set of live rows changed, then one
        program call and the copy
        of its token block into a host buffer behind an event. Returns
        (toks [K, B] host, event or None, the rows it decoded for, K)
        for :meth:`_process_tick`, one tick later."""
        # Flight event BEFORE the failpoint and the launch: if this
        # dispatch wedges, the ring's last event names it under the
        # iteration the watchdog's stall marker carries.
        self._flight.note("dispatch", self._loop_iter, inflight=inflight)
        # Failpoint: an injected dispatch fault takes the loop's recovery
        # envelope (_fail_all_and_reset): in-flight requests fail with a
        # well-formed error and the next request serves as before.
        failpoint("serve.scheduler.dispatch")
        K = self._choose_fuse_k(inflight) if allow_fuse else 1
        if K != self._last_fuse_k:
            # Only the flips: a steady K would evict everything else.
            self._flight.note("fuse_k", self._loop_iter, k=K)
            self._last_fuse_k = K
        self._n_decode_ticks += 1
        self._n_decode_steps += K
        if K > 1:
            self._n_fused_ticks += 1
            self._n_fused_steps += K
        now = time.monotonic()
        self._note_admission_gap(now)
        if (self._last_dispatch is not None
                and now - self._last_dispatch[0] < 0.25):
            # Idle gaps (> 250 ms) are load valleys, not decode wall.
            self._wall_hist.observe(
                (now - self._last_dispatch[0]) * 1e3 / self._last_dispatch[1])
        self._last_dispatch = (now, K)
        window = self._window(extra=max(1, inflight + K - 1))
        self._dev("tick", window, K, self._live_rows())
        toks = self._host_toks[self._flip][:K]
        self._flip ^= 1
        toks.copy_(self._toks_out[K], non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return toks, event, list(self._slots), K

    def _dev_tick(self, window: int, K: int, active: tuple) -> None:
        """The device half of a decode tick: the live-row mask, then the
        program of K steps at ``window``. Under tensor parallelism the
        tick runs eagerly, ends synchronised, and its wall over K and its
        collectives' time over K (the tick's own: earlier ops' are
        dropped) are the step's readings."""
        if self._tp:
            self.mesh.drop_collective_timing()
        t0 = time.perf_counter()
        self._sync_active(active)
        self._decode_fused_for(window, K)()
        if not self._tp:
            return
        self._fold(self._toks_out[K])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        coll = self.mesh.take_collective_ms()
        if len(self._tp_step_ms) < 4096:
            self._tp_step_ms.append((time.perf_counter() - t0) * 1e3 / K)
            self._tp_coll_ms.append(coll / K)

    def _live_rows(self) -> tuple:
        return tuple(s is not None for s in self._slots)

    def _sync_active(self, active: Optional[tuple] = None) -> None:
        """Upload the live-row mask when the set of live rows changed
        (``active``: the mask as the leader sent it; default the
        slots')."""
        if active is None:
            active = self._live_rows()
        if active != self._active_host:
            self._active_host = active
            mask = torch.tensor(active, dtype=torch.bool)
            if self.device.type == "cuda":
                mask = mask.pin_memory()
            self._active_dev.copy_(mask, non_blocking=True)

    def _spec_tick(self, allowed: dict[str, bool]) -> bool:
        """One speculative tick (the reference's ``_spec_tick``, with the
        n-gram source). False (the caller runs a plain tick) when no live
        row got a draft: the verify computes every row's S positions, so
        it pays only when something is drafted.

        Drafts: each allowed source in priority order proposes for the
        rows still without one (rows with no budget left are skipped);
        a consulted source that proposed nothing decays its EMA as a
        zero-acceptance tick would. Rows' cap: ``max_acc = min(len(draft),
        ctx_budget - 2 - ctx_len)``. Tree ticks place a source's second
        choices as sibling leaves where its score gap is below
        ``spec_tree_gap`` (the n-gram source has none, so its tree is the
        main chain in an N-node program); a row too close to its budget
        for N node slots keeps a plain chain.

        Verify: the input block goes to the device in one pinned copy,
        the window's spec program runs (a CUDA graph replay on the card),
        and one event-synced readback brings (accepted, correction, used
        sibling). The tick is a dispatch: the ``serve.scheduler.dispatch``
        failpoint fires here too. Then each source's EMA and counters,
        and every row's emitted tokens (accepted drafts, a used sibling,
        the correction) stream as a plain tick's would."""
        K = self.spec_k
        N = self.spec_tree_nodes
        tree = bool(N)
        host = self._fill_spec_base()
        cols = self._spec_cols
        tokens = host[:, cols["tokens"]]
        drafts = host[:, cols["drafts"]]
        max_acc = host[:, cols["max_acc"]]
        budgets: dict[int, int] = {}
        ctxs: dict[int, tuple] = {}
        remaining: list[int] = []
        for row, slot in enumerate(self._slots):
            if slot is None:
                continue
            tokens[row, 0] = slot.ids[-1]
            budget = slot.ctx_budget - 2 - slot.ctx_len
            if budget < 1:
                continue
            budgets[row] = budget
            ctxs[row] = (slot.prompt_ids, slot.ids)
            remaining.append(row)
        proposals: dict[int, tuple] = {}
        consulted: list[str] = []
        for src in self._sources:
            if not remaining or not allowed.get(src.name):
                continue
            consulted.append(src.name)
            if tree:
                got = src.draft_tree_batch(remaining, ctxs)
                for row in remaining:
                    t = got.get(row)
                    if t and t[0]:
                        d, sec, gap = t
                        proposals[row] = (src.name, list(d[:K]),
                                          list(sec[:K]), list(gap[:K]))
            else:
                got = src.draft_batch(remaining, ctxs)
                for row in remaining:
                    d = got.get(row)
                    if d:
                        proposals[row] = (src.name, list(d[:K]), [], [])
            remaining = [r for r in remaining if r not in proposals]
        for name in consulted:
            if not any(src == name for src, *_ in proposals.values()):
                self._spec_ema[name] *= (1 - _SPEC_EMA_ZERO_ALPHA)
        if not proposals:
            return False
        src_rows: dict[str, list[int]] = {s.name: [] for s in self._sources}
        for row, (src, d, sec, gap) in proposals.items():
            src_rows[src].append(row)
            self._n_spec_proposed_src[src] += len(d)
            drafts[row, :len(d)] = d
            tokens[row, 1:1 + len(d)] = d
            max_acc[row, 0] = min(len(d), budgets[row])
            if tree:
                n_sib = 0
                # Node slots past the row's budget would be written to the
                # garbage page, and a sibling copied from there is stale.
                if self._slots[row].ctx_len + N + 2 <= self._slots[
                        row].ctx_budget:
                    sites = [j for j in range(min(len(d), len(sec), len(gap)))
                             if gap[j] < self.spec_tree_gap
                             and sec[j] != d[j]]
                    for j in sites[:N - K - 1]:
                        node = K + 1 + n_sib
                        tokens[row, node] = sec[j]
                        host[row, cols["depths"].start + node] = j + 1
                        base = cols["anc"].start + node * N
                        host[row, base:base + j + 1] = 1
                        host[row, cols["sib_tok"].start + j] = sec[j]
                        host[row, cols["sib_node"].start + j] = node
                        n_sib += 1
                self._n_spec_tree_rows += 1
                self._n_spec_tree_nodes += 1 + len(d) + n_sib
        self._flight.note("spec", self._loop_iter, rows=len(proposals))
        failpoint("serve.scheduler.dispatch")
        self._n_decode_ticks += 1
        self._n_spec_ticks += 1
        self._last_dispatch = None    # a spec wall is not a decode step's
        self._note_admission_gap(time.monotonic())
        for name, rows_d in src_rows.items():
            if rows_d:
                self._n_spec_dispatch_src[name] += 1
        window = self._window(extra=N - 1 if tree else K)
        self._dev("spec", window, host, self._live_rows())
        self._spec_out_host.copy_(self._spec_out, non_blocking=True)
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            event.synchronize()
        acc, corr, used = self._spec_out_host.tolist()
        for src in self._sources:
            rows_s = src_rows.get(src.name) or []
            if not rows_s:
                continue
            n_acc = sum(acc[r] for r in rows_s)
            self._n_spec_accepted_src[src.name] += n_acc
            tick_acc = n_acc / len(rows_s)
            alpha = _SPEC_EMA_ZERO_ALPHA if n_acc == 0 else _SPEC_EMA_ALPHA
            ema = (1 - alpha) * self._spec_ema[src.name] + alpha * tick_acc
            if tick_acc >= _SPEC_EMA_FLOOR:
                # One probe that clears the floor re-enables the source.
                ema = max(ema, _SPEC_EMA_SEED)
            self._spec_ema[src.name] = ema
            for r in rows_s:
                src.observe(r, acc[r] - used[r])
        for row, slot in enumerate(self._slots):
            if slot is None:
                continue
            if slot.cancelled.is_set():
                self._release(row)
                continue
            a = acc[row]
            self._n_spec_accepted += a
            if tree and row in proposals:
                self._n_spec_tree_accepted += a
            if used[row]:
                # Position a - 1 took the sibling, not the main draft.
                emitted = ([int(t) for t in drafts[row, :a - 1]]
                           + [int(host[row, cols["sib_tok"].start + a - 1]),
                              corr[row]])
            else:
                emitted = [int(t) for t in drafts[row, :a]] + [corr[row]]
            for t in emitted:
                slot.ctx_len += 1
                if not self._append_token(slot, row, t):
                    self._release(row)
                    break
        return True

    def _dev_spec(self, window: int, block, active: tuple) -> None:
        """The device half of a spec tick: the live-row mask, the input
        block (``block``: the pinned host block's numpy view, a copy on a
        follower) to the device in one copy, the window's spec
        program."""
        self._sync_active(active)
        if self._follower:
            self._spec_host.numpy()[...] = block
        self._spec_in.copy_(self._spec_host, non_blocking=True)
        self._spec_for(window)()
        if self._tp:
            self._fold(self._spec_out)

    def _process_tick(self, toks: torch.Tensor, event, snapshot: list,
                      K: int) -> None:
        """Host half of a decode tick (the reference's ``_process_tick``,
        scheduler.py:3968-4000): wait for its token block and drain each
        row's burst in order, up to its first finisher (EOS parked the
        row on the device at exactly that point). Rows released or
        re-admitted since dispatch are skipped by identity."""
        # Failpoint: the token readback (device -> host); a fault here
        # takes the same recovery envelope as a dispatch fault.
        failpoint("serve.engine.readback")
        if event is not None:
            event.synchronize()
        block = toks.tolist()
        for row, slot in enumerate(snapshot):
            if slot is None or slot.done or self._slots[row] is not slot:
                continue
            if slot.cancelled.is_set():
                self._release(row)
                continue
            for k in range(K):
                slot.ctx_len += 1       # the step's input landed in the pool
                if not self._append_token(slot, row, block[k][row]):
                    self._release(row)
                    break

    def _append_token(self, slot: _Slot, row: int, tok: int) -> bool:
        """Record one sampled token and stream its text. False = the
        request is finished (EOS, stop string, length or context
        limit)."""
        now = time.monotonic()
        if slot.last_emit_t:
            self._tbt_hist.observe((now - slot.last_emit_t) * 1e3)
        slot.last_emit_t = now
        if tok in self._stop_ids:
            self._flush_text(slot, final=True)
            slot.finish()
            return False
        slot.ids.append(tok)
        for src in self._sources:
            src.append(row, tok)
        if slot.stats is not None:
            slot.stats.completion_tokens = len(slot.ids)
        if self._flush_text(slot):
            slot.finish()
            return False
        if len(slot.ids) >= slot.max_new or slot.ctx_len + 1 >= slot.ctx_budget:
            self._flush_text(slot, final=True)
            slot.finish()
            return False
        return True

    def _flush_text(self, slot: _Slot, final: bool = False) -> bool:
        """Incremental detokenisation: decode only new ids, hold back a
        trailing partial UTF-8 sequence and any suffix that may start a
        stop string. True when a stop string matched (text past it is
        dropped, as Ollama does)."""
        pending = self.tokenizer.decode(slot.ids[slot.decoded_upto:])
        if pending:
            if not final and pending.endswith("�"):
                return False
            slot.text += pending
            slot.decoded_upto = len(slot.ids)
        stops = [s for s in slot.req.options.stop if s]
        max_stop = max((len(s) for s in stops), default=0)
        for s in stops:
            idx = slot.text.find(s, max(0, slot.streamed - len(s) + 1))
            if idx >= 0:
                slot.push(slot.text[slot.streamed: idx])
                slot.text = slot.text[:idx]
                slot.streamed = idx
                return True
        emit_to = len(slot.text)
        if not final and stops:
            for k in range(min(max_stop - 1, len(slot.text)), 0, -1):
                if any(s.startswith(slot.text[-k:]) for s in stops):
                    emit_to = len(slot.text) - k
                    break
        if emit_to > slot.streamed:
            slot.push(slot.text[slot.streamed: emit_to])
            slot.streamed = emit_to
        return False

    def _release(self, row: int) -> None:
        """Free a row: zero its page table (later parked-row writes land
        in the garbage page) BEFORE its pages return to the allocator."""
        slot = self._slots[row]
        self._slots[row] = None
        for src in self._sources:
            src.release(row)
        if (slot is not None and self._trace is not None
                and slot.req.trace_sampled and slot.stats is not None
                and slot.stats.ttft_s is not None):
            # The decode phase: first token -> release.
            t_first = slot.req.arrival_time + slot.stats.ttft_s
            self._trace.add(slot.req.trace_id, "sched.decode", t_first,
                            time.monotonic() - t_first,
                            tokens=len(slot.ids), row=row)
        if (slot is not None and self._tier is not None
                and self._retain_session(slot, row)):
            return
        if slot is not None and slot.pages:
            # Fills on the stream, after every tick already queued: a
            # tick in flight still writes this row's own pages.
            self._dev("release", row)
            self._alloc.free(slot.pages)
            slot.pages = None

    def _fail_all_and_reset(self) -> None:
        """Error-path recovery: note and dump the flight recorder, fail
        every in-flight and queued-for-a-row request, and reset the device
        state in place. The reset's fills queue on the serving stream
        behind any tick still in flight, so that tick cannot write over
        the cleared state."""
        self._flight.note("reset", self._loop_iter,
                          failed=sum(s is not None for s in self._slots))
        try:
            path = self._flight.dump("fail_all_and_reset")
            log.warning("flight recorder dumped to %s", path)
        except OSError as e:
            log.warning("flight-recorder dump failed: %s", e)
        self._fail_rows("internal error: serving state was reset")
        for src in self._sources:
            src.reset()
        if self._tier is not None:
            # Resident sessions' page ids point into the allocator being
            # rebuilt; parked payloads live on the host and survive.
            self._tier.reset_resident()
        self._dev("reset")

    def _fail_rows(self, msg: str) -> None:
        """Fail every in-flight request and every one queued for a row."""
        for i, s in enumerate(self._slots):
            if s is not None:
                s.fail(msg)
                self._slots[i] = None
        pc, self._prefill_carry = self._prefill_carry, None
        for s in self._admit_carry + self._waiting + (pc.chunk if pc else []):
            s.pages = None
            s.fail(msg)
        self._admit_carry, self._waiting = [], []

    # -- the KV tier: retain, park, wake (scheduler thread) -----------------

    def _session_key(self, slot: _Slot) -> Optional[str]:
        """The conversation's key: the client's session id, else the hash
        of the prompt's first HEAD_GRAIN ids (a follow-up's prompt head is
        the earlier turn's verbatim); None = anonymous and too short to
        index, not worth retaining."""
        if slot.req.session:
            return f"sid:{slot.req.session}"
        return head_key(slot.prompt_ids)

    def _retain_session(self, slot: _Slot, row: int) -> bool:
        """Keep a finished request's KV open as a resident session instead
        of freeing it; True when the row's cleanup (table zeroed, pages
        owned) was done here. The trusted content is the first ``ctx_len``
        tokens (prompt + all generated but the last), on
        ceil(ctx_len / page_size) pages; growth pages past them return to
        the allocator. A tick still in flight writes past ctx_len only:
        into the kept tail page's slack, a trimmed page any re-user
        overwrites after it (one stream), or the garbage page.

        Over the dense cache the row parks at once (:meth:`_park_row`)
        and this returns False, as the reference's does: the row has no
        pages, and the ordinary release runs."""
        key = self._session_key(slot)
        if key is None or slot.ctx_len <= 0:
            return False
        toks = (list(slot.prompt_ids) + list(slot.ids))[: slot.ctx_len]
        if len(toks) < slot.ctx_len:
            return False
        if self.kv_mode == "dense":
            self._park_row(key, tuple(toks), row)
            return False
        if not slot.pages:
            return False
        keep = min(len(slot.pages), self._alloc.pages_for(slot.ctx_len))
        kept, extra = slot.pages[:keep], slot.pages[keep:]
        self._dev("release", row)
        if extra:
            self._alloc.free(extra)
        slot.pages = None
        old = self._tier.take(key)
        if old is not None:
            self._recycle_session(old)
        self._tier.insert(SessionKV(key=key, tokens=tuple(toks),
                                    length=slot.ctx_len, pages=kept))
        self._tier_enforce()
        return True

    def _park_row(self, key: str, tokens: tuple, row: int) -> None:
        """A finished dense row's session, parked to the host (the
        reference's dense retention): its first W = the power-of-two
        bucket of ``len(tokens)`` slots of every layer, copied out of the
        cache (the reference's ``_extract_row_for``) and read back
        synchronously. A tick still in flight writes this row only at
        ``len(tokens)`` and beyond, queued before the copy: slots the
        session does not trust."""
        W = _bucket(len(tokens), self.max_seq)
        payload = tuple(self._to_host(a)
                        for a in self._dev("park_row", row, W))
        old = self._tier.take(key)
        if old is not None:
            self._recycle_session(old)
        self._tier.insert(SessionKV(
            key=key, tokens=tokens, length=len(tokens), host=(payload, W),
            nbytes=sum(tensor_nbytes(a) for a in payload)))
        self._tier.note_parked()
        self._tier_enforce()

    def _dev_park_row(self, row: int, W: int) -> tuple:
        """The device half of a dense park: (k, v) [L, W, Hkv, D] of
        ``row``'s first ``W`` slots, with every kv head."""
        return tuple(self._heads_whole(a[:, row, :W].clone(
            memory_format=torch.contiguous_format), 2)
            for a in (self._cache.k, self._cache.v))

    def _recycle_session(self, sess: SessionKV) -> None:
        """Return a replaced session's resident pages to the allocator."""
        if sess.pages:
            self._alloc.free(sess.pages)
            sess.pages = None

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """One parked array on the host, read back synchronously into
        pinned memory on the card's machine: on the H100 both the readback
        and the wake's upload ran faster than through pageable memory,
        and the upload is then asynchronous (chip_smoke's server_tier
        prints both ways)."""
        if t.device.type != "cuda":
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
        return out

    def _upload(self, arrays: tuple) -> tuple:
        """A parked payload onto the device, queued on the serving
        stream."""
        return tuple(None if a is None
                     else a.to(self.device, non_blocking=True)
                     for a in arrays)

    def _park_session(self, sess: SessionKV) -> None:
        """Demote a resident session to host tensors: ONE gather of the
        raw pool words (int8 values and head-major scales included, never
        a requantize) over its pages padded with page 0 to a power-of-two
        count, one synchronous readback, the pages back to the
        allocator."""
        sess = self._tier.take(sess.key)
        if sess is None or not sess.pages:
            return
        pages, n = sess.pages, len(sess.pages)
        P2 = 1 << max(0, n - 1).bit_length()
        payload = tuple(None if a is None else self._to_host(a)
                        for a in self._dev("park", pages + [0] * (P2 - n)))
        self._alloc.free(pages)
        self._tier.insert(SessionKV(
            key=sess.key, tokens=sess.tokens, length=sess.length,
            host=(payload, n), nbytes=sum(tensor_nbytes(a) for a in payload),
            last_used=sess.last_used))
        self._tier.note_parked(pages_freed=n)
        self._tier_enforce()

    def _dev_park(self, pages: list) -> tuple:
        """The device half of a paged park: the raw pool words of
        ``pages`` (ops/paged_kv.gather_pages) with every kv head — k, v
        [L, P, ps, Hkv, D] and the scales [L, P, Hkv, ps_pad]."""
        k, v, ks, vs = gather_pages(self._cache, torch.tensor(
            pages, dtype=torch.long))
        return (self._heads_whole(k, 3), self._heads_whole(v, 3),
                None if ks is None else self._heads_whole(ks, 2),
                None if vs is None else self._heads_whole(vs, 2))

    def _reclaim_pages(self, need: int) -> None:
        """Pool pressure: park resident sessions, least recently used
        first, until ``need`` pages are free or none is left."""
        for sess in self._tier.park_candidates(force=True):
            if self._alloc.free_pages >= need:
                return
            self._park_session(sess)

    def _free_released(self) -> None:
        """Free the resident pages of sessions the tier dropped as
        diverged inside a lookup or a claim (kv_tier.KVTier.
        released_pages), here on the scheduler thread like every other
        free of the pool. The reference loses them (the port's repair)."""
        pages = self._tier.released_pages()
        if pages:
            self._alloc.free(pages)

    def _tier_enforce(self) -> None:
        """The tier's policies after an insert: the host byte budget over
        parked sessions (cost eviction), then the session cap (LRU;
        resident victims' pages return to the allocator)."""
        for sess in self._tier.host_victims():
            self._tier.drop(sess)
        for sess in self._tier.overflow_victims():
            pages = self._tier.drop(sess)
            if pages:
                self._alloc.free(pages)

    def _tier_sweep(self) -> None:
        """Idle parking: at most one park per 250 ms of loop time (each is
        a gather and a readback, a bounded stall). Paged pools only: a
        dense session is never resident."""
        if self._tier is None or self.kv_mode != "paged":
            return
        now = time.monotonic()
        if now - self._last_tier_sweep < 0.25:
            return
        self._last_tier_sweep = now
        cands = self._tier.park_candidates(now=now)
        if cands:
            self._park_session(cands[0])

    def _serving_bucket(self, n: int) -> int:
        """A wake's suffix bucket: the power-of-two bucket of ``n``,
        rounded up to the smallest warmed prompt bucket that holds it (the
        reference's ``_serving_bucket``; past every warmed bucket it keeps
        its own)."""
        b = _bucket(n, self.max_seq)
        for w in self._warmed_buckets:
            if w >= b:
                return w
        return b

    def _wake_window(self, S: int, start: int) -> int:
        """The wake's attention window: every live row's context plus one
        slot, and the deepest waking session's ``start + S`` (the
        reference's ladder)."""
        deepest = max((s.ctx_len for s in self._slots if s is not None),
                      default=0)
        need = max(deepest + 1, start + S)
        w = min(128, self.max_seq)
        while w < need:
            w *= 2
        return min(w, self.max_seq)

    def _wake_candidate(self, slot: _Slot) -> Optional[int]:
        """The suffix bucket S when ``slot`` can wake an open session,
        else None (cold admission). Peeks only (:meth:`_admit_wake`
        claims); a parked session's upload starts here, so it overlaps
        whatever admission work runs first. Under live traffic a (window,
        S) no wake has run yet admits cold, as in the reference."""
        sess = self._tier.lookup(self._session_key(slot) or "",
                                 slot.prompt_ids)
        self._free_released()
        if sess is None:
            return None
        S = self._serving_bucket(len(slot.prompt_ids) - sess.length)
        if sess.length + S > self.max_seq or S > _WAKE_MAX_SUFFIX:
            return None
        if self._any_active():
            if (self._wake_window(S, sess.length), S) \
                    not in self._wake_shapes_run:
                return None
        slot.wake_key = sess.key
        if sess.parked:
            if slot.wake_dev is None or slot.wake_dev[0] is not sess:
                slot.wake_dev = (sess, self._upload(sess.host[0]))
        else:
            slot.wake_dev = None
        return S

    def _wake_install_kv(self, slot: _Slot, sess: SessionKV,
                         table: torch.Tensor) -> bool:
        """Place a waking session's KV: reserve the row's whole page
        budget, scatter a parked payload into its first pages (in place),
        or take the resident pages plus growth pages, and write the page
        map into ``table`` [max_pages_per_row]. False = no pages even
        after parking others: the session goes back untouched and the
        request admits cold."""
        need = self._alloc.pages_for(len(slot.prompt_ids) + slot.max_new + 1)
        need = min(need, self._cache.max_pages_per_row)
        if sess.parked:
            arrays, n = sess.host
            need = max(need, n)
            pages = self._alloc.alloc(need)
            if pages is None:
                self._reclaim_pages(need)
                pages = self._alloc.alloc(need)
            if pages is None:
                self._tier.insert(sess)
                slot.wake_dev = None
                return False
            P2 = arrays[0].shape[1]
            self._dev("wake_kv", pages[:n] + [0] * (P2 - n),
                      _Payload(self._wake_arrays(slot, sess)))
        else:
            extra = need - len(sess.pages)
            if extra > 0:
                more = self._alloc.alloc(extra)
                if more is None:
                    self._reclaim_pages(extra)
                    more = self._alloc.alloc(extra)
                if more is None:
                    self._tier.insert(sess)
                    slot.wake_dev = None
                    return False
                pages = sess.pages + more
            else:
                pages = sess.pages
            sess.pages = None
        slot.pages = pages
        slot.ctx_budget = min(len(pages) * self.page_size, self.max_seq)
        table[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
        return True

    def _wake_install_row(self, slot: _Slot, row: int,
                          sess: SessionKV) -> None:
        """Place a parked dense session: its (k, v) ``[L, W, Hkv, D]``
        copied into slots ``0 .. W`` of ``row`` IN PLACE (the reference's
        ``_inject_row_for``; the decode graphs hold the cache's storage),
        from the upload :meth:`_wake_candidate` began when it is this
        session's."""
        self._dev("wake_row", row, sess.host[1],
                  _Payload(self._wake_arrays(slot, sess)))
        slot.pages = []

    def _wake_arrays(self, slot: _Slot, sess: SessionKV) -> tuple:
        """A parked session's arrays for its wake: the upload
        :meth:`_wake_candidate` began when it is this session's, else the
        host arrays."""
        dev = None
        if slot.wake_dev is not None and slot.wake_dev[0] is sess:
            dev = slot.wake_dev[1]
        slot.wake_dev = None
        return sess.host[0] if dev is None else dev

    def _dev_wake_kv(self, pages: list, payload: _Payload) -> None:
        """Scatter a parked session's pool words into ``pages`` (padded
        with garbage page 0), in place: this rank's heads of the
        leader's arrays."""
        k, v, ks, vs = self._receive(payload)
        scatter_pages(
            self._cache, torch.tensor(pages, dtype=torch.long),
            self._heads_mine(k, 3), self._heads_mine(v, 3),
            None if ks is None else self._heads_mine(ks, 2),
            None if vs is None else self._heads_mine(vs, 2))

    def _dev_wake_row(self, row: int, W: int, payload: _Payload) -> None:
        """Copy a parked dense session into slots ``0 .. W`` of ``row``
        in place: this rank's heads of the leader's arrays."""
        k, v = self._receive(payload)
        self._cache.k[:, row, :W].copy_(self._heads_mine(k, 2))
        self._cache.v[:, row, :W].copy_(self._heads_mine(v, 2))

    def _wake_forward(self, tokens: torch.Tensor, tables: torch.Tensor,
                      starts: torch.Tensor, last: torch.Tensor,
                      window: int) -> torch.Tensor:
        """The wake's forward over R waking rows (host tensors: suffix
        tokens [R, S] right-padded, session lengths [R], each row's last
        suffix position [R]; ``tables``: the rows' page maps [R,
        max_pages_per_row] on a paged pool, their row indices [R] on the
        dense cache): the family's ``verify_step_paged`` on a view of the
        cache with these rows' tables and lengths — each layer attends the
        session's KV plus the suffix block (kernel B's verify mode on the
        card), and the block lands at ``start ..`` after the layer loop.
        The dense cache's view is its identity pool view restricted to
        the rows (ops/dense_attention.rows_view), always the
        attend-then-write branch. Returns the logits at ``last`` [R, V].
        The cache is written in place; the live rows' tables are not
        touched."""
        dev = self.device
        S = tokens.shape[1]
        lengths = starts.to(device=dev, dtype=torch.int32)
        if self.kv_mode == "dense":
            view = rows_view(self._cache, tables.to(dev), lengths)
            impl, ps = "gather", VIEW_PAGE
        else:
            cache = self._cache
            view = PagedKVCache(
                k=cache.k, v=cache.v, page_table=tables.to(dev),
                lengths=lengths, k_scale=cache.k_scale,
                v_scale=cache.v_scale)
            impl, ps = self.attn_impl, self.page_size
        pages = min(-(-(window + S) // ps), view.max_pages_per_row)
        logits, _ = self._family.verify_step_paged(
            self._params, self.config, tokens.to(dev), view, pages=pages,
            impl=impl, last_idx=last.to(dev), mesh=self.mesh)
        return logits[:, 0, :]

    def _dev_wake(self, tokens: torch.Tensor, tables: torch.Tensor,
                  starts: torch.Tensor, last: torch.Tensor, window: int,
                  rows: Optional[list] = None, samp: Optional[tuple] = None
                  ) -> Optional[torch.Tensor]:
        """The device half of a wake: :meth:`_wake_forward`, then (with
        ``rows``) the rows' tables and lengths (session + suffix) and
        their first tokens sampled (:meth:`_sample_first`, returned on
        the device). Without ``rows``, a warmup's forward only."""
        logits = self._wake_forward(tokens, tables, starts, last, window)
        if rows is None:
            return None
        dev = self.device
        idx = torch.tensor(rows, dtype=torch.long, device=dev)
        if self.kv_mode == "paged":
            self._cache.page_table[idx] = tables.to(dev)
        self._cache.lengths[idx] = (starts + last + 1).to(device=dev,
                                                          dtype=torch.int32)
        return self._sample_first(rows, logits, samp)

    def _warm_wake(self, w: int, S: int) -> None:
        """Run one wake forward at (window ``w``, suffix bucket ``S``) on
        a dummy row, and record the shape as run. On a paged pool the row's
        table is all garbage page 0 (its writes land there); on the dense
        cache it is a row no slot and no chunked admission holds, at
        length 0 (its writes land in slots nobody trusts; a warmup job
        only runs with a row free). A dispatch never picks w < S."""
        if w < S:
            return
        zeros = torch.zeros((1,), dtype=torch.long)
        if self.kv_mode == "dense":
            held = set(self._prefill_carry.rows
                       if self._prefill_carry is not None else ())
            free = [r for r in self._free_rows() if r not in held]
            if not free:
                return
            table = torch.tensor(free[:1], dtype=torch.long)
        else:
            table = torch.zeros((1, self._cache.max_pages_per_row),
                                dtype=torch.int32)
        self._dev("wake", torch.zeros((1, S), dtype=torch.long), table,
                  zeros, zeros, w)
        self._wake_shapes_run.add((w, S))

    def _admit_wake(self, chunk: list[_Slot], rows: list[int],
                    S: int) -> tuple[list[_Slot], list[int]]:
        """Wake up to len(chunk) sessions sharing suffix bucket ``S``:
        claim each session, place its KV (:meth:`_wake_install_kv` on a
        paged pool, :meth:`_wake_install_row` on the dense cache), run the
        suffixes through ONE :meth:`_wake_forward`, install the rows'
        tables and lengths, and sample each first token
        (:meth:`_install_admitted`). Returns (demoted slots, unused rows):
        a session that vanished since matching or whose pages could not be
        reserved sends its request to a cold admission this same round.
        No fallback: a failing forward raises into the admission
        envelope."""
        failpoint("serve.scheduler.admit")
        t0 = time.monotonic()
        demoted: list[_Slot] = []
        unused: list[int] = []
        claimed: list[tuple[_Slot, int, SessionKV]] = []
        for slot, row in zip(chunk, rows):
            sess = self._tier.claim(slot.wake_key or "", slot.prompt_ids)
            slot.wake_key = None
            if sess is None:
                slot.wake_dev = None
                demoted.append(slot)
                unused.append(row)
                continue
            claimed.append((slot, row, sess))
        self._free_released()
        if not claimed:
            return demoted, unused
        w = self._wake_window(S, max(s.length for _, _, s in claimed))
        if self._any_active() and (w, S) not in self._wake_shapes_run:
            # Another waking session is deeper than this slot's estimate:
            # the window has not run under live traffic — admit cold.
            for slot, row, sess in claimed:
                self._tier.insert(sess)
                slot.wake_dev = None
                demoted.append(slot)
                unused.append(row)
            return demoted, unused
        dense = self.kv_mode == "dense"
        tables = torch.zeros((len(claimed), 1 if dense else
                              self._cache.max_pages_per_row),
                             dtype=torch.int32)
        live: list[tuple[_Slot, int, int]] = []
        for slot, row, sess in claimed:
            if dense:
                # Nothing to reserve: the row owns its max_seq slots.
                self._wake_install_row(slot, row, sess)
            elif not self._wake_install_kv(slot, sess, tables[len(live)]):
                demoted.append(slot)
                unused.append(row)
                continue
            live.append((slot, row, sess.length))
        if not live:
            return demoted, unused
        R = len(live)
        tables = (torch.tensor([row for _, row, _ in live], dtype=torch.long)
                  if dense else tables[:R])
        tokens = torch.zeros((R, S), dtype=torch.long)
        starts = torch.tensor([n for _, _, n in live], dtype=torch.long)
        sufs = torch.zeros((R,), dtype=torch.long)
        for i, (slot, _, n) in enumerate(live):
            suffix = slot.prompt_ids[n:]
            tokens[i, :len(suffix)] = torch.tensor(suffix, dtype=torch.long)
            sufs[i] = len(suffix)
            slot.admit_t = t0
        self._flight.note("wake", self._loop_iter, n=R, S=S, w=w)
        woken = [s for s, _, _ in live]
        rows_w = [r for _, r, _ in live]
        toks = self._dev("wake", tokens, tables, starts, sufs - 1, w, rows_w,
                         self._sample_args(woken))
        self._wake_shapes_run.add((w, S))
        self._admit_since_tick = True
        self._install_admitted(woken, rows_w, toks,
                               wake=(t0, starts.tolist()))
        return demoted, unused
