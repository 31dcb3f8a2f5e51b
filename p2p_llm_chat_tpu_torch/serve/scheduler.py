"""Continuous-batching scheduler over the paged KV pool — a lean port of
p2p_llm_chat_tpu/serve/scheduler.py's core.

One background thread owns the device state (params, pool, per-row
sampling state) and runs the loop; HTTP threads talk to it through
queues only:

- ``submit`` enqueues a request (a bounded queue: at ``queue_max`` queued
  requests it raises :class:`OverloadError`, the front's 503);
- admission groups pending requests by power-of-two prompt bucket,
  reserves each request's page budget from the :class:`PageAllocator`,
  prefills the group together (models/llama.prefill), splices its KV into
  the pool (ops/paged_kv.write_prefill_batch) and samples each row's
  first token;
- one ``decode_step_paged`` per tick runs every row (parked rows ride
  along; their writes land in the garbage page), walking
  ``ceil(max live length / page_size)`` pages;
- a request stops on EOS, ``num_predict``, a ``stop`` string or its
  context budget; its row's page table is zeroed and its pages freed;
- detokenization is incremental and UTF-8 safe, and holds back text that
  may be the start of a stop string.

Not in this slice (later ones): prefix cache, chunked prefill, fused
K-step decode, speculation, KV tiering, tensor parallelism. None of them
changes greedy output in the reference.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import torch

from ..models import llama
from ..models.configs import ModelConfig
from ..models.quant import param_bytes, quant_mode
from ..models.sampling import sample_step_batched
from ..ops.paged_kv import (PageAllocator, PagedKVCache, set_row_table,
                            write_prefill_batch)
from ..tokenizer import Tokenizer
from ..utils.device import resolve_device
from ..utils.log import get_logger
from ..utils.metrics import Histogram
from .backend import (GenerateRequest, OverloadError, RequestStats,
                      normalize_request)

log = get_logger("serve.torch_scheduler")

_MIN_BUCKET = 16
# Cap on one admission group's R x S prefill footprint (the dense
# per-request cache and scores it materialises).
_ADMIT_TOKEN_BUDGET = 16384
# Repeat-penalty recent-token window (Ollama repeat_last_n default).
_RING = 64


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
    cancelled: threading.Event = field(default_factory=threading.Event)
    error: Optional[str] = None
    last_emit_t: float = 0.0
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


class _WarmupJob:
    """A closure run ON the scheduler thread (only it may touch the
    device state)."""

    __slots__ = ("fn", "done", "err")

    def __init__(self, fn) -> None:
        self.fn = fn
        self.done = threading.Event()
        self.err: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self.fn()
        except BaseException as e:   # noqa: BLE001 — re-raised by caller
            self.err = e
        finally:
            self.done.set()


class BatchScheduler:
    """Owns the device state and the serving loop, on ``device`` (the card
    unless the CPU is asked for; see utils/device.py)."""

    def __init__(self, params: dict, config: ModelConfig,
                 tokenizer: Tokenizer, *, num_slots: int = 8,
                 max_seq: int = 1024, page_size: int = 64,
                 num_pages: Optional[int] = None,
                 queue_timeout_s: Optional[float] = 60.0,
                 queue_max: Optional[int] = None, kv_quant: bool = False,
                 device: Optional[torch.device | str] = None) -> None:
        if queue_max is not None and queue_max < 0:
            raise ValueError(f"queue_max must be >= 0, got {queue_max}")
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
        self._params = llama.fuse_params(params)
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
        self._n_expired = 0
        self._tbt_hist = Histogram("inter_token_ms")
        self._step_hist = Histogram("decode_step_ms")
        self._reset_device_state()
        self._admit_q: "queue.Queue[Optional[object]]" = queue.Queue()
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="torch-scheduler")
        self._thread.start()

    # -- device state ------------------------------------------------------

    def _reset_device_state(self) -> None:
        B = self.num_slots
        self._alloc = PageAllocator(self.num_pages, self.page_size)
        self._cache = PagedKVCache.create(
            self.config, B, self.num_pages, self.page_size,
            max_pages_per_row=-(-self.max_seq // self.page_size),
            dtype=self._dtype, quantized=self.kv_quant, device=self.device)
        self._next = torch.zeros((B, 1), dtype=torch.long,
                                 device=self.device)
        # Per-row sampling options, host-side (installed at admission),
        # and each row's repeat-penalty ring on the device: the token at
        # context position p sits at p % _RING (ids >= vocab are empty).
        self._temps = [0.0] * B
        self._top_ks = [0] * B
        self._top_ps = [1.0] * B
        self._rps = [1.0] * B
        self._ring = torch.full((B, _RING), self.config.vocab_size,
                                dtype=torch.long, device=self.device)
        self._gens: list[Optional[torch.Generator]] = [None] * B

    # -- client side (HTTP threads) ----------------------------------------

    def note_warmup_pending(self) -> None:
        self._warmup_done_at = None
        self._warmup_started = True

    @property
    def ready(self) -> bool:
        if self._closed.is_set() or not self._thread.is_alive():
            return False
        if self._draining.is_set() or self.warmup_error is not None:
            return False
        return not self._warmup_started or self._warmup_done_at is not None

    def drain(self) -> None:
        """Stop taking new work (submit sheds, /readyz turns 503); what is
        queued or running finishes."""
        self._draining.set()

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

    def warmup(self, prompt_buckets: tuple[int, ...] = (128,)) -> None:
        """Run the serving path once before traffic: on the card this
        builds and loads both CUDA kernels and launches them at the
        serving shapes (a prefill per bucket, then one decode tick with
        every row parked — its writes land in the garbage page).
        Blocks until the scheduler thread has run it."""
        self.note_warmup_pending()

        def run() -> None:
            for S in prompt_buckets:
                S = _bucket(S, self.max_seq)
                toks = torch.zeros((1, S), dtype=torch.long,
                                   device=self.device)
                lens = torch.full((1,), S, dtype=torch.long,
                                  device=self.device)
                llama.prefill(self._params, self.config, toks, lens,
                              last_only=True)
            active = torch.zeros((self.num_slots,), dtype=torch.bool,
                                 device=self.device)
            llama.decode_step_paged(self._params, self.config, self._next,
                                    self._cache, active, pages=1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        job = _WarmupJob(run)
        self._admit_q.put(job)
        job.done.wait()
        if job.err is not None:
            self.warmup_error = job.err
            raise job.err
        self._warmup_done_at = time.monotonic()

    def stop(self) -> None:
        self._closed.set()
        self._admit_q.put(None)
        self._thread.join(timeout=10.0)
        for i, s in enumerate(self._slots):
            if s is not None:
                s.finish()
                self._slots[i] = None
        for s in self._waiting + self._admit_carry:
            s.finish()
        self._waiting, self._admit_carry = [], []
        while True:
            try:
                s = self._admit_q.get_nowait()
            except queue.Empty:
                break
            if isinstance(s, _WarmupJob):
                s.err = RuntimeError("scheduler stopped before warmup ran")
                s.done.set()
            elif s is not None:
                s.finish()

    def metrics_snapshot(self) -> dict[str, float]:
        """Serving-plane series, under the reference's names for the
        series this slice has."""
        with self._depth_mu:
            shed = self._n_shed
        return {
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
            "decode_wall_ms": round(self._step_hist.percentile(50) or 0.0, 4),
            "inter_token_p50_ms": round(
                self._tbt_hist.percentile(50) or 0.0, 4),
            "inter_token_p95_ms": round(
                self._tbt_hist.percentile(95) or 0.0, 4),
            "serve_kv_free_pages": self._alloc.free_pages,
            "serve_kv_total_pages": self.num_pages - 1,
        }

    # -- scheduler thread --------------------------------------------------

    def _loop(self) -> None:
        while not self._closed.is_set():
            try:
                self._admit_pending(block=not self._any_active())
                if self._closed.is_set():
                    return
                if self._any_active():
                    self._decode_tick()
            except Exception:   # noqa: BLE001 — fail requests, keep serving
                log.exception("serving tick failed; failing in-flight "
                              "requests")
                self._fail_all_and_reset()

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
            if isinstance(slot, _WarmupJob):
                slot.run()
                break
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
        next-write slot), all or nothing."""
        need = self._alloc.pages_for(len(slot.prompt_ids) + slot.max_new + 1)
        need = min(need, self._cache.max_pages_per_row)
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
        """Admit pending requests into free rows, one prefill per
        (bucket, chunk). With live streams, at most one chunk per call (the
        rest carries), so a burst cannot stall decoding for long."""
        free = self._free_rows()
        if not free:
            return
        had_active = len(free) < self.num_slots
        pending: list[_Slot] = []
        for s in self._admit_carry:
            if s.cancelled.is_set() or s.done or self._expired(s):
                s.depart()
                if s.pages:
                    self._alloc.free(s.pages)
                    s.pages = None
                continue
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
        room = len(free) - len(pending)
        if room > 0:
            for s in self._collect_pending(
                    room, block and not pending and not self._waiting):
                if self._waiting or not self._try_reserve(s):
                    self._wait_or_fail(s)
                else:
                    pending.append(s)
        if not pending:
            return
        groups: dict[int, list[_Slot]] = {}
        for s in pending:
            groups.setdefault(_bucket(len(s.prompt_ids), self.max_seq),
                              []).append(s)
        order = [(S, g) for S, g in sorted(groups.items())]
        for gi, (S, group) in enumerate(order):
            while group:
                R = max(1, min(len(group), _ADMIT_TOKEN_BUDGET // S))
                chunk, group = group[:R], group[R:]
                rows = [free.pop(0) for _ in chunk]
                try:
                    self._admit_chunk(chunk, rows, S)
                except Exception:   # noqa: BLE001
                    log.exception("admission failed for %d request(s)",
                                  len(chunk))
                    for s in chunk + group + [x for _, g in order[gi + 1:]
                                              for x in g]:
                        s.fail("internal error: admission failed")
                    self._fail_all_and_reset()
                    return
                if had_active and (group or gi + 1 < len(order)):
                    self._admit_carry = group + [
                        x for _, g in order[gi + 1:] for x in g]
                    return

    def _admit_chunk(self, chunk: list[_Slot], rows: list[int],
                     S: int) -> None:
        """Prefill ``chunk`` together, splice its KV into the pool at
        ``rows``, install per-row sampling state and sample each row's
        first token."""
        R = len(chunk)
        dev = self.device
        tokens = torch.zeros((R, S), dtype=torch.long)
        lens = torch.zeros((R,), dtype=torch.long)
        tables = torch.zeros((R, self._cache.max_pages_per_row),
                             dtype=torch.int32)
        for i, slot in enumerate(chunk):
            n = len(slot.prompt_ids)
            tokens[i, :n] = torch.tensor(slot.prompt_ids, dtype=torch.long)
            lens[i] = n
            tables[i, :len(slot.pages)] = torch.tensor(slot.pages,
                                                       dtype=torch.int32)
        logits, k_all, v_all = llama.prefill(
            self._params, self.config, tokens.to(dev), lens.to(dev),
            last_only=True)
        write_prefill_batch(self._cache, k_all, v_all,
                            torch.tensor(rows, dtype=torch.long), lens,
                            tables)
        del k_all, v_all
        rings = torch.full((R, _RING), self.config.vocab_size,
                           dtype=torch.long)
        for i, (slot, row) in enumerate(zip(chunk, rows)):
            o = slot.req.options
            self._temps[row] = o.temperature
            self._top_ks[row] = o.top_k
            self._top_ps[row] = o.top_p
            self._rps[row] = o.repeat_penalty
            n = len(slot.prompt_ids)
            for p in range(max(0, n - _RING), n):    # the prompt's tail
                rings[i, p % _RING] = slot.prompt_ids[p]
            gen = None
            if o.temperature > 0.0:
                gen = torch.Generator(device=dev)
                gen.manual_seed(slot.seed)
            self._gens[row] = gen
        self._ring[torch.tensor(rows, device=dev)] = rings.to(dev)
        # Each row's first token sits at context position len(prompt).
        first = self._sample(logits[:, 0, :], rows,
                             [len(s.prompt_ids) for s in chunk])
        self._next[torch.tensor(rows, device=dev), 0] = torch.tensor(
            first, dtype=torch.long, device=dev)
        now = time.monotonic()
        self._n_admitted += R
        for slot, row, tok in zip(chunk, rows, first):
            slot.depart()
            if slot.stats is not None:
                slot.stats.ttft_s = now - slot.req.arrival_time
            slot.ctx_len = len(slot.prompt_ids)
            self._slots[row] = slot
            if not self._append_token(slot, row, tok):
                self._release(row)

    def _sample(self, logits: torch.Tensor, rows: list[int],
                emit_pos: list[int]) -> list[int]:
        """Sample one token per row of ``logits`` ([len(rows), V]) with
        the rows' installed options, generators and penalty rings; each
        token joins its row's ring at context position ``emit_pos``."""
        dev = self.device
        idx = torch.tensor(rows, device=dev)
        toks, ring = sample_step_batched(
            logits,
            [self._gens[r] for r in rows],
            torch.tensor([self._temps[r] for r in rows], dtype=torch.float32),
            torch.tensor([self._top_ks[r] for r in rows], dtype=torch.long),
            torch.tensor([self._top_ps[r] for r in rows],
                         dtype=torch.float32),
            ring=self._ring[idx],
            rp=torch.tensor([self._rps[r] for r in rows],
                            dtype=torch.float32, device=dev),
            emit_pos=torch.tensor(emit_pos, device=dev),
            active=torch.ones((len(rows),), dtype=torch.bool, device=dev))
        self._ring[idx] = ring
        return toks.tolist()

    def _decode_tick(self) -> None:
        t0 = time.monotonic()
        active_rows = [i for i, s in enumerate(self._slots) if s is not None]
        longest = max(self._slots[r].ctx_len for r in active_rows)
        pages = max(1, -(-longest // self.page_size))
        active = torch.zeros((self.num_slots,), dtype=torch.bool)
        active[active_rows] = True
        logits, _ = llama.decode_step_paged(
            self._params, self.config, self._next, self._cache,
            active.to(self.device), pages=pages)
        # The sampled token follows this tick's input (at ctx_len).
        toks = self._sample(logits[active_rows, 0, :], active_rows,
                            [self._slots[r].ctx_len + 1 for r in active_rows])
        self._next[torch.tensor(active_rows, device=self.device), 0] = \
            torch.tensor(toks, dtype=torch.long, device=self.device)
        self._n_decode_ticks += 1
        self._step_hist.observe((time.monotonic() - t0) * 1e3)
        for row, tok in zip(active_rows, toks):
            slot = self._slots[row]
            if slot.cancelled.is_set():
                self._release(row)
                continue
            slot.ctx_len += 1           # the input token landed in the pool
            if not self._append_token(slot, row, tok):
                self._release(row)

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
        self._gens[row] = None
        if slot is not None and slot.pages:
            set_row_table(self._cache, row, torch.zeros(
                (self._cache.max_pages_per_row,), dtype=torch.int32))
            self._alloc.free(slot.pages)
            slot.pages = None

    def _fail_all_and_reset(self) -> None:
        for i, s in enumerate(self._slots):
            if s is not None:
                s.fail("internal error: serving state was reset")
                self._slots[i] = None
        for s in self._admit_carry + self._waiting:
            s.pages = None
            s.fail("internal error: serving state was reset")
        self._admit_carry, self._waiting = [], []
        self._reset_device_state()
