"""Lockstep batched serving over N processes, the port of
p2p_llm_chat_tpu/serve/multihost.py on ``torch.distributed``.

One process drives one card (parallel/distributed.py). The world is laid
out as a ``dp × tp`` mesh (``SERVE_TP`` = t ranks hold one model, split
Megatron-style by parallel/sharding.py; ``dp`` = world / t replicas).

- **Every rank runs the same programs on the same host inputs**, or the
  collectives hang. The leader (rank 0) gathers up to R = dp distinct
  requests inside a short admission window, packs them into one
  fixed-shape int32 command and broadcasts it on the gloo control group;
  rows past the admitted count are inert padding (len 1, max_new 0).
- Row d of a round is computed by the ranks at dp index d, on their tp
  group (the model forms' ``mesh=`` path: kernels D and B on each rank's
  head shard on the card). Each rank's logits are all-gathered over
  ``dp``, so every rank samples every row from the SAME BYTES, with
  per-row ``np.random.Generator(PCG64(seed))`` generators through
  models/sampling.sample_np: the seed rides the command (the request's
  ``options.seed`` or leader-chosen), not folded with the row index, so
  a user seed reproduces its completion whichever row admission picked.
  Temperature / top-p / repeat penalty ride quantised to 1e-3.
- The decode loop runs ``max(max_new)`` steps with a per-row done mask
  every rank computes identically (stop ids, budgets); a done row parks
  (``active``), and the loop ends the moment all rows are done.

Stop STRINGS (``options.stop``) are applied on the leader after the
loop (truncation only). The plane serves the dense ``KVCache`` with no
paged pool, speculation, prefix cache or chunked prefill: those are
per-tick scheduler decisions that would each need a broadcast protocol
(the reference's deliberate deltas). ``serve_multihost_batched_rounds``
against ``serve_multihost_requests`` on /metrics shows R requests per
model pass.

Env: ``SERVE_COORDINATOR`` (host:port of rank 0; or ``JAX_COORDINATOR``)
with ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``, ``SERVE_TP``,
``SERVE_MAX_SEQ`` (default 512), ``SERVE_MH_WINDOW_MS`` (default 25).
serve/api.main runs the Ollama front on the leader and
:meth:`MultihostEngine.follower_loop` on the others.

Each round and decode step is timed on the host clock (both end in the
host readback of the gathered logits), and the collectives inside a step
by CUDA events on the card (parallel/mesh.Mesh.take_collective_ms). Each
rank logs them with its kernels' launch counts when it closes.

A failed round ends the plane (a deliberate divergence from the
reference, whose follower logs the failure and waits for the next
broadcast). A round issues its collectives one at a time from Python, so
a rank that failed partway leaves its peers waiting in a collective, or
pairing their next ones with its leftovers: no rank can realign. A
follower whose round fails logs it, leaves the world and raises, so its
process exits non-zero; the leader's collectives then fail. A leader
whose round fails (its own fault, or a follower gone) fails the batch
and every queued request, turns not ready, refuses new work and leaves
the world, which ends the followers' waits with an error.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch

from ..models import family_for
from ..models.configs import ModelConfig
from ..models.llama import KVCache
from ..models.sampling import sample_np
from ..parallel.mesh import Mesh
from ..utils.log import get_logger
from .backend import GenerateRequest, RequestStats, normalize_request

log = get_logger("serve.multihost")

# Command ops broadcast from the leader (int32 header slot 0).
_OP_SHUTDOWN = 0
_OP_GENERATE = 1
_OP_EMBED = 2
_HDR = 2          # [op, n_active]
# Per-row int32 fields (quantised floats carry milli-units):
#   [len, max_new, temp_milli, top_k, top_p_milli, repeat_milli, seed]
_ROW_FIELDS = 7
_REPEAT_WINDOW = 64   # Ollama repeat_last_n default (backend.py:33)
_KEEP = 4096          # timing samples kept per series


def _bucket(n: int, cap: int) -> int:
    b = 32
    while b < n:
        b *= 2
    return min(b, cap)


@dataclass
class _Pending:
    """A leader-side request waiting for its lockstep round."""

    req: GenerateRequest
    ids: list
    max_new: int
    # Pre-validated int32 command fields [temp_milli, top_k, top_p_milli,
    # repeat_milli, seed32], clamped per request so a malformed request
    # fails alone instead of erroring its whole batch.
    fields: tuple = ()
    # Ollama num_predict <= 0 ("until EOS / context full"): the whole
    # context budget, so it runs in a round of its own.
    unbounded: bool = False
    event: threading.Event = field(default_factory=threading.Event)
    text: str = ""
    out_ids: list = field(default_factory=list)   # generated ids as recorded
    error: Optional[BaseException] = None


def _row_fields(options) -> tuple:
    """Quantise and clamp one request's sampling options into the int32
    per-row command fields. Raises ValueError on non-numeric values —
    callers raise before enqueue, so one bad request cannot poison the
    co-batched rounds."""
    temp = float(options.temperature)
    top_k = int(options.top_k)
    top_p = float(options.top_p)
    repeat = float(options.repeat_penalty)
    if not all(map(np.isfinite, (temp, top_p, repeat))):
        raise ValueError("non-finite sampling option")
    if options.seed is not None:
        seed = int(options.seed)
    else:
        # Fresh entropy per request (Ollama semantics for an absent seed);
        # lockstep holds because the chosen seed rides the command.
        seed = int.from_bytes(os.urandom(4), "little")
    seed32 = seed & 0xFFFFFFFF
    if seed32 >= 1 << 31:                     # two's-complement into int32
        seed32 -= 1 << 32
    clamp = lambda v, lo, hi: max(lo, min(hi, v))   # noqa: E731
    return (
        int(round(clamp(temp, 0.0, 1e6) * 1000)),
        clamp(top_k, 0, 1 << 30),
        int(round(clamp(top_p, 0.0, 1.0) * 1000)),
        int(round(clamp(repeat, 0.0, 1e6) * 1000)),
        seed32,
    )


@dataclass
class _PendingEmbed:
    """A leader-side embedding group (<= R texts) awaiting its round."""

    ids_list: list
    event: threading.Event = field(default_factory=threading.Event)
    vecs: list = field(default_factory=list)
    error: Optional[BaseException] = None


_SHUTDOWN = object()


class MultihostEngine:
    """serve Backend over a mesh of processes (leader-driven lockstep,
    batched: one admitted request per dp row). ``params`` is this rank's
    fused shard (parallel/sharding.shard_model), on its device."""

    def __init__(self, params, config: ModelConfig, tokenizer, mesh: Mesh,
                 *, max_seq: int = 512, name: Optional[str] = None,
                 window_ms: float = 25.0) -> None:
        self.name = name or config.name
        self.config = config
        self.tokenizer = tokenizer
        self.mesh = mesh
        self.max_seq = min(max_seq, config.max_seq_len)
        self.window_s = window_ms / 1e3
        self._params = params
        self._model = family_for(config)
        self._device = params["embed"].device
        self._dtype = params["embed"].dtype
        self._stop_ids = set(config.eos_token_ids)
        eos = getattr(tokenizer, "eos_id", None)
        if eos is not None and 0 <= eos < config.vocab_size:
            self._stop_ids.add(eos)
        # dp rows = admission slots; this rank computes row _row.
        self._rows = max(1, mesh.shape.get("dp", 1))
        self._row = mesh.coords.get("dp", 0)
        self._cmd_size = _HDR + _ROW_FIELDS * self._rows \
            + self._rows * self.max_seq
        # Timing series (every rank) and the leader's counters.
        self._round_ms: deque = deque(maxlen=_KEEP)
        self._step_ms: deque = deque(maxlen=_KEEP)
        self._coll_ms: deque = deque(maxlen=_KEEP)
        self._q: "queue.Queue" = queue.Queue()
        self._dispatcher: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        # A round failed: the plane stopped for good (not a shutdown).
        self._down = False
        self._requests_served = 0       # owned-by: _dispatch_loop
        self._batched_rounds = 0        # owned-by: _dispatch_loop
        self._rows_served_total = 0     # owned-by: _dispatch_loop
        self._check_replicas()
        if not self.is_follower:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, name="mh-dispatch", daemon=True)
            self._dispatcher.start()

    @property
    def is_follower(self) -> bool:
        return self.mesh.rank != 0

    def _check_replicas(self) -> None:
        """Every rank's command size, and the weights of the ranks that
        hold the same shard (the same coordinates but dp), agree — checked
        once, over the mesh's compute group. Diverged weights would not
        hang the collectives; they would serve each row from another
        model."""
        if self.mesh.world is None:
            return
        with torch.no_grad():
            # Every 1021st element of each leaf, in f64: a few MB however
            # large the shard.
            total = sum(t.reshape(-1)[::1021].double().sum()
                        for t in _leaves(self._params))
            mine = torch.tensor([
                float(self._cmd_size),
                float(self.mesh.rank - self._row * (self.mesh.size
                                                    // self._rows)),
                0.0], dtype=torch.float64, device=self._device)
            mine[2] = total
            got = [torch.empty_like(mine) for _ in range(self.mesh.size)]
            torch.distributed.all_gather(got, mine, group=self.mesh.world)
        rows = torch.stack(got).cpu().numpy()
        for coord in set(rows[:, 1]):
            same = rows[rows[:, 1] == coord]
            if len(set(same[:, 2])) != 1 or len(set(rows[:, 0])) != 1:
                raise RuntimeError(
                    f"replicas disagree (command size, shard, weight sum): "
                    f"{rows.tolist()}")

    # -- command packing (leader) ------------------------------------------

    def _pack(self, batch: list) -> np.ndarray:
        cmd = np.zeros((self._cmd_size,), np.int32)
        cmd[0], cmd[1] = _OP_GENERATE, len(batch)
        for r, p in enumerate(batch):
            base = _HDR + r * _ROW_FIELDS
            cmd[base: base + _ROW_FIELDS] = [len(p.ids), p.max_new,
                                             *p.fields]
            toff = _HDR + _ROW_FIELDS * self._rows + r * self.max_seq
            cmd[toff: toff + len(p.ids)] = p.ids
        return cmd

    def _pack_embed(self, ids_list: list) -> np.ndarray:
        cmd = np.zeros((self._cmd_size,), np.int32)
        cmd[0], cmd[1] = _OP_EMBED, len(ids_list)
        for r, ids in enumerate(ids_list):
            cmd[_HDR + r * _ROW_FIELDS] = len(ids)
            toff = _HDR + _ROW_FIELDS * self._rows + r * self.max_seq
            cmd[toff: toff + len(ids)] = ids
        return cmd

    # -- lockstep core (every rank executes this identically) --------------

    def _mine(self, a: np.ndarray) -> torch.Tensor:
        """This rank's row of a host array, on its device."""
        return torch.from_numpy(np.ascontiguousarray(
            a[self._row: self._row + 1])).to(self._device)

    def _gather_rows(self, x: torch.Tensor) -> np.ndarray:
        """Every row's ``x`` (this rank's is [1, ...]) on the host: the
        all-gather over ``dp``, then the readback that ends the step."""
        return self.mesh.all_gather(x, "dp", dim=0).cpu().numpy()

    @torch.no_grad()
    def _run_cmd(self, cmd: np.ndarray) -> Optional[list]:
        """Execute one broadcast command; returns the generated token-id
        list per active row (the leader turns them into responses;
        followers discard). Every host decision below — bucketing,
        sampling, done masks — derives only from ``cmd`` and the gathered
        logits, so every rank stays in lockstep."""
        op, n_active = int(cmd[0]), int(cmd[1])
        if op == _OP_SHUTDOWN:
            return None
        t0 = time.perf_counter()
        R = self._rows
        rows = np.zeros((R, _ROW_FIELDS), np.int32)
        rows[:] = cmd[_HDR: _HDR + _ROW_FIELDS * R].reshape(R, _ROW_FIELDS)
        lens = np.maximum(rows[:, 0], 1)      # padding rows hold 1 token

        def unpack_tokens(S: int) -> np.ndarray:
            toks = np.zeros((R, S), np.int32)
            tbase = _HDR + _ROW_FIELDS * R
            for r in range(R):
                toks[r, : lens[r]] = cmd[tbase + r * self.max_seq:
                                         tbase + r * self.max_seq
                                         + lens[r]]
            return toks

        model, params, mesh = self._model, self._params, self.mesh
        if op == _OP_EMBED:
            toks = unpack_tokens(_bucket(int(lens.max()), self.max_seq))
            vecs = self._gather_rows(model.embed_pooled(
                params, self.config, self._mine(toks).long(),
                self._mine(lens), mesh=mesh))
            self.mesh.take_collective_ms()
            self._round_ms.append((time.perf_counter() - t0) * 1e3)
            return [vecs[r] for r in range(n_active)]
        max_new = rows[:, 1]
        T = int(max_new.max()) if n_active else 0
        S = _bucket(int(lens.max()) + 1, self.max_seq)
        toks = unpack_tokens(S)
        # Bucketed like S: distinct num_predict values must not each
        # allocate a fresh cache shape.
        budget = _bucket(S + T + 1, self.max_seq)
        cache = KVCache.create(self.config, 1, budget, dtype=self._dtype,
                               device=self._device, mesh=mesh)
        logits, cache = model.prefill(params, self.config,
                                      self._mine(toks).long(),
                                      self._mine(lens), last_only=True,
                                      cache=cache, mesh=mesh)
        last = self._gather_rows(logits)[:, 0]               # [R, V]
        self.mesh.take_collective_ms()

        # Per-row deterministic PRNG: identical on every rank because the
        # seeds ride the command. Seeded by the request seed alone.
        rngs = [np.random.Generator(np.random.PCG64(
            int(rows[r, 6]) & 0xFFFFFFFF)) for r in range(R)]
        temp = rows[:, 2] / 1000.0
        top_p = rows[:, 4] / 1000.0
        repeat = rows[:, 5] / 1000.0
        out_ids: list = [[] for _ in range(R)]
        # The prompt tail counts toward repeat_last_n, as the single-host
        # scheduler's penalty ring does.
        prompt_tails = [toks[r, max(0, int(lens[r]) - _REPEAT_WINDOW):
                             int(lens[r])].tolist() for r in range(R)]
        done = np.asarray(max_new <= 0)
        for _ in range(T):
            nxt = np.zeros((R,), np.int32)
            for r in range(R):
                if done[r]:
                    continue
                t = sample_np(last[r], rngs[r], temperature=temp[r],
                              top_k=int(rows[r, 3]), top_p=top_p[r],
                              recent=(prompt_tails[r]
                                      + out_ids[r])[-_REPEAT_WINDOW:],
                              repeat_penalty=repeat[r])
                if t in self._stop_ids:
                    done[r] = True
                    continue
                out_ids[r].append(t)
                nxt[r] = t
                if len(out_ids[r]) >= max_new[r]:
                    done[r] = True
            if done.all():
                break
            # active = ~done: a retired row parks (its length stops), so
            # its writes keep landing on one untrusted slot.
            ts = time.perf_counter()
            lg, cache = model.decode_step(
                params, self.config, self._mine(nxt[:, None]).long(),
                cache, self._mine(~done), mesh=mesh)
            last = self._gather_rows(lg)[:, 0]
            self._step_ms.append((time.perf_counter() - ts) * 1e3)
            self._coll_ms.append(self.mesh.take_collective_ms())
        self._round_ms.append((time.perf_counter() - t0) * 1e3)
        return out_ids[:n_active]

    def _truncate_at_stop(self, ids: list, stops: list) -> tuple:
        """The scheduler's stop-string record: text truncated at the
        earliest stop match, kept ids run up to and including the token
        that completed the match (never a re-encode of the text)."""
        text = self.tokenizer.decode(ids)
        best = None
        for s in stops:
            i = text.find(s)
            if i >= 0 and (best is None or i < best[0]):
                best = (i, s)
        if best is None:
            return ids, text
        idx, s = best
        for k in range(1, len(ids) + 1):
            if len(self.tokenizer.decode(ids[:k])) >= idx + len(s):
                return ids[:k], text[:idx]
        return ids, text[:idx]

    def _broadcast(self, cmd: np.ndarray) -> np.ndarray:
        """The leader's command to every rank, on the gloo control group
        (a sync point by design)."""
        t = torch.from_numpy(np.ascontiguousarray(cmd, np.int32))
        if self.mesh.control is not None:
            torch.distributed.broadcast(t, 0, group=self.mesh.control)
        return t.numpy()

    # -- leader dispatch loop ----------------------------------------------

    def _dispatch_loop(self) -> None:
        """Single owner of every broadcast on the leader: accumulates up
        to R requests inside the admission window, runs one lockstep
        round, delivers per-row results to the waiting HTTP threads.
        ``_stopped`` is set on the way out whatever escapes, so no waiting
        request spins forever."""
        try:
            self._dispatch_loop_inner()
        finally:
            self._stopped.set()

    def _dispatch_loop_inner(self) -> None:
        # Items displaced out of a round (embed / unbounded / shutdown
        # met mid-fill) are HELD as the next rounds' heads, never
        # re-queued behind newer arrivals, and holding never truncates
        # the batch being filled.
        held: deque = deque()
        while True:
            item = held.popleft() if held else self._q.get()
            if item is _SHUTDOWN:
                try:
                    self._broadcast(np.zeros((self._cmd_size,), np.int32))
                except Exception:             # noqa: BLE001
                    # A dead follower must not leave _stopped unset.
                    log.exception("shutdown broadcast failed")
                finally:
                    self._stopped.set()
                    while True:
                        try:
                            late = self._q.get_nowait()
                        except queue.Empty:
                            break
                        if late is not _SHUTDOWN:
                            late.error = RuntimeError(
                                "server shutting down")
                            late.event.set()
                return
            if isinstance(item, _PendingEmbed):
                # One embedding group per round (never co-batched).
                try:
                    res = self._run_cmd(self._broadcast(
                        self._pack_embed(item.ids_list)))
                    item.vecs = [v.tolist() for v in res]
                except Exception as e:        # noqa: BLE001
                    log.exception("multihost embed round failed")
                    item.error = e
                    self._end_plane(held, [item])
                    return
                item.event.set()
                continue
            batch = [item]
            deadline = time.monotonic() + self.window_s
            # An unbounded request runs alone: a round costs max(max_new)
            # steps for every row.
            while not item.unbounded and len(batch) < self._rows:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    held.append(nxt)
                    break
                if isinstance(nxt, _PendingEmbed) or nxt.unbounded:
                    held.append(nxt)
                    continue
                batch.append(nxt)
            try:
                results = self._run_cmd(self._broadcast(self._pack(batch)))
                self._batched_rounds += 1
                self._rows_served_total += len(batch)
            except Exception as e:            # noqa: BLE001
                log.exception("multihost round failed")
                for p in batch:
                    p.error = e
                self._end_plane(held, batch)
                return
            # Per-row post-processing fails alone.
            for p, ids in zip(batch, results):
                try:
                    p.out_ids, p.text = self._truncate_at_stop(
                        ids, [s for s in p.req.options.stop if s])
                    self._requests_served += 1
                except Exception as e:        # noqa: BLE001
                    log.exception("row post-processing failed")
                    p.error = e
                finally:
                    p.event.set()

    def _end_plane(self, held: deque, failed=()) -> None:
        """The leader's end of the plane after a failed round: the ranks
        may have stopped at different collectives of it, so none can
        realign. Every held and queued request fails, the engine turns
        not ready and refuses new work, and this rank leaves the world,
        which ends the followers' waits with an error. ``failed``: the
        round's own requests (their error already set), woken only once
        the engine reads not ready, so their callers never see it
        ready."""
        log.error("a lockstep round failed; the plane stops and this rank "
                  "leaves the world")
        self._down = True
        self._stopped.set()
        for p in failed:
            p.event.set()
        err = RuntimeError("internal error: the multihost plane stopped")
        while True:
            try:
                item = held.popleft() if held else self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _SHUTDOWN:
                item.error = err
                item.event.set()
        from ..parallel.distributed import leave_world
        leave_world()

    # -- Backend protocol (leader) -----------------------------------------

    def _leader_only(self) -> None:
        if self.is_follower:
            raise RuntimeError("only the leader (rank 0) serves HTTP")
        if self._down:
            raise RuntimeError("the multihost plane stopped after a failed "
                               "round")

    def ready(self) -> bool:
        """Taking work: false once the plane stopped (shutdown or a failed
        round)."""
        return not self._stopped.is_set()

    def generate_stream(self, req: GenerateRequest,
                        stats: Optional[RequestStats] = None) -> Iterator[str]:
        self._leader_only()
        # Validate everything request-specific BEFORE enqueue so a bad
        # request fails alone instead of erroring its co-batched round.
        try:
            fields = _row_fields(req.options)
        except (ValueError, TypeError, OverflowError) as e:
            raise ValueError(f"invalid sampling options: {e}") from None
        ids, max_new, _ = normalize_request(
            self.tokenizer, self.config.vocab_size, self.max_seq, req)
        pending = _Pending(req=req, ids=list(ids), max_new=max_new,
                           fields=fields,
                           unbounded=req.options.max_tokens <= 0)
        t0 = time.monotonic()
        self._q.put(pending)

        def _gen():
            # Stop-aware wait: if stop() won the race, no one sets the
            # event.
            while not pending.event.wait(timeout=0.5):
                if self._stopped.is_set():
                    raise RuntimeError("server shutting down")
            if pending.error is not None:
                raise pending.error
            if stats is not None:
                stats.prompt_tokens = len(ids)
                stats.completion_tokens = len(pending.out_ids)
                stats.ttft_s = time.monotonic() - t0
                stats.context = list(ids) + list(pending.out_ids)
            yield pending.text

        return _gen()

    def follower_loop(self) -> None:
        """Run on every rank but the leader: join each broadcast and
        mirror the leader's programs until shutdown. A round that fails
        is logged, this rank leaves the world and the error is raised
        (the process exits non-zero): its peers may wait in a collective
        it never reached, so it cannot realign (the module's
        docstring)."""
        if not self.is_follower:
            raise RuntimeError("the leader does not follow")
        log.info("multihost follower %d/%d ready", self.mesh.rank,
                 self.mesh.size)
        cmd = np.zeros((self._cmd_size,), np.int32)
        while True:
            got = self._broadcast(cmd)
            if int(got[0]) == _OP_SHUTDOWN:
                log.info("follower %d shutting down", self.mesh.rank)
                return
            try:
                self._run_cmd(got)
            except Exception:
                log.exception("follower %d: round failed; leaving the world "
                              "(a rank cannot rejoin the lockstep partway)",
                              self.mesh.rank)
                from ..parallel.distributed import leave_world
                leave_world()
                raise

    def render_chat(self, messages: list[dict]) -> str:
        from .engine import default_chat_prompt
        return default_chat_prompt(messages)

    def embed(self, texts: list[str]) -> tuple[list[list[float]], int]:
        """Sequence embeddings over the mesh: groups of up to R texts ride
        one lockstep round each (the family's embed_pooled)."""
        self._leader_only()
        ids = [self.tokenizer.encode(t, add_bos=True)[: self.max_seq]
               for t in texts]
        n_tokens = sum(len(i) for i in ids)
        out: list[list[float]] = []
        for start in range(0, len(ids), self._rows):
            p = _PendingEmbed(ids_list=ids[start: start + self._rows])
            self._q.put(p)
            while not p.event.wait(timeout=0.5):
                if self._stopped.is_set():
                    raise RuntimeError("server shutting down")
            if p.error is not None:
                raise p.error
            out.extend(p.vecs)
        return out, n_tokens

    def warmup(self, buckets=(), background: bool = False) -> None:
        return None

    def models(self) -> list[str]:
        return [self.name]

    # Advisory gauges: torn int reads off the dispatcher thread are fine.
    def metrics_snapshot(self) -> dict[str, float]:
        rounds = max(1, self._batched_rounds)
        return {
            "serve_multihost_processes": float(self.mesh.size),
            "serve_multihost_rows": float(self._rows),
            "serve_multihost_requests": float(self._requests_served),
            "serve_multihost_batched_rounds": float(self._batched_rounds),
            "serve_multihost_rows_per_round":
                self._rows_served_total / rounds,
        }

    def timings(self) -> dict:
        """This rank's p50 round and decode-step walls and the p50 time a
        step spent in collectives (ms), with their sample counts."""
        def p50(xs) -> Optional[float]:
            return float(np.median(list(xs))) if xs else None
        return {"rounds": len(self._round_ms),
                "round_ms_p50": p50(self._round_ms),
                "steps": len(self._step_ms),
                "step_ms_p50": p50(self._step_ms),
                "collective_ms_p50": p50(self._coll_ms)}

    def stop(self) -> None:
        if not self.is_follower and not self._stopped.is_set():
            self._q.put(_SHUTDOWN)
            self._stopped.wait(timeout=30)

    def close(self) -> None:
        """Log this rank's summary (timings, kernel launches, peak device
        memory, the compute backend) and leave the world: after
        :meth:`stop` on the leader, after :meth:`follower_loop` returns on
        a follower."""
        from ..ops import wrappers
        from ..parallel.distributed import leave_world
        peak = (torch.cuda.max_memory_allocated(self._device) / 2**20
                if self._device.type == "cuda" else None)
        summary = dict(self.timings(), rank=self.mesh.rank,
                       backend=self.mesh.backend, peak_mb=peak,
                       launches={k: w.launches
                                 for k, w in wrappers().items()})
        log.info("multihost rank %d summary: %s", self.mesh.rank,
                 json.dumps(summary))
        leave_world()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def build_multihost_engine(coordinator: Optional[str] = None, *,
                           params: Optional[dict] = None,
                           device: Optional[str | torch.device] = None
                           ) -> MultihostEngine:
    """The ``SERVE_COORDINATOR`` env path: join the world, build the
    ``dp × tp`` mesh (``SERVE_TP`` must divide the world size), take this
    rank's shard of ``MODEL_CONFIG`` (random bf16 init from seed 0 on
    every rank, as the reference's, each rank drawing only its shard a
    layer at a time; or ``params``: the whole tree of that config, fused
    or not) on its device, return the engine (serve/api.main runs the
    leader's front or a follower's loop)."""
    from ..models.configs import get_config
    from ..parallel.distributed import (init_distributed, multihost_mesh,
                                        rank_device)
    from ..parallel.mesh import MeshConfig
    from ..parallel.sharding import shard_model
    from ..tokenizer import ByteTokenizer
    from ..utils.env import env_float, env_int, env_or

    try:
        joined = init_distributed(coordinator=coordinator)
    except ValueError as e:
        raise SystemExit(f"multi-process serving: {e}") from None
    if not joined:
        raise SystemExit("SERVE_COORDINATOR set but distributed init "
                         "failed (need JAX_NUM_PROCESSES/JAX_PROCESS_ID)")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tp = env_int("SERVE_TP", 1)
    world = torch.distributed.get_world_size()
    if tp < 1 or world % tp:
        raise SystemExit(f"SERVE_TP={tp} does not divide the world size "
                         f"{world}")
    mesh = multihost_mesh(MeshConfig(dp=world // tp, tp=tp), dev)
    config = get_config(env_or("MODEL_CONFIG", "tiny"))
    if params is None:
        params = family_for(config).init_params(config, seed=0, device=dev,
                                                mesh=mesh)
    else:
        params = shard_model(params, config, mesh, dev)
    tok = ByteTokenizer(vocab_size=config.vocab_size)
    eng = MultihostEngine(params, config, tok, mesh,
                          max_seq=env_int("SERVE_MAX_SEQ", 512),
                          name=env_or("LLM_MODEL", config.name),
                          window_ms=env_float("SERVE_MH_WINDOW_MS", 25.0))
    log.info("multihost serving: %d processes, mesh dp=%d tp=%d on %s "
             "(compute groups %s), %s as process %d", world,
             mesh.shape["dp"], mesh.shape["tp"], dev, mesh.backend,
             "leader" if mesh.rank == 0 else "follower", mesh.rank)
    return eng
