"""Resident draft model for speculative decoding (the "model" draft
source), the port of p2p_llm_chat_tpu/serve/draft_model.py.

A second, small model resident on the same card as the serving target
proposes K greedy tokens per batch row each spec tick; the target
verifies them in one forward (the scheduler's ``verify_step`` /
``verify_tree`` and models/sampling's exact acceptance). Greedy proposals
are a point-mass draft distribution, so the acceptance stays exact and
greedy output is the same with the drafter on or off.

The device design is the reference's, on the port's dense model forms:

- a **dense KV cache** ``[L_d, B, max_seq, Hkv_d, D_d]`` (models/llama.
  KVCache) mirroring the target's batch rows;
- **catch-up = verify_step**: the context tokens the drafter has not
  seen (the last correction, anything emitted while another source
  drafted) are fed in ONE multi-position forward at the row's valid
  prefix, whose last pending position yields the first draft (kernel B's
  verify mode on the card, at most ``_MAX_FEED`` = 256 positions, the
  mode's widest block; a longer suffix feeds in 256-wide chunks first);
- **drafting = decode_fused** with an argmax ``sample_fn`` over the
  dense ``decode_step`` (kernel B's pool mode on the card) for the
  remaining K - 1 tokens, each position's runner-up token and top-1/top-2
  logit gap kept beside it (the tree's sibling signal);
- **rollback is free**: every dispatch sets the cache's lengths from the
  host's valid prefix per row (``_fed``), so rejected drafts' KV is
  stale past the length and :meth:`ModelDrafter.observe` is bookkeeping.

Every method runs on the scheduler thread. A draft dispatch of a
pending block of up to ``_GRAPH_MAX_FEED`` positions is one program per
(block bucket, window) fed from static device buffers: the scheduler
hands the drafter its ``program`` hook, which on the card captures the
program in a CUDA graph (in the scheduler's pool, under its capture
lock; warmup captures the steady-state buckets at every window) and
replays it; without one (tests, the CPU) the program runs eagerly.
Admission and catch-up feeds run eagerly. ``draft_s`` /
``n_draft_dispatches`` time the draft dispatches, the readback included.
"""

from __future__ import annotations

import time
import numpy as np
import torch

from ..models import family_for
from ..models.configs import ModelConfig
from ..models.llama import KVCache
from ..models.quant import param_bytes
from ..utils.draft import DraftSource
from ..utils.log import get_logger

log = get_logger("serve.draft_model")

# Catch-up feed buckets: pending suffixes bucket to the smallest power of
# two >= len (floor _MIN_FEED); a longer suffix than _MAX_FEED feeds in
# _MAX_FEED-wide chunks first (kernel B's verify mode takes up to 256
# positions; the reference's cap is 512).
_MIN_FEED = 4
_MAX_FEED = 256
# Draft programs over pending blocks up to this wide are captured (B x
# 16 rows stay on kernel A's path); wider ones, rare, run eagerly.
_GRAPH_MAX_FEED = 16


def _pow2(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


def _ctx_len(ctx) -> int:
    prompt, ids = ctx
    return len(prompt) + len(ids)


def _ctx_suffix(ctx, start: int) -> list:
    """Context tokens past ``start`` of a (prompt, generated) pair,
    without concatenating the whole pair."""
    prompt, ids = ctx
    if start >= len(prompt):
        return ids[start - len(prompt):]
    return list(prompt[start:]) + list(ids)


class ModelDrafter(DraftSource):
    """Device-resident draft model behind the DraftSource protocol.

    ``params``/``config``: the drafter (llama or mixtral family; its
    ``vocab_size`` must equal the target's, which the scheduler checks).
    ``num_slots``/``max_seq`` mirror the target scheduler's geometry;
    ``k`` is the drafts-per-tick budget (the scheduler's ``spec_k``).
    The cache lives on the params' device."""

    name = "model"

    def __init__(self, params: dict, config: ModelConfig, *,
                 num_slots: int, max_seq: int, k: int) -> None:
        if k < 1:
            raise ValueError(f"drafter k must be >= 1, got {k}")
        self.config = config
        self.k = k
        self.num_slots = num_slots
        self.max_seq = min(max_seq, config.max_seq_len)
        self._model = family_for(config)
        self._params = self._model.fuse_params(params)
        self._dtype = self._params["embed"].dtype
        self.device = self._params["embed"].device
        self._cache = KVCache.create(config, num_slots, self.max_seq,
                                     dtype=self._dtype, device=self.device)
        self._no_stop = torch.zeros((0,), dtype=torch.long,
                                    device=self.device)
        # The draft programs' static inputs (block tokens per bucket,
        # pending counts, valid prefixes) and outputs ([drafts, runner-up]
        # and the gaps); the programs read and write them in place.
        dev, B = self.device, num_slots
        self._tok_in: dict[int, torch.Tensor] = {}
        self._pend_in = torch.zeros((B,), dtype=torch.long, device=dev)
        self._len_in = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._ids_out = torch.zeros((2, B, k), dtype=torch.long, device=dev)
        self._gap_out = torch.zeros((B, k), dtype=torch.float32, device=dev)
        # program(key, make) -> a callable running make()'s function:
        # eager by default; the scheduler installs its CUDA-graph one.
        self.program = lambda key, make: make()
        # Valid-KV prefix per row, and the rows the last draft dispatch
        # drafted for, awaiting observe(). Scheduler thread only.
        self._fed = [0] * num_slots
        self._await_obs: set[int] = set()
        self.n_draft_dispatches = 0
        self.n_feed_dispatches = 0
        self.draft_s = 0.0

    # -- memory accounting ----------------------------------------------------

    def kv_bytes(self) -> int:
        """The drafter's dense KV footprint (the engine logs it beside
        the target's at build)."""
        return self._cache.nbytes()

    def param_bytes(self) -> int:
        return param_bytes(self._params)

    # -- device calls -----------------------------------------------------------

    def _window(self, need: int) -> int:
        return _pow2(need, min(128, self.max_seq), self.max_seq)

    def _inputs(self, rows: list[int], pend_toks: dict[int, list[int]],
                M: int) -> tuple:
        """The static (tokens [B, M], pend [B]) filled for ``rows``, and
        the valid prefixes in ``_len_in`` and the cache's lengths."""
        B = self.num_slots
        tokens = np.zeros((B, M), np.int64)
        pend = np.zeros((B,), np.int64)
        for row in rows:
            t = pend_toks[row]
            tokens[row, :len(t)] = t
            pend[row] = len(t)
        tok = self._tok_in.get(M)
        if tok is None:
            tok = self._tok_in[M] = torch.zeros((B, M), dtype=torch.long,
                                                device=self.device)
        tok.copy_(torch.from_numpy(tokens))
        self._pend_in.copy_(torch.from_numpy(pend))
        self._len_in.copy_(torch.tensor(self._fed, dtype=torch.int32))
        self._cache.lengths.copy_(self._len_in)
        return tok, self._pend_in

    def _feed(self, tokens: torch.Tensor, pend: torch.Tensor, W: int
              ) -> torch.Tensor:
        """One verify-shaped forward over the pending block (rows with
        pend = 0 write past their valid prefix and change nothing
        trusted), lengths advanced by pend. Returns the logits of each
        row's last pending position [B, V]."""
        M = tokens.shape[1]
        last = (pend - 1).clamp(0, M - 1)
        logits, _ = self._model.verify_step(self._params, self.config,
                                            tokens, self._cache,
                                            kv_window=W, last_idx=last)
        self._cache.lengths += pend.to(torch.int32)
        return logits[:, 0]

    def _dispatch_feed(self, rows: list[int],
                       pend_toks: dict[int, list[int]]) -> None:
        if not rows:
            return
        M = _pow2(max(len(pend_toks[r]) for r in rows), _MIN_FEED,
                  _MAX_FEED)
        need = max(self._fed[r] + len(pend_toks[r]) for r in rows) + 1
        tokens, pend = self._inputs(rows, pend_toks, M)
        self.n_feed_dispatches += 1
        self._feed(tokens, pend, self._window(need))
        for row in rows:
            self._fed[row] += len(pend_toks[row])

    def _draft(self, tokens: torch.Tensor, pend: torch.Tensor, W: int):
        """Catch-up + K greedy drafts: the feed's last-position logits
        give draft 1, ``decode_fused`` (argmax, no stop parking — the
        target's verify decides what an EOS draft means) the other K - 1.
        Returns (drafts, runner-up, top-1/top-2 gap), each [B, K]."""
        B, K = tokens.shape[0], self.k
        last = self._feed(tokens, pend, W)
        v2, i2 = torch.topk(last, 2, dim=-1)
        d1 = i2[:, 0]
        sec = torch.zeros((B, K), dtype=torch.long, device=self.device)
        gap = torch.full((B, K), float("inf"), device=self.device)
        sec[:, 0] = i2[:, 1]
        gap[:, 0] = v2[:, 0] - v2[:, 1]
        if K == 1:
            return d1[:, None], sec, gap

        def sample_fn(lg, state, emit_pos, act):
            s, g, i = state
            vs, ix = torch.topk(lg, 2, dim=-1)
            s[:, i] = ix[:, 1]
            g[:, i] = vs[:, 0] - vs[:, 1]
            return ix[:, 0], (s, g, i + 1)

        toks, _, _, _, _, (sec, gap, _) = self._model.decode_fused(
            self._params, self.config, d1[:, None], self._cache, pend > 0,
            num_steps=K - 1, sample_fn=sample_fn, sample_state=(sec, gap, 1),
            stop_ids=self._no_stop, kv_window=W)
        return torch.cat([d1[:, None], toks.T], dim=1), sec, gap

    def _draft_fn(self, M: int, W: int):
        """The draft program of bucket M at window W on the static
        buffers: lengths from the valid prefixes, :meth:`_draft`, its
        [B, K] results copied out."""
        def run() -> None:
            self._cache.lengths.copy_(self._len_in)
            drafts, sec, gap = self._draft(self._tok_in[M], self._pend_in, W)
            self._ids_out[0].copy_(drafts)
            self._ids_out[1].copy_(sec)
            self._gap_out.copy_(gap)
        return run

    def _draft_program(self, M: int, W: int):
        if M > _GRAPH_MAX_FEED:
            return self._draft_fn(M, W)
        return self.program((M, W), lambda: self._draft_fn(M, W))

    def _catch_up_oversize(self, rows: list[int], ctxs: dict) -> None:
        """Feed _MAX_FEED-wide chunks until every row's pending suffix
        fits one draft dispatch (a long stretch drafted by another
        source, or a drafter enabled mid-stream)."""
        logged = False
        while True:
            big = [r for r in rows
                   if _ctx_len(ctxs[r]) - self._fed[r] > _MAX_FEED]
            if not big:
                return
            if not logged:
                logged = True
                log.info("drafter catching up %d row(s), longest pending "
                         "suffix %d tokens", len(big),
                         max(_ctx_len(ctxs[r]) - self._fed[r] for r in big))
            self._dispatch_feed(
                big, {r: _ctx_suffix(ctxs[r], self._fed[r])[:_MAX_FEED]
                      for r in big})

    # -- DraftSource protocol -------------------------------------------------

    def prefill(self, rows: list[int], ctxs: dict) -> None:
        """Batched admission: feed each admitted row's prompt (``ctxs[row]``
        a list of ids) in _MAX_FEED-wide dispatches, nothing read back."""
        for row in rows:
            self._fed[row] = 0
            self._await_obs.discard(row)
        todo = [r for r in rows if ctxs[r]]
        while todo:
            chunk = {r: list(ctxs[r][self._fed[r]: self._fed[r] + _MAX_FEED])
                     for r in todo}
            self._dispatch_feed(todo, chunk)
            todo = [r for r in todo if self._fed[r] < len(ctxs[r])]

    def admit(self, row: int, ctx: list[int]) -> None:
        self.prefill([row], {row: ctx})

    def release(self, row: int) -> None:
        self._fed[row] = 0
        self._await_obs.discard(row)

    def _dispatch_draft(self, rows: list[int], ctxs: dict):
        """Catch up, then ONE combined feed + draft dispatch and its
        readback. Returns the rows drafted and the [B, K] (drafts,
        runner-up, gap) on the host. Rows whose context plus drafts would
        pass the drafter's max_seq, and rows with nothing pending, are
        not drafted."""
        rows = [r for r in rows
                if _ctx_len(ctxs[r]) + self.k + 1 <= self.max_seq
                and _ctx_len(ctxs[r]) > self._fed[r]]
        if not rows:
            return [], None, None, None
        t0 = time.monotonic()
        self._catch_up_oversize(rows, ctxs)
        pend_toks = {r: _ctx_suffix(ctxs[r], self._fed[r]) for r in rows}
        M = _pow2(max(len(t) for t in pend_toks.values()), _MIN_FEED,
                  _MAX_FEED)
        need = max(self._fed[r] + len(pend_toks[r]) for r in rows) + self.k
        self._inputs(rows, pend_toks, M)
        self.n_draft_dispatches += 1
        self._draft_program(M, self._window(need))()
        (drafts, sec), gap = self._ids_out.tolist(), self._gap_out.tolist()
        self.draft_s += time.monotonic() - t0
        for row in rows:
            self._fed[row] += len(pend_toks[row])
            self._await_obs.add(row)
        return rows, drafts, sec, gap

    def draft_batch(self, rows: list[int], ctxs: dict
                    ) -> dict[int, list[int]]:
        """K greedy tokens for each requested row (linear spec)."""
        rows, drafts, _, _ = self._dispatch_draft(rows, ctxs)
        return {row: drafts[row] for row in rows}

    def draft_tree_batch(self, rows: list[int], ctxs: dict
                         ) -> dict[int, tuple[list[int], list[int],
                                              list[float]]]:
        """The same single dispatch as :meth:`draft_batch`: the main
        chain is the greedy path, with each position's runner-up token
        and top-1/top-2 logit gap (the scheduler's sibling sites)."""
        rows, drafts, sec, gap = self._dispatch_draft(rows, ctxs)
        return {row: (drafts[row], sec[row], gap[row]) for row in rows}

    def observe(self, row: int, accepted: int) -> None:
        """Accepted drafts became context: their KV (written as decode
        inputs d1..d_{K-1}) is trusted, so the valid prefix advances by
        min(accepted, K - 1). The rest is stale past the length."""
        if row in self._await_obs:
            self._await_obs.discard(row)
            self._fed[row] += min(max(0, accepted), self.k - 1)

    def reset(self) -> None:
        """The scheduler's device state was reset: every row's valid
        prefix is gone (the cache itself stays allocated)."""
        self._fed = [0] * self.num_slots
        self._await_obs.clear()

    def warm(self, buckets: tuple[int, ...],
             windows: tuple[int, ...]) -> None:
        """With no row pending (pend = 0: lengths stay, writes land past
        every valid prefix): build the steady-state draft programs (a
        pending block of 1-8 tokens: buckets 4 and 8) at every window,
        captured by the scheduler's hook on the card, and run an
        admission feed per prompt bucket, so live ticks run warm paths."""
        for W in sorted({self._window(min(w, self.max_seq))
                         for w in windows}):
            for M in (_MIN_FEED, 2 * _MIN_FEED):
                self._inputs([], {}, M)
                self._draft_program(M, W)
        for S in buckets:
            M = _pow2(min(S, _MAX_FEED), _MIN_FEED, _MAX_FEED)
            tok, pend = self._inputs([], {}, M)
            self._feed(tok, pend, self._window(min(S + 1, self.max_seq)))
