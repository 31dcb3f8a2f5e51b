"""Draft sources for speculative decoding — a copy of
p2p_llm_chat_tpu/utils/draft.py (the port imports nothing of the
reference package).

The scheduler (serve/scheduler.py) consults its sources per row in
priority order; the port has the prompt-lookup n-gram source
(:class:`NGramSource`, one incremental :class:`NGramDrafter` per row).
The reference's resident draft model (its serve/draft_model.py) keeps a
dense KV cache, which waits for the port's dense path. Every source
proposes point-mass (deterministic) drafts, which is what keeps the
acceptance math of models/sampling.spec_verify_batched exact.

The n-gram index is incremental: O(1) per generated token, last
occurrence wins (recency beats frequency for chat text).
"""

from __future__ import annotations


class DraftSource:
    """Scheduler-facing draft-source protocol (batch-level: one instance
    serves every batch row — the model drafter must dispatch ONE batched
    device program per tick, not one per row, so the per-row NGramDrafter
    shape cannot be the shared interface).

    Lifecycle hooks mirror the scheduler's slot lifecycle; every method
    is called from the scheduler thread only. ``draft_batch`` proposes
    up to k tokens per requested row; ``observe`` reports the verify
    outcome so stateful sources (the model drafter's KV) can roll back
    to the last accepted position. All proposals must be DETERMINISTIC
    functions of the row context (point-mass draft distribution) — the
    exact-acceptance math in models/sampling.spec_verify_batched relies
    on it."""

    name: str = "?"

    def admit(self, row: int, ctx: list[int]) -> None:
        """Row entered the batch with ``ctx`` (prompt ids) as context."""

    def append(self, row: int, tok: int) -> None:
        """One token was accepted into the row's context (plain ticks,
        accepted drafts, corrections — every emitted token)."""

    def release(self, row: int) -> None:
        """Row left the batch."""

    def draft_batch(self, rows: list[int],
                    ctxs: dict[int, tuple[list[int], list[int]]]
                    ) -> dict[int, list[int]]:
        """Proposals for ``rows``: row -> up to k draft tokens ([] /
        missing = no proposal). ``ctxs[row]`` is the row's context as
        the UNCONCATENATED ``(prompt_ids, generated_ids)`` pair — the
        scheduler passes its live list references, so a spec tick costs
        no per-row context copies; sources slice only what they need
        (the model drafter: the suffix past its fed prefix)."""
        raise NotImplementedError

    def draft_tree_batch(self, rows: list[int],
                         ctxs: dict[int, tuple[list[int], list[int]]]
                         ) -> dict[int, tuple[list[int], list[int],
                                              list[float]]]:
        """Tree proposals: row -> (main_chain, second_choices, gaps).
        ``main_chain`` is exactly what :meth:`draft_batch` would
        propose; ``second_choices[j]``/``gaps[j]`` are the source's
        second-best token at main position j and its top-1/top-2 score
        gap (smaller = less certain = better branch site). The default
        degrades to a LINEAR chain — empty second/gap lists, so the
        scheduler budgets no siblings and the tree is a path
        (NGramSource proposes from a lookup table with no runner-up
        score; it rides tree ticks unchanged this way). Sources with
        real runner-up scores (the reference's
        serve/draft_model.ModelDrafter) override. ``observe`` still
        reports the MAIN-CHAIN accepted prefix only — a used sibling
        diverges from this source's fed state, so it must not be counted
        as fed context."""
        return {r: (d, [], [])
                for r, d in self.draft_batch(rows, ctxs).items()}

    def observe(self, row: int, accepted: int) -> None:
        """Verify outcome for a row this source drafted this tick."""

    def reset(self) -> None:
        """Scheduler device-state reset — drop everything."""


class NGramSource(DraftSource):
    """Prompt-lookup drafting behind the batch protocol: one incremental
    :class:`NGramDrafter` per live row."""

    name = "ngram"

    def __init__(self, k: int, n: int = 2) -> None:
        self.k = k
        self.n = n
        self._rows: dict[int, NGramDrafter] = {}

    def admit(self, row: int, ctx: list[int]) -> None:
        self._rows[row] = NGramDrafter(ctx, self.k, n=self.n)

    def append(self, row: int, tok: int) -> None:
        d = self._rows.get(row)
        if d is not None:
            d.append(tok)

    def release(self, row: int) -> None:
        self._rows.pop(row, None)

    def draft_batch(self, rows: list[int],
                    ctxs: dict[int, tuple[list[int], list[int]]]
                    ) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        for row in rows:
            d = self._rows.get(row)
            if d is None:
                # Late bind (e.g. source enabled after admission): build
                # the index from the full context once.
                prompt, ids = ctxs[row]
                d = self._rows[row] = NGramDrafter(list(prompt) + list(ids),
                                                   self.k, n=self.n)
            prop = d.draft()
            if prop:
                out[row] = prop
        return out

    def reset(self) -> None:
        self._rows.clear()


class NGramDrafter:
    """Per-request n-gram index over prompt + generated ids."""

    def __init__(self, ids: list[int], k: int, n: int = 2) -> None:
        self.k = k
        self.n = n
        self.ids = list(ids)
        # ngram tuple -> position just after its latest occurrence,
        # excluding the trailing ngram itself (its continuation doesn't
        # exist yet — it's what we're trying to predict).
        self._index: dict[tuple, int] = {}
        for i in range(len(self.ids) - n):
            self._index[tuple(self.ids[i: i + n])] = i + n

    def append(self, tok: int) -> None:
        if len(self.ids) >= self.n:
            self._index[tuple(self.ids[-self.n:])] = len(self.ids)
        self.ids.append(tok)

    def draft(self) -> list[int]:
        """Up to k proposed continuation tokens ([] = no match)."""
        if len(self.ids) < self.n:
            return []
        pos = self._index.get(tuple(self.ids[-self.n:]))
        if pos is None:
            return []
        return self.ids[pos: pos + self.k]
