"""Paged KV cache: page pool, page table, allocator, and write ops.

The port of p2p_llm_chat_tpu/ops/paged_kv.py, keeping its layouts so the
two pools compare byte for byte:

- k/v pool ``[L, num_pages, page_size, Hkv, D]``, token-major within a page;
- int8 pools carry f32 scales stored head-major and lane-padded,
  ``[L, num_pages, Hkv, ps_pad]`` with ``ps_pad`` = page_size rounded up
  to 128 (the layout kernel B reads one scale row per (page, head) from);
- page 0 is the garbage page: padded prefill slots, positions past a
  row's allocation and released rows all write there.

Unlike the reference's immutable pytrees, the write ops here update the
pool tensors IN PLACE (and return the same cache object): the 8B pool is
gigabytes, and a functional copy per step would double it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..models.configs import ModelConfig
from ..utils.device import resolve_device


@dataclass
class PagedKVCache:
    """k/v: [L, N, ps, Hkv, D]; page_table: [B, max_pages] int32
    (unused entries hold 0, the garbage page); lengths: [B] int32 tokens
    in the pool per row; k_scale/v_scale: [L, N, Hkv, ps_pad] f32 for int8
    pools, None for bf16 pools."""

    k: torch.Tensor
    v: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_pages_per_row(self) -> int:
        return self.page_table.shape[1]

    @classmethod
    def create(cls, config: ModelConfig, batch: int, num_pages: int,
               page_size: int, max_pages_per_row: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16, quantized: bool = False,
               device: Optional[torch.device | str] = None, mesh=None
               ) -> "PagedKVCache":
        """A zeroed pool on ``device`` (the card unless the CPU is asked
        for; see utils/device.py). Under a ``mesh`` that cuts the heads
        (parallel/sharding.Split) the pool holds this rank's kv heads and
        an int8 pool's scales are ``[L, N, Hkv_r, ps_pad]`` — the
        reference's pool spec, kv heads on ``tp``; the page table and
        lengths stay whole (the leader's host decisions write them). The
        writes below work per head, so they run unchanged on a shard, and
        an int8 scale per head row is the same number cut or not."""
        from ..parallel.sharding import Split
        device = resolve_device(device)
        split = Split.of(config, mesh)
        if split is not None:
            config = split.config
        shape = (config.num_layers, num_pages, page_size,
                 config.num_kv_heads, config.head_dim)
        if max_pages_per_row is None:
            max_pages_per_row = num_pages
        pt = torch.zeros((batch, max_pages_per_row), dtype=torch.int32,
                         device=device)
        lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
        if not quantized:
            return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       page_table=pt, lengths=lengths)
        ps_pad = -(-page_size // 128) * 128
        sshape = (config.num_layers, num_pages, config.num_kv_heads, ps_pad)
        return cls(k=torch.zeros(shape, dtype=torch.int8, device=device),
                   v=torch.zeros(shape, dtype=torch.int8, device=device),
                   page_table=pt, lengths=lengths,
                   k_scale=torch.zeros(sshape, dtype=torch.float32,
                                       device=device),
                   v_scale=torch.zeros(sshape, dtype=torch.float32,
                                       device=device))


def quant_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the trailing head_dim axis: x [..., Hkv, D] ->
    (int8 [..., Hkv, D], f32 scale [..., Hkv]). The f32 op order of the
    reference (amax / 127, then x / s, round half to even) so the bytes
    and scales match it exactly, on the card too: the divisor is a 0-d
    tensor, since PyTorch's CUDA division by a Python scalar multiplies
    by its reciprocal (one ulp off the IEEE quotient at times; the
    session wire carries these bytes between the packages)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = torch.where(amax > 0, amax / torch.full((), 127.0, device=x.device),
                    torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


class PageAllocator:
    """Host-side free-list over physical pages 1..num_pages-1 (page 0 is
    the shared garbage page and is never handed out). Owned by the
    scheduler thread."""

    def __init__(self, num_pages: int, page_size: int) -> None:
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.page_size = page_size
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` slots."""
        return max(1, -(-tokens // self.page_size))

    def alloc(self, n: int) -> Optional[list[int]]:
        """n physical pages, or None if the pool can't satisfy it (the
        request waits; nothing is partially held)."""
        if n <= 0:
            raise ValueError(f"alloc({n}): need a positive page count")
        if n > len(self._free):
            return None
        taken = self._free[-n:]
        del self._free[-n:]
        return taken

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"freeing invalid page {p}")
        self._free.extend(pages)


def _scatter_kv(cache: PagedKVCache, new_k: torch.Tensor,
                new_v: torch.Tensor, scatter, sscatter=None) -> None:
    """Apply ``scatter(pool, update)`` to k and v, quantizing the updates
    (and scattering their scales via ``sscatter``) for int8 pools."""
    if not cache.quantized:
        scatter(cache.k, new_k.to(cache.k.dtype))
        scatter(cache.v, new_v.to(cache.v.dtype))
        return
    qk, sk = quant_kv(new_k)
    qv, sv = quant_kv(new_v)
    scatter(cache.k, qk)
    scatter(cache.v, qv)
    sscatter(cache.k_scale, sk)
    sscatter(cache.v_scale, sv)


def _page_tiling(S: int, ps: int) -> tuple[int, int]:
    """(page tiles P, effective tile width): a sub-page span is one partial
    leading tile; otherwise ceil(S/ps) full-width tiles."""
    return (1, S) if S < ps else (-(-S // ps), ps)


def _tile_scatter(cache: PagedKVCache, chunk_k: torch.Tensor,
                  chunk_v: torch.Tensor, phys: torch.Tensor, P: int,
                  ps_eff: int) -> None:
    """Land [L, R, S, Hkv, D] k/v as R*P page tiles of width ``ps_eff`` at
    physical pages ``phys`` [R*P] (a pure reshape under the token-major
    layout; the last tile is zero-padded when S does not page-align)."""
    L, R, S = chunk_k.shape[:3]
    ps = cache.page_size

    def tiles(x: torch.Tensor) -> torch.Tensor:
        if S % ps and S >= ps:
            pad = x.new_zeros((*x.shape[:2], P * ps - S, *x.shape[3:]))
            x = torch.cat([x, pad], dim=2)
        return x.reshape(L, R * P, ps_eff, *x.shape[3:])

    def scatter(arr, upd):
        arr[:, phys, :ps_eff] = tiles(upd)

    def sscatter(arr, upd):
        arr[:, phys, :, :ps_eff] = tiles(upd).transpose(2, 3)

    _scatter_kv(cache, chunk_k, chunk_v, scatter, sscatter)


def write_prefill_batch(cache: PagedKVCache, chunk_k: torch.Tensor,
                        chunk_v: torch.Tensor, rows: torch.Tensor,
                        lens: torch.Tensor,
                        tables: torch.Tensor) -> PagedKVCache:
    """Splice an admission chunk's prefill KV into the pool, one page tile
    per (row, logical page), and install the rows' tables and lengths.

    chunk_k/v: [L, R, S, Hkv, D]; rows: [R] target batch rows (entries
    >= B are padding and install nothing); lens: [R] valid tokens;
    tables: [R, max_pages_per_row] physical page ids, zero past each
    row's allocation. Tiles past a row's allocation land in page 0."""
    R, S = chunk_k.shape[1:3]
    P, ps_eff = _page_tiling(S, cache.page_size)
    dev = cache.k.device
    phys = tables[:, :P].reshape(R * P).to(device=dev, dtype=torch.long)
    _tile_scatter(cache, chunk_k, chunk_v, phys, P, ps_eff)
    rows = rows.to(device=dev, dtype=torch.long)
    keep = rows < cache.page_table.shape[0]
    r = rows[keep]
    cache.page_table[r] = tables.to(device=dev, dtype=torch.int32)[keep]
    cache.lengths[r] = lens.to(device=dev, dtype=torch.int32)[keep]
    return cache


def write_prefill_chunk(cache: PagedKVCache, chunk_k: torch.Tensor,
                        chunk_v: torch.Tensor, tables: torch.Tensor,
                        start: int) -> PagedKVCache:
    """Splice ONE continuation-prefill chunk into the pool: chunk_k/v
    [L, R, C, Hkv, D] cover token positions ``start .. start+C`` of each
    row; tables [R, max_pages_per_row] are the rows' physical pages
    (zero past each allocation, all zero for padding entries).

    Installs NEITHER tables NOR lengths: the scheduler installs a row's
    state with its FINAL chunk, so a half-prefilled row never looks live
    (its live page-table row stays zeroed, and parked-row garbage writes
    keep landing in page 0 while the chunks accumulate).

    A page-aligned ``start`` takes write_prefill_batch's page tiles
    shifted by ``start // page_size``; an unaligned one (a prefix-offset
    chunk) scatters per token. Positions past a row's allocation land in
    page 0."""
    L, R, C = chunk_k.shape[:3]
    ps = cache.page_size
    mppr = tables.shape[1]
    dev = cache.k.device
    tables = tables.to(device=dev, dtype=torch.long)
    if start % ps == 0:
        P, ps_eff = _page_tiling(C, ps)
        lp = start // ps + torch.arange(P, device=dev)      # logical pages
        phys = torch.where((lp < mppr)[None, :],
                           tables[:, lp.clamp(max=mppr - 1)], 0)
        _tile_scatter(cache, chunk_k, chunk_v, phys.reshape(R * P), P,
                      ps_eff)
        return cache
    pos = start + torch.arange(C, device=dev)
    logical = pos // ps
    phys = torch.where((logical < mppr)[None, :],
                       tables[:, logical.clamp(max=mppr - 1)], 0)  # [R, C]
    slot = (pos % ps)[None, :].expand(R, C)

    def scatter(arr, upd):
        arr[:, phys, slot] = upd

    def sscatter(arr, upd):
        # non-adjacent advanced indices move to the front: [R, C, L, Hkv]
        arr[:, phys, :, slot] = upd.permute(1, 2, 0, 3)

    _scatter_kv(cache, chunk_k, chunk_v, scatter, sscatter)
    return cache


def _pos_slots(cache: PagedKVCache, pos: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical page, slot) of absolute positions ``pos`` (any shape,
    row-major over the batch: ``pos[b, ...]`` indexes row b's table).
    A position past the row's table goes to the garbage page 0: clamping
    it onto the last real page would wrap its slot into trusted kv."""
    ps = cache.page_size
    mppr = cache.max_pages_per_row
    pos = pos.long()
    logical = pos // ps
    flat = logical.reshape(pos.shape[0], -1)
    phys = cache.page_table.gather(1, flat.clamp(max=mppr - 1)).long()
    phys = torch.where(flat < mppr, phys, 0).reshape(pos.shape)
    return phys, pos % ps


def _decode_slots(cache: PagedKVCache) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical page, slot) [B] of each row's next write, at position
    ``lengths[b]``. A position past the row's page table (a finished row
    that a pipelined tick ran one step further) lands in the garbage
    page."""
    phys, slot = _pos_slots(cache, cache.lengths[:, None])
    return phys[:, 0], slot[:, 0]


def write_decode(cache: PagedKVCache, layer: int, k: torch.Tensor,
                 v: torch.Tensor) -> PagedKVCache:
    """Write one decode step's k/v of ONE layer for every row (the
    write-then-attend branch of models/llama.decode_step_paged): row b
    writes page ``page_table[b, lengths[b] // ps]`` slot ``lengths[b] %
    ps`` of ``layer``. Lengths do not move (the caller advances them after
    the layer loop); parked rows overwrite the same slot next step, and a
    released row's zeroed table routes its write to the garbage page.
    k/v: [B, Hkv, D]."""
    phys, slot = _decode_slots(cache)

    def scatter(arr, upd):
        arr[layer, phys, slot] = upd

    def sscatter(arr, upd):
        # layer-sliced target [N, Hkv, ps]; advanced dims 0, 2 -> [B, Hkv]
        arr[layer, phys, :, slot] = upd

    _scatter_kv(cache, k, v, scatter, sscatter)
    return cache


def write_decode_burst(cache: PagedKVCache, k_all: torch.Tensor,
                       v_all: torch.Tensor, inc: torch.Tensor
                       ) -> PagedKVCache:
    """Land one decode step for every layer and advance: row b writes page
    ``page_table[b, lengths[b] // ps]`` slot ``lengths[b] % ps`` across all
    layers, then ``lengths += inc`` ([B] int — the active mask; parked rows
    keep their position, and their zeroed table routes the write to the
    garbage page). k_all/v_all: [L, B, Hkv, D]."""
    phys, slot = _decode_slots(cache)

    def scatter(arr, upd):
        arr[:, phys, slot] = upd

    def sscatter(arr, upd):
        # non-adjacent advanced indices move to the front: [B, L, Hkv]
        arr[:, phys, :, slot] = upd.permute(1, 0, 2)

    _scatter_kv(cache, k_all, v_all, scatter, sscatter)
    cache.lengths += inc.to(cache.lengths.dtype)
    return cache


def _multi_write_indices(cache: PagedKVCache, S: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(phys, slot) [B, S] for S consecutive candidate positions per row
    from ``lengths`` on (the reference's ``_multi_write_indices``): the
    one containment rule every multi-position write shares."""
    pos = cache.lengths.long()[:, None] + torch.arange(
        S, device=cache.lengths.device)[None, :]
    return _pos_slots(cache, pos)


def write_decode_multi_all_layers(cache: PagedKVCache, k_all: torch.Tensor,
                                  v_all: torch.Tensor) -> PagedKVCache:
    """Write S candidate slots per row for EVERY layer in one scatter
    (speculative verify's landing after the layer loop): row b's
    position j goes to ``lengths[b] + j``; k_all/v_all [L, B, S, Hkv, D].
    Lengths do not move; positions past a row's table land in page 0."""
    phys, slot = _multi_write_indices(cache, k_all.shape[2])

    def scatter(arr, upd):
        arr[:, phys, slot] = upd

    def sscatter(arr, upd):
        # non-adjacent advanced indices move to the front: [B, S, L, Hkv]
        arr[:, phys, :, slot] = upd.permute(1, 2, 0, 3)

    _scatter_kv(cache, k_all, v_all, scatter, sscatter)
    return cache


def write_decode_multi(cache: PagedKVCache, layer: int, k: torch.Tensor,
                       v: torch.Tensor) -> PagedKVCache:
    """Write S consecutive candidate slots per row for ONE layer (the
    write-then-attend verify): k/v [B, S, Hkv, D], row b's position j at
    ``lengths[b] + j``; lengths do not move; positions past a row's
    table land in page 0."""
    phys, slot = _multi_write_indices(cache, k.shape[1])

    def scatter(arr, upd):
        arr[layer, phys, slot] = upd

    def sscatter(arr, upd):
        # layer-sliced target [N, Hkv, ps]; advanced dims 0, 2 -> [B, S, Hkv]
        arr[layer, phys, :, slot] = upd

    _scatter_kv(cache, k, v, scatter, sscatter)
    return cache


def copy_slot(cache: PagedKVCache, src_pos: torch.Tensor,
              dst_pos: torch.Tensor) -> PagedKVCache:
    """Move ONE kv slot per row, every layer, from absolute position
    ``src_pos[b]`` to ``dst_pos[b]`` (tree speculation's sibling
    compaction: an accepted sibling's kv, written at its node slot, is
    copied onto the accepted path before lengths advance over it). Raw
    pool words move — int8 values with their head-major scales, never a
    requantize. ``src == dst`` copies onto itself; a position past a
    row's table is page 0 in either direction."""
    sp, so = _pos_slots(cache, src_pos[:, None])
    dp, do = _pos_slots(cache, dst_pos[:, None])
    sp, so, dp, do = sp[:, 0], so[:, 0], dp[:, 0], do[:, 0]
    cache.k[:, dp, do] = cache.k[:, sp, so]
    cache.v[:, dp, do] = cache.v[:, sp, so]
    if cache.quantized:
        cache.k_scale[:, dp, :, do] = cache.k_scale[:, sp, :, so]
        cache.v_scale[:, dp, :, do] = cache.v_scale[:, sp, :, so]
    return cache


# -- page-set extract / inject (the KV tier, serve/kv_tier.py) ---------------

def gather_pages(cache: PagedKVCache, pages: torch.Tensor) -> tuple:
    """A page set's raw pool words in one gather per array — the device
    half of parking a session (the caller reads the result back and frees
    the pages). ``pages`` [P] physical ids, padded with page 0 to a
    power-of-two bucket by the caller, so the payload shapes are the
    reference's. Returns (k, v [L, P, ps, Hkv, D], k_scale, v_scale [L, P,
    Hkv, ps_pad] head-major, or None on bf16 pools): the pool's words, not
    a dequant, so a woken session attends exactly what it parked."""
    pages = pages.to(device=cache.k.device, dtype=torch.long)
    k = cache.k.index_select(1, pages)
    v = cache.v.index_select(1, pages)
    if not cache.quantized:
        return k, v, None, None
    return (k, v, cache.k_scale.index_select(1, pages),
            cache.v_scale.index_select(1, pages))


def scatter_pages(cache: PagedKVCache, pages: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None) -> PagedKVCache:
    """Land a parked page set back into the pool, the inverse of
    :func:`gather_pages`, IN PLACE (``index_copy_`` into the existing
    pool tensors, whose addresses the captured decode and spec graphs
    hold). ``pages`` [P] freshly allocated ids padded with page 0 to the
    payload's bucket; the duplicate 0 entries land garbage in the garbage
    page. Touches pool content only: the caller installs the waking row's
    table and length."""
    pages = pages.to(device=cache.k.device, dtype=torch.long)
    cache.k.index_copy_(1, pages, k.to(cache.k.device))
    cache.v.index_copy_(1, pages, v.to(cache.v.device))
    if k_scale is not None:
        cache.k_scale.index_copy_(1, pages, k_scale.to(cache.k.device))
        cache.v_scale.index_copy_(1, pages, v_scale.to(cache.k.device))
    return cache


def set_row_table(cache: PagedKVCache, row: int,
                  pages: torch.Tensor) -> PagedKVCache:
    """Install a row's page map (physical ids, zero past its allocation,
    ``max_pages_per_row`` wide) and reset its length to 0, in place."""
    cache.page_table[row] = pages.to(device=cache.page_table.device,
                                     dtype=torch.int32)
    cache.lengths[row] = 0
    return cache


def zero_row(cache: PagedKVCache, row: int) -> PagedKVCache:
    """Release a row on the device, in place: its table to the garbage
    page and its length to 0 (queued after any tick in flight, so that
    tick's writes still land in the row's own pages)."""
    cache.page_table[row].zero_()
    cache.lengths[row].zero_()
    return cache
