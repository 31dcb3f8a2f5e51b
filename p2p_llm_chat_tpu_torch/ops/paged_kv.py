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
               device: Optional[torch.device | str] = None
               ) -> "PagedKVCache":
        """A zeroed pool on ``device`` (the card unless the CPU is asked
        for; see utils/device.py)."""
        device = resolve_device(device)
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
    and scales match it exactly."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
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
    L, R, S = chunk_k.shape[:3]
    ps = cache.page_size
    P, ps_eff = _page_tiling(S, ps)
    dev = cache.k.device
    phys = tables[:, :P].reshape(R * P).to(device=dev, dtype=torch.long)

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
    rows = rows.to(device=dev, dtype=torch.long)
    keep = rows < cache.page_table.shape[0]
    r = rows[keep]
    cache.page_table[r] = tables.to(device=dev, dtype=torch.int32)[keep]
    cache.lengths[r] = lens.to(device=dev, dtype=torch.int32)[keep]
    return cache


def write_decode_burst(cache: PagedKVCache, k_all: torch.Tensor,
                       v_all: torch.Tensor, inc: torch.Tensor
                       ) -> PagedKVCache:
    """Land one decode step for every layer and advance: row b writes page
    ``page_table[b, lengths[b] // ps]`` slot ``lengths[b] % ps`` across all
    layers, then ``lengths += inc`` ([B] int — the active mask; parked rows
    keep their position, and their zeroed table routes the write to the
    garbage page). k_all/v_all: [L, B, Hkv, D]."""
    ps = cache.page_size
    lengths = cache.lengths.long()
    phys = cache.page_table.gather(1, (lengths // ps)[:, None])[:, 0].long()
    slot = lengths % ps

    def scatter(arr, upd):
        arr[:, phys, slot] = upd

    def sscatter(arr, upd):
        # non-adjacent advanced indices move to the front: [B, L, Hkv]
        arr[:, phys, :, slot] = upd.permute(1, 0, 2)

    _scatter_kv(cache, k_all, v_all, scatter, sscatter)
    cache.lengths += inc.to(cache.lengths.dtype)
    return cache


def set_row_table(cache: PagedKVCache, row: int,
                  pages: torch.Tensor) -> PagedKVCache:
    """Install a row's page map (physical ids, 0-padded to
    max_pages_per_row) and reset its length to 0. Releasing a row installs
    all zeros, so its later parked-row writes land in the garbage page."""
    cache.page_table[row] = pages.to(device=cache.page_table.device,
                                     dtype=torch.int32)
    cache.lengths[row] = 0
    return cache

