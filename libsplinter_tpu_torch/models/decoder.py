"""Causal decoder LM (PyTorch) for the completion daemon — the dense
counterpart of the JAX package's flax decoder:

  - llama-family geometry: pre-norm RMSNorm, rotary positions, SwiGLU
    MLP, causal attention with grouped-query kv heads;
  - a static-shape KV cache of length ``max_len`` per layer, updated IN
    PLACE (a slice assign at the chunk's slots) where the JAX package
    threads a donated buffer through each program;
  - bfloat16 activations and projection weights on the card, RMSNorm
    statistics and scales in f32, an f32 LM head over the hidden cast
    to f32 (flax's ``Dense(dtype=float32)``);
  - the reference's sampler chain (top-p 0.9 -> temp 0.7 -> draw), with
    a ``torch.Generator`` in place of the threefry key: the two draw
    different numbers from the same seed, so only greedy decoding
    (temp <= 0) can match the JAX package token for token.

Prefill chunks at or above ``flash_min_seq`` attend through kernel K4
(ops/flash_attention.causal_flash_attention); shorter chunks and the
dense S = 1 decode steps through the plain masked softmax, as in the
JAX package.

The block-paged continuous lane keeps K/V in a global page pool
(``PagedKVCache``: host block tables, refcounts, trash block 0; bf16,
f32, int8 or int4-packed storage) that every decode step and every
prefix-cache suffix prefill reads in place through kernel K5
(ops/paged_attention.paged_attention).  The pools are updated IN PLACE
by the appends, the commit scatter and the copy-on-write copy, where
the JAX package donates them to each program.

Weights load from a llama-family GGUF file (models/gguf.py) or
safetensors file (the port's own reader), bridge from the JAX package's
flax tree (``params_from_jax``), or are seeded random draws from an
explicit torch.Generator.  ``DecoderConfig.quantized`` and
``weights_int8`` keep the attention and MLP projections on the card as
int8 codes + f32 scales (models/quant.py), a float checkpoint being
quantized at load.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..obs.devtime import DEVTIME, close_mark
from ..ops.flash_attention import (causal_attention_plain,
                                  causal_flash_attention)
from ..ops.paged_attention import (INT4_QMAX, pack_int4, paged_attention,
                                  unpack_int4)
from ..utils.device import DeviceFuture, resolve_device
from .encoder import (_apply_rotary, _rotary_angles, read_safetensors,
                      state_dict_from_flax, write_safetensors)
from .quant import (QUANT_LEAVES, ChannelQuantDense, QuantDense,
                    quantize_state_dict)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    kv_heads: int = 12            # grouped-query attention when < heads
    mlp_dim: int = 2048
    max_len: int = 2048           # KV cache length = context window
    rope_base: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16   # activation dtype
    # int8 blockwise weight residency (models/quant.py QuantDense): the
    # attention + MLP projections live on the card as Q8_0-geometry
    # int8 + per-block f32 scales.  Embeddings, norms and the LM head
    # stay float.
    quantized: bool = False
    # per-OUTPUT-channel int8 weight residency (models/quant.py
    # ChannelQuantDense): the product runs on the int8 codes with an f32
    # result, one f32 scale per output column after it.  Mutually
    # exclusive with `quantized` (one residency per model).
    weights_int8: bool = False
    # prefill chunks at/above this width attend through kernel K4: long
    # prompts stop materialising (B, H, S, T) logits.  0 = off.
    flash_min_seq: int = 512
    # tensor-parallel shards this config describes ONE of (shard()):
    # heads, kv_heads and mlp_dim are then that shard's; 1 = the model
    tp: int = 1

    @classmethod
    def tiny(cls, **kw) -> "DecoderConfig":
        """Small config for tests and CPU CI; kw overrides any field."""
        base = dict(vocab_size=1024, hidden=64, layers=2, heads=4,
                    kv_heads=2, mlp_dim=128, max_len=128)
        base.update(kw)
        return cls(**base)

    @property
    def head_dim(self) -> int:
        return self.hidden // (self.heads * self.tp)

    def shard(self, tp: int, ep: int = 1,
              ep_index: int = 0) -> "DecoderConfig":
        """The per-shard geometry of a tensor-parallel shard: heads/tp
        query heads, kv_heads/tp kv heads and mlp_dim/tp MLP lanes (the
        column-parallel outputs and row-parallel inputs it holds); the
        head width and everything else stay the model's.  A dense
        decoder replicates over the ep axis, so ep and ep_index are
        accepted and unused here (moe.MoeDecoderConfig splits experts
        on them)."""
        del ep, ep_index
        if self.tp != 1:
            raise ValueError("shard() takes the whole model's config")
        for name in ("heads", "kv_heads", "mlp_dim"):
            if getattr(self, name) % tp:
                raise ValueError(f"{name}={getattr(self, name)} must "
                                 f"divide the tp={tp} mesh axis")
        return dataclasses.replace(
            self, heads=self.heads // tp, kv_heads=self.kv_heads // tp,
            mlp_dim=self.mlp_dim // tp, tp=tp)


def init_cache(cfg: DecoderConfig, batch: int, device=None):
    """Fresh zeroed KV cache: a list of (k, v) per layer, each
    (B, max_len, kv_heads, head_dim) in the activation dtype."""
    shape = (batch, cfg.max_len, cfg.kv_heads, cfg.head_dim)
    return [tuple(torch.zeros(shape, dtype=cfg.dtype, device=device)
                  for _ in range(2)) for _ in range(cfg.layers)]


# the paged pool's storage dtypes: "int8" stores int8 values with one
# f32 scale per (page block, kv head) beside each pool; "int4" packs two
# 4-bit codes per uint8 byte (last axis head_dim / 2, split-half nibble
# layout, ops/paged_attention.pack_int4) under the same scales; "bf16"
# and "f32" are float pools
KV_DTYPES = ("bf16", "f32", "int8", "int4")


def _kv_storage(cfg: DecoderConfig, kv_dtype: str | None):
    """(label, storage dtype, quantized?) of a pool.  None keeps the
    model's activation dtype; a uint8 pool is int4-packed (every
    consumer keys packing off the dtype)."""
    if kv_dtype is None:
        label = ("bf16" if cfg.dtype == torch.bfloat16 else
                 "f32" if cfg.dtype == torch.float32 else
                 str(cfg.dtype).replace("torch.", ""))
        return label, cfg.dtype, False
    table = {"int8": (torch.int8, True), "int4": (torch.uint8, True),
             "bf16": (torch.bfloat16, False), "f32": (torch.float32, False)}
    if kv_dtype not in table:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r} (supported: {KV_DTYPES})")
    return (kv_dtype, *table[kv_dtype])


def _rescale_append(pages, scales, bids, offs, x, qmax: float):
    """The rescale-on-append arithmetic shared by int8 and int4, over
    (B, KH, page, D) f32 CODES of the touched pages: per (row, kv head)
    the page's scale grows to cover the new token (s_new = max(s_old,
    |x|_inf / qmax)), the existing codes re-round at the grown scale,
    and the token's codes land in its slot.  A write at in-page offset
    0 treats the page as fresh (s_old = 0): a page back from the free
    list still carries its last owner's scale.  Returns (codes, s_new)."""
    s_old = torch.where(offs[:, None] == 0, 0.0, scales[bids])   # (B, KH)
    xf = x.float()
    s_tok = xf.abs().amax(dim=-1) / qmax
    s_new = torch.maximum(s_old, s_tok)
    safe = torch.where(s_new > 0, s_new, 1.0)
    pages = torch.round(pages * (s_old / safe)[:, :, None, None])
    qtok = torch.clamp(torch.round(xf / safe[:, :, None]), -qmax, qmax)
    slot = (torch.arange(pages.shape[2], device=pages.device)[None, None, :,
                                                              None]
            == offs[:, None, None, None])
    return torch.where(slot, qtok[:, :, None, :], pages), s_new


def _quant_append(pool, scales, bids, offs, x):
    """Append one token per row into int8 pages, IN PLACE, with
    rescale-on-append (monotone per-page scales, see _rescale_append).

    pool: (n_blocks, KH, page, D) int8; scales: (n_blocks, KH) f32;
    bids/offs: (B,) block id + in-page slot per row; x: (B, KH, D).
    Dead rows and pad appends point at the trash block 0 — their writes
    (duplicate indices, any one of them wins) land there harmlessly;
    live rows never share a written page (copy-on-write runs first).
    A uint8 pool is int4-packed and goes to _quant_append_int4."""
    if pool.dtype == torch.uint8:
        return _quant_append_int4(pool, scales, bids, offs, x)
    codes, s_new = _rescale_append(pool[bids].float(), scales, bids, offs,
                                   x, 127.0)
    pool[bids] = codes.to(torch.int8)
    scales[bids] = s_new
    return pool, scales


def _quant_append_int4(pool, scales, bids, offs, x):
    """int4-packed rescale-on-append, IN PLACE: unpack the touched
    pages' codes, rescale at qmax 7, write the token's codes, repack.
    Never-written tail slots unpack to code -8; the rescale ratio <= 1
    keeps them in [-8, 7] and the length mask hides them.

    pool: (n_blocks, KH, page, D/2) uint8; scales: (n_blocks, KH) f32;
    x: (B, KH, D)."""
    codes, s_new = _rescale_append(unpack_int4(pool[bids]), scales, bids,
                                   offs, x, INT4_QMAX)
    pool[bids] = pack_int4(torch.clamp(codes, -8, 7))
    scales[bids] = s_new
    return pool, scales


class PagePools:
    """The device half of a PagedKVCache: ONE shard's per-layer pools
    on its device,

        k_pools / v_pools: (n_blocks, kv_heads, page, head_dim)

    (head_dim / 2 uint8 bytes for int4), plus for quantized pools
    k_scales / v_scales (n_blocks, kv_heads) f32.  Every pool is its own
    contiguous tensor: a tensor-parallel shard's pool holds its kv-head
    slice whole, never as a view of a wider pool (kernel K5 takes
    contiguous pools).  `head_pos` is the slice's position in head
    order (0 when unsharded)."""

    def __init__(self, layers: int, n_blocks: int, kv_heads: int,
                 page: int, width: int, store_dtype, quantized: bool,
                 device, head_pos: int = 0):
        self.device = device
        self.head_pos = head_pos
        shape = (n_blocks, kv_heads, page, width)

        def zeros(shp, dtype):
            return [torch.zeros(shp, dtype=dtype, device=device)
                    for _ in range(layers)]

        self.k_pools = zeros(shape, store_dtype)
        self.v_pools = zeros(shape, store_dtype)
        if quantized:
            self.k_scales = zeros((n_blocks, kv_heads), torch.float32)
            self.v_scales = zeros((n_blocks, kv_heads), torch.float32)
        else:
            self.k_scales = self.v_scales = None

    def layers(self) -> list[tuple]:
        """Per layer (k_pool, v_pool), or (k_pool, v_pool, k_scales,
        v_scales) for a quantized pool."""
        if self.k_scales is not None:
            return list(zip(self.k_pools, self.v_pools, self.k_scales,
                            self.v_scales))
        return list(zip(self.k_pools, self.v_pools))

    def tensors(self) -> list[torch.Tensor]:
        """Every device tensor: k pools, v pools, then the scales."""
        out = list(self.k_pools) + list(self.v_pools)
        if self.k_scales is not None:
            out += list(self.k_scales) + list(self.v_scales)
        return out

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.tensors())


class PagedKVCache:
    """Block-paged KV pool for the continuous-batching decode lane: a
    host-side page scheduler over the device pools of one or more
    shards (PagePools).

    Per layer, on each shard's device: (n_blocks, kv_heads / shards,
    page, head_dim) k and v pools (head_dim / 2 uint8 bytes for int4),
    plus for quantized pools (n_blocks, kv_heads / shards) f32 scales;
    on the host a (batch, pages_per_row) int32 block table and (batch,)
    lengths.  `shards` lists (device, head position) per pool: a
    tensor-parallel model's shards each hold every page at their kv-head
    slice (replicas of one slice share a position), and one scheduler
    drives them all — a block id names the same page in every pool.
    Without `shards` the cache is one whole pool on `device`.
    Block 0 is the reserved TRASH block: never allocated, every unused
    table entry points at it, so dead rows' appends land harmlessly and
    gathers of unused pages read garbage the ragged length mask hides.

    Allocation is host-side and page-granular, with the JAX package's
    semantics: ensure(row, tokens) grows a row's table all-or-nothing
    (admission backpressure), free_row returns its pages; per-page
    refcounts let rows share full prompt pages (map_shared), and a
    bound prefix cache (engine/prefix_cache.PrefixCache) may keep
    zero-ref pages frozen until the allocator reclaims them.  The
    device tensors are updated in place by the model's programs."""

    def __init__(self, cfg: DecoderConfig, batch: int, *,
                 page: int = 128, pool_pages: int | None = None,
                 kv_dtype: str | None = None, device=None,
                 shards: list[tuple] | None = None):
        if page < 1:
            raise ValueError("page must be >= 1")
        self.cfg = cfg
        self.batch = batch
        self.page = page
        self.pages_per_row = -(-cfg.max_len // page)
        if pool_pages is None:
            # safe default: every row's full window (== dense memory at
            # this batch); deployments cap it with --pool-pages
            pool_pages = batch * self.pages_per_row
        if pool_pages < self.pages_per_row:
            raise ValueError(
                f"pool_pages {pool_pages} cannot hold even one full "
                f"window ({self.pages_per_row} pages)")
        self.n_blocks = pool_pages + 1               # + the trash block
        self.kv_dtype, store_dtype, self.quantized = \
            _kv_storage(cfg, kv_dtype)
        self.packed = store_dtype == torch.uint8
        if self.packed and cfg.head_dim % 2:
            raise ValueError(
                f"kv_dtype=\"int4\" packs two codes per byte along "
                f"head_dim; head_dim={cfg.head_dim} must be even")
        self.sharded = shards is not None
        if shards is None:
            shards = [(resolve_device(device), 0)]
        self.device = shards[0][0]
        self.head_shards = 1 + max(pos for _, pos in shards)
        if cfg.kv_heads % self.head_shards:
            raise ValueError(f"kv_heads={cfg.kv_heads} must divide the "
                             f"{self.head_shards} head shards")
        width = cfg.head_dim // 2 if self.packed else cfg.head_dim
        self.pools = [PagePools(cfg.layers, self.n_blocks,
                                cfg.kv_heads // self.head_shards, page,
                                width, store_dtype, self.quantized, dev,
                                pos) for dev, pos in shards]
        self.tables = np.zeros((batch, self.pages_per_row), np.int32)
        self.lengths = np.zeros((batch,), np.int32)
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self._owned: list[list[int]] = [[] for _ in range(batch)]
        self.refcounts = np.zeros((self.n_blocks,), np.int64)
        self.prefix_cache = None
        self._ever_shared = False

    # shard 0's pools (the whole pool when unsharded)
    k_pools = property(lambda self: self.pools[0].k_pools)
    v_pools = property(lambda self: self.pools[0].v_pools)
    k_scales = property(lambda self: self.pools[0].k_scales)
    v_scales = property(lambda self: self.pools[0].v_scales)

    def layers(self) -> list:
        """The decoder's paged cache: per layer (k_pool, v_pool), or
        (k_pool, v_pool, k_scales, v_scales) for a quantized pool — and
        for a sharded pool one such list per shard (what the sharded
        trunk, parallel/serve.ShardedDecoder, takes)."""
        if not self.sharded:
            return self.pools[0].layers()
        return [p.layers() for p in self.pools]

    def head_order(self) -> list[PagePools]:
        """One shard per kv-head slice, in head order (the first of any
        replicas): what the page wire gathers and scatters."""
        first: dict[int, PagePools] = {}
        for p in self.pools:
            first.setdefault(p.head_pos, p)
        return [first[i] for i in range(self.head_shards)]

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Free-list pages plus zero-ref prefix-cache pages the
        allocator can reclaim on demand (admission compares against
        this)."""
        pc = self.prefix_cache
        extra = pc.evictable_count() if pc is not None else 0
        return len(self._free) + extra

    def _alloc_page(self) -> int:
        """Pop one page (refcount 1), evicting zero-ref cached pages
        LRU-first when the free list is dry; raises when the pool is
        truly exhausted (callers gate on available_pages first)."""
        if not self._free:
            pc = self.prefix_cache
            if pc is None or not pc.reclaim(1):
                raise RuntimeError("paged pool exhausted")
        bid = self._free.pop()
        self.refcounts[bid] = 1
        return bid

    def _decref(self, bid: int) -> None:
        self.refcounts[bid] -= 1
        if self.refcounts[bid] < 0:      # double-free: a scheduler bug
            raise RuntimeError(f"page {bid} refcount underflow")
        if self.refcounts[bid] == 0:
            pc = self.prefix_cache
            if pc is None or not pc.on_zero_ref(bid):
                self._free.append(bid)

    def map_shared(self, row: int, bids: list[int]) -> None:
        """Point `row`'s next table entries at already-committed pages
        (refcount bump, no device work); the caller sets lengths[row]
        to the token count the mapped prefix covers."""
        have = len(self._owned[row])
        if have + len(bids) > self.pages_per_row:
            raise ValueError("mapped prefix exceeds the row's table")
        pc = self.prefix_cache
        for i, bid in enumerate(bids):
            bid = int(bid)
            if bid <= 0 or bid >= self.n_blocks:
                raise ValueError(f"bad shared page id {bid}")
            self.refcounts[bid] += 1
            if self.refcounts[bid] == 1 and pc is not None:
                pc.on_ref(bid)         # evictable page pinned again
            self._owned[row].append(bid)
            self.tables[row, have + i] = bid
        if bids:
            self._ever_shared = True

    def cow_targets(self) -> list[tuple[int, int]]:
        """(row, page_index) pairs whose NEXT decode append would write
        into a page another reader holds (refcount > 1, or frozen in
        the prefix tree): only the page holding position lengths[row]
        can qualify."""
        if not self._ever_shared and self.prefix_cache is None:
            return []
        out = []
        pc = self.prefix_cache
        for r in range(self.batch):
            length = int(self.lengths[r])
            if length <= 0:
                continue
            p_idx = min(length, self.cfg.max_len - 1) // self.page
            if p_idx >= len(self._owned[r]):
                continue
            bid = int(self.tables[r, p_idx])
            if bid == 0:
                continue
            if self.refcounts[bid] > 1 or \
                    (pc is not None and pc.retains(bid)):
                out.append((r, p_idx))
        return out

    def commit_cow(self, row: int, p_idx: int, new_bid: int) -> None:
        """Host half of a copy-on-write: swap the row's table entry to
        the private copy and drop its reference on the original."""
        old = int(self.tables[row, p_idx])
        self._owned[row][p_idx] = new_bid
        self.tables[row, p_idx] = new_bid
        self._decref(old)
        pc = self.prefix_cache
        if pc is not None:
            pc.stats.cow_copies += 1

    def kv_bytes_per_token(self) -> int:
        """KV bytes one token occupies across every layer (k + v);
        int4-packed pools store half a byte per value."""
        if self.packed:
            return (self.cfg.layers * 2 * self.cfg.kv_heads
                    * (self.cfg.head_dim // 2))
        itemsize = (1 if self.quantized else
                    4 if self.kv_dtype == "f32" else 2)
        return (self.cfg.layers * 2 * self.cfg.kv_heads
                * self.cfg.head_dim * itemsize)

    @property
    def used_pages(self) -> int:
        return self.n_blocks - 1 - len(self._free)

    def pages_needed(self, tokens: int) -> int:
        tokens = min(int(tokens), self.cfg.max_len)
        return -(-tokens // self.page) if tokens > 0 else 0

    def ensure(self, row: int, tokens: int) -> bool:
        """Grow row's table to cover `tokens`; False (nothing
        allocated) when the pool cannot — admission backpressure."""
        need = self.pages_needed(tokens)
        have = len(self._owned[row])
        if need <= have:
            return True
        if need - have > self.available_pages:
            return False
        for p in range(have, need):
            bid = self._alloc_page()
            self._owned[row].append(bid)
            self.tables[row, p] = bid
        return True

    def free_row(self, row: int) -> None:
        """Drop every page reference the row holds; a page returns to
        the free list when its last reader lets go (or parks evictable
        when the prefix tree retains it)."""
        for bid in self._owned[row]:
            self._decref(bid)
        self._owned[row] = []
        self.tables[row, :] = 0
        self.lengths[row] = 0

    def reset(self) -> None:
        for r in range(self.batch):
            self.free_row(r)

    def live_tokens(self) -> int:
        return int(self.lengths.sum())

    def device_mb(self) -> float:
        """Pool bytes of the device tensors (values + scales, all
        layers, k and v, every shard), in MB."""
        return round(sum(p.nbytes() for p in self.pools) / 1e6, 3)


class PendingChunk:
    """One in-flight paged decode chunk (paged_decode_chunk_async): the
    (n, batch) sampled block still on the device, plus `last`, the final
    sampled column as a DEVICE tensor the next chunk's dispatch consumes
    (carry=), so chaining chunks costs no host round trip.  is_ready()
    queries a CUDA event and never syncs; block() makes the one host
    copy per chunk and returns (batch, n)."""

    __slots__ = ("_out", "last", "n", "_mark")

    def __init__(self, out, last, n: int, mark=None):
        self._out = DeviceFuture(out)
        self.last = last
        self.n = n
        self._mark = mark             # devtime DispatchMark, closed at
        # block()

    def is_ready(self) -> bool:
        return self._out.is_ready()

    def block(self) -> np.ndarray:
        host = self._out.value.cpu().numpy().T          # (batch, n)
        mark, self._mark = self._mark, None
        close_mark(mark)
        return host


class RMSNorm(nn.Module):
    """f32 statistics and f32 scale, output in the activation dtype."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight).to(self.dtype)


def _proj(cfg: DecoderConfig, din: int, dout: int) -> nn.Module:
    """The decoder's projection: a bias-free Linear, QuantDense for the
    Q8_0 block residency, or ChannelQuantDense for the per-output-channel
    one (--weights-int8)."""
    if cfg.weights_int8:
        return ChannelQuantDense(din, dout, cfg.dtype)
    if cfg.quantized:
        return QuantDense(din, dout, cfg.dtype)
    return nn.Linear(din, dout, bias=False)


class CausalAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.head_dim
        self.q = _proj(cfg, cfg.hidden, cfg.heads * d)
        self.k = _proj(cfg, cfg.hidden, cfg.kv_heads * d)
        self.v = _proj(cfg, cfg.hidden, cfg.kv_heads * d)
        self.out = _proj(cfg, cfg.heads * d, cfg.hidden)

    def forward(self, x, cache_kv, pos: int, start, rotary, lengths=None,
                tables=None, n_valid: int | None = None):
        """x: (B, S, hidden), the chunk at cache slots pos..pos+S-1.
        cache_kv: (k, v) each (B, T, KH, D), written in place at those
        slots.  start: None, or (B,) left-pad offsets — row r's real
        tokens occupy slots start[r].., its rotary position at slot s is
        s - start[r], and slots below start[r] are masked.  rotary: the
        (T, D/2) cos/sin tables.

        PAGED (lengths given): cache_kv is one layer of a PagedKVCache,
        (k_pool, v_pool) or (k_pool, v_pool, k_scales, v_scales); tables
        (B, P) int32 and lengths (B,) on the device; pos/start are
        ignored (see _paged)."""
        cfg = self.cfg
        b, s, _ = x.shape
        d = cfg.head_dim
        q = self.q(x).reshape(b, s, cfg.heads, d)
        k = self.k(x).reshape(b, s, cfg.kv_heads, d)
        v = self.v(x).reshape(b, s, cfg.kv_heads, d)
        if lengths is not None:
            out = self._paged(q, k, v, cache_kv, lengths, tables, n_valid,
                              rotary)
            return self.out(out.reshape(b, s, cfg.heads * d))
        cos_t, sin_t = rotary
        slots = pos + torch.arange(s, device=x.device)
        if start is None:
            cos, sin = cos_t[slots], sin_t[slots]            # (S, D/2)
        else:
            rp = torch.clamp(slots[None, :] - start[:, None], min=0)
            cos, sin = cos_t[rp], sin_t[rp]                  # (B, S, D/2)
        q = _apply_rotary(q, cos, sin)
        k = _apply_rotary(k, cos, sin)
        ck, cv = cache_kv
        ck[:, pos:pos + s] = k
        cv[:, pos:pos + s] = v
        if cfg.flash_min_seq and s >= cfg.flash_min_seq:
            # long-prompt prefill: kernel K4 over the unrepeated cache
            out = causal_flash_attention(q, ck, cv, pos, start)
        else:
            rep = cfg.heads // cfg.kv_heads
            kk = ck.repeat_interleave(rep, dim=2) if rep > 1 else ck
            vv = cv.repeat_interleave(rep, dim=2) if rep > 1 else cv
            if start is None:
                start = torch.zeros(b, dtype=torch.int32, device=x.device)
            out = causal_attention_plain(q, kk, vv, pos, start)
        return self.out(out.reshape(b, s, cfg.heads * d))

    def _paged(self, q, k, v, cache_kv, lengths, tables, n_valid, rotary):
        """Row r's S new tokens sit at ITS OWN positions lengths[r] ..
        lengths[r]+S-1, clamped to the window's last slot (a contract
        violation rewrites the row's last slot instead of wrapping into
        a neighbour's page).  Each token's K/V append into its page of
        the row's table, in place: float pools in one scatter for the
        whole stack, quantized pools token by token (rescale-on-append
        is order-dependent).  Stack positions s >= n_valid (the pad of a
        suffix bucket) append to the trash block, so a pad never grows
        an int8 page's monotone scale.  Then K5 over the pool: S == 1 is
        the decode step, S > 1 the multi-query stack (token t attends
        keys j < lengths[r] + 1 + t).  Returns (B, S, H, D)."""
        cfg = self.cfg
        s = q.shape[1]
        cos_t, sin_t = rotary
        kp, vp = cache_kv[0], cache_kv[1]
        ksc, vsc = (cache_kv[2], cache_kv[3]) if len(cache_kv) == 4 \
            else (None, None)
        page = kp.shape[2]
        steps = torch.arange(s, device=q.device)
        rp = torch.clamp(lengths.long()[:, None] + steps[None],
                         max=cfg.max_len - 1)                    # (B, S)
        q = _apply_rotary(q, cos_t[rp], sin_t[rp])
        k = _apply_rotary(k, cos_t[rp], sin_t[rp])
        bids = torch.gather(tables.long(), 1, rp // page)        # (B, S)
        if n_valid is not None and n_valid < s:
            bids[:, n_valid:] = 0
        offs = rp % page
        if ksc is None:
            # advanced indices around a slice: the (B, S) index dims
            # come first, then (KH, D) — k's own layout
            kp[bids, :, offs] = k.to(kp.dtype)
            vp[bids, :, offs] = v.to(vp.dtype)
        else:
            for i in range(s):
                _quant_append(kp, ksc, bids[:, i], offs[:, i], k[:, i])
                _quant_append(vp, vsc, bids[:, i], offs[:, i], v[:, i])
        att_len = rp[:, 0] + 1
        out = paged_attention(q if s > 1 else q[:, 0], kp, vp, tables,
                              att_len, k_scales=ksc, v_scales=vsc)
        return out if s > 1 else out[:, None]


class DecoderLayer(nn.Module):
    """Pre-norm attention + MLP block.  mlp_cls=None is the dense
    SwiGLU, its gate/up/down projections directly under the layer as in
    the flax tree; a custom mlp_cls (moe.MoeMlp) mounts under the name
    `moe` instead."""

    def __init__(self, cfg: DecoderConfig, mlp_cls=None):
        super().__init__()
        self.mlp_cls = mlp_cls
        self.attn = CausalAttention(cfg)
        self.ln_attn = RMSNorm(cfg.hidden, cfg.rms_eps, cfg.dtype)
        self.ln_mlp = RMSNorm(cfg.hidden, cfg.rms_eps, cfg.dtype)
        if mlp_cls is not None:
            self.moe = mlp_cls(cfg)
            return
        self.gate = _proj(cfg, cfg.hidden, cfg.mlp_dim)
        self.up = _proj(cfg, cfg.hidden, cfg.mlp_dim)
        self.down = _proj(cfg, cfg.mlp_dim, cfg.hidden)

    def forward(self, x, cache_kv, pos, start, rotary, lengths=None,
                tables=None, n_valid=None):
        x = x + self.attn(self.ln_attn(x), cache_kv, pos, start, rotary,
                          lengths, tables, n_valid)
        return x + self.mlp(self.ln_mlp(x))

    def mlp(self, h):
        """The MLP half.  With attn (its out projection), one of the two
        places a tensor-parallel shard returns a PARTIAL sum: the
        sharded trunk (parallel/serve.ShardedDecoder) reduces each
        across its shards before the residual add."""
        if self.mlp_cls is not None:
            return self.moe(h)
        return self.down(F.silu(self.gate(h)) * self.up(h))


class Decoder(nn.Module):
    """Causal LM over a static KV cache; one forward serves prefill
    (S = bucket) and decode (S = 1).  Submodule names mirror the flax
    tree (tok_emb, layer_<i>.{attn.{q,k,v,out},ln_attn,ln_mlp,gate,up,
    down}, ln_out, lm_head), so params_from_jax maps leaf by leaf.  The
    trunk is shared by every decoder family: mlp_cls swaps each layer's
    MLP (moe.MoeDecoder passes MoeMlp, mounted at layer_<i>.moe)."""

    def __init__(self, cfg: DecoderConfig, mlp_cls=None):
        super().__init__()
        self.cfg = cfg
        self.mlp_cls = mlp_cls
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", DecoderLayer(cfg, mlp_cls))
        self.ln_out = RMSNorm(cfg.hidden, cfg.rms_eps, cfg.dtype)
        self.lm_head = nn.Linear(cfg.hidden, cfg.vocab_size, bias=False)
        cos, sin = _rotary_angles(cfg.max_len, cfg.head_dim,
                                  self.lm_head.weight.device, cfg.rope_base)
        self.register_buffer("rot_cos", cos, persistent=False)
        self.register_buffer("rot_sin", sin, persistent=False)

    def layer_modules(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.layers)]

    def forward(self, token_ids, cache, pos: int, start=None, *,
                last: int | None = None, lengths=None, tables=None,
                n_valid: int | None = None):
        """token_ids: (B, S) int; cache: list of per-layer (k, v),
        updated in place; pos: cache slot of token_ids[:, 0]; start:
        optional (B,) left-pad offsets.  Returns (B, S, V) float32
        logits — or (B, 1, V) at chunk position `last` only, which is
        all a prefill samples from (the LM head is row-wise).

        With lengths (B,) and tables (B, P) on the device, cache is a
        PagedKVCache's layers() and the step runs the paged path
        (CausalAttention._paged; n_valid routes pad appends to the trash
        block)."""
        if lengths is None and pos + token_ids.shape[1] > self.cfg.max_len:
            raise ValueError(f"slots {pos}..{pos + token_ids.shape[1] - 1} "
                             f"exceed the {self.cfg.max_len}-slot cache")
        x = self.tok_emb(token_ids)
        rotary = (self.rot_cos, self.rot_sin)
        for layer, kv in zip(self.layer_modules(), cache):
            x = layer(x, kv, pos, start, rotary, lengths, tables, n_valid)
        x = self.ln_out(x)
        if last is not None:
            x = x[:, last:last + 1]
        return self.lm_head(x.float())


def quantize_params(cfg: DecoderConfig, params: dict) -> dict:
    """A float state_dict quantized for cfg's int8 residency (idempotent:
    int8 leaves pass through); unchanged for a float residency."""
    if not (cfg.quantized or cfg.weights_int8):
        return params
    return quantize_state_dict(
        params, QUANT_LEAVES, mode="channel" if cfg.weights_int8 else "block")


@torch.no_grad()
def seat_module(module: Decoder, params: dict | None) -> Decoder:
    """Load `params` (None keeps the weights the module holds), then put
    the projections and the embedding table in the activation dtype; the
    norms and the LM head stay f32 (flax's param/compute dtypes),
    int8-resident projections their codes and f32 scales (MoeMlp keeps
    its own dtypes: an f32 router, experts created in the activation
    dtype).  Returns the module in eval mode without gradients."""
    if params is not None:
        module.load_state_dict(params)
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)) \
                and m is not module.lm_head:
            m.to(module.cfg.dtype)
    return module.eval().requires_grad_(False)


@torch.no_grad()
def init_params(module: Decoder, generator: torch.Generator) -> None:
    """Seeded random init drawn from `generator`: Dense kernels
    normal(0, 1/fan_in) variance, embeddings normal(0, 1/hidden)
    variance, RMSNorm scales at 1; int8-resident projections draw codes
    uniform in [-127, 127] under scales 1 / (127 sqrt(fan_in))."""
    for m in module.modules():
        if hasattr(m, "init_weights"):      # int8 projections, MoeMlp
            m.init_weights(generator)
        elif isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                             generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                             generator=generator)
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)


def params_from_jax(flax_params, cfg: DecoderConfig) -> dict:
    """The weight bridge: a flax decoder tree -> this Decoder's
    state_dict (every flax leaf has a module twin of the same path; the
    quantized leaf sets {q, scale} and {wq, wscale} keep their int8 and
    f32 layouts)."""
    return state_dict_from_flax(flax_params)


# ---------------------------------------------------------------- sampling

def _nucleus_logits(logits, top_p: float, temp: float):
    """The sampler chain's filter over the last axis: descending order
    (stable, ties to the lower id), temperature, and the top-p nucleus
    (always keeps the top token).  Returns (order, masked sorted
    logits), the rest at -inf."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, order) / temp
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    return order, sorted_logits.masked_fill(~keep, -math.inf)


def _sample_rows(generator, logits, top_p: float, temp: float):
    """Per-row sampling shared by every path (prefill tail and the chunk
    loop): logits (B, V) -> (B,) int64 ids, on the logits' device.
    temp <= 0 is greedy (first max on ties); otherwise a Gumbel-max draw
    from the nucleus with uniforms from `generator`."""
    if temp <= 0:
        return torch.argmax(logits, dim=-1)
    order, masked = _nucleus_logits(logits, top_p, temp)
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    choice = torch.argmax(masked + gumbel, dim=-1, keepdim=True)
    return torch.gather(order, -1, choice)[:, 0]


def sample_top_p(generator, logits, *, top_p: float = 0.9,
                 temp: float = 0.7) -> int:
    """The reference's sampler chain on one (V,) logits row."""
    return int(_sample_rows(generator, logits[None], top_p, temp)[0])


def sample_top_p_batch(generator, logits, *, top_p: float = 0.9,
                       temp: float = 0.7):
    """(B, V) logits -> (B,) ids in one pass."""
    return _sample_rows(generator, logits, top_p, temp)


# ------------------------------------------------------------- front end

def _host(t: torch.Tensor, program: str) -> np.ndarray:
    """One device->host copy, then close the program's device window
    (the copy waited for it)."""
    host = t.cpu().numpy()
    close_mark(DEVTIME.take_mark(program))
    return host


class CompletionModel:
    """Bucketed prefill + token-at-a-time decode with a persistent cache
    on one device.

    The generation surface the completion daemon drives:
        logits = model.prefill(prompt_ids)
        tok = model.sample(logits)
        while ...: logits = model.decode_one(tok); tok = model.sample(...)
    and the batched one: prefill_batch / decode_chunk_batch /
    generate_batch over left-padded rows, and the block-paged one the
    continuous lane drives: init_paged / paged_prefill_row /
    paged_append_prefill / paged_decode_chunk(_async).  The caches stay
    on the device between calls; the host sees the sampled ids once per
    chunk.
    """

    # the block-paged continuous lane (PagedKVCache + kernel K5)
    paged_supported = True

    def __init__(self, cfg: DecoderConfig, *, seed: int = 0,
                 buckets: tuple[int, ...] = (64, 128, 256, 512, 1024),
                 params: dict | None = None, weights: str | None = None,
                 top_p: float = 0.9, temp: float = 0.7, device=None,
                 kv_dtype: str | None = None,
                 suffix_buckets: tuple[int, ...] = (16, 64),
                 mlp_cls=None, module: Decoder | None = None):
        """params: a Decoder state_dict (e.g. from params_from_jax);
        weights: a .gguf or .safetensors checkpoint path.  With
        cfg.quantized or cfg.weights_int8 a float state_dict is
        quantized at load (quant.quantize_state_dict, idempotent), so
        checkpoints of either kind serve int8-resident.  device: "cuda"
        (default) or "cpu".  kv_dtype: init_paged's default pool
        storage (None = the activation dtype).  suffix_buckets: the pad
        buckets of paged_append_prefill's stacks (longer suffixes loop
        the largest).  mlp_cls: the trunk's per-layer MLP (moe.MoeMlp;
        None is the dense SwiGLU).  module: an already-built trunk on
        `device` served with the weights it holds (a self-draft's view
        of its target, speculative.self_draft_model): nothing is
        initialised, loaded or cast."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.suffix_buckets = tuple(sorted(
            b for b in suffix_buckets if 0 < b < cfg.max_len)) or (
            min(16, max(1, cfg.max_len - 1)),)
        self.kv_dtype = kv_dtype
        self.buckets = tuple(b for b in buckets if b <= cfg.max_len)
        if not self.buckets or self.buckets[-1] < cfg.max_len:
            # a prompt longer than the largest bucket (but inside the
            # window) must still have a shape to land in
            self.buckets = self.buckets + (cfg.max_len,)
        self.top_p, self.temp = top_p, temp
        if cfg.quantized and cfg.weights_int8:
            raise ValueError(
                "quantized (Q8_0 blocks) and weights_int8 (per-channel) "
                "are two residencies for the same projections — pick one")
        if module is not None:
            if params is not None or weights is not None:
                raise ValueError("module= serves the weights the module "
                                 "holds: pass no params or weights")
            self.module = module
        else:
            if params is None and weights is not None:
                if weights.endswith(".gguf"):
                    from .gguf import load_decoder_params
                    params = load_decoder_params(weights, cfg)
                else:
                    params = load_safetensors_params(weights, cfg)
            self.module = self._build(cfg, seed, params, mlp_cls)
        self._fn = DEVTIME.register("completer.trunk", self._forward)
        self._chunk_fn = DEVTIME.register("completer.chunk", self._chunk)
        self._commit_fn = DEVTIME.register("completer.paged_commit",
                                           self._paged_commit)
        self._suffix_fn = DEVTIME.register("completer.suffix_prefill",
                                           self._paged_suffix)
        self._paged_chunk_fn = DEVTIME.register("completer.paged_chunk",
                                                self._paged_chunk)
        self._cow_fn = DEVTIME.register("completer.cow_copy",
                                        self._cow_copy)
        self._export_fn = DEVTIME.register("completer.page_export",
                                           self._page_export)
        self._import_fn = DEVTIME.register("completer.page_import",
                                           self._page_import)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 1)
        self._cache = None
        self._pos = 0
        self._start = None            # (B,) left-pad offsets when batched
        self._batch = 0
        self._shapes: set[tuple] = set()

    def _build(self, cfg: DecoderConfig, seed: int, params, mlp_cls):
        """The trunk on this model's device: seeded or loaded weights,
        a float state_dict quantized first for an int8 residency."""
        with torch.device(self.device):
            module = Decoder(cfg, mlp_cls)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            init_params(module, gen)
            return seat_module(module, None)
        return seat_module(module, quantize_params(cfg, params))

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def reset(self) -> None:
        """llama_memory_clear analog (splainference.cpp:378)."""
        self._cache = None
        self._pos = 0
        self._start = None
        self._batch = 0

    @property
    def pos(self) -> int:
        return self._pos

    def compile_count(self) -> int:
        """Distinct (program, shape) pairs run, the paged programs
        included — PyTorch has no jit cache, so this is the shape-leak
        signal: a count still growing after warmup means some serving
        geometry escapes the bucket set."""
        return len(self._shapes)

    # -- cache layout hooks (parallel/serve.ShardedCompletionModel keeps
    # one cache per shard and overrides these) ---------------------------

    def _fresh_cache(self, batch: int):
        """A zeroed dense cache of `batch` rows for the trunk."""
        return init_cache(self.cfg, batch, self.device)

    def _row_cache(self, row: int):
        """Views of one row of the live batched cache; the trunk writes
        through them."""
        return [(k[row:row + 1], v[row:row + 1]) for k, v in self._cache]

    def _cache_rows(self) -> int:
        return self._cache[0][0].shape[0]

    def _paged_scratch(self, bucket: int):
        """A paged prefill's (1, bucket) dense scratch cache."""
        return init_cache(dataclasses.replace(self.cfg, max_len=bucket), 1,
                          self.device)

    def _pool_shards(self):
        """(device, head position) of each paged pool; None: one whole
        pool on the model's device."""
        return None

    def _per_shard(self, cache) -> list:
        """A dense cache as a list of per-shard caches."""
        return [cache]

    def _ids(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(
            self.device)

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """A private device copy of a host array the caller goes on
        mutating (the paged tables and lengths change while chunks are
        in flight): staged through pinned memory and copied
        asynchronously on the current stream, so the dispatch never
        waits for the device (PyTorch's pinned-memory allocator holds
        the staging block until the copy has run).  The pinned copy is
        the snapshot; on the CPU the array is copied outright."""
        if self.device.type == "cuda":
            return torch.from_numpy(arr).pin_memory().to(self.device,
                                                         non_blocking=True)
        return torch.from_numpy(np.array(arr, copy=True))

    @torch.no_grad()
    def _forward(self, ids, cache, pos: int, start=None, last=None):
        self._shapes.add(("trunk", *ids.shape))
        return self.module(ids, cache, pos, start, last=last)

    def prefill(self, prompt_ids: np.ndarray) -> np.ndarray:
        """prompt_ids: (P,) int, 0 < P < max_len.  Pads to a bucket, runs
        one prefill, returns the last real token's logits (V,) f32."""
        n = len(prompt_ids)
        if n == 0:
            raise ValueError("empty prompt")
        if n >= self.cfg.max_len:
            raise ValueError("prompt exceeds context window")
        b = self.bucket_for(n)
        ids = np.zeros((1, b), np.int64)
        ids[0, :n] = prompt_ids
        # slots n..b-1 hold pad-token K/V, but a query at slot p attends
        # only j <= p, and every slot <= p is rewritten with real data
        # before the first query that could see it
        self._cache = self._fresh_cache(1)
        logits = self._fn(self._ids(ids), self._cache, 0, last=n - 1)
        self._pos, self._start, self._batch = n, None, 1
        return _host(logits[0, 0], "completer.trunk")

    def decode_one(self, token: int) -> np.ndarray:
        """Append one token at the current position; returns logits (V,)."""
        if self._cache is None:
            raise RuntimeError("prefill first")
        if self._pos >= self.cfg.max_len:
            raise RuntimeError("context window full")
        ids = torch.full((1, 1), int(token), dtype=torch.int64,
                         device=self.device)
        logits = self._fn(ids, self._cache, self._pos)
        self._pos += 1
        return _host(logits[0, 0], "completer.trunk")

    def sample(self, logits: np.ndarray) -> int:
        return sample_top_p(self._gen, torch.from_numpy(logits).to(
            self.device), top_p=self.top_p, temp=self.temp)

    def sample_batch(self, logits: np.ndarray) -> np.ndarray:
        """(B, V) logits -> (B,) sampled ids."""
        ids = sample_top_p_batch(self._gen, torch.from_numpy(logits).to(
            self.device), top_p=self.top_p, temp=self.temp)
        return ids.cpu().numpy().astype(np.int32)

    # -- chunked decode (the tokens/sec path) -----------------------------

    @torch.no_grad()
    def _chunk(self, toks, n: int):
        """n decode steps for the (bp,) token column `toks` on the
        device: per step, forward one token per row at the next slot and
        sample the next in place (the same sampler as the prefill tail).
        Nothing reaches the host inside the loop; returns (bp, n) ids."""
        self._shapes.add(("chunk", n, toks.shape[0]))
        out = torch.empty((toks.shape[0], n), dtype=torch.int64,
                          device=self.device)
        for i in range(n):
            logits = self.module(toks[:, None], self._cache, self._pos + i,
                                 self._start)
            toks = _sample_rows(self._gen, logits[:, 0], self.top_p,
                                self.temp)
            out[:, i] = toks
        return out

    def decode_chunk(self, token: int, n: int) -> np.ndarray:
        """Append `token`, then decode and sample n tokens on the device
        with one host sync.  Returns the n sampled ids.  A mid-chunk EOG
        wastes at most n-1 speculative steps (their cache slots lie past
        the final position and are reset with the request)."""
        if self._cache is None:
            raise RuntimeError("prefill first")
        if self._pos + n > self.cfg.max_len:
            raise RuntimeError("context window full")
        toks = torch.tensor([int(token)], dtype=torch.int64,
                            device=self.device)
        out = self._chunk_fn(toks, n)
        self._pos += n
        return _host(out[0], "completer.chunk")

    def generate_tokens(self, prompt_ids: np.ndarray, max_new: int,
                        *, chunk: int = 8, eos_id: int | None = None):
        """Generator of sampled token ids: bucketed prefill, then
        chunk-at-a-time on-device decode (single-token steps near the
        window/budget tail).

        With eos_id=None the generator keeps yielding the chunk's
        SPECULATIVE tokens after an end-of-generation token — the
        consumer detects its own stop condition and breaks (the
        completion daemon does).  Pass eos_id to stop right after
        yielding that token."""
        logits = self.prefill(np.asarray(prompt_ids, np.int32))
        tok = self.sample(logits)
        yield int(tok)
        if eos_id is not None and tok == eos_id:
            return
        produced = 1
        while produced < max_new:
            room = min(self.cfg.max_len - self._pos, max_new - produced)
            if room <= 0:
                break
            if room < chunk:
                logits = self.decode_one(tok)
                tok = self.sample(logits)
                yield int(tok)
                if eos_id is not None and tok == eos_id:
                    return
                produced += 1
                continue
            toks = self.decode_chunk(tok, chunk)
            for t in toks:
                yield int(t)
                if eos_id is not None and int(t) == eos_id:
                    return
            tok = int(toks[-1])
            produced += chunk

    # -- batched generation (the aggregate-throughput path) ----------------
    #
    # Batched serving left-pads the prompts into one bucket so every
    # row's NEXT slot is uniform: row r's tokens occupy slots
    # [bucket - P_r, bucket) and decode proceeds at slot bucket,
    # bucket+1, ... for all rows at once — only the positions need the
    # per-row offsets (`start`).

    def prefill_batch(self, prompts: list[np.ndarray]) -> np.ndarray:
        """Left-padded batched prefill.  prompts: list of (P_i,) int,
        each 0 < P_i < max_len.  Returns the last real token's logits
        per row, (B, vocab) float32."""
        n_rows = len(prompts)
        if n_rows == 0:
            raise ValueError("empty batch")
        lens = [len(p) for p in prompts]
        if min(lens) == 0:
            raise ValueError("empty prompt")
        if max(lens) >= self.cfg.max_len:
            raise ValueError("prompt exceeds context window")
        b = self.bucket_for(max(lens))
        bp = 1 << max(n_rows - 1, 0).bit_length()   # batch power-of-two pad
        ids = np.zeros((bp, b), np.int64)
        start = np.full((bp,), b, np.int32)          # pad rows: no real slots
        for r, p in enumerate(prompts):
            ids[r, b - lens[r]:] = p
            start[r] = b - lens[r]
        self._cache = self._fresh_cache(bp)
        self._start = torch.from_numpy(start).to(self.device)
        # every row's last REAL token sits in the last slot (left pad)
        logits = self._fn(self._ids(ids), self._cache, 0, self._start,
                          last=b - 1)
        self._pos, self._batch = b, n_rows
        return _host(logits[:n_rows, 0], "completer.trunk")

    def decode_chunk_batch(self, tokens: np.ndarray, n: int) -> np.ndarray:
        """Append tokens (B,), decode+sample n steps on the device for
        the whole batch.  Returns (B, n) sampled ids.  Rows that already
        finished keep decoding speculatively — the caller discards."""
        if self._cache is None or self._start is None:
            raise RuntimeError("prefill_batch first")
        if self._pos + n > self.cfg.max_len:
            raise RuntimeError("context window full")
        toks = np.zeros((self._cache_rows(),), np.int64)
        toks[: self._batch] = np.asarray(tokens, np.int64)
        out = self._chunk_fn(self._ids(toks), n)
        self._pos += n
        return _host(out[: self._batch], "completer.chunk")

    def join_row(self, prompt_ids: np.ndarray, row: int) -> np.ndarray:
        """Prefill `prompt_ids` into row `row` of the live batched cache,
        ending at the current decode position.  The prompt is clipped to
        the most recent tokens that fit the widest bucket at or below
        the position (a joiner cannot reach behind the batch's shared
        window).  Updates the row's start offset; returns its last-token
        logits (V,) for sampling its first output token."""
        if self._cache is None or self._start is None:
            raise RuntimeError("prefill_batch first")
        n = len(prompt_ids)
        if n == 0:
            raise ValueError("empty prompt")
        fit = [bb for bb in self.buckets if bb <= self._pos]
        b = next((bb for bb in fit if bb >= n), fit[-1])
        if n > b:
            prompt_ids = prompt_ids[-b:]      # keep recent context
            n = b
        ids = np.zeros((1, b), np.int64)
        ids[0, b - n:] = prompt_ids[-n:]
        start_row = torch.tensor([self._pos - n], dtype=torch.int32,
                                 device=self.device)
        # row views of the batch cache: the forward writes through them
        logits = self._fn(self._ids(ids), self._row_cache(row), self._pos - b,
                          start_row, last=b - 1)
        self._start[row] = self._pos - n
        return _host(logits[0, 0], "completer.trunk")

    def join_budget(self) -> int:
        """Largest prompt a joiner can bring into the live batch without
        losing context: the widest bucket at or below the current decode
        position."""
        if self._cache is None:
            return 0
        return max((b for b in self.buckets if b <= self._pos), default=0)

    def generate_batch(self, prompts: list[np.ndarray], max_new: int,
                       *, chunk: int = 8):
        """Generator over token COLUMNS for a batch of prompts: first the
        (B,) post-prefill samples, then one (B,) column per decoded
        step, chunk steps per host sync.  Rows past their stop
        condition yield speculative tokens — the consumer tracks per-row
        completion and discards (as generate_tokens with eos_id=None)."""
        logits = self.prefill_batch(prompts)
        toks = self.sample_batch(logits)
        yield toks.copy()
        produced = 1
        while produced < max_new:
            room = min(self.cfg.max_len - self._pos, max_new - produced)
            if room <= 0:
                break
            step = min(chunk, room)
            block = self.decode_chunk_batch(toks, step)   # (B, step)
            for c in range(step):
                yield block[:, c].copy()
            toks = block[:, -1].astype(np.int32)
            produced += step

    def warmup(self, chunk: int = 8, batch: int = 1) -> None:
        """Run every prefill bucket, decode-one and the chunked decode
        once off the serving path; batch > 1 also runs the batched
        shapes (prefill_batch per bucket + the batched chunk)."""
        with DEVTIME.warmup_phase():
            for b in self.buckets:
                self.prefill(np.ones((max(1, b - 1),), np.int32))
                self.decode_one(1)
            # the loop leaves the position at max_len, where no chunk
            # fits: re-prefill short so the chunk shape runs too
            self.reset()
            self.prefill(np.ones((max(1, self.buckets[0] - 1),), np.int32))
            if self._pos + chunk <= self.cfg.max_len:
                self.decode_chunk(1, chunk)
            self.reset()
            if batch > 1:
                chunk_done = False
                for b in self.buckets:
                    n = max(1, b - 1)
                    self.prefill_batch([np.ones((n,), np.int32)] * batch)
                    if not chunk_done and b + chunk <= self.cfg.max_len:
                        self.decode_chunk_batch(
                            np.ones((batch,), np.int32), chunk)
                        chunk_done = True
                    self.reset()

    # -- block-paged serving (the continuous lane) --------------------------
    #
    # Each row has its own logical positions 0..len-1 in pages of a
    # global pool (PagedKVCache): a joiner prefills into freshly
    # allocated pages at any time with its full context, and a finished
    # row's pages return to the pool at once.  A prompt prefills through
    # the dense trunk over a bucket-sized scratch cache (K4 on buckets of
    # 512 and up), then one commit scatter writes the rows into pages;
    # decode steps and prefix-cache suffix stacks attend through K5 over
    # the pool in place.

    def init_paged(self, batch: int, *, page: int = 128,
                   pool_pages: int | None = None,
                   kv_dtype: str | None = None) -> PagedKVCache:
        """A fresh pool on this model's device serving `batch` rows; the
        default holds batch full windows.  kv_dtype None defers to the
        constructor's kv_dtype."""
        return PagedKVCache(self.cfg, batch, page=page,
                            pool_pages=pool_pages,
                            kv_dtype=(self.kv_dtype if kv_dtype is None
                                      else kv_dtype),
                            device=self.device, shards=self._pool_shards())

    @torch.no_grad()
    def _paged_commit(self, cache: PagedKVCache, dense, bids, n_valid: int):
        """Scatter a (1, bucket) dense prefill cache into pool pages at
        `bids` (the row's first ceil(bucket / page) table entries; the
        trash block past its pages), in place.  The tail of the last
        page holds garbage the length mask hides until decode appends
        overwrite it.  Quantized pools quantize here: rows past the
        prompt's n_valid are zeroed first (pad K/V would inflate the
        page scale), then each (page, kv head) gets d = absmax / qmax
        and its codes (int4: packed two per byte)."""
        dense = self._per_shard(dense)
        bucket, page = dense[0][0][0].shape[1], cache.page
        self._shapes.add(("paged_commit", bucket, page, cache.kv_dtype))
        n_cp = -(-bucket // page)
        pad = n_cp * page - bucket
        qmax = INT4_QMAX if cache.packed else 127.0

        def blocks(x, keep):
            x = x[0]                                   # (bucket, KH, D)
            if keep is not None:
                x = x.masked_fill(~keep[:, None, None], 0)
            if pad:
                x = F.pad(x, (0, 0, 0, 0, 0, pad))
            return x.reshape(n_cp, page, x.shape[1], -1).transpose(1, 2)

        # each shard's pools from its own scratch, at its own kv heads
        for pools, scratch in zip(cache.pools, dense):
            b_ids = bids.to(pools.device)
            keep = torch.arange(bucket, device=pools.device) < n_valid
            for li, kv in enumerate(pools.layers()):
                for x, pool, scales in ((scratch[li][0], kv[0], kv[2:3]),
                                        (scratch[li][1], kv[1], kv[3:4])):
                    if not cache.quantized:
                        pool[b_ids] = blocks(x, None).to(pool.dtype)
                        continue
                    xb = blocks(x, keep).float()
                    d = xb.abs().amax(dim=(2, 3)) / qmax
                    codes = torch.clamp(torch.round(
                        xb / torch.where(d > 0, d, 1.0)[:, :, None, None]),
                        -qmax, qmax)
                    pool[b_ids] = (pack_int4(codes) if cache.packed
                                   else codes.to(torch.int8))
                    scales[0][b_ids] = d
        return bids      # a device result, as the devtime wrapper expects

    def paged_prefill_row(self, cache: PagedKVCache,
                          prompt_ids: np.ndarray, row: int) -> np.ndarray:
        """Prefill one row's prompt into its pages: bucketed dense
        prefill over a (1, bucket) scratch cache, then the commit
        scatter.  The row keeps its FULL prompt (callers clip only to
        the window budget).  Returns the last real token's logits (V,)
        for sampling the first output token."""
        cfg = self.cfg
        n = len(prompt_ids)
        if n == 0:
            raise ValueError("empty prompt")
        if n >= cfg.max_len:
            raise ValueError("prompt exceeds context window")
        if not cache.ensure(row, n):
            raise RuntimeError(
                f"paged pool exhausted: row {row} needs "
                f"{cache.pages_needed(n)} pages, {cache.free_pages} free")
        b = self.bucket_for(n)
        ids = np.zeros((1, b), np.int64)
        ids[0, :n] = np.asarray(prompt_ids[:n], np.int64)
        # a bucket-sized scratch (not max_len): the trunk runs at T = b
        scratch = self._paged_scratch(b)
        logits = self._fn(self._ids(ids), scratch, 0, last=n - 1)
        # table entries past the prompt's pages are 0 (trash) or the
        # row's reserved decode pages: the bucket's pad rows land there
        # and decode appends overwrite them before any query sees them
        n_cp = -(-b // cache.page)
        bids = self._h2d(cache.tables[row, :n_cp].astype(np.int64))
        self._commit_fn(cache, scratch, bids, n)
        cache.lengths[row] = n
        return _host(logits[0, 0], "completer.trunk")

    # The radix prefix cache (engine/prefix_cache.py) turns a shared
    # prompt prefix into a host-side table write (map_shared); only the
    # uncached suffix runs a forward, attending over the mapped pages
    # through K5's multi-query stack.  A fully cached prompt prefills
    # nothing: the row enters at lengths = P-1 and the first decode
    # chunk replays the last prompt token, whose append lands in the
    # shared tail page and so takes the copy-on-write below.

    @torch.no_grad()
    def _paged_suffix(self, cache: PagedKVCache, ids, table, lengths,
                      n_valid: int):
        """Append a (1, sb) suffix stack into a row's pages (positions
        lengths..lengths+n_valid-1; pads to the trash block) and attend
        through K5; returns the last valid token's logits (V,)."""
        self._shapes.add(("suffix", ids.shape[1], cache.kv_dtype))
        logits = self.module(ids, cache.layers(), 0, lengths=lengths,
                             tables=table, n_valid=n_valid,
                             last=n_valid - 1)
        return logits[0, 0]

    def paged_append_prefill(self, cache: PagedKVCache, suffix_ids,
                             row: int) -> np.ndarray:
        """Prefill ONLY the uncached suffix of row's prompt atop the
        cache.lengths[row] tokens its table already maps, in stacks of
        the suffix buckets (longer suffixes loop the largest).  Returns
        the last real token's logits (V,)."""
        ids = np.asarray(suffix_ids, np.int64)
        if ids.size == 0:
            raise ValueError("empty suffix")
        pos = int(cache.lengths[row])
        if pos + ids.size >= self.cfg.max_len:
            raise ValueError("suffix exceeds context window")
        if not cache.ensure(row, pos + ids.size):
            raise RuntimeError(
                f"paged pool exhausted: row {row} suffix needs "
                f"{cache.pages_needed(pos + ids.size)} pages")
        table = self._h2d(cache.tables[row: row + 1])
        logits = None
        off = 0
        while off < ids.size:
            rem = ids.size - off
            sb = next((b for b in self.suffix_buckets if b >= rem),
                      self.suffix_buckets[-1])
            n = min(rem, sb)
            chunk = np.zeros((1, sb), np.int64)
            chunk[0, :n] = ids[off: off + n]
            logits = self._suffix_fn(cache, self._ids(chunk), table,
                                     self._h2d(cache.lengths[row: row + 1]),
                                     n)
            cache.lengths[row] += n
            off += n
        return _host(logits, "completer.suffix_prefill")

    @torch.no_grad()
    def _cow_copy(self, cache: PagedKVCache, src: int, dst: int):
        """Duplicate pool page `src` into `dst` across every layer and
        side (and the scales), in place — the device half of a
        copy-on-write, queued before the table swap."""
        self._shapes.add(("cow", cache.kv_dtype))
        for shard in cache.pools:       # one block id, every shard's pool
            for p in shard.tensors():
                p[dst] = p[src]
        return cache.k_pools[0][dst]   # a device result, as for the commit

    def _cow_fixups(self, cache: PagedKVCache) -> int:
        """Copy-on-write pass before a decode dispatch: every row whose
        next append would write into a shared or tree-frozen page gets a
        private copy first.  Returns pages copied."""
        n = 0
        for row, p_idx in cache.cow_targets():
            src = int(cache.tables[row, p_idx])
            dst = cache._alloc_page()
            self._cow_fn(cache, src, dst)
            cache.commit_cow(row, p_idx, dst)
            n += 1
        return n

    @torch.no_grad()
    def _paged_chunk(self, cache: PagedKVCache, tables, lengths, toks,
                     n: int):
        """n paged decode steps for every row of the pool: per step,
        append one token per row into its pages, K5, and sample on the
        device.  Returns (n, batch) ids; nothing reaches the host."""
        self._shapes.add(("paged_chunk", n, cache.batch, cache.kv_dtype))
        out = torch.empty((n, toks.shape[0]), dtype=torch.int64,
                          device=self.device)
        layers = cache.layers()
        for i in range(n):
            logits = self.module(toks[:, None], layers, 0, lengths=lengths,
                                 tables=tables)
            toks = _sample_rows(self._gen, logits[:, 0], self.top_p,
                                self.temp)
            out[i] = toks
            lengths = lengths + 1
        return out

    def paged_decode_chunk(self, cache: PagedKVCache, tokens, n: int
                           ) -> np.ndarray:
        """Append tokens (batch,), decode and sample n steps for every
        row of the pool.  Rows with lengths == 0 are dead: they decode
        into the trash block and the caller discards their column.
        Returns (batch, n) sampled ids."""
        return self.paged_decode_chunk_async(cache, tokens, n).block()

    def paged_decode_chunk_async(self, cache: PagedKVCache, tokens,
                                 n: int, carry=None) -> PendingChunk:
        """Dispatch a decode chunk without waiting for it.  `tokens`
        (batch,) host ids: with carry=None every row reads its first
        input from them; with carry (the previous PendingChunk.last, a
        device column) only rows with tokens[r] >= 0 do (a joiner's
        prefill sample) and the rest take the carry, so chained chunks
        cost no host round trip.  The tables and lengths go to the
        device as private copies taken here; host lengths advance at
        dispatch, so window checks already count in-flight chunks."""
        bp = cache.batch
        for r in range(bp):
            length = int(cache.lengths[r])
            if length > 0 and not cache.ensure(
                    r, min(length + n, self.cfg.max_len)):
                raise RuntimeError(
                    f"paged pool exhausted mid-decode: row {r} "
                    f"(admission must reserve prompt + max_new)")
        # copy-on-write BEFORE the tables snapshot below
        self._cow_fixups(cache)
        toks = np.full((bp,), -1, np.int64)
        toks[: len(tokens)] = np.asarray(tokens, np.int64)
        fresh_mask = np.ones((bp,), bool) if carry is None else toks >= 0
        toks = np.maximum(toks, 0)
        toks_t = self._h2d(toks)
        if carry is not None:
            toks_t = torch.where(self._h2d(fresh_mask), toks_t, carry)
        out = self._paged_chunk_fn(cache, self._h2d(cache.tables),
                                   self._h2d(cache.lengths), toks_t, n)
        live = cache.lengths > 0
        cache.lengths[live] = np.minimum(cache.lengths[live] + n,
                                         self.cfg.max_len)
        return PendingChunk(out, out[-1], n,
                            mark=DEVTIME.take_mark("completer.paged_chunk"))

    def warmup_paged(self, cache: PagedKVCache, chunk: int = 8,
                     max_prompt: int | None = None) -> None:
        """Run every paged program the continuous lane's hot path
        touches — per-bucket prefill + commit scatter, the sampler, the
        chunked paged decode, and with a prefix cache attached the
        suffix stacks and the COW copy — so compile_count stays flat
        across join/finish/join cycles.  max_prompt bounds the bucket
        sweep (no bucket above bucket_for(max_prompt) is ever used)."""
        with DEVTIME.warmup_phase():
            cap = (self.bucket_for(max_prompt) if max_prompt is not None
                   else self.buckets[-1])
            chunk_done = False
            for b in self.buckets:
                if b > cap:
                    break
                n = max(1, min(b, self.cfg.max_len) - 1)
                logits = self.paged_prefill_row(
                    cache, np.ones((n,), np.int32), 0)
                self.sample(logits)
                if not chunk_done and n + chunk < self.cfg.max_len:
                    self.paged_decode_chunk(
                        cache, np.ones((cache.batch,), np.int32), chunk)
                    chunk_done = True
                cache.free_row(0)
            if cache.prefix_cache is not None:
                for sb in self.suffix_buckets:
                    if sb + chunk >= self.cfg.max_len:
                        break
                    self.paged_append_prefill(
                        cache, np.ones((sb,), np.int32), 0)
                    cache.free_row(0)
                src, dst = cache._alloc_page(), cache._alloc_page()
                self._cow_fn(cache, src, dst)
                cache._decref(src)
                cache._decref(dst)

    # -- the page wire --------------------------------------------------------
    #
    # The host-DRAM KV tier demotes and readmits pool pages through it
    # (engine/kv_tier.py), and the disaggregated lanes hand rows from the
    # prefill pool to the decode pool through it (engine/disagg.py).  A
    # wire page is one pool page across every layer: the k stack then the
    # v stack, each (layers, KH, page, D_store) in the pool's own storage
    # (bf16 as its two raw bytes, int4 as the packed bytes); a quantized
    # pool's scales ride apart as (layers, KH) f32 for k, then for v.  The
    # layout is the JAX package's, so a JAX prefill lane's handoff adopts
    # here and tier snapshots of either package carry the same geometry.
    # One gather or scatter per page, as in the JAX package.

    def _page_wire_dtype(self, cache: PagedKVCache) -> str:
        """The pool's storage dtype under numpy's name — "bfloat16",
        "float32", "int8", or "uint8" for int4-packed pools — as the JAX
        model's str(np.dtype) reads (tier snapshots record it)."""
        if cache.quantized:
            return "uint8" if cache.packed else "int8"
        return str(cache.k_pools[0].dtype).removeprefix("torch.")

    def _page_wire_shape(self, cache: PagedKVCache) -> tuple[int, ...]:
        """One side's stacked wire-page shape, read from the pool (last
        axis head_dim / 2 for int4-packed pools)."""
        return (self.cfg.layers, self.cfg.kv_heads, cache.page,
                int(cache.k_pools[0].shape[3]))

    def page_wire_bytes(self, cache: PagedKVCache) -> int:
        """Bytes one exported page occupies on the wire (k + v values
        across every layer; quantized scales ride apart)."""
        return (2 * cache.k_pools[0].element_size()
                * math.prod(self._page_wire_shape(cache)))

    @torch.no_grad()
    def _page_export(self, cache: PagedKVCache, bid: int):
        """Pool page `bid` across every layer: (2 layers, KH, page, D)
        values, k layers first, and for quantized pools (2 layers, KH)
        f32 scales.  A sharded pool's kv-head slices are gathered in
        head order onto the model's device, so the wire page is the
        unsharded pool's byte for byte."""
        vals, scales = [], []
        for shard in cache.head_order():
            vals.append(torch.stack([p[bid] for p in (*shard.k_pools,
                                                      *shard.v_pools)]))
            if cache.quantized:
                scales.append(torch.stack([s[bid] for s in (
                    *shard.k_scales, *shard.v_scales)]))

        def gather(parts):
            if len(parts) == 1:
                return parts[0]
            return torch.cat([p.to(self.device) for p in parts], dim=1)

        return gather(vals), gather(scales) if scales else None

    @torch.no_grad()
    def _page_import(self, cache: PagedKVCache, bid: int, vals, scales):
        """Scatter one wire page's stacks (as _page_export returns them)
        into pool page `bid`, in place: each shard takes its kv-head
        slice (replicas of a slice each take a copy)."""
        n_layers = self.cfg.layers
        kh = vals.shape[1] // cache.head_shards
        for shard in cache.pools:
            lo = shard.head_pos * kh
            sv = vals[:, lo:lo + kh].to(shard.device)
            ss = (None if scales is None else
                  scales[:, lo:lo + kh].to(shard.device))
            for li in range(n_layers):
                shard.k_pools[li][bid] = sv[li]
                shard.v_pools[li][bid] = sv[n_layers + li]
                if ss is not None:
                    shard.k_scales[li][bid] = ss[li]
                    shard.v_scales[li][bid] = ss[n_layers + li]
        return vals

    def export_page_bytes(self, cache: PagedKVCache, bid: int
                          ) -> tuple[bytes, bytes | None]:
        """Host copy of ONE pool page: (k stack then v stack bytes, the
        scale stacks' bytes or None for float pools) — the tier's
        demotion copy and one page of a handoff."""
        vals, scales = self._export_fn(cache, int(bid))
        page = _host(vals.view(torch.uint8), "completer.page_export")
        return (page.tobytes(),
                None if scales is None else scales.cpu().numpy().tobytes())

    def export_row_pages(self, cache: PagedKVCache, row: int
                         ) -> tuple[list[bytes], list[bytes | None]]:
        """Host copies of every page `row`'s table maps, in table order:
        (page bytes, scale bytes or None) lists.  The partial last page
        is exported whole — adoption masks by length, as K5 does."""
        pages: list[bytes] = []
        scales: list[bytes | None] = []
        for p_idx in range(len(cache._owned[row])):
            buf, sbuf = self.export_page_bytes(
                cache, int(cache.tables[row, p_idx]))
            pages.append(buf)
            scales.append(sbuf)
        return pages, scales

    def _wire_to_device(self, cache: PagedKVCache, buf: bytes,
                        sbuf: bytes | None):
        """One wire page's bytes as device stacks shaped for
        _page_import (the sizes were checked by the caller)."""
        n_layers, kh = self._page_wire_shape(cache)[:2]
        shape = (2 * n_layers, *self._page_wire_shape(cache)[1:])
        vals = self._h2d(np.frombuffer(buf, np.uint8).copy()).view(
            cache.k_pools[0].dtype).reshape(shape)
        if sbuf is None:
            return vals, None
        return vals, self._h2d(np.frombuffer(sbuf, np.float32).copy()
                               ).reshape(2 * n_layers, kh)

    def _scale_wire_bytes(self) -> int:
        """Bytes of one side's (layers, KH) f32 scale stack."""
        return self.cfg.layers * self.cfg.kv_heads * 4

    def import_page_bytes(self, cache: PagedKVCache, bid: int,
                          buf: bytes, sbuf: bytes | None = None) -> None:
        """Scatter one wire page's host bytes into pool page `bid` — the
        tier's READMISSION: a host-DRAM hit becomes this copy plus a
        block-table write instead of a re-prefill."""
        want = self.page_wire_bytes(cache)
        if len(buf) != want:
            raise ValueError(
                f"tier page holds {len(buf)} bytes, expected {want}")
        if cache.quantized:
            sn = self._scale_wire_bytes()
            if sbuf is None or len(sbuf) != 2 * sn:
                raise ValueError(
                    f"tier scales hold {0 if sbuf is None else len(sbuf)} "
                    f"bytes, expected {2 * sn}")
        else:
            sbuf = None
        self._import_fn(cache, int(bid),
                        *self._wire_to_device(cache, buf, sbuf))

    def paged_adopt_row(self, cache: PagedKVCache, row: int, length: int,
                        pages: list[bytes],
                        scales: list[bytes | None] | None = None) -> bool:
        """Seat a handed-off row into THIS pool: grow its table to cover
        `length` tokens (all or nothing), scatter each wire page into its
        block, set the row's length.  Returns False — nothing imported —
        when the pool cannot hold the row (adoption backpressure: the
        row stays DECODE_READY).  The caller reserves the row's worst
        case (prompt + max_new) afterwards, as for paged_prefill_row."""
        need = cache.pages_needed(length)
        if len(pages) < need:
            raise ValueError(
                f"handoff for row {row} carries {len(pages)} pages, "
                f"{need} needed to cover {length} tokens")
        if not cache.ensure(row, length):
            return False
        want = self.page_wire_bytes(cache)
        sn = self._scale_wire_bytes()
        for p_idx in range(need):
            buf = pages[p_idx]
            if len(buf) != want:
                raise ValueError(
                    f"wire page {p_idx} holds {len(buf)} bytes, "
                    f"expected {want}")
            sbuf = None
            if cache.quantized:
                sbuf = (scales or [None] * need)[p_idx] or b""
                if len(sbuf) != 2 * sn:
                    raise ValueError(
                        f"wire scales {p_idx} hold {len(sbuf)} bytes, "
                        f"expected {2 * sn}")
            self._import_fn(cache, int(cache.tables[row, p_idx]),
                            *self._wire_to_device(cache, buf, sbuf))
        cache.lengths[row] = int(length)
        return True

    def warmup_handoff(self, cache: PagedKVCache, *, export: bool = True,
                       adopt: bool = True) -> None:
        """Run the wire's export and import once on a scratch page, so
        their first serving call adds no new shape (PyTorch has nothing
        to compile; the JAX package's signature is kept)."""
        with DEVTIME.warmup_phase():
            bid = cache._alloc_page()
            try:
                if export:
                    self.export_page_bytes(cache, bid)
                if adopt:
                    zeros = bytes(self.page_wire_bytes(cache))
                    self.import_page_bytes(
                        cache, bid, zeros,
                        bytes(2 * self._scale_wire_bytes())
                        if cache.quantized else None)
            finally:
                cache._decref(bid)


# ------------------------------------------------------ checkpoint loading

def _hf_names(cfg: DecoderConfig) -> dict[str, str]:
    """This Decoder's state_dict names -> HF llama-family tensor names
    (model.embed_tokens, model.layers.{i}.self_attn.{q,k,v,o}_proj,
    mlp.{gate,up,down}_proj, input/post_attention_layernorm,
    model.norm, lm_head).  Both sides keep Linear weights (out, in)."""
    names = {"tok_emb.weight": "model.embed_tokens.weight",
             "ln_out.weight": "model.norm.weight",
             "lm_head.weight": "lm_head.weight"}
    for i in range(cfg.layers):
        n, p = f"model.layers.{i}", f"layer_{i}"
        names[f"{p}.ln_attn.weight"] = f"{n}.input_layernorm.weight"
        names[f"{p}.ln_mlp.weight"] = f"{n}.post_attention_layernorm.weight"
        for src, dst in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("out", "o_proj")):
            names[f"{p}.attn.{src}.weight"] = f"{n}.self_attn.{dst}.weight"
        for m in ("gate", "up", "down"):
            names[f"{p}.{m}.weight"] = f"{n}.mlp.{m}_proj.weight"
    return names


def load_safetensors_params(path: str, cfg: DecoderConfig) -> dict:
    """Map a HF llama-family safetensors checkpoint onto this Decoder's
    state_dict; the LM head ties to the embeddings when the file has
    none, and padded-vocab exports are cut to cfg.vocab_size."""
    tensors = read_safetensors(path)
    sd: dict[str, torch.Tensor] = {}
    for name, hf in _hf_names(cfg).items():
        if hf == "lm_head.weight" and hf not in tensors:
            hf = "model.embed_tokens.weight"        # tied embeddings
        if hf not in tensors:
            raise KeyError(f"checkpoint {path} lacks {hf}; present keys "
                           f"include {sorted(tensors)[:8]}...")
        arr = tensors[hf]
        if name in ("tok_emb.weight", "lm_head.weight"):
            if arr.shape[0] < cfg.vocab_size:
                raise ValueError(
                    f"checkpoint {hf} vocab {arr.shape[0]} < "
                    f"cfg.vocab_size {cfg.vocab_size}")
            arr = arr[:cfg.vocab_size]
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return sd


def export_safetensors_params(state_dict: dict, cfg: DecoderConfig,
                              path: str) -> None:
    """Inverse of load_safetensors_params (llama naming), in f32."""
    write_safetensors(path, {
        hf: state_dict[name].detach().float().cpu().numpy()
        for name, hf in _hf_names(cfg).items()})
