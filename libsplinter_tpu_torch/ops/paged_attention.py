"""Ragged paged decode attention over a block-paged KV pool (kernel K5).

The continuous completion lane keeps K/V in a GLOBAL page pool

    k_pool / v_pool: (n_blocks, KH, page, D)     per layer

and each batch row owns an int32 block table mapping its logical pages
to pool blocks (models/decoder.PagedKVCache).  Rows are ragged: row b's
first query attends keys j < lengths[b], and block 0 is the TRASH block
every unused table entry points at.

Layout and semantics follow the JAX package's ``paged_attention``:

  - q is (B, H, D) — one query token per row — or (B, S, H, D), the
    MULTI-QUERY stack (a prefix-cache suffix prefill): query token t
    attends keys j < lengths[b] + t;
  - GQA: query head h reads kv head h // (H / KH);
  - float pools (bf16 or f32), or QUANTIZED pools with one f32 scale
    per (page block, kv head), (n_blocks, KH): int8 values, or int4
    PACKED two codes per uint8 byte along the head dim (pool
    (n_blocks, KH, page, D/2), split-half nibble layout, offset 8 —
    ``pack_int4``/``unpack_int4``);
  - f32 logits and softmax; probabilities are cast to the pool's value
    dtype before P.V (the dequantized f32 values for quantized pools);
  - a row that sees no key (``lengths == 0`` with one query token: a
    dead batch slot) is don't-care.  The kernel writes exact zeros
    there; the plain version gives an average over the trash it
    gathers, which nobody reads.

On CPU tensors ``paged_attention`` runs the plain PyTorch version
(``paged_attention_plain``, the counterpart of the JAX package's
``_paged_ref`` after ``dequantize_pool``); on CUDA tensors it launches
K5 (csrc/paged_fwd.cu) or raises.  Forward only.  K5 is split-K: each
block takes the keys of a few table pages (``_paged_plan``, from the
shapes alone) and a second small kernel merges the splits.
"""
from __future__ import annotations

import collections
import math

import torch

from . import _cuda
from ._cuda import H100_SMS

NEG_INF = -1e30

# int4-packed pools: symmetric 4-bit codes (clip +-7, scale =
# page-absmax / 7) stored offset 8, byte j holding element j (low
# nibble) and element j + D/2 (high nibble)
INT4_QMAX = 7.0
_INT4_BIAS = 8

# head dims the kernel is built for (the pools' rows must be whole
# 16-byte chunks in every storage type, int4 included)
PAGED_HEAD_DIMS = (32, 64, 128)

# storage kind codes of the C entry: float pools by dtype, int8, int4
_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.uint8: 3}

# K5's split plan (csrc/paged_fwd.cu): a split covers whole table pages,
# at least PAGED_SPLIT_KEYS keys, and the plan takes the fewest splits
# that give the grid PAGED_WAVES waves of PAGED_BLOCKS_PER_SM blocks on
# every SM, or as many as the pages allow
PAGED_SPLIT_KEYS = 256
PAGED_BLOCKS_PER_SM = 8
PAGED_WAVES = 2
PAGED_WIDEST_TILE = 8       # query rows a block takes at most (f32 pools)

# K5 launches by query tokens per row (1 = a decode step, > 1 = the
# multi-query stack of a suffix prefill), and by splits (more than one:
# the combine kernel ran too); bumped with LAUNCHES
LAUNCHES_BY_QTOKENS: collections.Counter = collections.Counter()
LAUNCHES_BY_SPLITS: collections.Counter = collections.Counter()


def pack_int4(q):
    """(..., D) integer codes in [-8, 7] -> (..., D/2) uint8, split-half
    nibble layout (low = element j, high = element j + D/2)."""
    d = q.shape[-1]
    u = (q.to(torch.int32) + _INT4_BIAS).to(torch.uint8)
    return u[..., :d // 2] | (u[..., d // 2:] << 4)


def unpack_int4(packed):
    """(..., D/2) uint8 -> (..., D) f32 codes in [-8, 7]: the exact
    inverse of pack_int4 on its range."""
    lo = (packed & 0xF).to(torch.float32) - _INT4_BIAS
    hi = (packed >> 4).to(torch.float32) - _INT4_BIAS
    return torch.cat([lo, hi], dim=-1)


def dequantize_pool(pool, scales):
    """(n_blocks, KH, page, D) int8 — or (n_blocks, KH, page, D/2) uint8
    int4-packed — times (n_blocks, KH) f32 scales -> f32 values."""
    if pool.dtype == torch.uint8:
        return unpack_int4(pool) * scales[:, :, None, None]
    return pool.to(torch.float32) * scales[:, :, None, None]


def paged_attention_plain(q, k_pool, v_pool, tables, lengths,
                          k_scales=None, v_scales=None):
    """K5's plain PyTorch version: gather every table page into a dense
    (B, KH, P*page, D) view and run the masked softmax (quantized pools
    are dequantized first).  Logits and softmax in f32; probabilities
    cast to the (dequantized) pool dtype for P.V; the output in q's
    dtype.  q: (B, H, D) or (B, S, H, D)."""
    if k_scales is not None:
        k_pool = dequantize_pool(k_pool, k_scales)
        v_pool = dequantize_pool(v_pool, v_scales)
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, s, h, d = q.shape
    kh, page = k_pool.shape[1], k_pool.shape[2]
    rep = h // kh
    tables = tables.long()
    n_pages = tables.shape[1]
    t = n_pages * page
    kseq = k_pool[tables].permute(0, 2, 1, 3, 4).reshape(b, kh, t, d)
    vseq = v_pool[tables].permute(0, 2, 1, 3, 4).reshape(b, kh, t, d)
    qr = q.reshape(b, s, kh, rep, d)
    logits = torch.einsum("bskrd,bktd->bskrt", qr.float(),
                          kseq.float()) / math.sqrt(d)
    keys = torch.arange(t, device=q.device)
    toks = torch.arange(s, device=q.device)
    valid = keys[None, None, :] < (lengths.to(q.device).long()[:, None, None]
                                   + toks[None, :, None])
    logits = torch.where(valid[:, :, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bskrt,bktd->bskrd", probs.to(vseq.dtype), vseq)
    out = out.reshape(b, s, h, d).to(q.dtype)
    return out[:, 0] if squeeze else out


def _paged_plan(b: int, kh: int, n_pages: int, page: int, s: int,
                sms: int = H100_SMS) -> tuple[int, int]:
    """(table pages a split covers, splits) for K5 at B rows, KH kv
    heads, P = n_pages table pages of `page` keys and S query tokens a
    row.  Shapes alone decide, so the launch never reads lengths on the
    host (a CUDA graph can capture it).  The blocks counted are
    (row, kv head, split) times the stack's row tiles, ceil(S / 8) at
    the least; a split past a row's last key costs a block that exits
    at once."""
    least = max(1, -(-PAGED_SPLIT_KEYS // page))
    most = max(1, n_pages // least)
    blocks = b * kh * -(-s // PAGED_WIDEST_TILE)
    want = -(-PAGED_WAVES * PAGED_BLOCKS_PER_SM * sms // blocks)
    pps = -(-n_pages // max(1, min(want, most)))
    return pps, -(-n_pages // pps)


def paged_fwd_cuda(q, k_pool, v_pool, tables, lengths, k_scales=None,
                   v_scales=None):
    """Launch K5.  q: (B, S, H, D) CUDA f32 or bf16 view with the last
    dim contiguous (token-major rows are mapped through the strides, so
    the (B, KH, S*rep, D) stack is never materialised); pools:
    contiguous (n_blocks, KH, page, D) bf16/f32, or int8 / (..., D/2)
    uint8 with (n_blocks, KH) f32 scales; tables: (B, P) int32; lengths:
    (B,) int32.  Returns a new (B, S, H, D) tensor in q's dtype.

    Replaces libsplinter_tpu/ops/paged_attention.py `_paged_kernel`;
    bound on an H100 by the bytes of each row's visible K/V pages.
    Split-K over table pages (``_paged_plan``); with more than one split
    the (m, l, acc) scratch is allocated here and a combine kernel
    merges it (see the source's header for the design).  Reads nothing
    back from the device."""
    tensors = [q, k_pool, v_pool, tables, lengths]
    quant = k_scales is not None
    if quant:
        tensors += [k_scales, v_scales]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_fwd_cuda needs CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_fwd_cuda: q dtype {q.dtype} (f32 or bf16)")
    if q.dim() != 4 or q.stride(-1) != 1:
        raise ValueError(f"paged_fwd_cuda: q {tuple(q.shape)} must be a "
                         "(B, S, H, D) view with the last dim contiguous")
    kind = _KV_KIND.get(k_pool.dtype)
    if kind is None or v_pool.dtype != k_pool.dtype \
            or quant != (kind >= 2):
        raise ValueError(f"paged_fwd_cuda: pools {k_pool.dtype} / "
                         f"{v_pool.dtype} with scales={quant} (bf16/f32 "
                         "pools, or int8/uint8 pools with scales)")
    b, s, h, d = q.shape
    n_blocks, kh, page, dk = k_pool.shape
    if d not in PAGED_HEAD_DIMS:
        raise ValueError(f"paged_fwd_cuda: head dim {d} not in "
                         f"{PAGED_HEAD_DIMS}")
    if dk != (d // 2 if kind == 3 else d) or v_pool.shape != k_pool.shape \
            or h % kh:
        raise ValueError(f"paged_fwd_cuda: q {tuple(q.shape)} against pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    for t in (k_pool, v_pool):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("paged_fwd_cuda: pools must be contiguous and "
                             "16-byte aligned")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or tables.dim() != 2 or tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError(f"paged_fwd_cuda: tables {tuple(tables.shape)} "
                         f"{tables.dtype} / lengths {tuple(lengths.shape)} "
                         f"{lengths.dtype} (int32, (B, P) and (B,))")
    if quant:
        for sc in (k_scales, v_scales):
            if sc.dtype != torch.float32 or sc.shape != (n_blocks, kh):
                raise ValueError(f"paged_fwd_cuda: scales {tuple(sc.shape)} "
                                 f"{sc.dtype} (f32 (n_blocks, KH))")
        k_scales, v_scales = k_scales.contiguous(), v_scales.contiguous()
    tables, lengths = tables.contiguous(), lengths.contiguous()
    n_pages = tables.shape[1]
    pps, splits = _paged_plan(
        b, kh, n_pages, page, s,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    part_ml = part_acc = None
    if splits > 1:
        rows = s * (h // kh)
        part_ml = torch.empty((b, kh, rows, splits, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((b, kh, rows, splits, d),
                               dtype=torch.float32, device=q.device)
    _cuda.launch("paged_fwd", "sptk_paged_fwd",
                 q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scales.data_ptr() if quant else None,
                 v_scales.data_ptr() if quant else None,
                 tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 part_ml.data_ptr() if splits > 1 else None,
                 part_acc.data_ptr() if splits > 1 else None,
                 b, s, h, kh, d, page, n_pages, pps,
                 int(q.dtype == torch.bfloat16), kind,
                 q.stride(0), q.stride(1), q.stride(2),
                 out.stride(0), out.stride(1), out.stride(2),
                 1.0 / math.sqrt(d), _cuda.stream_handle(q.device))
    LAUNCHES_BY_QTOKENS[s] += 1
    LAUNCHES_BY_SPLITS[splits] += 1
    return out


def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    k_scales=None, v_scales=None):
    """Ragged paged attention (forward / serving only).

    q: (B, H, D) — one query token per row, after the step's K/V was
    appended (lengths counts it) — or (B, S, H, D), S new tokens per row
    whose K/V are all appended: token t attends keys j < lengths[b] + t.
    k_pool/v_pool: (n_blocks, KH, page, D) with the kv heads unrepeated,
    or quantized (int8, or int4-packed uint8 with D/2 bytes) with
    k_scales/v_scales (n_blocks, KH) f32.  tables: (B, P) block table
    (unused entries 0, the trash block); lengths: (B,).  Returns q's
    shape in q's dtype.  CUDA tensors run K5; CPU tensors the plain
    version."""
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, tables, lengths,
                                     k_scales, v_scales)
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    out = paged_fwd_cuda(q4, k_pool, v_pool, tables.to(torch.int32),
                         lengths.to(torch.int32), k_scales, v_scales)
    return out[:, 0] if squeeze else out
