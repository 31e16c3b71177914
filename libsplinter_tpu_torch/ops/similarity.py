"""Cosine similarity and top-k over the store's vector lane.

Two hand-written CUDA kernels carry the search lane on the card:

  K3  cosine_scores_cuda (csrc/cosine_scores.cu): the (N, Q) cosine
      score matrix with in-kernel row norms, plain f32 FMA, on K2's
      score tile (csrc/topk_tile.cuh);
  K2  fused_topk_cuda (csrc/fused_topk.cu): score + streaming top-k in
      one pass over the lane, only O(k * Q) leaves the kernel.

Both exclude masked rows and zero-norm rows (un-embedded slots) with
the finite NEG_INF, and order results by (score desc, row asc) — the
JAX package's lax.top_k order, ties included.  On CPU tensors each
function runs its plain PyTorch version (``_cosine_scores_plain``,
``_fused_topk_plain``); on CUDA tensors it launches the kernel or
raises.  The unfused path for k > FUSED_K_MAX sorts K3's scores with a
stable descending sort outside any kernel (the JAX package leaves that
step to lax.top_k, outside its kernel too; torch.topk does not order
ties, so it is not used).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..obs.devtime import DEVTIME, close_mark
from . import _cuda
from ._cuda import H100_SMS

NEG_INF = -1e30

# The fused kernel's warp-cooperative insert holds a list of at most
# 128 entries (four per lane); larger k takes the score matrix + stable
# sort.  The CLI's fetch-k growth schedule (8, 64, 512) crosses this at
# its third step.
FUSED_K_MAX = 128

# K2 and K3 (csrc/topk_tile.cuh TileShape): query tile -> rows per tile,
# queries per thread, depth of a staged chunk.  The narrow tiles
# stream the lane; the wide one is an f32 GEMM.
TOPK_TILES = {8: (256, 8, 64), 32: (256, 8, 32), 256: (128, 16, 32)}
# shared memory of a block and of an SM (sm_90)
TOPK_SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
_TOPK_STAGES, _TOPK_CAP = 2, 32      # ring stages, survivors per query


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _inputs(vectors, queries, mask):
    """(vectors, queries 2-D, mask (N,) f32 or None) on the lane's
    device — the device of `vectors`, CPU for host arrays."""
    device = vectors.device if isinstance(vectors, torch.Tensor) else "cpu"
    vectors = _as_f32(vectors, device)
    queries = _as_f32(queries, device)
    if queries.dim() == 1:
        queries = queries[None, :]
    if mask is not None:
        mask = _as_f32(mask, device).reshape(-1)
    return vectors, queries, mask


def _check_lane(vectors, queries, mask, who: str) -> None:
    if not (vectors.is_cuda and queries.is_cuda):
        raise ValueError(f"{who} needs CUDA tensors")
    if vectors.dtype != torch.float32 or queries.dtype != torch.float32:
        raise ValueError(f"{who}: vectors and queries must be f32")
    if vectors.dim() != 2 or queries.dim() != 2 \
            or queries.shape[1] != vectors.shape[1]:
        raise ValueError(f"{who}: shapes {tuple(vectors.shape)} x "
                         f"{tuple(queries.shape)}")
    if not (vectors.is_contiguous() and queries.is_contiguous()):
        raise ValueError(f"{who}: vectors and queries must be contiguous")
    if mask is not None and (mask.shape != (vectors.shape[0],)
                             or mask.dtype != torch.float32
                             or not mask.is_contiguous()
                             or mask.device != vectors.device):
        raise ValueError(f"{who}: mask must be a contiguous (N,) f32 "
                         f"tensor on the lane's device")


def _cosine_scores_plain(vectors, queries, mask=None, vnorm=None, *,
                         mxu_bf16: bool = False):
    """K3's plain version (the JAX package's ``_cosine_scores_jnp``):
    (N, D) x (Q, D) -> (N, Q).  vnorm: optional staged (N,) row norms.
    mxu_bf16 rounds both operands to bf16 before the product (f32
    sums), the kernel's option; norms stay f32."""
    if mxu_bf16:
        dots = (vectors.to(torch.bfloat16).float()
                @ queries.to(torch.bfloat16).float().T)
    else:
        dots = vectors @ queries.T
    if vnorm is None:
        vnorm = torch.linalg.vector_norm(vectors, dim=-1, keepdim=True)
    else:
        vnorm = _as_f32(vnorm, vectors.device).reshape(-1, 1)
    qnorm = torch.linalg.vector_norm(queries, dim=-1, keepdim=True).T
    cos = dots / torch.clamp(vnorm * qnorm, min=1e-12)
    keep = vnorm > 0.0                 # zero rows: never candidates
    if mask is not None:
        keep = keep & (mask.reshape(-1, 1) > 0.0)
    return torch.where(keep, cos, torch.full_like(cos, NEG_INF))


def cosine_scores_cuda(vectors, queries, mask=None, *,
                       mxu_bf16: bool = False) -> torch.Tensor:
    """Launch K3: (N, D) x (Q, D) CUDA f32 -> (N, Q) f32 cosine scores.

    Replaces libsplinter_tpu/ops/similarity.py `_scores_kernel`; bound
    on an H100 by the lane read and the scores written (N * D * 4 and
    N * Q * 4 bytes over 3.35 TB/s) for small Q, by f32 FMA
    (2 * N * D * Q FLOPs over 67 TFLOP/s) for Q = 256.  K2's score tile
    and grid (``_topk_plan``), row norms from the tile's registers, the
    scores staged in shared memory and stored as whole rows (16-byte
    stores when Q % 4 == 0).  Any d: rows that are not 16-byte aligned
    load by 4-byte copies."""
    _check_lane(vectors, queries, mask, "cosine_scores_cuda")
    n, d = vectors.shape
    nq = queries.shape[0]
    dev = vectors.device
    tq, nblk = _topk_plan(
        n, nq, torch.cuda.get_device_properties(dev).multi_processor_count)
    qnorm = torch.linalg.vector_norm(queries, dim=-1).contiguous()
    out = torch.empty((n, nq), dtype=torch.float32, device=dev)
    _cuda.launch("cosine_scores", "sptk_cosine_scores",
                 vectors.data_ptr(), n, d, queries.data_ptr(), nq,
                 qnorm.data_ptr(), 0 if mask is None else mask.data_ptr(),
                 out.data_ptr(), tq, nblk, int(mxu_bf16),
                 _cuda.stream_handle(dev))
    return out


def cosine_scores(vectors, queries, mask=None, *, mxu_bf16: bool = False,
                  vnorm=None) -> torch.Tensor:
    """(N, D) vectors x (Q, D) queries -> (N, Q) cosine scores on the
    lane's device.

    mask: optional (N,) {0,1} prefilter; filtered rows score NEG_INF.
    Rows of all zeros (empty slots) also score NEG_INF — the exclusion
    comes from the row norm, computed in-kernel (CUDA) or from `vnorm`
    when the caller staged it (CPU; the kernel ignores it).
    mxu_bf16: bf16 products, f32 sums — ~2e-2 absolute score error, so
    exact f32 stays the default."""
    vectors, queries, mask = _inputs(vectors, queries, mask)
    if vectors.is_cuda:
        return cosine_scores_cuda(vectors, queries.contiguous(), mask,
                                  mxu_bf16=mxu_bf16)
    return _cosine_scores_plain(vectors, queries, mask, vnorm,
                                mxu_bf16=mxu_bf16)


def _stable_topk(scores_t: torch.Tensor, k: int):
    """(Q, N) -> (Q, k) scores and int32 rows in lax.top_k order:
    descending, ties to the smallest row."""
    s, i = torch.sort(scores_t, dim=-1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32)


def _fused_topk_plain(vectors, queries, k: int, mask=None, *,
                      mxu_bf16: bool = False):
    """K2's plain version: the fused kernel's function — the top k per
    query by (score desc, row asc), with (NEG_INF, -1) filler where
    fewer than k rows are candidates."""
    scores = _cosine_scores_plain(vectors, queries, mask,
                                  mxu_bf16=mxu_bf16)
    s, i = _stable_topk(scores.T, k)
    if s.shape[1] < k:
        fill = k - s.shape[1]
        s = torch.cat([s, s.new_full((s.shape[0], fill), NEG_INF)], 1)
        i = torch.cat([i, i.new_full((i.shape[0], fill), -1)], 1)
    i = torch.where(s > NEG_INF, i, torch.full_like(i, -1))
    return s, i


def _topk_smem(tq: int) -> int:
    """Shared-memory bytes of one K2 partial block: the ring of staged
    rows and queries, the survivor buffers, and per query its k-th
    entry, push count, bound and norm (csrc/fused_topk.cu
    partial_smem_bytes).  The lists live in the candidate arrays."""
    tn, _, dk = TOPK_TILES[tq]
    return 4 * (_TOPK_STAGES * (tn + tq) * (dk + 4) + 2 * tq * _TOPK_CAP
                + 5 * tq)


def _topk_plan(n: int, nq: int, sms: int = H100_SMS) -> tuple[int, int]:
    """(query tile, blocks per query tile) for the fused kernel K2 and
    for K3, which runs on K2's tile with the same residency (one block
    an SM, two for the 32-query tile): the smallest tile holding nq
    queries (the widest for more), then as many blocks over all query
    tiles as the SMs hold at once."""
    tiles = sorted(TOPK_TILES)
    tq = next((t for t in tiles if t >= nq), tiles[-1])
    per_sm = max(1, SM_SMEM_BYTES // (_topk_smem(tq) + 1024))
    passes = -(-nq // tq)
    nblk = -(-sms * per_sm // passes)
    return tq, max(1, min(-(-n // TOPK_TILES[tq][0]), nblk))


def fused_topk_cuda(vectors, queries, k: int, mask=None, *,
                    mxu_bf16: bool = False):
    """Launch K2: the top k <= FUSED_K_MAX rows per query of a CUDA f32
    lane.  Returns ((Q, k) f32 scores, (Q, k) int32 rows), sorted by
    (score desc, row asc); (NEG_INF, -1) filler past the candidates.

    Replaces libsplinter_tpu/ops/similarity.py `_fused_topk_kernel`;
    bound on an H100 by the lane read for small Q and by f32 FMA for
    Q = 256.  A register-blocked f32 tile fed by a cp.async ring,
    selection from registers into per-block sorted lists (kept in the
    (Q, blocks, k) candidate arrays, bounded by the blocks' published
    scores), then a merge pass (see the source's header).  Any d: rows
    that are not 16-byte aligned load by 4-byte copies."""
    _check_lane(vectors, queries, mask, "fused_topk_cuda")
    if not 1 <= k <= FUSED_K_MAX:
        raise ValueError(f"fused_topk_cuda: k={k} outside 1.."
                         f"{FUSED_K_MAX}")
    n, d = vectors.shape
    nq = queries.shape[0]
    k_list = max(8, -(-k // 8) * 8)
    dev = vectors.device
    tq, nblk = _topk_plan(
        n, nq, torch.cuda.get_device_properties(dev).multi_processor_count)
    qnorm = torch.linalg.vector_norm(queries, dim=-1).contiguous()
    bounds = torch.full((nq, 8), NEG_INF, dtype=torch.float32,
                        device=dev)     # the blocks' published bounds
    cand_s = torch.empty((nq, nblk, k_list), dtype=torch.float32,
                         device=dev)
    cand_i = torch.empty((nq, nblk, k_list), dtype=torch.int32, device=dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    _cuda.launch("fused_topk", "sptk_fused_topk",
                 vectors.data_ptr(), n, d, queries.data_ptr(), nq,
                 qnorm.data_ptr(), 0 if mask is None else mask.data_ptr(),
                 k_list, k, tq, nblk, bounds.data_ptr(), cand_s.data_ptr(),
                 cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                 int(mxu_bf16), _cuda.stream_handle(dev))
    return out_s, out_i


@functools.lru_cache(maxsize=None)
def _scatter_program():
    # ledger-only registration: the in-place result has no host
    # collect point, so its device window is never closed
    def scatter(arr, norms, rows, vals, nvals):
        arr.index_copy_(0, rows, vals.to(arr.dtype))
        norms.index_copy_(0, rows, nvals.to(norms.dtype))
        return arr, norms

    return DEVTIME.register("searcher.scatter", scatter)


def _rows_tensor(rows, device) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(rows, np.int64)).to(device)


def _vals_tensor(vals, device) -> torch.Tensor:
    if isinstance(vals, torch.Tensor):
        return vals.to(device)
    return torch.from_numpy(np.ascontiguousarray(vals)).to(device)


def scatter_rows_with_norms(arr, norms, rows, vals, nvals):
    """In-place row update of a staged lane AND its row-norm vector
    (``index_copy_``; the JAX package computes the same update outside
    any kernel, as a donated in-place scatter).  Shapes: arr (N, D),
    norms (N,), rows (B,), vals (B, D) any float dtype (upcast on the
    device), nvals (B,) f32.  Duplicate rows must carry identical
    values (the bucket padding repeats row 0).  Returns (arr, norms)."""
    dev = arr.device
    return _scatter_program()(arr, norms, _rows_tensor(rows, dev),
                              _vals_tensor(vals, dev),
                              _vals_tensor(nvals, dev))


def scatter_rows_with_norms_ring(arr, norms, rows_ring, vals_ring,
                                 nvals_ring, n_valid: int):
    """Ring variant of scatter_rows_with_norms: applies the first
    n_valid of `depth` pre-staged same-bucket chunks.  Shapes:
    rows_ring (depth, B), vals_ring (depth, B, D), nvals_ring
    (depth, B).  Chunks within one refresh touch disjoint rows, so the
    order cannot change the result."""
    dev = arr.device
    rows_ring = _rows_tensor(rows_ring, dev)
    vals_ring = _vals_tensor(vals_ring, dev)
    nvals_ring = _vals_tensor(nvals_ring, dev)
    for i in range(int(n_valid)):
        arr, norms = _scatter_program()(arr, norms, rows_ring[i],
                                        vals_ring[i], nvals_ring[i])
    return arr, norms


def euclidean_distances(vectors, queries, mask=None) -> torch.Tensor:
    """(N, D) x (Q, D) -> (N, Q) euclidean distances (inf where masked).
    Computed from norms + dot so it reuses the same matmul shape."""
    vectors, queries, mask = _inputs(vectors, queries, mask)
    dots = vectors @ queries.T
    v2 = (vectors * vectors).sum(dim=-1, keepdim=True)
    q2 = (queries * queries).sum(dim=-1, keepdim=True).T
    dist = torch.sqrt(torch.clamp(v2 + q2 - 2.0 * dots, min=0.0))
    if mask is not None:
        dist = torch.where(mask.reshape(-1, 1) > 0, dist,
                           torch.full_like(dist, float("inf")))
    return dist


@functools.lru_cache(maxsize=32)
def _topk_fn(k: int, batch: bool, mxu_bf16: bool):
    """The score-matrix path: K3 (or its plain version) + a stable
    descending sort — lax.top_k's contract, filler rows keep their
    real (NEG_INF-scored) indices."""

    def run(vectors, queries, mask, vnorm):
        vectors, queries, mask = _inputs(vectors, queries, mask)
        scores = cosine_scores(vectors, queries, mask, mxu_bf16=mxu_bf16,
                               vnorm=vnorm)
        s, i = _stable_topk(scores.T, k)
        return (s, i) if batch else (s[0], i[0])

    return DEVTIME.register("searcher.topk", run)


@functools.lru_cache(maxsize=32)
def _fused_topk_fn(k: int, mxu_bf16: bool):
    """The fused score+select program: K2 on a CUDA lane, its plain
    version on a CPU lane.  run(vectors, queries, mask, vnorm) ->
    ((Q, k) scores, (Q, k) rows); vnorm is accepted for signature
    parity with _topk_fn and ignored (the kernel computes norms)."""

    def run(vectors, queries, mask, vnorm):
        del vnorm
        vectors, queries, mask = _inputs(vectors, queries, mask)
        if vectors.is_cuda:
            return fused_topk_cuda(vectors, queries.contiguous(), k, mask,
                                   mxu_bf16=mxu_bf16)
        return _fused_topk_plain(vectors, queries, k, mask,
                                 mxu_bf16=mxu_bf16)

    return DEVTIME.register("searcher.fused_topk", run)


def topk_program(k: int, *, batched: bool = True, mxu_bf16: bool = False,
                 fused: bool | None = None):
    """The (vectors, queries, mask, vnorm) -> (scores, rows) top-k
    program the search daemon batches its QB-bucketed drains through;
    results stay on the lane's device.

    fused=None auto-selects the streaming kernel K2 whenever
    k <= FUSED_K_MAX (the (N, Q) score matrix then never exists);
    larger k takes the score matrix (K3) + stable sort.
    batched=False returns (k,)-shaped results for one query (the
    legacy cosine_topk contract)."""
    if fused is None:
        fused = k <= FUSED_K_MAX
    if not fused:
        return _topk_fn(int(k), bool(batched), bool(mxu_bf16))
    fn = _fused_topk_fn(int(k), bool(mxu_bf16))
    if batched:
        return fn

    def single(vectors, queries, mask, vnorm):
        s, i = fn(vectors, queries, mask, vnorm)
        return s[0], i[0]

    return single


def fetch_topk(scores: torch.Tensor, rows: torch.Tensor):
    """ONE device->host copy of a top-k result: the int32 rows ride
    bit-cast beside the f32 scores.  Returns (f32 scores, int64 rows)
    numpy arrays of the input shapes."""
    both = torch.stack([scores.to(torch.float32),
                        rows.to(torch.int32).view(torch.float32)])
    host = both.cpu().numpy()
    return host[0], host[1].view(np.int32).astype(np.int64)


def cosine_topk(vectors, query, k: int, mask=None, *,
                mxu_bf16: bool = False, vnorm=None,
                fused: bool | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Top-k most-similar rows for one query.  Returns numpy (scores,
    rows), scores NEG_INF-padded when fewer than k candidates exist
    (the fused path marks filler rows -1; the score-matrix path leaves
    them as real rows — filter on score, not row)."""
    k = min(k, int(vectors.shape[0]))
    fn = topk_program(k, batched=False, mxu_bf16=mxu_bf16, fused=fused)
    out = fetch_topk(*fn(vectors, query, mask, vnorm))
    close_mark(DEVTIME.take_mark("searcher.topk"))
    close_mark(DEVTIME.take_mark("searcher.fused_topk"))
    return out


def cosine_topk_batch(vectors, queries, k: int, mask=None, *,
                      mxu_bf16: bool = False, vnorm=None,
                      fused: bool | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Top-k per query.  Returns numpy (Q, k) scores and rows."""
    k = min(k, int(vectors.shape[0]))
    fn = topk_program(k, batched=True, mxu_bf16=mxu_bf16, fused=fused)
    out = fetch_topk(*fn(vectors, queries, mask, vnorm))
    close_mark(DEVTIME.take_mark("searcher.topk"))
    close_mark(DEVTIME.take_mark("searcher.fused_topk"))
    return out
