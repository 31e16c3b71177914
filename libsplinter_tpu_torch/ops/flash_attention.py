"""Blockwise (flash-style) attention for long buckets: the encoder's
bidirectional attention (kernel K1) and its backward (kernel K6), and
the decoder's causal prefill attention over its KV cache (kernel K4).

The plain attention materialises (B, H, S, S) float32 logits (the
decoder's: (B, H, S, T) over the whole cache) in device memory — at
S = 2048 that is 16 MB per (batch row, head) and it caps the batch
size long before the arithmetic saturates.  Buckets at or above the
config's ``flash_min_seq`` therefore attend through K1
(csrc/flash_fwd.cu) or K4 (csrc/causal_fwd.cu): K/V stream through
shared memory in tiles under an online f32 softmax, and nothing
quadratic reaches device memory.  Training differentiates K1 through
an autograd Function whose backward is K6 (csrc/flash_bwd.cu): it
recomputes the probabilities tile by tile from the per-row max and
sum that K1 wrote in the forward, so the backward is as linear in
device memory as the forward.  bf16 inputs run all three kernels on
the tensor cores; f32 inputs run their exact FMA arm.

Layout and semantics follow the JAX package's ``flash_attention`` and
``causal_flash_attention``: (B, S, H, D) at the public functions (K1
pads S to a multiple of min(block_q, S) with masked keys, as the JAX
layout helper does, and the backward runs on the same padded layout),
masked logits at the finite ``NEG_INF`` so a row with no visible key
(a padded batch row, a left-pad query) is a uniform average instead
of NaN.  Those rows are don't-care values — the encoder's pooling
multiplies them by a zero mask, and the decoder masks the pad slots
its next layer writes them into.

On CPU tensors the functions run the plain PyTorch math; on CUDA
tensors they launch their kernel or raise.  Under ``no_grad`` (the
serving path) ``flash_attention`` launches K1 alone, as it always
has.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _cuda

NEG_INF = -1e30

FLASH_HEAD_DIMS = (16, 32, 64, 128)


def _mha_plain(q, k, v, mask):
    """Reference math, (B, S, H, D) layout — the counterpart of the JAX
    package's ``_mha_jnp`` (the encoder's short-bucket path and the CPU
    path of ``flash_attention``): logits in q's dtype, then f32 with
    the finite mask bias, f32 softmax, probabilities cast back to q's
    dtype for P.V."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    bias = torch.where(mask[:, None, None, :], 0.0, NEG_INF)
    probs = torch.softmax(logits + bias, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _pad_seq(q, k, v, mask, block_q: int):
    """Pad S to a multiple of min(block_q, S) with masked keys — the
    JAX package's kernel layout, which fixes the length a fully-masked
    row averages over.  Returns (q, k, v, mask, pad)."""
    s = q.shape[1]
    pad = (-s) % min(block_q, s)
    if pad:
        widths = (0, 0, 0, 0, 0, pad)
        q, k, v = (F.pad(t, widths) for t in (q, k, v))
        mask = F.pad(mask, (0, pad))
    return q, k, v, mask, pad


def flash_attention_plain(q, k, v, mask, *, block_q: int = 256):
    """K1's plain PyTorch version: the kernel's function (padding
    included) on any device.  q/k/v: (B, S, H, D); mask: (B, S) bool."""
    s = q.shape[1]
    q, k, v, mask, pad = _pad_seq(q, k, v, mask, block_q)
    out = _mha_plain(q, k, v, mask)
    return out[:, :s] if pad else out


def _check_aligned(fn: str, tensors) -> None:
    """cp.async (and K6's rowsum) move 16-byte chunks: every base
    pointer and every (batch, seq, head) stride must be a multiple of
    16 bytes.  A q/k/v split of a fused projection meets it."""
    for t in tensors:
        elt = t.element_size()
        if t.data_ptr() % 16 or any(t.stride(i) * elt % 16
                                    for i in range(3)):
            raise ValueError(f"{fn}: view not aligned to 16 bytes (base "
                             f"{t.data_ptr() % 16} mod 16, strides "
                             f"{tuple(t.stride())} of {elt}-byte elements)")


def flash_fwd_cuda(q, k, v, maskf, *, stats: bool = False):
    """Launch K1.  q/k/v: (B, S, H, D) CUDA f32 or bf16 views with the
    last dim contiguous, and in bf16 bases and strides aligned to 16
    bytes for cp.async (a split of a fused qkv projection passes as
    is); maskf: (B, S) f32 key
    validity.  Returns a new (B, S, H, D) tensor in q's dtype; with
    ``stats=True`` also each row's max and sum of its masked logits,
    (2, B, H, S) f32, which K6 takes (the output is the same bit for
    bit either way).

    Replaces libsplinter_tpu/ops/flash_attention.py `_mha_kernel`;
    bound on an H100 by 4 * B * H * S^2 * D FLOPs.  The dtype picks one
    of two hand-written kernels: bf16 runs on the tensor cores (bf16
    products, f32 sums, P rounded to bf16 as the reference does); f32
    runs the exact FMA tile, the counterpart of the JAX kernel at
    Precision.HIGHEST (see the source's header)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda and maskf.is_cuda):
        raise ValueError("flash_fwd_cuda needs CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_fwd_cuda: dtype {q.dtype} / {k.dtype} / "
                         f"{v.dtype} (f32 or bf16, all equal)")
    if maskf.dtype != torch.float32:
        raise ValueError("flash_fwd_cuda: mask must be f32")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_fwd_cuda: shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    b, s, h, d = q.shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_fwd_cuda: head dim {d} not in "
                         f"{FLASH_HEAD_DIMS}")
    if maskf.shape != (b, s):
        raise ValueError(f"flash_fwd_cuda: mask {tuple(maskf.shape)}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("flash_fwd_cuda: last dim must be contiguous")
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_fwd_cuda", (q, k, v))
    maskf = maskf.contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ml = (torch.empty((2, b, h, s), dtype=torch.float32, device=q.device)
          if stats else None)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    _cuda.launch("flash_fwd", "sptk_flash_fwd",
                 q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 maskf.data_ptr(), out.data_ptr(),
                 ml.data_ptr() if stats else None, b, s, h, d,
                 int(q.dtype == torch.bfloat16), *strides,
                 1.0 / math.sqrt(d), _cuda.stream_handle(q.device))
    return (out, ml) if stats else out


def _masked_logits(q, k, mask):
    """f32 logits (B, H, S, S) scaled by 1/sqrt(D), masked keys at the
    finite NEG_INF."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.where(mask[:, None, None, :], logits, NEG_INF)


def flash_row_stats_plain(q, k, mask):
    """The plain version of K1's ``stats`` output: per query row the max
    m of its masked, scaled f32 logits and the sum l of exp(logit - m),
    as a (2, B, H, S) f32 tensor.  q/k: (B, S, H, D); mask: (B, S)
    bool."""
    logits = _masked_logits(q, k, mask)
    m = logits.amax(dim=-1)
    return torch.stack((m, torch.exp(logits - m[..., None]).sum(dim=-1)))


def _bwd_terms(q, k, v, o, do, mask):
    """P and dS = P * (dO V^T - D) * scale in f32, (B, H, S, S)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    of, dof = o.float(), do.float()
    p = torch.softmax(_masked_logits(q, k, mask), dim=-1)
    d_i = (dof * of).sum(dim=-1).transpose(1, 2)[..., None]   # (B,H,S,1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    return p, p * (dp - d_i) * scale


def _bwd_products(p, ds, q, k, do):
    """(dq, dk, dv) = (dS K, dS^T Q, P^T dO) in f32."""
    qf, kf, dof = q.float(), k.float(), do.float()
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf),
            torch.einsum("bhqk,bqhd->bkhd", ds, qf),
            torch.einsum("bhqk,bqhd->bkhd", p, dof))


def flash_attention_bwd_plain(q, k, v, o, do, mask, *,
                              round_p: bool = False):
    """K6's plain PyTorch version: the JAX kernel's formulas, in f32,
    on the padded layout the forward ran on.  With P =
    softmax(mask(Q K^T * scale)) and D_i = rowsum(dO * O):
    dV = P^T dO, dS = P * (dO V^T - D) * scale, dQ = dS K,
    dK = dS^T Q.

    q/k/v/o/do: (B, S', H, D), o the forward's output; mask: (B, S')
    bool.  Returns (dq, dk, dv) in q's dtype.  ``round_p=True`` rounds
    P and dS to q's dtype before their products, as K6 does in bf16
    (the TPU kernel's default-precision dots round their f32 inputs the
    same way); off, every product is f32."""
    p, ds = _bwd_terms(q, k, v, o, do, mask)
    if round_p:
        p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    return tuple(t.to(q.dtype)
                 for t in _bwd_products(p, ds, q, k, do))


def flash_bwd_plain_and_terms(q, k, v, o, do, mask):
    """The f32 gradients of ``flash_attention_bwd_plain`` and, from the
    same P and dS, what rounding them moves in each gradient, per
    element: (|dS| |K|, |dS|^T |Q|, |P|^T |dO|) for (dq, dk, dv).
    Rounding each P or dS term to bf16 moves it by at most 2^-8 of
    itself, so a gradient by at most 2^-8 of these sums.  Returns
    ((dq, dk, dv), terms), all f32."""
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    p, ds = _bwd_terms(q, k, v, o, do, mask)
    ref = _bwd_products(p, ds, q, k, do)
    return ref, _bwd_products(p, ds.abs_(), q.abs(), k.abs(), do.abs())


def flash_bwd_cuda(q, k, v, o, do, maskf, stats):
    """Launch K6.  q/k/v/o/do: (B, S, H, D) CUDA f32 or bf16 views of
    one dtype with the last dim contiguous and bases and strides
    aligned to 16 bytes, o the forward's output; maskf: (B, S) f32 key
    validity; stats: K1's (2, B, H, S) row max and sum of that forward
    (``flash_fwd_cuda(..., stats=True)``).  Returns new (dq, dk, dv)
    tensors in q's dtype.  One call counts as one launch of
    ``flash_bwd`` (it runs three kernels: rowsum(dO * O), dK/dV, dQ).

    Replaces libsplinter_tpu/ops/flash_attention.py `_mha_bwd_kernel`;
    bound on an H100 by 10 * B * H * S^2 * D FLOPs.  The dtype picks one
    of two hand-written kernels: bf16 runs on the tensor cores with P
    and dS rounded to bf16 before their products (as the TPU kernel's
    default-precision dots round them); f32 runs the exact FMA tile
    (see the source's header)."""
    ts = (q, k, v, o, do)
    if not all(t.is_cuda for t in ts) or not maskf.is_cuda \
            or not stats.is_cuda:
        raise ValueError("flash_bwd_cuda needs CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"flash_bwd_cuda: dtypes "
                         f"{[str(t.dtype) for t in ts]} (f32 or bf16, "
                         f"all equal)")
    if maskf.dtype != torch.float32 or stats.dtype != torch.float32:
        raise ValueError("flash_bwd_cuda: mask and stats must be f32")
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"flash_bwd_cuda: shapes "
                         f"{[tuple(t.shape) for t in ts]}")
    b, s, h, d = q.shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_bwd_cuda: head dim {d} not in "
                         f"{FLASH_HEAD_DIMS}")
    if maskf.shape != (b, s):
        raise ValueError(f"flash_bwd_cuda: mask {tuple(maskf.shape)}")
    if stats.shape != (2, b, h, s):
        raise ValueError(f"flash_bwd_cuda: stats {tuple(stats.shape)}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash_bwd_cuda: last dim must be contiguous")
    _check_aligned("flash_bwd_cuda", ts)
    maskf, stats = maskf.contiguous(), stats.contiguous()
    delta = torch.empty((2, b, h, s), dtype=torch.float32,
                        device=q.device)   # D_i and log2 l per row
    grads = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    strides = []
    for t in ts + grads:
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    _cuda.launch("flash_bwd", "sptk_flash_bwd",
                 *(t.data_ptr() for t in ts), maskf.data_ptr(),
                 stats.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in grads),
                 b, s, h, d, int(q.dtype == torch.bfloat16),
                 _cuda.int64_array(strides), 1.0 / math.sqrt(d),
                 _cuda.stream_handle(q.device))
    return grads


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K6 backward on CUDA tensors; the plain versions of
    both on CPU tensors.  The padded q, k, v, mask and output are
    saved, so the backward runs on the layout the forward ran on (the
    JAX package's ``_to_kernel_layout`` warns that padded gradients
    diverge otherwise); gradients come back trimmed to S.  When the
    call will be differentiated (``need_stats``), K1 also writes each
    row's max and sum, which K6 takes instead of recomputing them."""

    @staticmethod
    def forward(ctx, q, k, v, mask, block_q, need_stats):
        s = q.shape[1]
        q, k, v, mask, pad = _pad_seq(q, k, v, mask, block_q)
        stats = None
        if not q.is_cuda:
            out = _mha_plain(q, k, v, mask)
        elif need_stats:
            out, stats = flash_fwd_cuda(q, k, v, mask.to(torch.float32),
                                        stats=True)
        else:
            out = flash_fwd_cuda(q, k, v, mask.to(torch.float32))
        ctx.save_for_backward(q, k, v, mask, out, stats)
        ctx.s = s
        return out[:, :s] if pad else out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, stats = ctx.saved_tensors
        s, pad = ctx.s, q.shape[1] - ctx.s
        # autograd may hand back a strided or expanded dO
        g = F.pad(g, (0, 0, 0, 0, 0, pad)) if pad else g.contiguous()
        if q.is_cuda:
            grads = flash_bwd_cuda(q, k, v, out, g, mask.to(torch.float32),
                                   stats)
        else:
            grads = flash_attention_bwd_plain(q, k, v, out, g, mask)
        if pad:
            grads = tuple(t[:, :s] for t in grads)
        return (*grads, None, None, None)


def flash_attention(q, k, v, mask, *, block_q: int = 256):
    """Bidirectional masked attention without device-quadratic logits.

    q/k/v: (B, S, H, D); mask: (B, S) bool key validity.  Returns
    (B, S, H, D) in q's dtype.  CUDA tensors run kernel K1; CPU tensors
    run the identical plain math (``flash_attention_plain``).  When
    grad is enabled and an input requires it, the call is
    differentiable: its backward runs K6 (``flash_attention_bwd_plain``
    on CPU tensors) on the row statistics K1 wrote; otherwise autograd
    records nothing and the call is K1 alone, writing no statistics."""
    need_stats = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, mask, block_q, need_stats)


# -- K4: decoder-prefill causal attention -------------------------------------

def causal_attention_plain(q, kk, vv, pos, start):
    """K4's plain PyTorch version — the counterpart of the JAX package's
    ``_causal_jnp`` (the decoder's short-chunk path): the query at cache
    slot pos + i sees keys start[b] <= j <= pos + i.  Logits in q's
    dtype, then f32 with the finite mask, f32 softmax, probabilities
    cast back to q's dtype for P.V.

    q: (B, S, H, D); kk/vv: (B, T, H, D) with the kv heads already
    repeated to H; pos: int; start: (B,) int.  Returns (B, S, H, D)."""
    s, t = q.shape[1], kk.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(q.shape[-1])
    slots = pos + torch.arange(s, device=q.device)
    keys = torch.arange(t, device=q.device)
    visible = ((keys[None, :] <= slots[:, None])[None]
               & (keys[None, None, :] >= start.to(q.device)[:, None, None]))
    logits = torch.where(visible[:, None], logits.float(), NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv)


def causal_fwd_cuda(q, kk, vv, pos: int, start):
    """Launch K4.  q: (B, S, H, D) CUDA f32 or bf16 view with the last
    dim contiguous; kk/vv: (B, T, KH, D) cache views of q's dtype, H a
    multiple of KH (query head h reads kv head h // (H / KH)); pos: the
    cache slot of q's first row, pos + S <= T; start: (B,) int32 CUDA
    left-pad offsets.  In bf16 every base and (batch, seq, head) stride
    must be a multiple of 16 bytes for cp.async (the decoder's caches,
    a row of them and a split of a fused qkv projection pass).  Returns
    a new (B, S, H, D) tensor in q's dtype.

    Replaces libsplinter_tpu/ops/flash_attention.py `_causal_kernel`;
    bound on an H100 by the bytes of q, the visible K/V and the output
    at the decoder's shapes.  The dtype picks one of two hand-written
    kernels, as for K1: bf16 runs on the tensor cores (bf16 products,
    f32 sums, P rounded to bf16 as the reference does); f32 runs the
    exact FMA tile (see the source's header for the design)."""
    if not (q.is_cuda and kk.is_cuda and vv.is_cuda and start.is_cuda):
        raise ValueError("causal_fwd_cuda needs CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or kk.dtype != q.dtype or vv.dtype != q.dtype:
        raise ValueError(f"causal_fwd_cuda: dtype {q.dtype} / {kk.dtype} "
                         f"/ {vv.dtype} (f32 or bf16, all equal)")
    if start.dtype != torch.int32:
        raise ValueError("causal_fwd_cuda: start must be int32")
    if q.dim() != 4 or kk.dim() != 4 or vv.shape != kk.shape:
        raise ValueError(f"causal_fwd_cuda: shapes {tuple(q.shape)} "
                         f"{tuple(kk.shape)} {tuple(vv.shape)}")
    b, s, h, d = q.shape
    t, kh = kk.shape[1], kk.shape[2]
    if kk.shape[0] != b or kk.shape[3] != d or h % kh:
        raise ValueError(f"causal_fwd_cuda: q {tuple(q.shape)} against "
                         f"cache {tuple(kk.shape)}")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"causal_fwd_cuda: head dim {d} not in "
                         f"{FLASH_HEAD_DIMS}")
    if start.shape != (b,):
        raise ValueError(f"causal_fwd_cuda: start {tuple(start.shape)}")
    if not 0 <= pos <= t - s:
        raise ValueError(f"causal_fwd_cuda: slots {pos}..{pos + s - 1} "
                         f"outside the cache's {t}")
    for x in (q, kk, vv):
        if x.stride(-1) != 1:
            raise ValueError("causal_fwd_cuda: last dim must be contiguous")
    if q.dtype == torch.bfloat16:
        _check_aligned("causal_fwd_cuda", (q, kk, vv))
    start = start.contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = []
    for x in (q, kk, vv, out):
        strides += [x.stride(0), x.stride(1), x.stride(2)]
    _cuda.launch("causal_fwd", "sptk_causal_fwd",
                 q.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                 start.data_ptr(), out.data_ptr(), b, s, h, d, t, pos,
                 h // kh, int(q.dtype == torch.bfloat16), *strides,
                 1.0 / math.sqrt(d), _cuda.stream_handle(q.device))
    return out


def causal_flash_attention(q, kk, vv, pos: int, start=None):
    """Decoder-prefill attention without device-quadratic logits.

    q: (B, S, H, D) queries at cache slots pos..pos+S-1; kk/vv:
    (B, T, KH, D) the updated cache with the kv heads UNREPEATED; pos:
    int; start: None or (B,) left-pad offsets.  Returns (B, S, H, D) in
    q's dtype.  CUDA tensors run kernel K4; CPU tensors run the plain
    math (``causal_attention_plain``) on the repeated cache.

    Unlike the JAX host function this pads nothing: the key length is
    the cache's T, not S, so zero query rows past S would change no
    real row, and the kernel masks its ragged last query tile itself."""
    b, h = q.shape[0], q.shape[2]
    if start is None:
        start = torch.zeros(b, dtype=torch.int32, device=q.device)
    if not q.is_cuda:
        rep = h // kk.shape[2]
        if rep > 1:
            kk = kk.repeat_interleave(rep, dim=2)
            vv = vv.repeat_interleave(rep, dim=2)
        return causal_attention_plain(q, kk, vv, pos, start)
    return causal_fwd_cuda(q, kk, vv, int(pos), start.to(torch.int32))
