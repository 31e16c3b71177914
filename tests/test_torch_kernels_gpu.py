"""The torch port's CUDA kernels against their plain PyTorch versions,
on the card.  Skipped without an NVIDIA GPU; on the card run

    python -m pytest --noconftest tests/test_torch_*.py -m gpu

(--noconftest: the suite's conftest configures JAX, which a CUDA host
running only the port need not have; this file imports no JAX).

Tolerances: f32 attention atol 1e-5 (online vs one-pass softmax sums
in another order); bf16 attention atol 2e-2 against the plain math run
in f32 on the same bf16 inputs (the kernel rounds probabilities to
bf16 before P.V, and the output to bf16), and K4 in bf16 per element
within K1's limit in chip_smoke.py: one bf16 ulp of |ref| (2^-7 |ref|)
plus 2^-8 of the attention-weighted mean of |V| (the probabilities'
rounding) plus 1e-5; K1's row max and sum at
1e-5 relative; K6 (the attention backward) in f32 within
1e-5 * max(1, max |ref|), and in bf16 per element within one bf16 ulp
of the f32 reference (2^-7 |ref|: the kernel's f32 result and the
reference's may round to neighbouring bf16 values) plus 2^-8 of the
sum that rounding P and dS to bf16 moves (|P|^T |dO| for dv,
|dS|^T |Q| for dk, |dS| |K| for dq: the kernel rounds them before
their products, as the TPU kernel's default-precision dots do) plus
that f32 tolerance; cosine scores atol 1e-5 on
random f32 data.  Top-k inputs are small integers over 4, so every dot
product and squared norm is exact in f32 in any summation order: the
kernel's scores then equal the plain version's bit for bit, and the
top-k rows must be identical, ties and filler included.
"""
import numpy as np
import pytest
import torch

from libsplinter_tpu_torch.ops import _cuda
from libsplinter_tpu_torch.ops.flash_attention import (
    _pad_seq, causal_attention_plain, causal_flash_attention,
    causal_fwd_cuda, flash_attention, flash_attention_plain, flash_bwd_cuda,
    flash_bwd_plain_and_terms, flash_fwd_cuda, flash_row_stats_plain)
from libsplinter_tpu_torch.ops.similarity import (
    _cosine_scores_plain, _fused_topk_plain, _stable_topk,
    cosine_scores_cuda, fused_topk_cuda, topk_program)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build()
    return torch.device("cuda")


def _attn_inputs(rng, b, s, h, d, dtype, dev):
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                .astype(np.float32)).to(dev, dtype)
               for _ in range(3))
    lens = rng.integers(1, s + 1, size=b)
    lens[-1] = 0                                # a fully-masked row
    mask = torch.from_numpy(np.arange(s)[None] < lens[:, None]).to(dev)
    return q, k, v, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(64, 16), (300, 64), (512, 64),
                                 (130, 128), (100, 32), (1, 64), (7, 16)])
def test_flash_matches_plain(cuda, dtype, s, d):
    rng = np.random.default_rng(s * 7 + d)
    q, k, v, mask = _attn_inputs(rng, 3, s, 2, d, dtype, cuda)
    before = _cuda.LAUNCHES["flash_fwd"]
    got = flash_attention(q, k, v, mask)
    assert _cuda.LAUNCHES["flash_fwd"] == before + 1
    ref = flash_attention_plain(q.float(), k.float(), v.float(), mask)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.to(dtype).float(),
                               atol=atol, rtol=0)
    # the fully-masked row is the uniform average over the padded keys
    sp = -(-s // min(256, s)) * min(256, s)
    uniform = v[-1].float().sum(dim=0) / sp
    torch.testing.assert_close(got[-1].float(),
                               uniform[None].expand(s, -1, -1),
                               atol=atol, rtol=0)


def test_flash_takes_strided_views(cuda):
    """The encoder hands K1 q/k/v split from one fused projection."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2, 256, 3 * 128))
                           .astype(np.float32)).to(cuda)
    q, k, v = (t.reshape(2, 256, 2, 64) for t in qkv.split(128, dim=-1))
    mask = torch.ones(2, 256, dtype=torch.bool, device=cuda)
    got = flash_attention(q, k, v, mask)
    ref = flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def _bwd_check(got, ref32, dtype, what, terms):
    """K6's tolerance (module docstring): f32 1e-5 * max(1, max|ref|);
    bf16 adds one bf16 ulp of |ref| and 2^-8 of the rounding terms
    (``flash_bwd_plain_and_terms``) per element."""
    for name, g, r, term in zip(("dq", "dk", "dv"), got, ref32, terms):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        f32_tol = 1e-5 * max(1.0, r.abs().max().item())
        lim = f32_tol if dtype == torch.float32 \
            else 2.0 ** -7 * r.abs() + 2.0 ** -8 * term + f32_tol
        err = (g.float() - r.to(dtype).float()).abs()
        assert (err <= lim).all(), f"{what} {name}: max err {err.max()}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(64, 16), (200, 32), (512, 64),
                                 (130, 128), (100, 64), (1, 64), (7, 16)])
def test_flash_bwd_matches_plain(cuda, dtype, s, d):
    """K6 on the padded layout, a fully-masked batch row included
    (uniform P over S), S = 100, 7 and 1 not multiples of the 64-row
    tile: the kernel against its plain version in f32 on the same
    values."""
    rng = np.random.default_rng(s * 11 + d)
    q, k, v, mask = _attn_inputs(rng, 3, s, 2, d, dtype, cuda)
    q, k, v, mask, _ = _pad_seq(q, k, v, mask, 256)
    o, stats = flash_fwd_cuda(q, k, v, mask.float(), stats=True)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)
                          ).to(cuda, dtype)
    before = _cuda.LAUNCHES["flash_bwd"]
    got = flash_bwd_cuda(q, k, v, o, do, mask.float(), stats)
    assert _cuda.LAUNCHES["flash_bwd"] == before + 1
    ref, terms = flash_bwd_plain_and_terms(q, k, v, o, do, mask)
    torch.cuda.synchronize()
    _bwd_check(got, ref, dtype, f"S={s} D={d}", terms)
    # the dead row's P is uniform over the S keys: its dV is the mean
    # of its dO over the queries
    mean = do[-1].float().mean(dim=0)
    tol = 1e-5 * max(1.0, mean.abs().max().item())
    if dtype == torch.bfloat16:
        tol = 2.0 ** -7 * mean.abs() + tol
    assert ((got[2][-1].float() - mean[None]).abs() <= tol).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(64, 16), (100, 32), (300, 64),
                                 (130, 128)])
def test_flash_row_stats(cuda, dtype, s, d):
    """K1's row max and sum (what K6 takes) against the plain helper on
    the same values, a fully-masked row (m = -1e30, l = S) included;
    the output is the same bit for bit with and without them."""
    rng = np.random.default_rng(s * 13 + d)
    q, k, v, mask = _attn_inputs(rng, 3, s, 2, d, dtype, cuda)
    maskf = mask.float()
    plain_out = flash_fwd_cuda(q, k, v, maskf)
    out, stats = flash_fwd_cuda(q, k, v, maskf, stats=True)
    want = flash_row_stats_plain(q.float(), k.float(), mask)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    assert stats.shape == (2, 3, 2, s) and stats.dtype == torch.float32
    torch.testing.assert_close(stats, want, rtol=1e-5, atol=1e-5)
    assert (stats[0, -1] == -1e30).all() and (stats[1, -1] == s).all()


def test_flash_rejects_misaligned_views(cuda):
    """cp.async moves 16-byte chunks: a view whose base or row stride
    is not a multiple of 16 bytes raises instead of launching."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 64, 2 * 64 + 1))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    q = x[..., 1:].reshape(2, 64, 2, 64)          # base off by 2 bytes
    k = v = x[..., :-1].reshape(2, 64, 2, 64)     # row stride 258 bytes
    mask = torch.ones(2, 64, dtype=torch.bool, device=cuda)
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_fwd_cuda(q, q.clone(), q.clone(), mask.float())
    with pytest.raises(ValueError, match="16 bytes"):
        flash_fwd_cuda(k.clone(), k, v, mask.float())
    qc = k.contiguous()
    o, stats = flash_fwd_cuda(qc, qc, qc, mask.float(), stats=True)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_bwd_cuda(qc, qc, qc, o, q, mask.float(), stats)
    assert _cuda.LAUNCHES["flash_bwd"] == before["flash_bwd"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_runs_k1_and_k6(cuda, dtype):
    """torch.autograd through flash_attention on the card: K1 forward,
    K6 backward, S = 300 padded to 512, q/k/v split from one fused
    projection and a strided dO; gradients trimmed to S against the
    plain backward on the padded layout."""
    rng = np.random.default_rng(9)
    b, s, h, d = 2, 300, 2, 64
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d))
                           .astype(np.float32)).to(cuda, dtype)
    qkv.requires_grad_(True)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    mask = torch.from_numpy(np.arange(s)[None] < np.array([[s], [170]])
                            ).to(cuda)
    fwd, bwd = _cuda.LAUNCHES["flash_fwd"], _cuda.LAUNCHES["flash_bwd"]
    out = flash_attention(q, k, v, mask)
    big = torch.from_numpy(rng.standard_normal((b, s, h, 2 * d))
                           .astype(np.float32)).to(cuda, dtype)
    g = big[..., :d]                                  # strided dO
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert _cuda.LAUNCHES["flash_fwd"] == fwd + 1
    assert _cuda.LAUNCHES["flash_bwd"] == bwd + 1
    qp, kp, vp, mp, pad = _pad_seq(q.detach(), k.detach(), v.detach(),
                                   mask, 256)
    assert pad == 212
    op = flash_attention(qp, kp, vp, mp)     # the output K6 was given
    gp = torch.nn.functional.pad(g.float(), (0, 0, 0, 0, 0, pad))
    ref, terms = flash_bwd_plain_and_terms(qp, kp, vp, op, gp, mp)
    torch.cuda.synchronize()
    _bwd_check(grads, [r[:, :s] for r in ref], dtype, "autograd",
               [t[:, :s] for t in terms])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_a_tensor_parallel_shards_shape(cuda, dtype):
    """K1 forward and K6 backward at the shape one tp = 2 shard of the
    sharded trainer gives them: H = 6 heads of 64 at S = 512, q/k/v
    views of the shard's fused (B, S, 3 * 384) projection (16-byte
    aligned in bf16), through autograd, against the plain versions."""
    rng = np.random.default_rng(15)
    b, s, h, d = 4, 512, 6, 64
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d))
                           .astype(np.float32)).to(cuda, dtype)
    qkv.requires_grad_(True)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    lens = np.array([s, 300, 129, 0])             # a fully-masked row
    mask = torch.from_numpy(np.arange(s)[None] < lens[:, None]).to(cuda)
    fwd, bwd = _cuda.LAUNCHES["flash_fwd"], _cuda.LAUNCHES["flash_bwd"]
    out = flash_attention(q, k, v, mask)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32)
                         ).to(cuda, dtype)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert _cuda.LAUNCHES["flash_fwd"] == fwd + 1
    assert _cuda.LAUNCHES["flash_bwd"] == bwd + 1
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    ref = flash_attention_plain(qd.float(), kd.float(), vd.float(), mask)
    want, terms = flash_bwd_plain_and_terms(qd, kd, vd, out.detach(), g,
                                            mask)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.to(dtype).float(),
                               atol=atol, rtol=0)
    _bwd_check(grads, want, dtype, "H=6 shard", terms)


def _causal_inputs(rng, b, s, t, h, kh, d, dtype, dev):
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kk, vv = (rng.standard_normal((b, t, kh, d)).astype(np.float32)
              for _ in range(2))
    return [torch.from_numpy(x).to(dev, dtype) for x in (q, kk, vv)]


def _causal_ref(q, kk, vv, pos, start):
    """The plain version in f32 on the same (possibly bf16) values."""
    rep = q.shape[2] // kk.shape[2]
    kk, vv = (x.float().repeat_interleave(rep, dim=2) for x in (kk, vv))
    return causal_attention_plain(q.float(), kk, vv, pos, start)


def _causal_check(got, q, kk, vv, pos, start, what):
    """K4 against its plain version in f32 on the same values: f32
    within 1e-5; bf16 per element within 2^-7 |ref| + 2^-8 P.|V| +
    1e-5 (one bf16 ulp of the output, the probabilities rounded to bf16
    before P.V).  Returns the worst share of the limit."""
    ref = _causal_ref(q, kk, vv, pos, start)
    if got.dtype == torch.float32:
        lim = torch.full_like(ref, 1e-5)
    else:
        lim = (2.0 ** -7 * ref.abs() + 2.0 ** -8
               * _causal_ref(q, kk, vv.abs(), pos, start) + 1e-5)
    diff = (got.float() - ref.to(got.dtype).float()).abs()
    worst = (diff / lim).max().item()
    assert worst <= 1.0, (f"{what}: max err {diff.max().item()}, "
                          f"{worst:.3f} of its limit")
    return worst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,pos,starts,kh,d", [
    (256, 512, 0, (0, 100, 256), 4, 64),    # left pad + a batch-pad row
    (100, 256, 60, (0, 90, 256), 2, 64),    # joiner-style pos > 0, ragged S
    (64, 128, 64, (10, 70, 128), 1, 16),    # GQA rep 4 at the window tail
    (130, 200, 0, (0, 3, 200), 2, 128),     # T not a multiple of the tile
    (512, 512, 0, (120, 300, 512), 4, 64),  # a whole-window prefill, large
    #                                         starts (B=1 S=2048's shape)
    (128, 128, 0, (0, 40, 128), 2, 32),     # warps 0-1 keyless, 2-3 see
    #                                         key tile 0 only, 4-7 both
])
def test_causal_matches_plain(cuda, dtype, s, t, pos, starts, kh, d):
    rng = np.random.default_rng(s + t + pos + d)
    q, kk, vv = _causal_inputs(rng, 3, s, t, 4, kh, d, dtype, cuda)
    start = torch.tensor(starts, dtype=torch.int32, device=cuda)
    before = _cuda.LAUNCHES["causal_fwd"]
    got = causal_flash_attention(q, kk, vv, pos, start)
    assert _cuda.LAUNCHES["causal_fwd"] == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    _causal_check(got, q, kk, vv, pos, start, f"S={s} T={t} pos={pos}")
    # a query with no visible key is the mean of V over all T slots
    mean = vv[2].float().mean(dim=0).repeat_interleave(4 // kh, dim=0)
    lim = 1e-5
    if dtype == torch.bfloat16:
        abs_mean = vv[2].float().abs().mean(dim=0)
        lim = (2.0 ** -7 * mean.abs() + 2.0 ** -8
               * abs_mean.repeat_interleave(4 // kh, dim=0) + 1e-5)
    assert ((got[2].float() - mean[None]).abs() <= lim).all()


def test_causal_takes_a_row_of_the_batch_cache(cuda):
    """join_row prefills one row of the live batch cache: a (1, T, KH, D)
    slice, at pos > 0, in f32 and in bf16 (whose 16-byte check the row
    view passes)."""
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(11)
        q, kk, vv = _causal_inputs(rng, 4, 64, 256, 4, 2, 64, dtype, cuda)
        start = torch.tensor([150], dtype=torch.int32, device=cuda)
        got = causal_flash_attention(q[2:3], kk[2:3], vv[2:3], 128, start)
        _causal_check(got, q[2:3], kk[2:3], vv[2:3], 128, start,
                      f"join_row {dtype}")


def test_causal_takes_a_fused_qkv_split(cuda):
    """bf16 q and a k/v cache split from one fused projection pass the
    16-byte check and match the plain version."""
    rng = np.random.default_rng(12)
    qkv = torch.from_numpy(rng.standard_normal((2, 256, 3 * 128))
                           .astype(np.float32)).to(cuda, torch.bfloat16)
    q, kk, vv = (x.reshape(2, 256, 2, 64) for x in qkv.split(128, dim=-1))
    start = torch.tensor([0, 90], dtype=torch.int32, device=cuda)
    got = causal_flash_attention(q[:, 128:], kk, vv, 128, start)
    _causal_check(got, q[:, 128:], kk, vv, 128, start, "fused qkv")


def test_causal_rejects_misaligned_views(cuda):
    """A bf16 view whose base or row stride is not a multiple of 16
    bytes raises instead of launching."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((2, 64, 2 * 64 + 1))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    shifted = x[..., 1:].reshape(2, 64, 2, 64)    # base off by 2 bytes
    strided = x[..., :-1].reshape(2, 64, 2, 64)   # row stride 258 bytes
    good = strided.contiguous()
    start = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = _cuda.LAUNCHES["causal_fwd"]
    for q, kk, vv in ((shifted, good, good), (good, strided, good),
                      (good, good, strided)):
        with pytest.raises(ValueError, match="16 bytes"):
            causal_fwd_cuda(q, kk, vv, 0, start)
    assert _cuda.LAUNCHES["causal_fwd"] == before
    causal_fwd_cuda(good, good, good, 0, start)       # aligned: launches
    assert _cuda.LAUNCHES["causal_fwd"] == before + 1


def test_decoder_prefill_through_k4_matches_plain_attention(cuda):
    """A tiny f32 decoder on the card: a left-padded bucket-32 batch and
    a join at pos > 0 through K4 (flash_min_seq=16) against the same
    weights with the plain attention, logits within 1e-4."""
    from libsplinter_tpu_torch.models.decoder import (CompletionModel,
                                                      DecoderConfig)

    cfg = DecoderConfig.tiny(dtype=torch.float32, flash_min_seq=16)
    m = CompletionModel(cfg, buckets=(16, 32), temp=0.0, device=cuda)
    plain = CompletionModel(DecoderConfig.tiny(dtype=torch.float32,
                                               flash_min_seq=0),
                            buckets=(16, 32), temp=0.0,
                            params=m.module.state_dict(), device=cuda)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, 1024, n).astype(np.int32) for n in (30, 9, 2)]
    before = _cuda.LAUNCHES["causal_fwd"]
    got = [m.prefill_batch(prompts), m.join_row(prompts[1][:5], 2)]
    # the bucket-32 batch and the bucket-16 join at pos 16: both >= 16
    assert _cuda.LAUNCHES["causal_fwd"] == before + 2 * cfg.layers
    want = [plain.prefill_batch(prompts), plain.join_row(prompts[1][:5], 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def _paged_inputs(rng, lengths, *, kh, d, page, n_pages, kind, dev):
    """Random pools of storage `kind` (bf16, f32, int8 or int4) with
    one block per used page, shuffled into the rows' tables."""
    b = len(lengths)
    n_blocks = 1 + sum(-(-int(n) // page) or 1 for n in lengths)
    scales = None
    if kind in ("bf16", "f32"):
        pools = [torch.from_numpy(rng.standard_normal(
            (n_blocks, kh, page, d)).astype(np.float32)).to(
                dev, getattr(torch, {"bf16": "bfloat16",
                                     "f32": "float32"}[kind]))
            for _ in range(2)]
    else:
        lo, hi, dt, w = ((-127, 128, torch.int8, d) if kind == "int8"
                         else (0, 256, torch.uint8, d // 2))
        pools = [torch.from_numpy(rng.integers(lo, hi, (n_blocks, kh, page, w))
                                  ).to(dev, dt) for _ in range(2)]
        scales = [torch.from_numpy(rng.uniform(0.005, 0.05, (n_blocks, kh))
                                   .astype(np.float32)).to(dev)
                  for _ in range(2)]
    tables = np.zeros((b, n_pages), np.int32)
    ids = list(rng.permutation(np.arange(1, n_blocks)))
    for r, n in enumerate(lengths):
        for p in range(-(-int(n) // page)):
            tables[r, p] = ids.pop()
    return (pools, scales, torch.from_numpy(tables).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _paged_lengths(s, h, kh, page, pages):
    """Ragged lengths and the table width.  pages = 0: short rows (one
    split).  Otherwise rows over a table of `pages` pages, which K5's
    plan cuts into several splits: a row ending exactly on a split
    boundary, one a key past it, one a key short of two splits, a row
    of one key, dead rows and one that fills the table."""
    if not pages:
        lengths = [1, page, 0, 3 * page + 5, 2 * page - 1, 0]
        return lengths, -(-(max(lengths) + s) // page) + 1
    from libsplinter_tpu_torch.ops.paged_attention import _paged_plan

    pps, splits = _paged_plan(8, kh, pages, page, s)
    assert splits > 1
    sk = pps * page
    return [1, sk, 0, pages * page - s + 1, 2 * sk - 1, 0, sk + 1,
            (pages - 1) * page + 5], pages


@pytest.mark.parametrize("kind,s,h,kh,d,page,pages", [
    ("bf16", 1, 12, 12, 64, 16, 0),       # decode, rep 1
    ("f32", 1, 8, 4, 64, 16, 0),          # GQA rep 2
    ("bf16", 1, 6, 2, 128, 8, 0),         # rep 3, D 128, many small pages
    ("int8", 1, 8, 4, 64, 16, 0),
    ("int4", 1, 6, 2, 32, 16, 0),
    ("bf16", 5, 6, 2, 64, 16, 0),         # the multi-query stack, rep 3
    ("int4", 20, 4, 4, 64, 128, 0),       # multi-query, one page per row
    # several splits a row
    ("bf16", 1, 12, 12, 64, 128, 16),     # the lane's decode shape
    ("f32", 1, 12, 12, 64, 128, 16),
    ("int8", 1, 12, 4, 64, 128, 8),       # GQA rep 3
    ("int4", 1, 12, 12, 64, 128, 16),
    ("bf16", 1, 12, 1, 64, 16, 64),       # KH = 1 (rep 12), page 16
    ("int8", 1, 12, 1, 32, 64, 32),       # rep 12, D 32, page 64
    ("f32", 1, 8, 4, 128, 64, 16),        # D 128
    ("int4", 1, 6, 2, 128, 16, 40),       # D 128
    ("bf16", 3, 6, 2, 64, 16, 32),        # a stack crossing splits
    ("bf16", 5, 12, 12, 64, 128, 16),     # the speculative verify stack
    ("bf16", 64, 12, 12, 64, 128, 16),    # the lane's suffix stack
])
def test_paged_matches_plain(cuda, kind, s, h, kh, d, page, pages):
    """K5 against its plain version on the same pools: live rows within
    1e-5 (f32 and quantized pools, f32 queries) or the bf16 rounding
    bound (bf16), and the bf16 case again over the widened f32 pools
    within 1e-5; dead rows (length 0, one query token) exactly 0.  The
    cases with `pages` run several splits and the combine."""
    from libsplinter_tpu_torch.ops.paged_attention import (
        LAUNCHES_BY_QTOKENS, paged_attention, paged_attention_plain)

    rng = np.random.default_rng(h * 31 + s + d + page + pages)
    lengths, n_pages = _paged_lengths(s, h, kh, page, pages)
    (kp, vp), scales, tables, lens = _paged_inputs(
        rng, lengths, kh=kh, d=d, page=page, n_pages=n_pages, kind=kind,
        dev=cuda)
    qdt = torch.bfloat16 if kind == "bf16" else torch.float32
    shape = (len(lengths), h, d) if s == 1 else (len(lengths), s, h, d)
    q = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda, qdt)
    kw = {} if scales is None else {"k_scales": scales[0],
                                    "v_scales": scales[1]}
    before = _cuda.LAUNCHES["paged_fwd"]
    by_q = LAUNCHES_BY_QTOKENS[s]
    got = paged_attention(q, kp, vp, tables, lens, **kw)
    assert _cuda.LAUNCHES["paged_fwd"] == before + 1
    assert LAUNCHES_BY_QTOKENS[s] == by_q + 1
    if kind == "bf16":
        kp, vp, q = kp.float(), vp.float(), q.float()
    ref = paged_attention_plain(q, kp, vp, tables, lens,
                                kw.get("k_scales"), kw.get("v_scales"))
    torch.cuda.synchronize()
    assert got.dtype == qdt and got.shape == q.shape
    g4 = got.float() if s > 1 else got.float()[:, None]
    r4 = ref.float() if s > 1 else ref.float()[:, None]
    live = (lens.long()[:, None]
            + torch.arange(s, device=cuda)[None]) > 0   # sees a key
    if kind == "bf16":
        # one bf16 ulp of |ref| (the output's rounding) and 2^-8 of the
        # attention-weighted |V| (the probabilities' rounding before P.V)
        pv = paged_attention_plain(q, kp, vp.abs(), tables, lens)
        pv = pv if s > 1 else pv[:, None]
        diff = (g4[live] - r4[live].to(qdt).float()).abs()
        lim = 2.0 ** -7 * r4[live].abs() + 2.0 ** -8 * pv[live] + 1e-5
        assert (diff <= lim).all(), (diff / lim).max()
    else:
        torch.testing.assert_close(g4[live], r4[live], atol=1e-5, rtol=0)
    assert (g4[~live] == 0).all()
    if kind == "bf16":
        wide = paged_attention(q, kp, vp, tables, lens)
        w4 = wide if s > 1 else wide[:, None]
        torch.testing.assert_close(w4[live], r4[live], atol=1e-5, rtol=0)
        assert (w4[~live] == 0).all()


@pytest.mark.parametrize("kind", ["bf16", "int4"])
def test_paged_all_dead_batch_is_zero(cuda, kind):
    """Every row of length 0 over a table the plan splits: exact zeros
    (the combine reads no split, and no scratch)."""
    from libsplinter_tpu_torch.ops.paged_attention import (
        _paged_plan, paged_attention)

    rng = np.random.default_rng(5)
    assert _paged_plan(4, 12, 16, 128, 1)[1] > 1
    (kp, vp), scales, _, lens = _paged_inputs(
        rng, [0, 0, 0, 0], kh=12, d=64, page=128, n_pages=16, kind=kind,
        dev=cuda)
    tables = torch.from_numpy(rng.integers(0, kp.shape[0], (4, 16))
                              .astype(np.int32)).to(cuda)
    q = torch.randn(4, 12, 64, device=cuda).to(
        torch.bfloat16 if kind == "bf16" else torch.float32)
    kw = {} if scales is None else {"k_scales": scales[0],
                                    "v_scales": scales[1]}
    got = paged_attention(q, kp, vp, tables, lens, **kw)
    torch.cuda.synchronize()
    assert (got == 0).all()


def test_paged_replays_under_cuda_graph(cuda):
    """The wrapper never reads the device on the host: K5 (several
    splits and the combine) records under torch.cuda.graph capture, a
    replay equals the eager output, and a replay after new lengths and
    queries are copied in equals the eager output on them."""
    from libsplinter_tpu_torch.ops.paged_attention import (
        _paged_plan, paged_attention)

    rng = np.random.default_rng(6)
    assert _paged_plan(8, 12, 16, 128, 1)[1] > 1
    lengths = [int(x) for x in rng.integers(1, 2048, 8)]
    (kp, vp), _, tables, lens = _paged_inputs(
        rng, [2047] * 8, kh=12, d=64, page=128, n_pages=16, kind="bf16",
        dev=cuda)
    lens.copy_(torch.tensor(lengths, dtype=torch.int32))
    q = torch.randn(8, 12, 64, device=cuda).to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm up off the capture
        paged_attention(q, kp, vp, tables, lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _cuda.LAUNCHES["paged_fwd"]
    with torch.cuda.graph(graph):
        out = paged_attention(q, kp, vp, tables, lens)
    assert _cuda.LAUNCHES["paged_fwd"] == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, paged_attention(q, kp, vp, tables, lens))
    lens.copy_(torch.tensor([0, 5, 128, 129, 2047, 1, 1000, 256],
                            dtype=torch.int32))
    q.copy_(torch.randn(8, 12, 64, device=cuda).to(torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, paged_attention(q, kp, vp, tables, lens))
    assert (out[0] == 0).all()


def test_paged_takes_strided_query_views(cuda):
    """The decoder hands K5 (B, S, H, D) query views of a larger
    projection; the output is the same as for a contiguous copy."""
    from libsplinter_tpu_torch.ops.paged_attention import paged_attention

    rng = np.random.default_rng(4)
    (kp, vp), _, tables, lens = _paged_inputs(
        rng, [7, 40, 1], kh=2, d=64, page=16, n_pages=4, kind="f32",
        dev=cuda)
    big = torch.from_numpy(rng.standard_normal((3, 4, 2 * 4 * 64))
                           .astype(np.float32)).to(cuda)
    q = big[..., :4 * 64].reshape(3, 4, 4, 64)
    got = paged_attention(q, kp, vp, tables, lens)
    want = paged_attention(q.contiguous(), kp, vp, tables, lens)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _lane(rng, n, d, dev):
    x = rng.integers(-4, 5, size=(n, d)).astype(np.float32) / 4.0
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("nq", [1, 8, 20, 64, 200, 256, 300])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", [100, 99, 3])     # 4-byte copies at d % 4
def test_cosine_scores_match_plain(cuda, nq, bf16, d):
    rng = np.random.default_rng(nq)
    vec = torch.from_numpy(rng.standard_normal((5000, d))
                           .astype(np.float32)).to(cuda)
    vec[17] = 0.0                               # an un-embedded slot
    qry = torch.from_numpy(rng.standard_normal((nq, d))
                           .astype(np.float32)).to(cuda)
    mask = torch.from_numpy((rng.random(5000) > 0.2)
                            .astype(np.float32)).to(cuda)
    got = cosine_scores_cuda(vec, qry, mask, mxu_bf16=bf16)
    ref = _cosine_scores_plain(vec, qry, mask, mxu_bf16=bf16)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def _tie_lane(rng, n, d, dev):
    vec = _lane(rng, n, d, dev)
    vec[n // 3] = vec[5]                        # exact duplicates
    vec[n - 1] = vec[5]
    vec[n // 2] = vec[5] * 2.0                  # colinear: equal cosine
    vec[40:90] = 0.0                            # zero rows
    mask = torch.ones(n, device=dev)
    mask[100:180] = 0.0                         # filtered rows
    return vec, mask


@pytest.mark.parametrize("nq", [1, 8, 32, 129, 256, 300])
@pytest.mark.parametrize("k", [1, 10, 16, 128])
@pytest.mark.parametrize("bf16", [False, True])
def test_fused_topk_identical_to_plain(cuda, nq, k, bf16):
    """nq = 129 and 300 span several query tiles, the last one
    partial."""
    rng = np.random.default_rng(nq * 1000 + k)
    vec, mask = _tie_lane(rng, 20000, 96, cuda)
    qry = torch.cat([vec[[5]], _lane(rng, nq - 1, 96, cuda)])
    got_s, got_i = fused_topk_cuda(vec, qry, k, mask, mxu_bf16=bf16)
    ref_s, ref_i = _fused_topk_plain(vec, qry, k, mask, mxu_bf16=bf16)
    torch.testing.assert_close(got_s, ref_s, atol=0, rtol=0)
    assert torch.equal(got_i, ref_i)
    if k >= 3:       # query 0 is row 5: its duplicates tie first
        assert got_i[0, :3].tolist() == [5, 20000 // 3, 10000]


@pytest.mark.parametrize("d", [100, 99, 3])
@pytest.mark.parametrize("bf16", [False, True])
def test_fused_topk_any_depth(cuda, d, bf16):
    """d = 100 ends in a partial staged chunk; d = 99 and 3 leave the
    rows unaligned to 16 bytes, so the kernel loads them by 4-byte
    copies (never the plain version)."""
    rng = np.random.default_rng(d)
    vec, mask = _tie_lane(rng, 7000, d, cuda)
    qry = torch.cat([vec[[5]], _lane(rng, 40, d, cuda)])
    for k in (16, 128):
        before = _cuda.LAUNCHES["fused_topk"]
        got_s, got_i = fused_topk_cuda(vec, qry, k, mask, mxu_bf16=bf16)
        assert _cuda.LAUNCHES["fused_topk"] == before + 1
        ref_s, ref_i = _fused_topk_plain(vec, qry, k, mask, mxu_bf16=bf16)
        torch.testing.assert_close(got_s, ref_s, atol=0, rtol=0)
        assert torch.equal(got_i, ref_i)
    # a base off 16 bytes takes the same loader
    got_s, got_i = fused_topk_cuda(vec[1:], qry[1:], 16)
    ref_s, ref_i = _fused_topk_plain(vec[1:], qry[1:], 16)
    assert torch.equal(got_i, ref_i) and torch.equal(got_s, ref_s)


@pytest.mark.parametrize("nq", [8, 32, 256])
@pytest.mark.parametrize("bf16", [False, True])
def test_fused_topk_ties_at_the_kth_score(cuda, nq, bf16):
    """Hundreds of rows equal query 0's k-th score: runs inside one row
    tile, across tile edges (64, 128, 256 rows) and in tiles that other
    blocks own, so survivors pushed out of row order meet equality; the
    smallest rows must win, as in the plain version."""
    rng = np.random.default_rng(nq + 7)
    n, d = 40000, 96
    vec, mask = _tie_lane(rng, n, d, cuda)
    x = vec[5].clone()
    rows = np.r_[250:262, 1000:1200, 4090:4110, 8190:8200,
                 np.arange(300, n, 977)]
    vec[torch.from_numpy(rows).to(cuda)] = x
    vec[6000:6040] = 2.0 * x                     # colinear: equal cosine
    qry = torch.cat([vec[[5]], _lane(rng, nq - 1, d, cuda)])
    for k in (16, 128):
        got_s, got_i = fused_topk_cuda(vec, qry, k, mask, mxu_bf16=bf16)
        ref_s, ref_i = _fused_topk_plain(vec, qry, k, mask, mxu_bf16=bf16)
        torch.testing.assert_close(got_s, ref_s, atol=0, rtol=0)
        assert torch.equal(got_i, ref_i)
        assert (got_s[0] == got_s[0, 0]).all()   # all k tie at the top


def test_fused_topk_fewer_candidates_than_k(cuda):
    """Three candidates: the (-1e30, -1) filler past them, at k = 10 and
    k = 128, on both arms."""
    for k, bf16 in ((10, False), (128, False), (10, True), (128, True)):
        rng = np.random.default_rng(3)
        vec = torch.zeros(3000, 64, device=cuda)
        vec[[4, 1500, 2999]] = _lane(rng, 3, 64, cuda)
        qry = _lane(rng, 8, 64, cuda)
        s, i = fused_topk_cuda(vec, qry, k, mxu_bf16=bf16)
        assert (s[:, 3:] <= -1e29).all() and (i[:, 3:] == -1).all()
        assert sorted(i[0, :3].tolist()) == [4, 1500, 2999]
        ref_s, ref_i = _fused_topk_plain(vec, qry, k, mxu_bf16=bf16)
        assert torch.equal(i, ref_i) and torch.equal(s, ref_s)


@pytest.mark.parametrize("k", [129, 300])
def test_unfused_program_matches_plain_sort(cuda, k):
    """k > FUSED_K_MAX: K3 + the stable sort, ties to the smaller row."""
    rng = np.random.default_rng(k)
    vec, mask = _tie_lane(rng, 9000, 64, cuda)
    qry = torch.cat([vec[[5]], _lane(rng, 7, 64, cuda)])
    s, i = topk_program(k)(vec, qry, mask, None)
    ref_s, ref_i = _stable_topk(_cosine_scores_plain(vec, qry, mask).T, k)
    torch.testing.assert_close(s, ref_s, atol=0, rtol=0)
    assert torch.equal(i, ref_i)
