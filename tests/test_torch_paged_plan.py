"""K5's split-K design on the CPU: the launch plan (``_paged_plan``, a
pure function of the shapes) and the split-and-merge arithmetic.

The kernel (csrc/paged_fwd.cu) gives each block the keys of `pps`
table pages, keeps an online softmax (m, l, acc) per query row over
them, and a combine merges the splits in split order:

    out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s

reading only the splits that hold one of the row's keys.  ``_split_merge``
below renders that arithmetic in plain torch and Python floats (the K
scale folded into the logit, the V scale into P.V, as the kernel does);
it is a test helper, never on the serving path.  It is held against the port's
plain version, the JAX package's ``_paged_ref`` and its Pallas kernel
in interpret mode, on seeded numpy inputs over f32, int8 and int4
pools.  Tolerance 1e-5 (atol and rtol): the same f32 math summed in
another order over at most 64 keys of 8-16 products.  Rows that see no
key: exact zeros in the merge and in the Pallas kernel (the plain
version and _paged_ref average the trash they gather, which nobody
reads)."""
import math

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
jpa = pytest.importorskip("libsplinter_tpu.ops.paged_attention")

from libsplinter_tpu_torch.ops import paged_attention as tpa  # noqa: E402

TOL = 1e-5


# -- the plan -------------------------------------------------------------

@pytest.mark.parametrize("b,kh,n_pages,page,s", [
    (32, 12, 16, 128, 1),        # the continuous lane's decode step
    (32, 4, 16, 128, 1),         # GQA 12/4
    (1, 12, 16, 128, 64),        # a suffix prefill's bucket-64 stack
    (32, 12, 16, 128, 16),
    (6, 2, 7, 16, 3),
    (256, 32, 16, 128, 1),       # a grid full without splits
    (1, 1, 1, 128, 1),
    (4, 2, 40, 8, 1),
    (8, 1, 64, 16, 1),
    (3, 5, 33, 7, 2),            # a page that is not a power of two
])
def test_paged_plan_covers_every_page_once(b, kh, n_pages, page, s):
    pps, splits = tpa._paged_plan(b, kh, n_pages, page, s)
    assert 1 <= pps <= n_pages and splits >= 1
    assert splits == -(-n_pages // pps)
    covered = [p for sp in range(splits)
               for p in range(sp * pps, min((sp + 1) * pps, n_pages))]
    assert covered == list(range(n_pages))
    # a split holds at least PAGED_SPLIT_KEYS keys unless the table is
    # shorter than that
    assert pps * page >= min(tpa.PAGED_SPLIT_KEYS, n_pages * page)
    # the same shapes, the same plan (no input but the shapes)
    assert tpa._paged_plan(b, kh, n_pages, page, s) == (pps, splits)


def test_paged_plan_fills_the_card_at_the_lane_shape():
    """B = 32, KH = 12, P = 16, page = 128: at least two waves of
    PAGED_BLOCKS_PER_SM blocks on each of the H100's SMs, where one
    block per (row, kv head) would be under one; a grid that is full
    already takes one split; a stack's row tiles count toward the
    grid."""
    sms = tpa.H100_SMS
    wave = sms * tpa.PAGED_BLOCKS_PER_SM
    b, kh = 32, 12
    pps, splits = tpa._paged_plan(b, kh, 16, 128, 1)
    assert splits > 1 and b * kh < wave
    assert b * kh * splits >= 2 * wave
    assert tpa._paged_plan(256, 32, 16, 128, 1) == (16, 1)
    one = tpa._paged_plan(1, 12, 16, 128, 1)[1]
    stack = tpa._paged_plan(1, 12, 16, 128, 64)[1]
    assert 1 < stack <= one
    assert tpa._paged_plan(32, 12, 16, 128, 1, sms=264)[1] >= splits


# -- the split-and-merge arithmetic ------------------------------------------

def _split_merge(q, k_pool, v_pool, tables, lengths, pps, k_scales=None,
                 v_scales=None):
    """K5's arithmetic in plain torch: per split of `pps` table pages an
    online-softmax state (m, l, acc) per query row, then the combine
    over the row's live splits.  q: (B, S, H, D) f32."""
    quant = k_scales is not None
    if quant:
        kc = (tpa.unpack_int4(k_pool) if k_pool.dtype == torch.uint8
              else k_pool.float())
        vc = (tpa.unpack_int4(v_pool) if v_pool.dtype == torch.uint8
              else v_pool.float())
    else:
        kc, vc = k_pool.float(), v_pool.float()
    b, s, h, d = q.shape
    kh, page = kc.shape[1], kc.shape[2]
    rep = h // kh
    n_pages = tables.shape[1]
    cap, sk = n_pages * page, pps * page
    splits = -(-n_pages // pps)
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros(b, s, h, d)
    for bi in range(b):
        for t in range(s):
            kv = min(max(int(lengths[bi]), 0) + t, cap)
            live = -(-kv // sk)
            for hi in range(h):
                g = hi // rep
                parts = []
                for sp in range(splits):
                    m, l, acc = tpa.NEG_INF, 0.0, torch.zeros(d)
                    for j in range(sp * sk, min((sp + 1) * sk, kv)):
                        bid = int(tables[bi, j // page])
                        ks = (scale * float(k_scales[bid, g]) if quant
                              else scale)
                        vs = float(v_scales[bid, g]) if quant else 1.0
                        x = float(torch.dot(q[bi, t, hi],
                                            kc[bid, g, j % page])) * ks
                        mn = max(m, x)
                        corr, p = math.exp(m - mn), math.exp(x - mn)
                        l = l * corr + p
                        acc = acc * corr + p * vs * vc[bid, g, j % page]
                        m = mn
                    parts.append((m, l, acc))
                if live == 0:
                    continue
                mx = max(parts[sp][0] for sp in range(live))
                w = [math.exp(parts[sp][0] - mx) for sp in range(live)]
                ls = sum(wi * parts[sp][1] for sp, wi in enumerate(w))
                a = sum(wi * parts[sp][2] for sp, wi in enumerate(w))
                out[bi, t, hi] = a / ls if ls > 0 else 0.0
    return out


def _pools(rng, lengths, s, kh, d, page, n_pages, kind):
    """Seeded pools (f32, or int8 / packed int4 with per-page scales)
    and shuffled tables covering each row's keys j < length + S - 1."""
    need = [-(-(int(n) + s - 1) // page) for n in lengths]
    n_blocks = 1 + sum(need) + 1
    kp = rng.randn(n_blocks, kh, page, d).astype(np.float32)
    vp = rng.randn(n_blocks, kh, page, d).astype(np.float32)
    tables = np.zeros((len(lengths), n_pages), np.int32)
    ids = list(rng.permutation(np.arange(1, n_blocks)))
    for r, n in enumerate(need):
        for p in range(n):
            tables[r, p] = ids.pop()
    if kind == "f32":
        return (kp, vp), None, tables
    qmax = 127.0 if kind == "int8" else 7.0
    pools, scales = [], []
    for x in (kp, vp):
        sc = np.abs(x).max(axis=(2, 3)) / qmax
        codes = np.clip(np.round(x / sc[:, :, None, None]), -qmax, qmax)
        pools.append(codes.astype(np.int8) if kind == "int8" else
                     np.array(jpa.pack_int4(jnp.asarray(
                         codes.astype(np.int32)))))
        scales.append(sc.astype(np.float32))
    return pools, scales, tables


def _run(lengths, *, s, h, kh, d, page, n_pages, pps, kind, seed):
    rng = np.random.RandomState(seed)
    pools, scales, tables = _pools(rng, lengths, s, kh, d, page, n_pages,
                                   kind)
    q = rng.randn(len(lengths), s, h, d).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    tp = [torch.from_numpy(p) for p in pools]
    tsc = [torch.from_numpy(x) for x in scales] if scales else [None] * 2
    merged = _split_merge(torch.from_numpy(q), *tp, torch.from_numpy(tables),
                          torch.from_numpy(lens), pps, *tsc).numpy()
    plain = tpa.paged_attention_plain(
        torch.from_numpy(q), *tp, torch.from_numpy(tables),
        torch.from_numpy(lens), *tsc).numpy()
    jargs = (jnp.asarray(q), *(jnp.asarray(p) for p in pools),
             jnp.asarray(tables), jnp.asarray(lens))
    jkw = ({} if scales is None else
           {"k_scales": jnp.asarray(scales[0]),
            "v_scales": jnp.asarray(scales[1])})
    kern = np.asarray(jpa.paged_attention(*jargs, interpret=True, **jkw))
    jp = list(jargs[1:3])
    if scales is not None:
        jp = [jpa.dequantize_pool(jp[0], jkw["k_scales"]),
              jpa.dequantize_pool(jp[1], jkw["v_scales"])]
    ref = np.asarray(jpa._paged_ref(jargs[0], *jp, *jargs[3:]))
    sees = (lens[:, None] + np.arange(s)[None]) > 0             # (B, S)
    np.testing.assert_allclose(merged, kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(merged[sees], plain[sees], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(merged[sees], ref[sees], rtol=TOL, atol=TOL)
    assert (merged[~sees] == 0).all() and (kern[~sees] == 0).all()
    return merged


KINDS = ["f32", "int8", "int4"]


@pytest.mark.parametrize("kind", KINDS)
def test_merge_rows_on_and_across_split_boundaries(kind):
    """Page 4, splits of 2 pages (8 keys): a row ending exactly on a
    split boundary (8, 16), one a key past it (9), one a key short (15),
    a one-key row, a dead row and a full table (24)."""
    _run([8, 16, 9, 15, 1, 0, 24], s=1, h=2, kh=2, d=8, page=4,
         n_pages=6, pps=2, kind=kind, seed=1)


@pytest.mark.parametrize("kind", KINDS)
def test_merge_stack_crossing_splits(kind):
    """S = 3 stacks: token t sees j < length + t.  Length 8 on a split
    boundary leaves split 1 without a key for token 0 but not for tokens
    1 and 2; length 0 leaves token 0 keyless; a stack whose last token
    reaches the end of the table."""
    _run([8, 0, 5, 22], s=3, h=4, kh=2, d=8, page=4, n_pages=6, pps=2,
         kind=kind, seed=2)


@pytest.mark.parametrize("kind", KINDS)
def test_merge_gqa_rep3_odd_split(kind):
    """GQA rep 3 (H = 6 over KH = 2), splits of 3 pages of 4 keys (the
    last split short: 7 pages)."""
    _run([1, 12, 13, 27, 0, 20], s=1, h=6, kh=2, d=16, page=4, n_pages=7,
         pps=3, kind=kind, seed=3)


@pytest.mark.parametrize("kind", KINDS)
def test_merge_all_dead_batch(kind):
    """Every row dead: no split is read, every output is exact zeros."""
    out = _run([0, 0, 0], s=1, h=2, kh=1, d=8, page=4, n_pages=4, pps=1,
               kind=kind, seed=4)
    assert (out == 0).all()


def test_merge_one_split_equals_many():
    """The merge is the same function whatever the split: one split of
    the whole table against splits of one page."""
    rng = np.random.RandomState(5)
    lengths = [3, 16, 7, 11]
    (kp, vp), _, tables = _pools(rng, lengths, 2, 2, 8, 4, 5, "f32")
    q = torch.from_numpy(rng.randn(4, 2, 4, 8).astype(np.float32))
    args = (torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(tables), torch.tensor(lengths))
    one = _split_merge(q, *args, pps=5)
    many = _split_merge(q, *args, pps=1)
    np.testing.assert_allclose(one.numpy(), many.numpy(), rtol=TOL, atol=TOL)
