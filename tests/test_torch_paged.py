"""The torch port's paged slice against the JAX package, on the CPU:
K5's plain version (ops/paged_attention.paged_attention_plain) against
the Pallas kernel in interpret mode and against _paged_ref, the int8 and
int4 appends, the PagedKVCache allocator, and the paged CompletionModel
through the weight bridge (params_from_jax) on DecoderConfig.tiny() f32.

Tolerances: K5's plain version atol = rtol = 2e-5 in f32, the JAX
kernel tests' own bar (sums of 8-16 products and a softmax over <= 32
keys in another order).  Model logits atol 1e-4 (the bar of
tests/test_torch_decoder.py).  Appends: codes identical and scales within 1e-6 relative
(the same f32 ops in the same order).  Greedy tokens equal wherever the
top-2 logit gap exceeds GAP = 1e-3; int8 and int4 token agreement at
the JAX tests' thresholds (>= 75% over 16 tokens; >= 30% over 13 with a
>= 4-token exact prefix).  The anchor for paged decode is the JAX
package's DENSE decode (generate_tokens); its paged-vs-dense byte
comparisons are not pinned here."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jdec = pytest.importorskip("libsplinter_tpu.models.decoder")
jpa = pytest.importorskip("libsplinter_tpu.ops.paged_attention")

from libsplinter_tpu_torch.engine.prefix_cache import PrefixCache  # noqa: E402
from libsplinter_tpu_torch.models import decoder as tdec  # noqa: E402
from libsplinter_tpu_torch.ops import paged_attention as tpa  # noqa: E402

TOL = 2e-5
ATOL = 1e-4
GAP = 1e-3


# -- K5's plain version -------------------------------------------------------

def _build_paged(rng, lengths, *, KH, D, page, P):
    """Random f32 pools and shuffled tables for the ragged lengths
    (tests/test_paged_attention.py's layout)."""
    n_blocks = 1 + sum(-(-int(n) // page) or 1 for n in lengths)
    kp = rng.randn(n_blocks, KH, page, D).astype(np.float32)
    vp = rng.randn(n_blocks, KH, page, D).astype(np.float32)
    tables = np.zeros((len(lengths), P), np.int32)
    ids = list(range(1, n_blocks))
    rng.shuffle(ids)
    for b, n in enumerate(lengths):
        for p in range(-(-int(n) // page)):
            tables[b, p] = ids.pop()
    return kp, vp, tables


def _quantize(pool, qmax):
    d = np.abs(pool).max(axis=(2, 3)) / qmax
    d = np.where(d == 0, 1.0, d)
    q = np.clip(np.round(pool / d[:, :, None, None]), -qmax, qmax)
    return q.astype(np.int32), d.astype(np.float32)


def _storage(kind, kp, vp):
    """(port pools, JAX pools, scales) for float, int8 or int4."""
    if kind == "f32":
        return (kp, vp), (kp, vp), None
    qmax = 127.0 if kind == "int8" else 7.0
    (kq, ks), (vq, vs) = _quantize(kp, qmax), _quantize(vp, qmax)
    if kind == "int8":
        pools = (kq.astype(np.int8), vq.astype(np.int8))
    else:
        pools = tuple(np.array(jpa.pack_int4(jnp.asarray(x)))
                      for x in (kq, vq))
    return pools, pools, (ks, vs)


def _both(q, pools, tables, lengths, scales):
    """(torch plain, JAX interpret kernel, JAX _paged_ref) outputs."""
    tkw, jkw = {}, {}
    if scales is not None:
        tkw = {"k_scales": torch.from_numpy(scales[0]),
               "v_scales": torch.from_numpy(scales[1])}
        jkw = {"k_scales": jnp.asarray(scales[0]),
               "v_scales": jnp.asarray(scales[1])}
    got = tpa.paged_attention(
        torch.from_numpy(q), *(torch.from_numpy(p) for p in pools),
        torch.from_numpy(tables), torch.tensor(np.asarray(lengths),
                                               dtype=torch.int32),
        **tkw).numpy()
    jargs = (jnp.asarray(q), *(jnp.asarray(p) for p in pools),
             jnp.asarray(tables), jnp.asarray(lengths, np.int32))
    kern = np.asarray(jpa.paged_attention(*jargs, interpret=True, **jkw))
    jp = list(jargs[1:3])
    if scales is not None:
        jp = [jpa.dequantize_pool(jp[0], jkw["k_scales"]),
              jpa.dequantize_pool(jp[1], jkw["v_scales"])]
    ref = np.asarray(jpa._paged_ref(jargs[0], *jp, *jargs[3:]))
    return got, kern, ref


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
@pytest.mark.parametrize("H", [4, 6])                   # GQA rep 2, rep 3
def test_plain_matches_pallas_ragged(kind, H):
    """lengths [1, 8, 7, 19] at page 8, P 4: a single-token row, a row
    ending on a page boundary, an unaligned one and a multi-page one,
    shuffled block ownership."""
    rng = np.random.RandomState(7 + H)
    lengths = [1, 8, 7, 19]
    D = 16 if H == 4 else 8
    kp, vp, tables = _build_paged(rng, lengths, KH=2, D=D, page=8, P=4)
    pools, _, scales = _storage(kind, kp, vp)
    q = rng.randn(4, H, D).astype(np.float32)
    got, kern, ref = _both(q, pools, tables, lengths, scales)
    np.testing.assert_allclose(got, kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
def test_plain_dead_rows_and_no_gqa(kind):
    """rep 1 and a lengths == 0 row: live rows match the kernel; the
    kernel writes zeros for the dead row, the plain version (like
    _paged_ref) an average over the trash it gathers, which nobody
    reads."""
    rng = np.random.RandomState(11)
    lengths = [9, 0, 4]
    kp, vp, tables = _build_paged(rng, lengths, KH=4, D=8, page=4, P=4)
    pools, _, scales = _storage(kind, kp, vp)
    q = rng.randn(3, 4, 8).astype(np.float32)
    got, kern, ref = _both(q, pools, tables, lengths, scales)
    assert np.isfinite(got).all()
    assert np.abs(kern[1]).max() == 0.0
    np.testing.assert_allclose(got[[0, 2]], kern[[0, 2]], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
def test_plain_multiquery_causal_stack(kind):
    """q_tokens = 3: token t of the stack sees keys j < lengths + t —
    the stack equals the kernel's and equals single-token calls at
    lengths + t."""
    rng = np.random.RandomState(3)
    lengths = np.array([1, 8, 19], np.int32)
    kp, vp, tables = _build_paged(rng, lengths + 2, KH=2, D=16, page=8, P=4)
    pools, _, scales = _storage(kind, kp, vp)
    qm = rng.randn(3, 3, 4, 16).astype(np.float32)
    got, kern, ref = _both(qm, pools, tables, lengths, scales)
    np.testing.assert_allclose(got, kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    for t in range(3):
        single, _, _ = _both(qm[:, t], pools, tables, lengths + t, scales)
        np.testing.assert_allclose(got[:, t], single, rtol=TOL, atol=TOL)


def test_pack_unpack_and_dequantize_match_jax():
    """pack_int4/unpack_int4 are exact inverses over [-8, 7] in the
    split-half layout (low nibble element j, high element j + D/2),
    byte for byte the JAX package's; dequantize_pool agrees."""
    rng = np.random.RandomState(0)
    codes = rng.randint(-8, 8, size=(3, 2, 8, 16)).astype(np.int32)
    packed = tpa.pack_int4(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8 and packed.shape == (3, 2, 8, 8)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jpa.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(tpa.unpack_int4(packed).numpy(), codes)
    one = tpa.pack_int4(torch.tensor([[1, 2, 3, 4]]))[0]
    assert [int(b) & 0xF for b in one] == [9, 10]         # elements 0, 1
    assert [int(b) >> 4 for b in one] == [11, 12]         # elements 2, 3
    scales = rng.uniform(0.01, 1, (3, 2)).astype(np.float32)
    i8 = rng.randint(-127, 128, (3, 2, 8, 16)).astype(np.int8)
    for pool in (i8, packed.numpy()):
        np.testing.assert_allclose(
            tpa.dequantize_pool(torch.from_numpy(pool),
                                torch.from_numpy(scales)).numpy(),
            np.asarray(jpa.dequantize_pool(jnp.asarray(pool),
                                           jnp.asarray(scales))),
            rtol=1e-7, atol=0)


def test_cuda_launcher_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 2, 32)
    pool = torch.zeros(2, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_fwd_cuda(q, pool, pool, torch.zeros(1, 1, dtype=torch.int32),
                           torch.ones(1, dtype=torch.int32))


# -- the quantized appends -----------------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quant_append_matches_jax(kind):
    """Growing magnitudes rescale the page on every append; a second row
    writes another page, a dead row the trash block: codes and scales
    equal the JAX package's after every append."""
    rng = np.random.RandomState(0)
    page, KH, D = 8, 2, 4
    width = D if kind == "int8" else D // 2
    tdt, jdt = ((torch.int8, jnp.int8) if kind == "int8"
                else (torch.uint8, jnp.uint8))
    tpool = torch.zeros((4, KH, page, width), dtype=tdt)
    tsc = torch.zeros((4, KH))
    jpool, jsc = jnp.zeros((4, KH, page, width), jdt), jnp.zeros((4, KH))
    for i in range(page):
        x = (rng.randn(3, KH, D) * (1 + 0.5 * i)).astype(np.float32)
        bids = np.array([1, 3, 0], np.int32)
        offs = np.array([i, (i + 5) % page, 0], np.int32)
        tdec._quant_append(tpool, tsc, torch.from_numpy(bids).long(),
                           torch.from_numpy(offs).long(), torch.from_numpy(x))
        jpool, jsc = jdec._quant_append(jpool, jsc, jnp.asarray(bids),
                                        jnp.asarray(offs), jnp.asarray(x))
        np.testing.assert_array_equal(tpool.numpy()[1:], np.asarray(jpool)[1:])
        np.testing.assert_allclose(tsc.numpy()[1:], np.asarray(jsc)[1:],
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quant_append_offset0_resets_stale_scale(kind):
    """A write at in-page offset 0 treats the page as fresh: a tiny
    token after a huge previous owner quantizes at its own scale, as in
    the JAX package."""
    rng = np.random.RandomState(1)
    qmax = 127.0 if kind == "int8" else 7.0
    width, tdt = (4, torch.int8) if kind == "int8" else (2, torch.uint8)
    pool, sc = torch.zeros((2, 2, 8, width), dtype=tdt), torch.zeros((2, 2))
    bids, offs = torch.tensor([1]), torch.tensor([0])
    big = torch.from_numpy(rng.randn(1, 2, 4).astype(np.float32) * 100.0)
    tdec._quant_append(pool, sc, bids, offs, big)
    assert sc[1].min() > 0.1
    small = rng.randn(1, 2, 4).astype(np.float32) * 0.01
    tdec._quant_append(pool, sc, bids, offs, torch.from_numpy(small))
    deq = tpa.dequantize_pool(pool, sc).numpy()[1][:, 0]
    d_own = np.abs(small[0]).max(-1, keepdims=True) / qmax
    assert (np.abs(deq - small[0]) <= d_own / 2 + 1e-9).all()
    jpool, jsc = jnp.zeros((2, 2, 8, width),
                           jnp.int8 if kind == "int8" else jnp.uint8), \
        jnp.zeros((2, 2))
    for x in (big.numpy(), small):
        jpool, jsc = jdec._quant_append(jpool, jsc, jnp.asarray([1]),
                                        jnp.asarray([0]), jnp.asarray(x))
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool))


# -- PagedKVCache ---------------------------------------------------------------

def _cache(batch, **kw):
    cfg = tdec.DecoderConfig.tiny(max_len=128, dtype=torch.float32)
    return tdec.PagedKVCache(cfg, batch, device="cpu", **kw)


def test_pool_alloc_free_no_leak():
    cache = _cache(4, page=16, pool_pages=20)
    assert cache.free_pages == 20 and cache.used_pages == 0
    assert cache.ensure(0, 40) and cache.ensure(1, 16) and cache.ensure(2, 17)
    assert cache.used_pages == 6
    assert cache.ensure(0, 48) and cache.used_pages == 6   # grows in place
    assert cache.ensure(0, 49) and cache.used_pages == 7
    for r in range(4):
        cache.free_row(r)
    assert cache.used_pages == 0 and cache.free_pages == 20
    assert sorted(cache._free) == list(range(1, 21))
    assert (cache.tables == 0).all() and (cache.lengths == 0).all()


def test_pool_exhaustion_backpressures_not_partial():
    cache = _cache(2, page=16, pool_pages=8)
    assert cache.ensure(0, 96)
    assert not cache.ensure(1, 48)          # needs 3, only 2 free
    assert cache.used_pages == 6 and len(cache._owned[1]) == 0
    cache.free_row(0)
    assert cache.ensure(1, 48) and cache.used_pages == 3


def test_pool_window_cap_and_trash_block():
    cache = _cache(2, page=16, pool_pages=8)
    assert cache.pages_needed(10_000) == cache.pages_per_row == 8
    assert cache.ensure(0, 10_000)          # exactly the whole pool
    assert 0 not in cache._owned[0]
    with pytest.raises(ValueError):
        _cache(2, page=16, pool_pages=4)    # < one window


def test_pool_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.PagedKVCache(tdec.DecoderConfig.tiny(), 2)


def test_pool_bytes_and_storage():
    """device_mb from the tensors: int8 ~ 1/2 bf16 ~ 1/4 f32 and int4
    ~ 1/4 bf16, the scales the only overhead; kv_bytes_per_token halves
    from int8 to int4; an odd head dim cannot pack."""
    mb, caches = {}, {}
    for kvd in ("f32", "bf16", "int8", "int4"):
        caches[kvd] = _cache(2, page=16, pool_pages=16, kv_dtype=kvd)
        mb[kvd] = caches[kvd].device_mb()
        assert caches[kvd].kv_dtype == kvd
    assert abs(mb["int8"] / mb["bf16"] - 0.5) < 0.1
    assert abs(mb["int8"] / mb["f32"] - 0.25) < 0.1
    assert abs(mb["int4"] / mb["bf16"] - 0.25) < 0.1
    assert caches["int4"].k_pools[0].dtype == torch.uint8
    assert caches["int4"].k_pools[0].shape[-1] == 8
    assert caches["int4"].kv_bytes_per_token() * 2 == \
        caches["int8"].kv_bytes_per_token()
    with pytest.raises(ValueError, match="must be even"):
        tdec.PagedKVCache(tdec.DecoderConfig.tiny(hidden=28), 2, page=16,
                          kv_dtype="int4", device="cpu")


# -- the paged CompletionModel against the JAX package ----------------------

def _jax_params(cfg_j, seed=0):
    params = jdec.Decoder(cfg_j).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
        jdec.init_cache(cfg_j, 1), jnp.int32(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(scale=0.05, size=x.shape).astype(np.float32), params)


def _models(seed=0, **kw):
    cfg_j = jdec.DecoderConfig.tiny(dtype=jnp.float32)
    cfg_t = tdec.DecoderConfig.tiny(dtype=torch.float32)
    params = _jax_params(cfg_j, seed)
    common = dict(buckets=(16, 32), temp=0.0, suffix_buckets=(8, 16), **kw)
    jm = jdec.CompletionModel(cfg_j, params=params, **common)
    tm = tdec.CompletionModel(cfg_t, params=tdec.params_from_jax(params,
                                                                 cfg_t),
                              device="cpu", **common)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _models()


def _prompt(n, seed=1):
    return np.random.default_rng(seed).integers(3, 1024, n).astype(np.int32)


def _same_pools(jc, tc, row, n_tokens):
    """The row's committed pages equal in both pools (float: 1e-5;
    quantized: codes equal, scales within 1e-6 relative)."""
    bids = tc.tables[row, :-(-n_tokens // tc.page)]
    assert (jc.tables[row] == tc.tables[row]).all()
    for li in range(len(tc.k_pools)):
        for jp, tp in ((jc.k_pools[li], tc.k_pools[li]),
                       (jc.v_pools[li], tc.v_pools[li])):
            a, b = np.asarray(jp)[bids], tp.numpy()[bids]
            if tc.quantized:
                assert (np.abs(a.astype(np.int32) - b.astype(np.int32))
                        <= 1).all() and (a == b).mean() > 0.999
            else:
                np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
        if tc.quantized:
            np.testing.assert_allclose(tc.k_scales[li].numpy()[bids],
                                       np.asarray(jc.k_scales[li])[bids],
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_paged_prefill_row_matches_jax(models, kv_dtype):
    """Prefill logits within 1e-4 and the committed pages equal (the
    quantizing commit included), on a row whose pages are not the first
    of the pool."""
    jm, tm = models
    jc = jm.init_paged(3, page=8, kv_dtype=kv_dtype)
    tc = tm.init_paged(3, page=8, kv_dtype=kv_dtype)
    for c in (jc, tc):
        assert c.ensure(0, 12)                 # another row's pages first
    prompt = _prompt(19)                         # bucket 32, 3 pages
    got = tm.paged_prefill_row(tc, prompt, 1)
    want = jm.paged_prefill_row(jc, prompt, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    assert tc.lengths[1] == jc.lengths[1] == 19
    _same_pools(jc, tc, 1, 19)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_paged_append_prefill_matches_jax(models, kv_dtype):
    """A mapped 16-token prefix plus a 21-token suffix (loops the
    largest suffix bucket, 16): the suffix stack's logits within 1e-4 of
    the JAX package's, and the step after it too."""
    jm, tm = models
    prefix, tail = _prompt(16, seed=2), _prompt(21, seed=3)
    out = []
    for m in (jm, tm):
        cache = m.init_paged(3, page=8, kv_dtype=kv_dtype)
        m.paged_prefill_row(cache, prefix, 0)
        cache.map_shared(1, [int(b) for b in cache.tables[0, :2]])
        cache.lengths[1] = 16
        assert cache.ensure(1, 40)
        lg = np.asarray(m.paged_append_prefill(cache, tail, 1))
        assert cache.lengths[1] == 37
        out.append((lg, cache))
    np.testing.assert_allclose(out[1][0], out[0][0], atol=ATOL, rtol=0)
    _same_pools(out[0][1], out[1][1], 1, 37)


def _torch_step(tm, cache, toks):
    """One paged decode step through the port's module: logits (B, V)."""
    with torch.no_grad():
        logits = tm.module(torch.from_numpy(np.asarray(toks, np.int64))[:, None],
                           cache.layers(), 0,
                           lengths=torch.from_numpy(cache.lengths.copy()),
                           tables=torch.from_numpy(cache.tables.copy()))
    cache.lengths[cache.lengths > 0] += 1
    return logits[:, 0].numpy()


def _jax_step(jm, cache, toks):
    lay = (list(zip(cache.k_pools, cache.v_pools, cache.k_scales,
                    cache.v_scales)) if cache.quantized
           else list(zip(cache.k_pools, cache.v_pools)))
    logits, new = jm.module.apply(
        jm.params, jnp.asarray(np.asarray(toks, np.int32))[:, None], lay,
        jnp.int32(0), None, jnp.asarray(cache.lengths),
        jnp.asarray(cache.tables))
    cache.k_pools = [c[0] for c in new]
    cache.v_pools = [c[1] for c in new]
    if cache.quantized:
        cache.k_scales = [c[2] for c in new]
        cache.v_scales = [c[3] for c in new]
    cache.lengths[cache.lengths > 0] += 1
    return np.asarray(logits)[:, 0]


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_paged_decode_steps_match_jax(models, kv_dtype):
    """Three paged decode steps over two live rows and a dead one, the
    same token columns into both: every live row's logits within 1e-4
    (the appends, rotary positions and K5's causal mask agree)."""
    jm, tm = models
    jc = jm.init_paged(3, page=8, kv_dtype=kv_dtype)
    tc = tm.init_paged(3, page=8, kv_dtype=kv_dtype)
    for m, c in ((jm, jc), (tm, tc)):
        m.paged_prefill_row(c, _prompt(15), 0)   # ends one short of a page
        m.paged_prefill_row(c, _prompt(5, seed=4), 2)
        for r in (0, 2):
            assert c.ensure(r, int(c.lengths[r]) + 4)
    for col in ([5, 0, 900], [17, 0, 3], [2, 0, 44]):
        got, want = _torch_step(tm, tc, col), _jax_step(jm, jc, col)
        np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], atol=ATOL,
                                   rtol=0)


def test_paged_greedy_tokens_match_dense_anchor(models):
    """The dense anchor: JAX's serial generate_tokens at temp 0.  The
    port's paged prefill + decode steps, teacher-forced on those tokens,
    pick the same argmax wherever the top-2 gap exceeds GAP, and the
    port's own paged_decode_chunk stream agrees up to the first near
    tie."""
    jm, tm = models
    prompt = _prompt(17, seed=5)
    want = [int(t) for t in jm.generate_tokens(prompt, 14, chunk=4)]
    jm.reset()
    cache = tm.init_paged(2, page=8)
    assert cache.ensure(0, 17 + 14)
    logits = [tm.paged_prefill_row(cache, prompt, 0)]
    for t in want[:-1]:
        logits.append(_torch_step(tm, cache, [t, 0])[0])
    logits = np.stack(logits)
    top = np.sort(logits, axis=-1)
    gaps = top[:, -1] - top[:, -2]
    ok = gaps > GAP
    assert ok.sum() >= len(want) // 2
    np.testing.assert_array_equal(logits.argmax(-1)[ok], np.asarray(want)[ok])
    cache.free_row(0)
    first = int(np.argmax(tm.paged_prefill_row(cache, prompt, 0)))
    got = [first] + [int(x) for x in tm.paged_decode_chunk(
        cache, np.array([first, 0]), 13)[0]]
    for g, w, gap in zip(got, want, gaps):
        if gap <= GAP:
            break
        assert g == w
    cache.reset()
    assert cache.used_pages == 0


def _greedy_paged(m, kv_dtype, prompt, n_chunks, chunk=3):
    cache = m.init_paged(2, page=16, kv_dtype=kv_dtype)
    out = [int(np.argmax(m.paged_prefill_row(cache, prompt, 0)))]
    toks = np.array([out[0], 0], np.int32)
    for _ in range(n_chunks):
        blk = m.paged_decode_chunk(cache, toks, chunk)
        out += [int(x) for x in blk[0]]
        toks = blk[:, -1].astype(np.int32)
    cache.reset()
    return out


def test_quantized_token_agreement():
    """Greedy paged decode over int8 and int4 pools against the f32
    pool of the same model: the JAX tests' thresholds (int8 >= 75% over
    16 tokens, first token exact; int4 >= 30% over 13 with a >= 4-token
    exact prefix), on the JAX tests' own model (seed 1, bridged)."""
    cfg_j = jdec.DecoderConfig.tiny(dtype=jnp.float32)
    jm = jdec.CompletionModel(cfg_j, buckets=(16, 32), temp=0.0, seed=1)
    cfg_t = tdec.DecoderConfig.tiny(dtype=torch.float32)
    m = tdec.CompletionModel(cfg_t, buckets=(16, 32), temp=0.0,
                             params=tdec.params_from_jax(jm.params, cfg_t),
                             device="cpu")
    prompt = np.arange(1, 8, dtype=np.int32)
    f32 = _greedy_paged(m, "f32", prompt, 5)
    i8 = _greedy_paged(m, "int8", prompt, 5)
    assert f32[0] == i8[0]
    assert np.mean([a == b for a, b in zip(f32, i8)]) >= 0.75, (f32, i8)
    i4 = _greedy_paged(m, "int4", prompt, 4)
    assert f32[0] == i4[0]
    prefix = 0
    for a, b in zip(f32, i4):
        if a != b:
            break
        prefix += 1
    assert prefix >= 4, (f32, i4)
    assert np.mean([a == b for a, b in zip(f32[:13], i4)]) >= 0.3


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cow_row_equals_private_row(models, kv_dtype):
    """A full-cover joiner (its whole prompt mapped from the donor's
    tree pages, entering at P-1 and replaying the last token into a
    copy-on-write page) decodes the donor's stream exactly; the shared
    pages (and an int8 pool's scales) stay byte-stable."""
    _, tm = models
    cache = tm.init_paged(4, page=8, kv_dtype=kv_dtype)
    pc = PrefixCache(cache.page)
    pc.attach(cache)
    cache.prefix_cache = pc
    prompt = _prompt(24, seed=6)                  # 3 full pages
    l0 = tm.paged_prefill_row(cache, prompt, 0)
    assert pc.insert(prompt, cache, 0) == 3
    shared = [int(b) for b in cache.tables[0, :3]]
    before = [p[shared].clone() for p in cache.k_pools]
    if kv_dtype:
        sc_before = [s[shared].clone() for s in cache.k_scales]
    bids, match = pc.lookup(prompt)
    assert match == 24 and bids == shared
    cache.map_shared(1, bids)
    cache.lengths[1] = 23
    assert cache.ensure(1, 40)
    toks = np.full((4,), -1, np.int64)
    toks[0], toks[1] = int(np.argmax(l0)), int(prompt[-1])
    out = tm.paged_decode_chunk(cache, toks, 7)
    assert [int(x) for x in out[1]] == \
        [int(toks[0])] + [int(x) for x in out[0][:6]]
    assert pc.stats.cow_copies == 1
    for p, b in zip(cache.k_pools, before):
        assert torch.equal(p[shared], b)
    if kv_dtype:
        for s, b in zip(cache.k_scales, sc_before):
            assert torch.equal(s[shared], b)
    cache.free_row(0)
    cache.free_row(1)
    assert pc.evictable_count() == 3
    assert cache.available_pages == cache.n_blocks - 1


def test_suffix_prefill_matches_private(models):
    """Partial hit: mapped prefix + suffix stack gives the first token
    and decode stream of a private full prefill, for a suffix shorter
    and one longer than the largest suffix bucket."""
    _, tm = models
    cache = tm.init_paged(4, page=8)
    prefix = _prompt(16, seed=7)
    tm.paged_prefill_row(cache, prefix, 0)
    for extra in (3, 21):
        full = np.concatenate([prefix, _prompt(extra, seed=extra)])
        cache.map_shared(1, [int(b) for b in cache.tables[0, :2]])
        cache.lengths[1] = 16
        assert cache.ensure(1, len(full) + 8)
        t = int(np.argmax(tm.paged_append_prefill(cache, full[16:], 1)))
        ref = tm.init_paged(2, page=8)
        tr = int(np.argmax(tm.paged_prefill_row(ref, full, 0)))
        assert t == tr
        ta = np.full((4,), -1, np.int64)
        ta[1] = t
        tb = np.array([tr, -1])
        np.testing.assert_array_equal(tm.paged_decode_chunk(cache, ta, 6)[1],
                                      tm.paged_decode_chunk(ref, tb, 6)[0])
        cache.free_row(1)


def test_pool_exhaustion_raises_for_unreserved(models):
    """A chunk that must grow a row past the pool raises (admission's
    reservation makes this unreachable in serving)."""
    _, tm = models
    cfg = tm.cfg
    cache = tm.init_paged(2, page=16, pool_pages=cfg.max_len // 16)
    tm.paged_prefill_row(cache, np.arange(1, 15, dtype=np.int32), 0)
    assert cache.ensure(1, cfg.max_len - 16)
    cache.lengths[1] = 15
    with pytest.raises(RuntimeError, match="pool exhausted"):
        tm.paged_decode_chunk(cache, np.array([1, 1]), 8)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_paged_warmup_pins_compile_count(kv_dtype):
    """After warmup_paged, join/finish/join cycles at other prompt
    lengths and occupancies run no new paged shape."""
    m = tdec.CompletionModel(tdec.DecoderConfig.tiny(dtype=torch.float32),
                             buckets=(16, 32), temp=0.0, seed=1,
                             device="cpu", suffix_buckets=(8,))
    cache = m.init_paged(2, page=16, kv_dtype=kv_dtype)
    pc = PrefixCache(cache.page)
    pc.attach(cache)
    cache.prefix_cache = pc
    m.warmup_paged(cache, chunk=4)
    base = m.compile_count()
    assert base > 0
    for prompt in (np.array([1, 2, 3], np.int32),
                   np.arange(1, 12, dtype=np.int32)):
        lg = m.paged_prefill_row(cache, prompt, 0)
        toks = np.array([int(np.argmax(lg)), 0], np.int32)
        m.paged_decode_chunk(cache, toks, 4)
        m.paged_prefill_row(cache, np.array([7, 7], np.int32), 1)
        m.paged_decode_chunk(cache, toks, 4)
        cache.free_row(0)
        cache.free_row(1)
    assert m.compile_count() == base
