"""The torch port's decoder and CompletionModel against the JAX
package's flax decoder, on the CPU, through the weight bridge
(params_from_jax), with every parameter leaf perturbed off its init
(seeded numpy) so the norms are not at identity.

The anchor is the JAX package's DENSE decode: Decoder.apply logits for
prefill and S=1 steps, serial generate_tokens and generate_batch at
temp=0, f32 on the CPU (the paged/sharded decode paths of the JAX
package are held to each other elsewhere and are not the reference
here).

Tolerances: f32 logits atol 1e-4 (12-wide sums in another order through
two layers and an f32 LM head over a 1024-id vocab); bf16 activations:
cosine >= 0.999 per logits row (bf16 rounds at other places in the two
frameworks); greedy tokens equal wherever the top-2 logit gap exceeds
GAP = 1e-3, ten times the logits tolerance, so a near-tie of random
weights cannot flake.  Sampling draws threefry bits in JAX and Philox in
torch: the nucleus itself must be equal, the torch draws are held to
the nucleus distribution (4000 draws, each frequency within 0.03, about
four standard deviations)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jdec = pytest.importorskip("libsplinter_tpu.models.decoder")

from libsplinter_tpu_torch.models import decoder as tdec  # noqa: E402

ATOL = 1e-4
GAP = 1e-3


def _configs(dtype="float32", **kw):
    return (jdec.DecoderConfig.tiny(dtype=getattr(jnp, dtype), **kw),
            tdec.DecoderConfig.tiny(dtype=getattr(torch, dtype), **kw))


def _jax_params(cfg_j, seed=0):
    params = jdec.Decoder(cfg_j).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
        jdec.init_cache(cfg_j, 1), jnp.int32(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(scale=0.05, size=x.shape).astype(np.float32), params)


def _models(dtype="float32", buckets=(16, 32), seed=0, **kw):
    cfg_j, cfg_t = _configs(dtype, **kw)
    params = _jax_params(cfg_j, seed)
    jm = jdec.CompletionModel(cfg_j, params=params, buckets=buckets,
                              temp=0.0)
    tm = tdec.CompletionModel(cfg_t, params=tdec.params_from_jax(params,
                                                                 cfg_t),
                              buckets=buckets, temp=0.0, device="cpu")
    return jm, tm


def _prompt(n, seed=1, vocab=1024):
    return np.random.default_rng(seed).integers(3, vocab, n).astype(np.int32)


def _cosine_rows(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _gap(logits):
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


def test_bridge_covers_every_leaf():
    cfg_j, cfg_t = _configs()
    sd = tdec.params_from_jax(_jax_params(cfg_j), cfg_t)
    module = tdec.Decoder(cfg_t)
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(sd)


@pytest.mark.parametrize("flash_min_seq", [0, 16])
def test_prefill_and_decode_logits_match_flax(flash_min_seq):
    """flash_min_seq=16 puts the port's causal_flash_attention (K4's CPU
    path) on the bucket-32 prefill; 0 keeps the plain attention."""
    jm, tm = _models(flash_min_seq=flash_min_seq)
    prompt = _prompt(20)                             # bucket 32
    np.testing.assert_allclose(tm.prefill(prompt), jm.prefill(prompt),
                               atol=ATOL, rtol=0)
    for tok in (5, 900, 17, 3):
        np.testing.assert_allclose(tm.decode_one(tok), jm.decode_one(tok),
                                   atol=ATOL, rtol=0)
    assert tm.pos == jm.pos == 24


def test_full_forward_matches_flax_apply():
    """Decoder.apply over a left-padded batch, every position's logits."""
    cfg_j, cfg_t = _configs(flash_min_seq=16)
    params = _jax_params(cfg_j, seed=4)
    ids = np.random.default_rng(2).integers(3, 1024, (3, 24)).astype(np.int32)
    start = np.asarray([0, 9, 24], np.int32)      # the last row: all pad
    want, _ = jdec.Decoder(cfg_j).apply(params, jnp.asarray(ids),
                                        jdec.init_cache(cfg_j, 3),
                                        jnp.int32(0), jnp.asarray(start))
    module = tdec.Decoder(cfg_t)
    module.load_state_dict(tdec.params_from_jax(params, cfg_t))
    with torch.no_grad():
        got = module(torch.from_numpy(ids).long(), tdec.init_cache(cfg_t, 3),
                     0, torch.from_numpy(start))
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                               atol=ATOL, rtol=0)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("flash_min_seq", [0, 16])
def test_prefill_batch_and_join_row_match_flax(flash_min_seq):
    jm, tm = _models(flash_min_seq=flash_min_seq, seed=2)
    prompts = [_prompt(n, seed=n) for n in (19, 4, 11)]   # bucket 32, bp 4
    np.testing.assert_allclose(tm.prefill_batch(prompts),
                               jm.prefill_batch(prompts), atol=ATOL, rtol=0)
    joiner = _prompt(13, seed=9)
    np.testing.assert_allclose(tm.join_row(joiner, 1),
                               jm.join_row(joiner, 1), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tm._start.numpy(), np.asarray(jm._start))
    assert tm.join_budget() == jm.join_budget() == 32
    # one batched step over the joined cache: every row's logits agree
    col = np.asarray([7, 8, 9, 0], np.int32)
    got = tm._fn(torch.from_numpy(col[:, None]).long(), tm._cache, tm.pos,
                 tm._start)[:3, 0].numpy()
    want, _ = jm._fn(jm.params, jnp.asarray(col[:, None]), jm._cache,
                     jnp.int32(jm.pos), jm._start)
    np.testing.assert_allclose(got, np.asarray(want)[:3, 0], atol=ATOL,
                               rtol=0)


def test_bf16_logits_close_to_flax_bf16():
    jm, tm = _models("bfloat16", flash_min_seq=16, seed=3)
    prompts = [_prompt(n, seed=n) for n in (30, 6)]
    cos = _cosine_rows(tm.prefill_batch(prompts), jm.prefill_batch(prompts))
    assert cos.min() >= 0.999, cos
    jm.reset()
    tm.reset()
    rows = [tm.prefill(prompts[0])] + [tm.decode_one(t) for t in (4, 5)]
    want = [jm.prefill(prompts[0])] + [jm.decode_one(t) for t in (4, 5)]
    cos = _cosine_rows(np.stack(rows), np.stack(want))
    assert cos.min() >= 0.999, cos


def _teacher_forced(model, prompt, toks):
    logits = [model.prefill(prompt)]
    logits += [model.decode_one(int(t)) for t in toks[:-1]]
    model.reset()
    return np.stack(logits)


def _agree_until_near_tie(got, want, gaps):
    """got == want up to the first step whose reference top-2 gap is
    within GAP (after it, either continuation is right)."""
    for g, w, gap in zip(got, want, gaps):
        if gap <= GAP:
            return
        assert g == w


@pytest.mark.parametrize("flash_min_seq", [0, 16])
def test_greedy_generate_tokens_matches_flax(flash_min_seq):
    jm, tm = _models(flash_min_seq=flash_min_seq, seed=5)
    prompt = _prompt(17, seed=3)
    want = [int(t) for t in jm.generate_tokens(prompt, 14, chunk=4)]
    jm.reset()
    logits = _teacher_forced(tm, prompt, want)
    ok = _gap(logits) > GAP
    assert ok.sum() >= len(want) // 2
    np.testing.assert_array_equal(logits.argmax(-1)[ok], np.asarray(want)[ok])
    got = [int(t) for t in tm.generate_tokens(prompt, 14, chunk=4)]
    tm.reset()
    assert len(got) == len(want)
    _agree_until_near_tie(got, want, _gap(logits))


@pytest.mark.parametrize("flash_min_seq", [0, 16])
def test_greedy_generate_batch_matches_flax(flash_min_seq):
    jm, tm = _models(flash_min_seq=flash_min_seq, seed=6)
    prompts = [_prompt(n, seed=n) for n in (22, 5, 12)]
    want = np.stack([np.asarray(c) for c in
                     jm.generate_batch(prompts, 9, chunk=4)], axis=1)
    jm.reset()
    # teacher-forced on JAX's columns through the torch trunk
    logits = [tm.prefill_batch(prompts)]
    for c in range(want.shape[1] - 1):
        col = np.zeros((4, 1), np.int64)
        col[:3, 0] = want[:, c]
        logits.append(tm._fn(torch.from_numpy(col), tm._cache, tm.pos + c,
                             tm._start)[:3, 0].numpy())
    tm.reset()
    logits = np.stack(logits, axis=1)                     # (B, n, V)
    ok = _gap(logits) > GAP
    np.testing.assert_array_equal(logits.argmax(-1)[ok], want[ok])
    got = np.stack([c for c in tm.generate_batch(prompts, 9, chunk=4)],
                   axis=1)
    tm.reset()
    assert got.shape == want.shape == (3, 9)
    for r in range(3):
        _agree_until_near_tie(got[r], want[r], _gap(logits[r]))


@pytest.mark.parametrize("top_p,temp", [(0.9, 0.7), (0.5, 1.0), (0.99, 1.3)])
def test_nucleus_kept_set_matches_flax(top_p, temp):
    logits = np.random.default_rng(int(top_p * 100)).normal(
        0, 2, (4, 64)).astype(np.float32)
    for row in logits:
        jorder, jmasked = jdec._nucleus_logits(jnp.asarray(row), top_p, temp)
        torder, tmasked = tdec._nucleus_logits(torch.from_numpy(row), top_p,
                                               temp)
        jkeep = np.isfinite(np.asarray(jmasked))
        tkeep = torch.isfinite(tmasked).numpy()
        np.testing.assert_array_equal(tkeep, jkeep)
        np.testing.assert_array_equal(torder.numpy()[tkeep],
                                      np.asarray(jorder)[jkeep])
        np.testing.assert_allclose(tmasked.numpy()[tkeep],
                                   np.asarray(jmasked)[jkeep], rtol=1e-6)


def test_sampler_draws_follow_the_nucleus_distribution():
    logits = torch.tensor([2.0, 1.5, 1.0, 0.2, -3.0, -4.0])
    top_p, temp, n = 0.9, 0.7, 4000
    order, masked = tdec._nucleus_logits(logits, top_p, temp)
    want = torch.zeros(6)
    want[order] = torch.softmax(masked, dim=-1)
    gen = torch.Generator().manual_seed(0)
    draws = tdec.sample_top_p_batch(gen, logits.expand(n, -1), top_p=top_p,
                                    temp=temp)
    freq = torch.bincount(draws, minlength=6).float() / n
    assert freq[want == 0].sum() == 0            # outside the nucleus
    assert (freq - want).abs().max() < 0.03, (freq, want)
    # greedy and the single-row sampler
    assert tdec.sample_top_p(gen, logits, temp=0.0) == 0
    assert all(tdec.sample_top_p(gen, logits, top_p=0.3, temp=1.0) == 0
               for _ in range(20))


def test_safetensors_round_trip_with_flax(tmp_path):
    cfg_j, cfg_t = _configs()
    params = _jax_params(cfg_j, seed=7)
    path = str(tmp_path / "from_jax.safetensors")
    jdec.export_safetensors_params(params, cfg_j, path)
    tm = tdec.CompletionModel(cfg_t, weights=path, temp=0.0, device="cpu")
    jm = jdec.CompletionModel(cfg_j, params=params, temp=0.0)
    prompt = _prompt(8)
    np.testing.assert_allclose(tm.prefill(prompt), jm.prefill(prompt),
                               atol=ATOL, rtol=0)
    # and back: the port's export loads into the JAX tree leaf for leaf
    back = str(tmp_path / "from_torch.safetensors")
    tdec.export_safetensors_params(tm.module.state_dict(), cfg_t, back)
    loaded = jdec.load_safetensors_params(back, cfg_j)
    for (pa, va), (pb, vb) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(loaded)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(vb), np.asarray(va),
                                      err_msg=str(pa))


def test_model_surface_and_guards():
    cfg = tdec.DecoderConfig.tiny(dtype=torch.float32)
    m = tdec.CompletionModel(cfg, buckets=(16,), temp=0.0, device="cpu")
    assert m.buckets == (16, cfg.max_len) and m.paged_supported
    assert m.prefill(np.ones(40, np.int32)).shape == (cfg.vocab_size,)
    assert m.pos == 40 and m.compile_count() == 1
    m.decode_chunk(1, 4)
    assert m.pos == 44 and m.compile_count() == 2
    m.reset()
    with pytest.raises(RuntimeError, match="prefill first"):
        m.decode_one(1)
    with pytest.raises(ValueError):
        m.prefill(np.ones(cfg.max_len, np.int32))
    with pytest.raises(ValueError):
        m.prefill_batch([np.ones(3, np.int32), np.zeros(0, np.int32)])
    with pytest.raises(FileNotFoundError):     # .gguf goes to the loader
        tdec.CompletionModel(cfg, weights="m.gguf", device="cpu")


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.CompletionModel(tdec.DecoderConfig.tiny())
