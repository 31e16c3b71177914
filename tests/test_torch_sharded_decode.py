"""Tensor-parallel completion serving in the torch port
(parallel/serve.py) against the JAX package's, mirroring
tests/test_sharded_decode.py: the port's decoder sharded at tp = 2 over
two CPU shards and the JAX ShardedCompletionModel over its virtual
(dp = 4, tp = 2) CPU mesh, on the same numpy weights (f32).

  - the weights are split: each shard's column-parallel q projection
    holds half the output rows, its row-parallel out projection half
    the input columns, and the per-shard geometry is heads/tp,
    kv_heads/tp and mlp_dim/tp at the model's head width;
  - prefill and decode logits within 1e-4 of the JAX sharded model's
    (the tp = 2 partial sums round differently from tp = 1, in either
    package), and within 1e-4 of the port's own tp = 1 model;
  - greedy generate_tokens equal to the JAX sharded model's, and the
    batched dense lane (left-padded prefill, a joiner) equal to tp = 1;
  - a tp that does not divide the heads is refused with the JAX text;
    a seed gives the same weights at every tp."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jdec = pytest.importorskip("libsplinter_tpu.models.decoder")
jpar = pytest.importorskip("libsplinter_tpu.parallel")

from libsplinter_tpu_torch.models import decoder as tdec  # noqa: E402
from libsplinter_tpu_torch.parallel import (  # noqa: E402
    ShardedCompletionModel, make_mesh)

ATOL = 1e-4
PROMPT = np.array([3, 1, 4, 1, 5], np.int32)


def _params(cfg_j, seed=0):
    params = jdec.Decoder(cfg_j).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
        jdec.init_cache(cfg_j, 1), jnp.int32(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(scale=0.05, size=x.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def models():
    """(JAX sharded, port sharded, port tp = 1) on the same weights."""
    cfg_j = jdec.DecoderConfig.tiny(dtype=jnp.float32)   # heads 4, kv 2
    cfg_t = tdec.DecoderConfig.tiny(dtype=torch.float32)
    params = _params(cfg_j)
    jm = jpar.ShardedCompletionModel(cfg_j, jpar.make_mesh(dp=4, tp=2),
                                     params=params, buckets=(16,),
                                     temp=0.0)
    sd = tdec.params_from_jax(params, cfg_t)
    tm = ShardedCompletionModel(cfg_t, make_mesh(tp=2, device="cpu"),
                                params=sd, buckets=(16,), temp=0.0)
    one = tdec.CompletionModel(cfg_t, params=sd, buckets=(16,), temp=0.0,
                               device="cpu")
    return jm, tm, one


def test_params_actually_sharded(models):
    _, tm, one = models
    full = one.module.layer_0.attn
    assert len(tm.module.shards) == 2
    for t, shard in enumerate(tm.module.shards):
        cfg = shard.cfg
        assert (cfg.heads, cfg.kv_heads, cfg.mlp_dim, cfg.head_dim) == (
            2, 1, 64, one.cfg.head_dim)
        attn = shard.layer_0.attn
        # column parallel: output rows split; row parallel: input columns
        assert torch.equal(attn.q.weight, full.q.weight.chunk(2, 0)[t])
        assert torch.equal(attn.out.weight, full.out.weight.chunk(2, 1)[t])
        assert torch.equal(shard.layer_0.down.weight,
                           one.module.layer_0.down.weight.chunk(2, 1)[t])
        assert torch.equal(shard.lm_head.weight, one.module.lm_head.weight)


def test_prefill_and_decode_logits_match(models):
    jm, tm, one = models
    got = tm.prefill(PROMPT)
    np.testing.assert_allclose(got, np.asarray(jm.prefill(PROMPT)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, one.prefill(PROMPT), rtol=0, atol=ATOL)
    got = tm.decode_one(7)
    np.testing.assert_allclose(got, np.asarray(jm.decode_one(7)), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got, one.decode_one(7), rtol=0, atol=ATOL)
    for m in models:
        m.reset()


def test_greedy_generation_identical(models):
    jm, tm, one = models
    want = [int(t) for t in jm.generate_tokens(PROMPT, 12, chunk=4)]
    jm.reset()
    got = [int(t) for t in tm.generate_tokens(PROMPT, 12, chunk=4)]
    tm.reset()
    assert got == want
    assert [int(t) for t in one.generate_tokens(PROMPT, 12, chunk=4)] == want
    one.reset()


def test_batched_dense_lane_with_joiner_equals_tp1(models):
    """Left-padded batched prefill, the batched chunk and a joiner row
    through the per-shard dense caches equal the tp = 1 lane."""
    _, tm, one = models
    prompts = [np.array([5, 2, 9], np.int32), np.arange(1, 10, dtype=np.int32)]
    outs = []
    for m in (one, tm):
        cols = [c for c in m.generate_batch(prompts, 6, chunk=3)]
        m.join_row(np.array([4, 4, 2], np.int32), 0)
        outs.append((np.stack(cols), m.decode_chunk_batch(
            np.array([1, 2]), 3)))
        m.reset()
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_head_divisibility_enforced():
    cfg = tdec.DecoderConfig.tiny(dtype=torch.float32)   # kv_heads = 2
    with pytest.raises(ValueError, match="must divide the tp=4 mesh axis"):
        ShardedCompletionModel(cfg, make_mesh(tp=4, device="cpu"))
    with pytest.raises(ValueError, match="divide"):
        jpar.ShardedCompletionModel(
            jdec.DecoderConfig.tiny(dtype=jnp.float32),
            jpar.make_mesh(dp=1, tp=8))


def test_seeded_weights_equal_at_every_tp():
    cfg = tdec.DecoderConfig.tiny(dtype=torch.float32)
    one = tdec.CompletionModel(cfg, seed=9, buckets=(16,), device="cpu")
    tp = ShardedCompletionModel(cfg, make_mesh(tp=2, device="cpu"), seed=9,
                                buckets=(16,))
    np.testing.assert_allclose(tp.prefill(PROMPT), one.prefill(PROMPT),
                               rtol=0, atol=ATOL)
