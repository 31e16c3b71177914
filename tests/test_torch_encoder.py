"""The torch port's encoder against the JAX package's flax encoder, on
the CPU, through the weight bridge (params_from_jax).

Inputs (token ids, a perturbation of every parameter leaf so biases and
layer norms are not at their identity init) come from seeded numpy.
Tolerances: f32 atol 1e-5 on the unit-norm embeddings (the same math
in two frameworks, sums in another order); bf16 activations: cosine
similarity >= 0.999 per embedding (bf16 rounds at other places in the
two frameworks); the fetch wires: their quantisation step (f16 1e-3,
bf16 8e-3, int8 1/127) plus the f32 tolerance."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jenc = pytest.importorskip("libsplinter_tpu.models.encoder")

from libsplinter_tpu_torch.models import encoder as tenc  # noqa: E402

ATOL = 1e-5


def _jax_params(cfg_j, seed):
    ids = np.ones((1, 8), np.int32)
    params = jenc.Encoder(cfg_j).init(jax.random.PRNGKey(seed), ids,
                                      np.ones((1, 8), bool))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(scale=0.05, size=x.shape).astype(np.float32), params)


def _ids(cfg, b, s, lens, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.arange(s)[None, :] < np.asarray(lens)[:, None]
    return ids, mask


def _configs(variant, dtype_j=None, dtype_t=torch.float32, **kw):
    cfg_j = jenc.EncoderConfig.tiny(variant=variant,
                                    dtype=dtype_j or jnp.float32, **kw)
    cfg_t = tenc.EncoderConfig.tiny(variant=variant, dtype=dtype_t, **kw)
    return cfg_j, cfg_t


def _torch_encoder(cfg_t, params):
    module = tenc.Encoder(cfg_t)
    module.load_state_dict(tenc.params_from_jax(params, cfg_t))
    if cfg_t.dtype != torch.float32:
        for m in module.modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Embedding)):
                m.to(cfg_t.dtype)
    return module.eval()


@pytest.mark.parametrize("variant", ["nomic", "bert"])
@pytest.mark.parametrize("s,flash_min_seq", [(24, 16), (40, 0)])
def test_encoder_matches_flax(variant, s, flash_min_seq):
    """flash_min_seq=16 puts the port's flash_attention (K1's CPU path)
    on the forward; 0 keeps the plain attention."""
    cfg_j, cfg_t = _configs(variant, out_dim=48,
                            flash_min_seq=flash_min_seq)
    params = _jax_params(cfg_j, seed=3)
    ids, mask = _ids(cfg_j, 3, s, [s, 9, 0])
    want = np.asarray(jenc.Encoder(cfg_j).apply(params, ids, mask))
    with torch.no_grad():
        got = _torch_encoder(cfg_t, params)(
            torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (3, 48)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[:2], axis=1), 1.0,
                               atol=1e-5)
    assert (got[2] == 0).all()               # an empty row pools to 0


@pytest.mark.parametrize("variant", ["nomic", "bert"])
def test_encoder_bf16_close_to_flax_bf16(variant):
    cfg_j, cfg_t = _configs(variant, dtype_j=jnp.bfloat16,
                            dtype_t=torch.bfloat16, flash_min_seq=16)
    params = _jax_params(cfg_j, seed=5)
    ids, mask = _ids(cfg_j, 4, 32, [32, 20, 5, 17])
    want = np.asarray(jenc.Encoder(cfg_j).apply(params, ids, mask),
                      np.float32)
    with torch.no_grad():
        got = _torch_encoder(cfg_t, params)(
            torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert (cos >= 0.999).all(), cos


def _models(fetch_dtype=None, **kw):
    cfg_j, cfg_t = _configs("nomic", out_dim=64, max_len=64,
                            flash_min_seq=32)
    params = _jax_params(cfg_j, seed=7)
    jm = jenc.EmbeddingModel(cfg_j, params=params, buckets=(16, 32),
                             fetch_dtype=fetch_dtype)
    tm = tenc.EmbeddingModel(cfg_t, params=tenc.params_from_jax(params,
                                                                cfg_t),
                             buckets=(16, 32), fetch_dtype=fetch_dtype,
                             device="cpu", **kw)
    return jm, tm


@pytest.mark.parametrize("fetch_dtype,tol", [(None, ATOL),
                                             ("f16", 1e-3 + ATOL),
                                             ("bf16", 8e-3 + ATOL),
                                             ("int8", 1 / 127 + ATOL)])
def test_embedding_model_wire_matches_jax(fetch_dtype, tol):
    jm, tm = _models(fetch_dtype)
    rng = np.random.default_rng(2)
    for bucket, lens in ((16, [16, 3, 9]), (32, [32, 20, 1, 7, 25]),
                         (64, [64, 40])):
        ids = rng.integers(0, 1024, (len(lens), bucket)).astype(np.int32)
        lens = np.asarray(lens, np.int32)
        want = jm.encode_ids(ids, lens)
        got = tm.encode_ids(ids, lens)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # three (batch-pad, bucket) shapes ran: 4x16, 8x32, 2x64
    assert tm.compile_count() == 3
    assert tm.bucket_for(17) == 32 and tm.buckets == (16, 32, 64)
    np.testing.assert_array_equal(tm.buckets_for(np.array([1, 16, 33, 99])),
                                  [16, 16, 64, 64])


def test_ring_slots_match_per_call():
    _, tm = _models()
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 1024, (3, 4, 32)).astype(np.int32)
    lens = rng.integers(1, 33, (3, 4)).astype(np.int32)
    ring = tm.encode_ring_async(ids, lens, 2)
    assert ring.is_ready()
    for j in range(2):
        np.testing.assert_allclose(ring.slot(j, 3).materialize(),
                                   tm.encode_ids(ids[j, :3], lens[j, :3]),
                                   atol=ATOL, rtol=0)
    with pytest.raises(ValueError):
        tm.encode_ring_async(ids, lens, 4)


@pytest.mark.parametrize("variant,family", [("nomic", "nomic"),
                                            ("bert", "bert")])
def test_safetensors_reader_matches_bridge(tmp_path, variant, family):
    cfg_j, cfg_t = _configs(variant)
    params = _jax_params(cfg_j, seed=11)
    path = str(tmp_path / "ckpt.safetensors")
    jenc.export_safetensors_params(params, cfg_j, path, family=family)
    loaded = tenc.load_safetensors_params(path, cfg_t)
    bridged = tenc.params_from_jax(params, cfg_t)
    assert sorted(loaded) == sorted(bridged)
    for k in bridged:
        torch.testing.assert_close(loaded[k], bridged[k], atol=0, rtol=0,
                                   msg=k)
    assert sorted(bridged) == sorted(tenc.Encoder(cfg_t).state_dict())
    m = tenc.EmbeddingModel(cfg_t, weights=path, buckets=(16,),
                            device="cpu")
    ids = np.ones((2, 16), np.int32)
    assert np.isfinite(m.encode_ids(ids, np.full(2, 16, np.int32))).all()


def test_safetensors_reader_bf16(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(0)
    tensors = {"a": torch.from_numpy(rng.standard_normal((3, 5))
                                     .astype(np.float32)).bfloat16(),
               "b": torch.arange(6, dtype=torch.float16).reshape(2, 3)}
    path = str(tmp_path / "bf16.safetensors")
    st_torch.save_file(tensors, path)
    got = tenc.read_safetensors(path)
    np.testing.assert_array_equal(got["a"], tensors["a"].float().numpy())
    np.testing.assert_array_equal(got["b"], tensors["b"].float().numpy())


def test_unported_options_raise(tmp_path):
    with pytest.raises(FileNotFoundError):     # .gguf goes to the loader
        tenc.EmbeddingModel(tenc.EncoderConfig.tiny(),
                            weights=str(tmp_path / "m.gguf"), device="cpu")
    with pytest.raises(ValueError):
        tenc.EmbeddingModel(tenc.EncoderConfig.tiny(), fetch_dtype="f8",
                            device="cpu")


def test_seeded_init_is_deterministic():
    cfg = tenc.EncoderConfig.tiny(dtype=torch.float32)
    a = tenc.EmbeddingModel(cfg, seed=3, device="cpu")
    b = tenc.EmbeddingModel(cfg, seed=3, device="cpu")
    c = tenc.EmbeddingModel(cfg, seed=4, device="cpu")
    ids = np.arange(32, dtype=np.int32).reshape(2, 16)
    lens = np.array([16, 8], np.int32)
    np.testing.assert_array_equal(a.encode_ids(ids, lens),
                                  b.encode_ids(ids, lens))
    assert not np.allclose(a.encode_ids(ids, lens), c.encode_ids(ids, lens))
