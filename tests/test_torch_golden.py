"""The pinned golden checkpoint opened cold by the torch port, on the CPU.

tests/fixtures/golden_encoder.gguf holds tiny nomic-geometry encoder
weights and a real trained WordPiece vocab; golden_expected.json holds
the JAX package's token ids and f32 vectors for four texts.  Here the
config, the tokenizer and the weights all come from the file, through
the port alone.

Tolerances: token ids exact; f32 vectors within atol 1e-5 of the pinned
ones (sums in another order than the JAX package's); the embedding
daemon derives a bf16 config, as the JAX daemon does, so its committed
vectors are held to the bf16 bar of tests/test_torch_encoder.py, a
cosine similarity of at least 0.999."""
import dataclasses
import json
import os
import uuid

import numpy as np
import pytest
import torch

from libsplinter_tpu_torch import T_VARTEXT, Store
from libsplinter_tpu_torch.engine import embedder
from libsplinter_tpu_torch.engine import protocol as P
from libsplinter_tpu_torch.engine.embedder import Embedder
from libsplinter_tpu_torch.models import (EmbeddingModel, GgufFile,
                                          encoder_config_from_gguf,
                                          load_tokenizer)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures")
GGUF = os.path.join(FIXDIR, "golden_encoder.gguf")
ATOL = 1e-5


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(FIXDIR, "golden_expected.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cold_model():
    with GgufFile(GGUF) as gf:
        cfg = encoder_config_from_gguf(gf, out_dim=32, dtype=torch.float32)
        tok = load_tokenizer(gf)
    model = EmbeddingModel(cfg, weights=GGUF, buckets=(32,), device="cpu")
    return cfg, tok, model


@pytest.fixture
def store():
    name = f"/spt-tgold-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=64, max_val=1024, vec_dim=32)
    yield st
    st.close()
    Store.unlink(name)


def _ask(st, golden):
    keys = {}
    for i, case in enumerate(golden["texts"]):
        key = f"g/{i}"
        st.set(key, case["text"])
        st.set_type(key, T_VARTEXT)
        st.label_or(key, P.LBL_EMBED_REQ)
        st.bump(key)
        keys[key] = np.asarray(case["vector"], np.float32)
    return keys


def test_config_derived_from_container(cold_model, golden):
    cfg, _, _ = cold_model
    want = golden["config"]
    assert (cfg.vocab_size, cfg.hidden, cfg.layers, cfg.out_dim) == \
        (want["vocab_size"], want["hidden"], want["layers"], want["out_dim"])
    assert cfg.variant == "nomic" and cfg.dtype == torch.float32
    # with no dtype override the derived config runs bf16 activations,
    # the daemon's configuration
    assert encoder_config_from_gguf(GGUF).dtype == torch.bfloat16


def test_config_matches_jax(cold_model):
    jnp = pytest.importorskip("jax.numpy")
    jgguf = pytest.importorskip("libsplinter_tpu.models.gguf")
    cfg, _, _ = cold_model
    ref = jgguf.encoder_config_from_gguf(GGUF, out_dim=32, dtype=jnp.float32)
    for f in dataclasses.fields(cfg):
        if f.name != "dtype" and hasattr(ref, f.name):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name


def test_token_ids_pinned(cold_model, golden):
    _, tok, _ = cold_model
    texts = [case["text"] for case in golden["texts"]]
    for case in golden["texts"]:
        assert tok.encode(case["text"]) == case["token_ids"], case["text"]
    ids, lens = tok.encode_batch(texts, 32)
    for row, n, case in zip(ids, lens, golden["texts"]):
        assert row[:n].tolist() == case["token_ids"]
        assert (row[n:] == tok.pad_id).all()


def test_vectors_pinned(cold_model, golden):
    _, tok, model = cold_model
    worst = 0.0
    for case in golden["texts"]:
        ids = case["token_ids"]
        arr = np.full((1, 32), tok.pad_id, np.int32)
        arr[0, :len(ids)] = ids
        vec = np.asarray(model.encode_ids(arr, np.array([len(ids)],
                                                        np.int32))[0])
        want = np.asarray(case["vector"], np.float32)
        np.testing.assert_allclose(vec, want, rtol=0, atol=ATOL,
                                   err_msg=case["text"])
        assert np.linalg.norm(vec) == pytest.approx(1.0, abs=1e-5)
        worst = max(worst, float(np.abs(vec - want).max()))
    print(f"golden vectors, port f32 on the CPU: worst abs err {worst:.3g}")


def test_unseen_text_uses_subword_backoff(cold_model):
    _, tok, model = cold_model
    ids = tok.encode("quixotic zephyrs")
    assert len(ids) >= 2
    arr = np.full((1, 32), tok.pad_id, np.int32)
    arr[0, :len(ids)] = ids[:32]
    vec = model.encode_ids(arr, np.array([min(len(ids), 32)], np.int32))[0]
    assert np.isfinite(np.asarray(vec)).all()


def test_embedder_commits_golden_vectors(cold_model, golden, store):
    """The f32 model and the file's tokenizer behind an in-process
    Embedder (f32 fetch wire): the committed vectors are the pinned
    ones, within 1e-5, whatever bucket each text lands in."""
    cfg, tok, _ = cold_model
    model = EmbeddingModel(cfg, weights=GGUF, device="cpu")
    emb = Embedder(store, model=model, tokenizer=tok, max_ctx=cfg.max_len)
    emb.attach()
    keys = _ask(store, golden)
    assert emb.run_once() == len(keys)
    for key, want in keys.items():
        np.testing.assert_allclose(store.vec_get(key), want, rtol=0,
                                   atol=ATOL, err_msg=key)


def test_embedder_main_serves_golden_cold(golden, store):
    """embedder.main with --weights <golden> and nothing else: config,
    tokenizer and weights from the file, out_dim from the store; bf16
    activations, so the bf16 bar."""
    keys = _ask(store, golden)
    assert embedder.main(["--store", store.name, "--device", "cpu",
                          "--weights", GGUF, "--oneshot"]) == 0
    for key, want in keys.items():
        got = store.vec_get(key)
        assert not store.labels(key) & (P.LBL_EMBED_REQ | P.LBL_WAITING)
        cos = float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want)))
        assert cos >= 0.999, (key, cos)

