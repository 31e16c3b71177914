"""The torch port's embed -> vector-commit -> search lane against the
JAX package's, on CPU stores.

Both Embedders run the same bridged tiny weights over the same texts
(seeded numpy) into two stores created alike; the vectors must agree
within f32 atol 1e-5 and the protocol outcome (labels, ctx-exceeded
marker, epochs) must match exactly.  The two Searchers then serve the
same requests over ONE lane: the result records must be identical
(rows, keys, counts), scores within 2e-6 (they are rounded to 6
decimals after sums taken in another order)."""
import json
import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jenc = pytest.importorskip("libsplinter_tpu.models.encoder")
jemb = pytest.importorskip("libsplinter_tpu.engine.embedder")
jsr = pytest.importorskip("libsplinter_tpu.engine.searcher")

from libsplinter_tpu_torch import T_VARTEXT, Store  # noqa: E402
from libsplinter_tpu_torch.engine import protocol as P  # noqa: E402
from libsplinter_tpu_torch.engine.embedder import Embedder  # noqa: E402
from libsplinter_tpu_torch.engine.searcher import (  # noqa: E402
    Searcher, consume_result, submit_search)
from libsplinter_tpu_torch.models import encoder as tenc  # noqa: E402

DIM = 64


@pytest.fixture
def stores():
    made = []

    def make():
        name = f"/spt-tl-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        st = Store.create(name, nslots=256, max_val=1024, vec_dim=DIM)
        made.append((st, name))
        return st

    yield make
    for st, name in made:
        st.close()
        Store.unlink(name)


def _texts():
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(60)]
    out = {}
    for i in range(24):
        n = int(rng.integers(2, 40))
        out[f"doc/{i}"] = " ".join(rng.choice(words, n))
    out["dup/3"] = out["doc/3"]
    out["long"] = "word " * 80               # past the 0.9 * 64 guard
    return out


def _models():
    cfg_j = jenc.EncoderConfig.tiny(dtype=jnp.float32, out_dim=DIM,
                                    max_len=64, flash_min_seq=32)
    cfg_t = tenc.EncoderConfig.tiny(dtype=torch.float32, out_dim=DIM,
                                    max_len=64, flash_min_seq=32)
    params = jenc.Encoder(cfg_j).init(jax.random.PRNGKey(0),
                                      np.ones((1, 8), np.int32),
                                      np.ones((1, 8), bool))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(scale=0.05, size=x.shape).astype(np.float32), params)
    jm = jenc.EmbeddingModel(cfg_j, params=params, buckets=(16, 32))
    tm = tenc.EmbeddingModel(cfg_t, params=tenc.params_from_jax(params,
                                                                cfg_t),
                             buckets=(16, 32), device="cpu")
    return jm, tm


def _label(st, texts):
    for key, text in texts.items():
        st.set(key, text)
        st.set_type(key, T_VARTEXT)
        st.label_or(key, P.LBL_EMBED_REQ)
        st.bump(key)


def test_embedder_matches_jax_lane(stores):
    jm, tm = _models()
    texts = _texts()
    sa, sb = stores(), stores()
    _label(sa, texts)
    _label(sb, texts)
    ja = jemb.Embedder(sa, model=jm, max_ctx=64)
    tb = Embedder(sb, model=tm, max_ctx=64)
    ja.attach()
    tb.attach()
    assert tb.run_once() == ja.run_once() == len(texts) - 1
    assert tb.stats.ctx_exceeded == ja.stats.ctx_exceeded == 1
    for key in texts:
        assert sb.find_index(key) == sa.find_index(key)
        np.testing.assert_allclose(sb.vec_get(key), sa.vec_get(key),
                                   atol=1e-5, rtol=0, err_msg=key)
        assert sb.labels(key) == sa.labels(key)
        assert not sb.labels(key) & (P.LBL_EMBED_REQ | P.LBL_WAITING)
        assert sb.epoch(key) == sa.epoch(key)
    assert sb.labels("long") & P.LBL_CTX_EXCEEDED
    assert not np.abs(sb.vec_get("long")).any()
    np.testing.assert_array_equal(sb.vec_get("doc/3"), sb.vec_get("dup/3"))
    # a second drain finds nothing new (epochs recorded as embedded)
    assert tb.run_once() == 0
    assert tm.compile_count() >= 1


def _request(st, key, qvec, k):
    st.set(key, json.dumps({"k": k, "bloom": 0}))
    st.vec_set(key, qvec)
    st.label_or(key, P.LBL_SEARCH_REQ | P.LBL_WAITING)
    st.bump(key)


def _record(st, key):
    rec = json.loads(st.get(P.search_result_key(st.find_index(key)))
                     .rstrip(b"\0"))
    rec.pop("ts")
    rec.pop("e")
    return rec


@pytest.mark.parametrize("k", [5, 200])
def test_searcher_records_match_jax(stores, k):
    """k=5 takes K2's path (its plain version here), k=200 the score
    matrix + stable sort; the JAX searcher on CPU scores unfused."""
    jm, tm = _models()
    st = stores()
    _label(st, _texts())
    emb = Embedder(st, model=tm, max_ctx=64)
    emb.attach()
    emb.run_once()
    rng = np.random.default_rng(k)
    queries = {"__q/a": st.vec_get("doc/3"), "__q/b": st.vec_get("doc/7"),
               "__q/c": rng.standard_normal(DIM).astype(np.float32)}
    js = jsr.Searcher(st)
    ts = Searcher(st, device="cpu")
    js.attach()
    ts.attach()
    records = []
    for sr in (js, ts):
        for key, q in queries.items():
            _request(st, key, q, k)
        assert sr.run_once() == len(queries)
        records.append({key: _record(st, key) for key in queries})
    want, got = records
    for key in queries:
        w, g = want[key], got[key]
        assert g["i"] == w["i"] and g["keys"] == w["keys"], key
        assert g["n"] == w["n"] and g["fetched"] == w["fetched"]
        np.testing.assert_allclose(g["s"], w["s"], atol=2e-6, rtol=0)
    # the duplicate text ranks right behind its twin, system rows never
    assert got["__q/a"]["keys"][:2] == ["doc/3", "dup/3"]
    assert not any(key.startswith("__") for key in got["__q/c"]["keys"])
    assert ts.stats.dispatches == 1 and ts.stats.coalesced_max == 3


def test_submit_search_round_trip(stores):
    """The client side: submit_search blocks until the torch searcher
    (draining in another thread) commits the record."""
    _, tm = _models()
    st = stores()
    _label(st, _texts())
    emb = Embedder(st, model=tm, max_ctx=64)
    emb.attach()
    emb.run_once()
    sr = Searcher(st, device="cpu")
    sr.attach()
    st.set("__q/x", "query")
    st.vec_set("__q/x", st.vec_get("doc/5"))
    stop = threading.Event()

    def drain():
        while not stop.is_set():
            sr.run_once()
            time.sleep(0.01)

    t = threading.Thread(target=drain)
    t.start()
    try:
        rec = submit_search(st, "__q/x", 3, timeout_ms=10_000)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert rec is not None and rec["keys"][0] == "doc/5"
    assert len(rec["s"]) == 3 and rec["s"] == sorted(rec["s"], reverse=True)
    consume_result(st, "__q/x")
    with pytest.raises(KeyError):
        st.get(P.search_result_key(st.find_index("__q/x")))


def test_daemon_mains_take_device_flag(stores, monkeypatch):
    """--device cpu runs the plain versions; --device cuda (the default)
    with no card raises instead of falling back to the CPU."""
    from libsplinter_tpu_torch.engine import embedder, searcher

    st = stores()
    st.set("doc/1", "x")
    st.vec_set("doc/1", np.ones(DIM, np.float32))
    assert searcher.main(["--store", st.name, "--device", "cpu",
                          "--oneshot"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        searcher.main(["--store", st.name, "--oneshot"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        embedder.main(["--store", st.name, "--oneshot"])
    with pytest.raises(FileNotFoundError):     # .gguf goes to the loader
        embedder.main(["--store", st.name, "--device", "cpu",
                       "--weights", "model.gguf", "--oneshot"])


def test_ring_drain_matches_per_call(stores):
    """Two or more full batches of one bucket ride one ring dispatch;
    the vectors equal the per-call path's."""
    _, tm = _models()
    texts = {f"r/{i}": " ".join(f"w{(i * 3 + j) % 40}" for j in range(6))
             for i in range(10)}                 # all in bucket 16
    out = []
    for depth in (4, 1):
        st = stores()
        _label(st, texts)
        emb = Embedder(st, model=tm, max_ctx=64, batch_cap=2,
                       ring_depth=depth)
        emb.attach()
        assert emb.run_once() == len(texts)
        out.append((emb.stats, {k: st.vec_get(k) for k in texts}))
    (ring, ring_vecs), (flat, flat_vecs) = out
    # 5 full batches: one ring of 4, the fifth per call
    assert ring.ring_dispatches == 1 and ring.resident_iterations == 4
    assert flat.ring_dispatches == 0
    for key in texts:
        np.testing.assert_allclose(ring_vecs[key], flat_vecs[key],
                                   atol=1e-6, rtol=0)
