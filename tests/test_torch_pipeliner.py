"""The torch port's pipeline lane (engine/pipeliner.py and scripting/,
verbatim copies of the JAX package's) on the CPU.

One Lua RAG chain — embed the query, search k = 5 with its vector, then
complete on the top hit's text — served in-process by the port's
Embedder, Searcher, Completer and Pipeliner on tiny f32 weights, and by
the JAX package's lanes on the same weights carried across
(params_from_jax): the result record, the hit keys and the greedy
completion bytes are identical.  Then the port's counterparts of the
JAX package's sandbox units (tests/test_pipeliner.py TestSandbox).  The
supervised crash drill of the lane lives in
tests/test_torch_supervised_drills.py."""
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
jdec = pytest.importorskip("libsplinter_tpu.models.decoder")
jemb = pytest.importorskip("libsplinter_tpu.engine.embedder")
jsr = pytest.importorskip("libsplinter_tpu.engine.searcher")
jcomp = pytest.importorskip("libsplinter_tpu.engine.completer")
jpl = pytest.importorskip("libsplinter_tpu.engine.pipeliner")
jtok = pytest.importorskip("libsplinter_tpu.models.tokenizer")

from libsplinter_tpu_torch import Store  # noqa: E402
from libsplinter_tpu_torch.engine import pipeliner as tpl  # noqa: E402
from libsplinter_tpu_torch.engine.completer import Completer  # noqa: E402
from libsplinter_tpu_torch.engine.embedder import Embedder  # noqa: E402
from libsplinter_tpu_torch.engine.searcher import Searcher  # noqa: E402
from libsplinter_tpu_torch.models import ByteTokenizer  # noqa: E402
from libsplinter_tpu_torch.models import decoder as tdec  # noqa: E402
from libsplinter_tpu_torch.models import encoder as tenc  # noqa: E402
from libsplinter_tpu_torch.scripting.microlua import LuaError  # noqa: E402
from libsplinter_tpu_torch.scripting.sandbox import (  # noqa: E402
    SandboxedRuntime, ScriptBudget, ScriptKilled)

DIM = 32

# the chain the smoke's phase 12 runs too: args (query key, query text,
# search k, completion key); returns the hit keys and the completed slot.
# The query key starts with "__" so the searcher leaves it out of hits
RAG = """
local qkey, text, k, ckey = ...
local ok, err = splinter.submit_embed(qkey, text)
if not ok then error(err) end
local scratch = qkey .. "/q"
splinter.set(scratch, "scratch")
splinter.set_embedding(scratch, splinter.get_embedding(qkey))
local hits, serr = splinter.submit_search(scratch, k)
splinter.unset(scratch)
if not hits then error(serr) end
local out, cerr = splinter.submit_completion(
    ckey, "ctx: " .. splinter.get(hits[1]) .. " q: " .. text)
if not out then error(cerr) end
return hits, out
"""

DOCS = [f"doc {w} about {v}" for w, v in
        zip(("red", "blue", "green", "gold", "gray", "pink", "teal", "rust",
             "jade", "ruby", "onyx", "sand"),
            ("cats", "ships", "rain", "maps", "tea", "bees", "owls", "salt",
             "ink", "oak", "fog", "ice"))]


def _params():
    """The tiny encoder's and decoder's flax trees, f32 numpy, seeded."""
    rng = np.random.default_rng(5)

    def jitter(tree):
        return jax.tree.map(
            lambda x: np.asarray(x, np.float32)
            + rng.normal(scale=0.05, size=x.shape).astype(np.float32), tree)

    ecfg = jenc.EncoderConfig.tiny(dtype=jnp.float32, out_dim=DIM,
                                   max_len=64)
    ep = jitter(jenc.Encoder(ecfg).init(jax.random.PRNGKey(0),
                                        np.ones((1, 8), np.int32),
                                        np.ones((1, 8), bool)))
    dcfg = jdec.DecoderConfig.tiny(vocab_size=300, dtype=jnp.float32)
    dp = jitter(jdec.Decoder(dcfg).init(jax.random.PRNGKey(1),
                                        jnp.zeros((1, 8), jnp.int32),
                                        jdec.init_cache(dcfg, 1),
                                        jnp.int32(0)))
    return ep, dp


def _jax_lanes(st, ep, dp):
    ecfg = jenc.EncoderConfig.tiny(dtype=jnp.float32, out_dim=DIM,
                                   max_len=64)
    dcfg = jdec.DecoderConfig.tiny(vocab_size=300, dtype=jnp.float32)
    return (jemb.Embedder(st, model=jenc.EmbeddingModel(
                ecfg, params=ep, buckets=(16, 32)), max_ctx=64),
            jsr.Searcher(st),
            jcomp.Completer(st, model=jdec.CompletionModel(
                dcfg, params=dp, buckets=(64, 128), temp=0.0),
                tokenizer=jtok.ByteTokenizer(), max_new_tokens=8,
                template="none"),
            jpl.Pipeliner(st))


def _port_lanes(st, ep, dp):
    ecfg = tenc.EncoderConfig.tiny(dtype=torch.float32, out_dim=DIM,
                                   max_len=64)
    dcfg = tdec.DecoderConfig.tiny(vocab_size=300, dtype=torch.float32)
    return (Embedder(st, model=tenc.EmbeddingModel(
                ecfg, params=tenc.params_from_jax(ep, ecfg),
                buckets=(16, 32), device="cpu"), max_ctx=64),
            Searcher(st, device="cpu"),
            Completer(st, model=tdec.CompletionModel(
                dcfg, params=tdec.params_from_jax(dp, dcfg),
                buckets=(64, 128), temp=0.0, device="cpu"),
                tokenizer=ByteTokenizer(), max_new_tokens=8,
                template="none"),
            tpl.Pipeliner(st))


def _run_chain(lanes_fn, submit, ep, dp):
    name = f"/spt-tpl-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=256, max_val=4096, vec_dim=DIM)
    daemons, threads = (), []
    try:
        vecs = np.random.default_rng(11).standard_normal(
            (len(DOCS), DIM)).astype(np.float32)
        for i, text in enumerate(DOCS):
            st.set(f"doc/{i}", text)
            st.vec_set(f"doc/{i}", vecs[i] / np.linalg.norm(vecs[i]))
        daemons = lanes_fn(st, ep, dp)
        for d in daemons:
            d.attach()
        threads = [threading.Thread(
            target=d.run, kwargs=dict(idle_timeout_ms=10, stop_after=120.0),
            daemon=True) for d in daemons]
        for t in threads:
            t.start()
        rec = submit(st, "rag", script=RAG,
                     args=["__rag/query", "which doc has blue ships", 5,
                           "answer"], timeout_ms=60_000)
        return (rec, st.get("answer").rstrip(b"\0"),
                st.vec_get("__rag/query"))
    finally:
        for d in daemons:
            d.stop()
        for t in threads:
            t.join(timeout=30)
        st.close()
        Store.unlink(name)


def test_rag_chain_identical_to_jax_package():
    ep, dp = _params()
    want, want_bytes, want_q = _run_chain(_jax_lanes, jpl.submit_script,
                                          ep, dp)
    got, got_bytes, got_q = _run_chain(_port_lanes, tpl.submit_script,
                                       ep, dp)
    assert want is not None and want.get("ok") is True, want
    assert got is not None and got.get("ok") is True, got
    # the query's vector from the two encoders, then everything after
    # it exactly: the record's hits and the completed slot
    np.testing.assert_allclose(got_q, want_q, atol=1e-5, rtol=0)
    hits, out = got["ret"]
    assert len(hits) == 5 and all(h.startswith("doc/") for h in hits)
    assert out.startswith("ctx: doc ")
    assert {k: got[k] for k in ("ok", "ret")} == \
        {k: want[k] for k in ("ok", "ret")}
    assert got_bytes == want_bytes and len(got_bytes) > len(
        "ctx: " + DOCS[0] + " q: which doc has blue ships")


# ----------------------------------------- the JAX package's sandbox units

class TestSandbox:
    def test_step_budget_kills_infinite_loop(self):
        rt = SandboxedRuntime(ScriptBudget(max_steps=20_000))
        with pytest.raises(ScriptKilled) as ei:
            rt.run("while true do end")
        assert ei.value.reason == "budget_exceeded"
        assert rt.kill_reason == "budget_exceeded"

    def test_pcall_cannot_swallow_the_kill(self):
        rt = SandboxedRuntime(ScriptBudget(max_steps=20_000))
        with pytest.raises(ScriptKilled):
            rt.run("while true do "
                   "pcall(function() while true do end end) end")

    def test_deadline_kills_mid_compute(self):
        rt = SandboxedRuntime(ScriptBudget(
            max_steps=100_000_000, deadline_ts=time.time() + 0.15))
        t0 = time.monotonic()
        with pytest.raises(ScriptKilled) as ei:
            rt.run("while true do end")
        assert ei.value.reason == "deadline_expired"
        assert time.monotonic() - t0 < 5.0

    def test_huge_allocation_guarded(self):
        rt = SandboxedRuntime(ScriptBudget(max_str_len=4096))
        with pytest.raises(LuaError, match="string budget"):
            rt.run("return string.rep('x', 1000000)")

    def test_os_removed_io_absent(self):
        rt = SandboxedRuntime(ScriptBudget())
        assert rt.run("return type(os), type(io)") == ("nil", "nil")

    def test_coroutine_cap(self):
        rt = SandboxedRuntime(ScriptBudget(max_coroutines=4))
        out = rt.run("""
            local cos = {}
            for i = 1, 8 do
              local co = coroutine.create(function()
                coroutine.yield()
              end)
              local ok = pcall(coroutine.resume, co)
              cos[#cos + 1] = ok
            end
            local n = 0
            for i = 1, #cos do if cos[i] then n = n + 1 end end
            return n
        """)
        rt.close()
        assert out[0] <= 4
