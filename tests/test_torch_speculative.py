"""The torch port's speculative decoding (models/speculative.py) and the
completer's speculative wiring, on the CPU, against the JAX package's
models/speculative.py where the two can agree and against the port's
own target-only greedy lane where they cannot.

  - _filtered_probs equals the JAX function within 1e-6 (sampled and
    greedy), the draws follow it, and the vectorised acceptance keeps
    the target's distribution;
  - self_draft_model: the port's draft shares the target's storage
    (data_ptr equal) and its logits lie within 1e-5 of the JAX
    self-draft's; its refusals; the self-draft of a tp = 2 target (two
    CPU shards) aliases the target's shard modules and its serial and
    paged greedy spec tokens equal the plain target's;
  - the serial lane's greedy tokens equal the JAX package's serial
    greedy spec tokens and the target-only tokens (f32, tiny);
  - the paged lane over f32 pools equals the port's target-only greedy
    token for token, a mid-flight joiner included, with zero leaked
    pages on both pools; over int8 pools >= 50% agreement with the
    first token exact (a rejected draft's stale append may grow a
    page's monotone scale); the window tail, EOS mid-step and the
    counters (verified > proposed);
  - the completer: --draft-layers on the continuous lane, --draft-weights
    (a .gguf written by gguf_writer) on the serial lane, the two flags'
    mutual exclusion and the non-.gguf exit, the acceptance heartbeat
    and demotion on both lanes.

The JAX package's paged spec bytes are not an anchor: its
test_quant_kv.py::test_spec_paged_greedy_token_exact fails on the CPU
from an aliasing race of the reference itself."""
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
jdec = pytest.importorskip("libsplinter_tpu.models.decoder")
jspec = pytest.importorskip("libsplinter_tpu.models.speculative")

from libsplinter_tpu_torch import Store  # noqa: E402
from libsplinter_tpu_torch.engine import completer as tcomp  # noqa: E402
from libsplinter_tpu_torch.engine import protocol as P  # noqa: E402
from libsplinter_tpu_torch.engine.completer import Completer  # noqa: E402
from libsplinter_tpu_torch.models import decoder as tdec  # noqa: E402
from libsplinter_tpu_torch.models import gguf as tgguf  # noqa: E402
from libsplinter_tpu_torch.models import speculative as tspec  # noqa: E402
from libsplinter_tpu_torch.models.gguf_writer import (  # noqa: E402
    GGML_F32, kv_f32_array, kv_i32_array, kv_str, kv_str_array, kv_u32,
    write_gguf)
from libsplinter_tpu_torch.models.moe import (  # noqa: E402
    MoeDecoderConfig, moe_completion_model)

PROMPT = np.array([3, 1, 4, 1, 5, 9, 2], np.int32)


def _jax_params(cfg_j, seed):
    params = jdec.Decoder(cfg_j).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
        jdec.init_cache(cfg_j, 1), jnp.int32(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(scale=0.05, size=x.shape).astype(np.float32), params)


def _pair(seed=2, **kw):
    """The same f32 weights as a JAX and a port CompletionModel."""
    cfg_j = jdec.DecoderConfig.tiny(dtype=jnp.float32, **kw)
    cfg_t = tdec.DecoderConfig.tiny(dtype=torch.float32, **kw)
    params = _jax_params(cfg_j, seed)
    jm = jdec.CompletionModel(cfg_j, params=params, buckets=(16,), temp=0.0)
    tm = tdec.CompletionModel(cfg_t, params=tdec.params_from_jax(params,
                                                                 cfg_t),
                              buckets=(16,), temp=0.0, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def target():
    return tdec.CompletionModel(tdec.DecoderConfig.tiny(dtype=torch.float32),
                                buckets=(16,), temp=0.0, seed=2,
                                device="cpu")


def _greedy(model, prompt, n):
    out = [int(x) for x in model.generate_tokens(prompt, n, chunk=4)]
    model.reset()
    return out


# -- the distribution and the acceptance rule ------------------------------

@pytest.mark.parametrize("temp", [0.9, 0.0], ids=["sampled", "greedy"])
def test_filtered_probs_equals_jax(temp):
    """The proposal distribution is the sampler chain's (the shared
    nucleus filter): within 1e-6 of the JAX function, row by row; a
    one-hot at the argmax when greedy."""
    logits = np.random.default_rng(0).normal(0, 2, (4, 64)).astype(
        np.float32)
    got = tspec._filtered_probs(torch.from_numpy(logits), 0.8, temp)
    for row in range(4):
        want = np.asarray(jspec._filtered_probs(jnp.asarray(logits[row]),
                                                top_p=0.8, temp=temp))
        np.testing.assert_allclose(got[row].numpy(), want, rtol=0,
                                   atol=1e-6)
    assert torch.allclose(got.sum(-1), torch.ones(4), atol=1e-5)
    if temp == 0.0:
        assert torch.equal(got.argmax(-1), torch.from_numpy(
            logits.argmax(-1)))


def test_draws_and_acceptance_keep_the_target_distribution():
    """A Gumbel-max draw follows its distribution, and the vectorised
    rejection rule (uniforms up front, first rejection by cumulative
    product, residual resample) leaves the first emitted token
    distributed as the target's first-position distribution: 20000
    rows, each frequency within 0.015 (about five standard
    deviations)."""
    gen = torch.Generator().manual_seed(3)
    v, b = 6, 20000
    tp = torch.tensor([0.4, 0.25, 0.15, 0.1, 0.06, 0.04])
    dp = torch.tensor([0.1, 0.1, 0.5, 0.1, 0.1, 0.1])
    draws = tspec._draw(gen, tp.expand(b, v), 0.7)
    freq = torch.bincount(draws, minlength=v).float() / b
    assert (freq - tp).abs().max() < 0.015
    dtoks = tspec._draw(gen, dp.expand(b, v), 0.7)[:, None]
    out, n_valid = tspec._accept(gen, dtoks, dp.expand(b, 1, v),
                                 tp.expand(b, 2, v), 0.7)
    assert out.shape == (b, 2) and set(n_valid.tolist()) <= {1, 2}
    freq = torch.bincount(out[:, 0], minlength=v).float() / b
    assert (freq - tp).abs().max() < 0.015
    # greedy: accept while the draft equals the target's argmax
    onehot = torch.eye(v)
    dt = torch.tensor([[0, 3], [1, 2]])
    out, n_valid = tspec._accept(gen, dt, onehot[dt],
                                 onehot[torch.tensor([[0, 3, 5],
                                                      [0, 2, 4]])], 0.0)
    assert out.tolist() == [[0, 3, 5], [0, 0, 0]]
    assert n_valid.tolist() == [3, 1]


# -- self-drafting ---------------------------------------------------------

def test_self_draft_shares_storage_and_matches_jax():
    """The draft's parameters ARE the target's (data_ptr equal), its
    layers the target's first k; prefill and decode logits within 1e-5
    of the JAX package's self-draft on the same weights."""
    jm, tm = _pair(layers=3)
    jd = jspec.self_draft_model(jm, 2)
    td = tspec.self_draft_model(tm, 2)
    assert td.cfg.layers == 2 and td.module.layer_1 is tm.module.layer_1
    assert not hasattr(td.module, "layer_2")
    tparams = {id(p): p.data_ptr() for p in tm.module.parameters()}
    for name, p in td.module.named_parameters():
        assert id(p) in tparams, name
    assert td.module.lm_head.weight.data_ptr() == \
        tm.module.lm_head.weight.data_ptr()
    np.testing.assert_allclose(td.prefill(PROMPT), jd.prefill(PROMPT),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(td.decode_one(7), jd.decode_one(7), rtol=0,
                               atol=1e-5)


def test_self_draft_of_an_int8_target_and_refusals():
    """An int8-resident target drafts over its own int8 buffers; a
    full-depth draft, a zero-layer one and a MoE trunk are refused."""
    qt = tdec.CompletionModel(tdec.DecoderConfig.tiny(
        dtype=torch.float32, quantized=True), buckets=(16,), temp=0.0,
        seed=4, device="cpu")
    qd = tspec.self_draft_model(qt, 1)
    assert qd.cfg.quantized
    assert qd.module.layer_0.attn.q.q.data_ptr() == \
        qt.module.layer_0.attn.q.q.data_ptr()
    want = _greedy(qt, PROMPT, 12)
    spec = tspec.SpeculativeCompletionModel(qt, qd, gamma=3)
    assert [int(x) for x in spec.generate_tokens(PROMPT, 12)] == want
    spec.reset()
    for k in (0, qt.cfg.layers):
        with pytest.raises(ValueError, match="draft_layers"):
            tspec.self_draft_model(qt, k)
    moe = moe_completion_model(MoeDecoderConfig.tiny(dtype=torch.float32),
                               buckets=(16,), device="cpu")
    with pytest.raises(ValueError, match="own draft checkpoint"):
        tspec.self_draft_model(moe, 1)


def test_self_draft_of_a_tp2_target(target):
    """A sharded target's self-draft is a ShardedCompletionModel over the
    same mesh whose shard modules ARE the target's shards' first layers;
    greedy spec equals plain on the serial lane and, a mid-flight joiner
    included, on the paged lane (f32), with no page leaked."""
    from libsplinter_tpu_torch.parallel import (ShardedCompletionModel,
                                                make_mesh)
    tp = ShardedCompletionModel(
        target.cfg, make_mesh(tp=2, device="cpu"),
        params=target.module.state_dict(), buckets=(16,), temp=0.0, seed=2)
    draft = tspec.self_draft_model(tp, 1)
    assert isinstance(draft, ShardedCompletionModel) and draft.mesh is tp.mesh
    for d, t in zip(draft.module.shards, tp.module.shards):
        assert d.layer_0 is t.layer_0 and d.lm_head is t.lm_head
        assert d.layer_0.attn.q.weight.data_ptr() == \
            t.layer_0.attn.q.weight.data_ptr()
    spec = tspec.SpeculativeCompletionModel(tp, draft, gamma=3)
    want = _greedy(tp, PROMPT, 12)
    assert want == _greedy(target, PROMPT, 12)
    assert [int(x) for x in spec.generate_tokens(PROMPT, 12)] == want
    spec.reset()
    a = np.arange(1, 8, dtype=np.int32)
    b = np.array([9, 2, 6], np.int32)
    out_a, out_b, cache = _paged_run(spec, "f32", a, b)
    assert out_a == _greedy(tp, a, 16) and out_b == _greedy(tp, b, 11)
    assert len(cache.target.pools) == 2
    cache.reset()
    assert cache.used_pages == 0 and cache.draft.used_pages == 0


# -- the serial lane -------------------------------------------------------

@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_serial_greedy_equals_jax_and_target_only(gamma):
    """Greedy speculative output is the target's own greedy output,
    token for token, in both packages, whatever the draft proposes (a
    separate small draft on the same vocab, then a self-draft), and the
    two packages count the same proposals and acceptances (greedy
    acceptance is deterministic)."""
    jt, tt = _pair(seed=2, layers=3)
    want = _greedy(tt, PROMPT, 24)
    jd, td = _pair(seed=5, layers=1, hidden=32, heads=2, kv_heads=2,
                   mlp_dim=64)
    for jdraft, tdraft in ((jd, td), (jspec.self_draft_model(jt, 2),
                                      tspec.self_draft_model(tt, 2))):
        jspecm = jspec.SpeculativeCompletionModel(jt, jdraft, gamma=gamma)
        jgot = [int(x) for x in jspecm.generate_tokens(PROMPT, 24)]
        jspecm.reset()
        spec = tspec.SpeculativeCompletionModel(tt, tdraft, gamma=gamma)
        got = [int(x) for x in spec.generate_tokens(PROMPT, 24)]
        spec.reset()
        assert got == want == jgot
        assert (spec.stats_proposed, spec.stats_accepted) == (
            jspecm.stats_proposed, jspecm.stats_accepted)
        assert spec.stats_verified > spec.stats_proposed > 0


def test_draft_equal_to_target_accepts_everything(target):
    twin = tdec.CompletionModel(target.cfg, params=target.module.state_dict(),
                                buckets=(16,), temp=0.0, device="cpu")
    spec = tspec.SpeculativeCompletionModel(target, twin, gamma=4)
    assert len(list(spec.generate_tokens(PROMPT, 20))) == 20
    spec.reset()
    assert spec.acceptance_rate == 1.0


def test_eos_mid_step_and_window_tail(target):
    """An EOS inside an accepted run stops right after it; near the
    window the step's gamma shrinks instead of overrunning the cache."""
    toks = _greedy(target, PROMPT, 24)
    eos = toks[5]
    spec = tspec.SpeculativeCompletionModel(target, tspec.self_draft_model(
        target, 1), gamma=4)
    got = [int(x) for x in spec.generate_tokens(PROMPT, 24, eos_id=eos)]
    spec.reset()
    assert got == toks[: toks.index(eos) + 1]
    cfg = tdec.DecoderConfig.tiny(dtype=torch.float32, max_len=32)
    t = tdec.CompletionModel(cfg, buckets=(16,), temp=0.0, seed=2,
                             device="cpu")
    want = _greedy(t, PROMPT, 64)
    spec = tspec.SpeculativeCompletionModel(
        t, tspec.self_draft_model(t, 1), gamma=4)
    out = [int(x) for x in spec.generate_tokens(PROMPT, 64)]
    assert t._pos < cfg.max_len
    spec.reset()
    assert 1 <= len(out) <= 25 and out == want[:len(out)]


def test_sampled_mode_runs_and_counts():
    t = tdec.CompletionModel(tdec.DecoderConfig.tiny(dtype=torch.float32),
                             buckets=(16,), temp=0.7, seed=2, device="cpu")
    spec = tspec.SpeculativeCompletionModel(t, tspec.self_draft_model(t, 1),
                                            gamma=3, seed=5)
    out = [int(x) for x in spec.generate_tokens(PROMPT, 18)]
    spec.reset()
    assert len(out) == 18 and all(0 <= x < t.cfg.vocab_size for x in out)
    assert spec.stats_proposed > 0 and 0.0 <= spec.acceptance_rate <= 1.0


# -- the paged lane --------------------------------------------------------

def _paged_run(spec, kv_dtype, a, b):
    """Row 0 decodes 5, row 1 joins mid-flight, both decode 5 twice
    more; returns both rows' tokens and the cache."""
    cache = spec.init_paged(2, page=16, kv_dtype=kv_dtype)
    out_a = [int(np.argmax(spec.paged_prefill_row(cache, a, 0)))]
    pend = spec.paged_decode_chunk_async(cache, np.array([out_a[0], -1]), 5)
    out_a += [int(x) for x in pend.block()[0]]
    out_b = [int(np.argmax(spec.paged_prefill_row(cache, b, 1)))]
    for first in (np.array([-1, out_b[0]]), np.array([-1, -1])):
        pend = spec.paged_decode_chunk_async(cache, first, 5,
                                             carry=pend.last)
        blk = pend.block()
        out_a += [int(x) for x in blk[0]]
        out_b += [int(x) for x in blk[1]]
    return out_a, out_b, cache


def _plain_paged_run(model, kv_dtype, a, b):
    """_paged_run's schedule on the plain paged lane."""
    cache = model.init_paged(2, page=16, kv_dtype=kv_dtype)
    out_a = [int(np.argmax(model.paged_prefill_row(cache, a, 0)))]
    out_a += [int(x) for x in model.paged_decode_chunk(
        cache, np.array([out_a[0], 0]), 5)[0]]
    out_b = [int(np.argmax(model.paged_prefill_row(cache, b, 1)))]
    col = np.array([out_a[-1], out_b[0]])
    for _ in range(2):
        blk = model.paged_decode_chunk(cache, col, 5)
        out_a += [int(x) for x in blk[0]]
        out_b += [int(x) for x in blk[1]]
        col = blk[:, -1]
    cache.reset()
    return out_a, out_b


@pytest.mark.parametrize("kv_dtype", ["f32", "int8", "int4"])
def test_paged_greedy_with_midflight_joiner(target, kv_dtype):
    """The batched step (draft through the paged forward, the target's
    verify stack through K5's multi-query form, acceptance on the
    device) against the port's own target-only greedy: token for token
    over f32 pools; over int8 pools the first token exact and >= 50%
    agreement; int4 pools compose: the first tokens equal the plain
    paged lane's over int4 pools, and no agreement after them is held
    (int4 noise alone moves the plain lane off the dense greedy tokens
    within a few steps at this width, row A agreeing on 1 of 16).  Zero
    leaked pages on both pools after the rows free."""
    a = np.arange(1, 8, dtype=np.int32)
    b = np.array([9, 2, 6], np.int32)
    if kv_dtype == "int4":
        sa, sb = _plain_paged_run(target, kv_dtype, a, b)
    else:
        sa, sb = _greedy(target, a, 16), _greedy(target, b, 11)
    spec = tspec.SpeculativeCompletionModel(
        target, tspec.self_draft_model(target, 1), gamma=3)
    out_a, out_b, cache = _paged_run(spec, kv_dtype, a, b)
    if kv_dtype == "f32":
        assert out_a == sa and out_b == sb
    elif kv_dtype == "int4":
        assert out_a[0] == sa[0] and out_b[0] == sb[0]
        assert len(out_a) == 16 and len(out_b) == 11
    else:
        assert out_a[0] == sa[0] and out_b[0] == sb[0]
        assert np.mean(np.array(out_a) == sa) >= 0.5
        assert np.mean(np.array(out_b) == sb) >= 0.5
    assert cache.draft.lengths.tolist() == cache.target.lengths.tolist()
    cache.free_row(0)
    cache.free_row(1)
    assert cache.used_pages == 0 and cache.draft.used_pages == 0
    assert spec.stats_verified > spec.stats_proposed > 0


def test_paged_window_edge_falls_back_to_a_plain_step():
    """A row whose next gamma+1 stack would cross the window runs plain
    paged steps (lengths frozen for sated rows on both pools): the
    tokens still equal the target-only greedy ones up to the window."""
    cfg = tdec.DecoderConfig.tiny(dtype=torch.float32, max_len=32)
    t = tdec.CompletionModel(cfg, buckets=(16,), temp=0.0, seed=2,
                             device="cpu")
    want = _greedy(t, PROMPT, 64)
    spec = tspec.SpeculativeCompletionModel(t, tspec.self_draft_model(t, 1),
                                            gamma=4)
    cache = spec.init_paged(2, page=8)
    got = [int(np.argmax(spec.paged_prefill_row(cache, PROMPT, 0)))]
    fresh = np.array([got[0], -1])
    plain_before = t.compile_count()
    while len(got) + 4 <= cfg.max_len - len(PROMPT):
        got += [int(x) for x in spec.paged_decode_chunk(cache, fresh, 4)[0]]
        fresh = np.array([-1, -1])
    assert got == want[:len(got)] and len(got) >= 20
    assert int(cache.target.lengths[0]) <= cfg.max_len
    assert cache.draft.lengths.tolist() == cache.target.lengths.tolist()
    assert t.compile_count() > plain_before     # the plain step ran
    cache.reset()
    assert cache.used_pages == 0 and cache.draft.used_pages == 0


def test_paged_warmup_pins_compile_count(target):
    spec = tspec.SpeculativeCompletionModel(
        target, tspec.self_draft_model(target, 1), gamma=3)
    cache = spec.init_paged(2, page=16)
    spec.warmup_paged(cache, chunk=4, max_prompt=15)
    base = spec.compile_count()
    assert base > 0 and spec.stats_proposed == 0 and cache.used_pages == 0
    _paged_run(spec, None, np.arange(1, 8, dtype=np.int32),
               np.array([9, 2, 6], np.int32))
    assert spec.compile_count() == base


# -- the completer's speculative wiring ------------------------------------

def _vocab(n):
    """A llama (unigram) vocab of n pieces: control tokens, the 256 byte
    pieces, the chatml markers, then seeded word pieces."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    tokens += ["<|im_start|>", "<|im_end|>"]
    types = [tgguf.TOKTYPE_UNKNOWN] + [tgguf.TOKTYPE_CONTROL] * 2 \
        + [tgguf.TOKTYPE_BYTE] * 256 + [tgguf.TOKTYPE_CONTROL] * 2
    rng = np.random.default_rng(0)
    seen = set(tokens)
    while len(tokens) < n:
        w = "▁" + "".join(rng.choice(list("abcdefgh"),
                                     int(rng.integers(1, 5))))
        if w not in seen:
            seen.add(w)
            tokens.append(w)
            types.append(tgguf.TOKTYPE_NORMAL)
    scores = [0.0] * 261 + [-float(len(t)) for t in tokens[261:]]
    return tokens, scores, types


_GGUF_NAMES = {"ln_attn": "attn_norm", "ln_mlp": "ffn_norm",
               "attn.q": "attn_q", "attn.k": "attn_k", "attn.v": "attn_v",
               "attn.out": "attn_output", "gate": "ffn_gate",
               "up": "ffn_up", "down": "ffn_down"}


def _llama_file(path, model):
    """A port CompletionModel's f32 weights as a llama GGUF (F32) with a
    unigram vocab: what --weights and --draft-weights read."""
    cfg = model.cfg
    top = {"tok_emb.weight": "token_embd.weight",
           "ln_out.weight": "output_norm.weight",
           "lm_head.weight": "output.weight"}
    tensors = {}
    for key, t in model.module.state_dict().items():
        if key in top:
            gname = top[key]
        else:
            layer, rest = key.split(".", 1)
            gname = (f"blk.{layer.split('_')[1]}."
                     f"{_GGUF_NAMES[rest.removesuffix('.weight')]}.weight")
        tensors[gname] = (t.float().numpy(), GGML_F32)
    tokens, scores, types = _vocab(cfg.vocab_size)
    write_gguf(str(path), tensors, [
        kv_str("general.architecture", "llama"),
        kv_u32("llama.block_count", cfg.layers),
        kv_u32("llama.embedding_length", cfg.hidden),
        kv_u32("llama.attention.head_count", cfg.heads),
        kv_u32("llama.attention.head_count_kv", cfg.kv_heads),
        kv_u32("llama.feed_forward_length", cfg.mlp_dim),
        kv_u32("llama.context_length", cfg.max_len),
        kv_str("tokenizer.ggml.model", "llama"),
        kv_str_array("tokenizer.ggml.tokens", tokens),
        kv_f32_array("tokenizer.ggml.scores", scores),
        kv_i32_array("tokenizer.ggml.token_type", types),
        kv_u32("tokenizer.ggml.bos_token_id", 1),
        kv_u32("tokenizer.ggml.eos_token_id", 2),
        kv_u32("tokenizer.ggml.unknown_token_id", 0)])
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny target .gguf and a one-layer draft .gguf on its vocab."""
    d = tmp_path_factory.mktemp("spec")
    big = tdec.CompletionModel(tdec.DecoderConfig.tiny(
        dtype=torch.float32, layers=3), seed=7, device="cpu")
    small = tdec.CompletionModel(tdec.DecoderConfig.tiny(
        dtype=torch.float32, layers=1), seed=8, device="cpu")
    return _llama_file(d / "target.gguf", big), \
        _llama_file(d / "draft.gguf", small)


@pytest.fixture
def stores():
    made = []

    def make(max_val=2048):
        name = f"/spt-ts-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        st = Store.create(name, nslots=64, max_val=max_val, vec_dim=0)
        made.append((st, name))
        return st

    yield make
    for st, name in made:
        st.close()
        Store.unlink(name)


def _submit(st, key, prompt):
    st.set(key, prompt)
    st.label_or(key, P.LBL_INFER_REQ)
    st.bump(key)


def _await(pred, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _ready(st, keys):
    return all(st.labels(k) & P.LBL_READY for k in keys)


PROMPTS = {"a": "hello there", "b": "the quick brown fox", "c": "abc"}
_RUN_CONTINUOUS = Completer.run_continuous      # before any monkeypatch


def _main_continuous(st, argv, monkeypatch, keys):
    """main on the continuous lane, stopped once `keys` are READY;
    returns the lane's Completer."""
    seen = {}

    def run_then_stop(self, **kw):
        seen["comp"] = self
        th = threading.Thread(target=_RUN_CONTINUOUS, args=(self,),
                              kwargs=dict(idle_timeout_ms=20,
                                          stop_after=240.0), daemon=True)
        th.start()
        seen["ready"] = _await(lambda: _ready(st, keys), 200)
        self.stop()
        th.join(timeout=60)

    monkeypatch.setattr(Completer, "run_continuous", run_then_stop)
    assert tcomp.main(["--store", st.name, "--device", "cpu", "--temp",
                       "0", "--template", "none", "--max-new-tokens", "12",
                       "--batch-cap", "2", *argv]) == 0
    assert seen["ready"]
    return seen["comp"]


def test_main_draft_layers_on_the_continuous_lane(stores, files,
                                                  monkeypatch):
    """--draft-layers 1 --gamma 3 serves the continuous lane (two rows,
    three requests: the third joins as a row frees) with the bytes of
    the plain lane on the same file; the heartbeat carries the
    speculative counters and both pools end empty."""
    target, _ = files
    outs = []
    for extra in ([], ["--draft-layers", "1", "--gamma", "3",
                       "--spec-min-acceptance", "0"]):
        st = stores()
        for k, text in PROMPTS.items():
            _submit(st, k, text)
        comp = _main_continuous(st, ["--weights", target, "--continuous",
                                     *extra], monkeypatch, list(PROMPTS))
        outs.append({k: st.get(k) for k in PROMPTS})
    assert outs[0] == outs[1]
    assert isinstance(comp._model, tspec.SpeculativeCompletionModel)
    assert comp._model.gamma == 3 and comp._model.draft.cfg.layers == 1
    comp.publish_stats()
    snap = json.loads(st.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
    assert snap["spec_verified_tokens"] > snap["spec_draft_tokens"] > 0
    assert 0.0 <= snap["spec_acceptance"] <= 1.0
    assert snap["spec_demotions"] == 0
    cache = comp._paged_cache
    assert cache.used_pages == 0 and cache.draft.used_pages == 0


def test_main_draft_weights_on_the_serial_lane(stores, files):
    """--draft-weights <draft.gguf> serves the serial lane with the
    target-only bytes (greedy); the draft's geometry comes from its
    file."""
    target, draft = files
    outs = []
    for extra in ([], ["--draft-weights", draft, "--gamma", "2"]):
        st = stores()
        for k, text in PROMPTS.items():
            _submit(st, k, text)
        assert tcomp.main(["--store", st.name, "--device", "cpu",
                           "--weights", target, "--oneshot", "--temp", "0",
                           "--template", "none", "--max-new-tokens", "10",
                           "--batch-cap", "1", *extra]) == 0
        assert _ready(st, list(PROMPTS))
        outs.append({k: st.get(k) for k in PROMPTS})
    assert outs[0] == outs[1]


def test_main_draft_flag_exits(files):
    """Both draft flags together, and a draft that is not a .gguf, exit
    non-zero with the JAX daemon's messages before anything loads."""
    target, draft = files
    with pytest.raises(SystemExit, match="mutually exclusive"):
        tcomp.main(["--store", "/spt-never-opened", "--device", "cpu",
                    "--weights", target, "--draft-weights", draft,
                    "--draft-layers", "1"])
    with pytest.raises(SystemExit, match="requires a .gguf draft"):
        tcomp.main(["--store", "/spt-never-opened", "--device", "cpu",
                    "--draft-weights", "draft.safetensors"])


def _hopeless():
    """A speculative model whose draft (disjoint seed) the target keeps
    rejecting."""
    t = tdec.CompletionModel(tdec.DecoderConfig.tiny(dtype=torch.float32),
                             buckets=(16,), temp=0.0, seed=2, device="cpu")
    d = tdec.CompletionModel(tdec.DecoderConfig.tiny(
        dtype=torch.float32, layers=1), buckets=(16,), temp=0.0, seed=99,
        device="cpu")
    return tspec.SpeculativeCompletionModel(t, d, gamma=4)


@pytest.mark.parametrize("floor", [0.95, 0.0], ids=["floor", "floor0"])
def test_spec_acceptance_heartbeat_and_demotion(stores, floor):
    """Serial lane: a hopeless draft publishes spec_acceptance and is
    demoted to its target below --spec-min-acceptance, and serving
    continues; a floor of 0 never demotes."""
    st = stores()
    spec = _hopeless()
    comp = Completer(st, model=spec, max_new_tokens=40, flush_tokens=4,
                     template="none", batch_cap=1,
                     spec_min_acceptance=floor)
    comp.attach()
    _submit(st, "q1", "first question")
    assert comp.run_once() == 1
    comp.publish_stats()
    snap = json.loads(st.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
    assert snap["spec_acceptance"] < 0.95
    if floor:
        assert comp.stats.spec_demotions == 1 and comp._model is spec.target
        assert snap["spec_demotions"] == 1
    else:
        assert comp.stats.spec_demotions == 0 and comp._model is spec
    _submit(st, "q2", "second question")
    assert comp.run_once() == 1 and st.labels("q2") & P.LBL_READY


def test_continuous_demotion_adopts_a_fresh_pool(stores):
    """Continuous lane: the floor trips at a heartbeat, the lane adopts
    the plain target at its next idle point with a fresh pool (the
    paired pools retire), later requests are served plain, and no page
    leaks."""
    st = stores()
    spec = _hopeless()
    comp = Completer(st, model=spec, max_new_tokens=24, flush_tokens=4,
                     template="none", batch_cap=2, page_size=8,
                     spec_min_acceptance=0.99)
    comp.attach()
    th = threading.Thread(target=comp.run_continuous,
                          kwargs=dict(idle_timeout_ms=20, stop_after=120.0),
                          daemon=True)
    th.start()
    try:
        for k in ("w1/0", "w1/1"):
            _submit(st, k, f"{k} question")
        assert _await(lambda: _ready(st, ["w1/0", "w1/1"]))
        assert _await(lambda: isinstance(comp._paged_cache,
                                         tdec.PagedKVCache), 30)
        for k in ("w2/0", "w2/1"):
            _submit(st, k, f"{k} question")
        assert _await(lambda: _ready(st, ["w2/0", "w2/1"]))
    finally:
        comp.stop()
        th.join(timeout=30)
    assert comp.stats.spec_demotions == 1 and comp._model is spec.target
    assert comp.stats.completions == 4 and comp.stats.aborts == 0
    assert comp._paged_cache.used_pages == 0
