"""Crash drills of the torch port's lanes under the port's supervisor,
with the lanes' real entry points as its children.

The supervisor (libsplinter_tpu_torch/engine/supervisor.py) spawns
`python -m libsplinter_tpu_torch.engine.<lane> --store NAME --device cpu
--weights tiny.gguf ...` (GGUF files written here by the port's
gguf_writer from seeded weights), SPTPU_FAULT arms a `crash` in the first
generation, and each drill asserts what the JAX package's drill asserts:
the crash is observed and the lane restarted (never `down`), every
admitted request converges with nothing stranded, and a request made
after the crash round-trips.  Counterparts:

  - tests/test_crash_recovery.py:144-230 (a crash at each lane site,
    then recovery), :306 (the supervised searcher) and :322 (the
    supervised embedder): test_supervised_{searcher,embedder,completer}
    _site_recovers; :361 (the sharded continuous lane crashed at its
    first sharded dispatch): test_supervise_restores_sharded_completer
    _lane, a --tp 2 completer over two CPU shards; :428 (a crash mid
    quantized commit): test_supervise_restores_quantized_commit_crash;
  - tests/test_pipeliner.py:662 (scripts reclaimed after a crash):
    test_supervised_crash_reclaims_scripts, over all four lanes;
  - tests/test_kv_tier.py:608,633,659 (mid-spill, mid-readmit,
    mid-restore): test_supervised_mid_*;
  - tests/test_disagg.py:599,610 (prefill handoff, decode adopt):
    test_supervise_recovers_*;
  - tests/test_elastic.py:150 (two embedder replicas byte-identical to
    one): in-process in f32 (exactly-once claims, vectors bit-equal to
    one replica's) and supervised, scaled up and down by a manual
    target, the vectors bit-equal to an in-process model on the file.

The drills run on the CPU here; SPTPU_TEST_DEVICE=cuda runs the same
drills with the children on the card (the file imports no JAX, so
`python -m pytest --noconftest` runs it there)."""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from libsplinter_tpu_torch import T_VARTEXT, Store
from libsplinter_tpu_torch.engine import protocol as P
from libsplinter_tpu_torch.engine.completer import Completer
from libsplinter_tpu_torch.engine.embedder import Embedder
from libsplinter_tpu_torch.engine.kv_tier import TierPersist
from libsplinter_tpu_torch.engine.pipeliner import submit_script
from libsplinter_tpu_torch.engine.searcher import (consume_result,
                                                   submit_search)
from libsplinter_tpu_torch.engine.supervisor import Supervisor
from libsplinter_tpu_torch.models import (CompletionModel, EmbeddingModel,
                                          GgufFile, decoder_config_from_gguf,
                                          encoder_config_from_gguf,
                                          load_tokenizer)
from libsplinter_tpu_torch.models import decoder as tdec
from libsplinter_tpu_torch.models import encoder as tenc
from libsplinter_tpu_torch.models import gguf as tgguf
from libsplinter_tpu_torch.models.gguf_writer import (
    GGML_F32, export_encoder_gguf, kv_f32_array, kv_i32_array, kv_str,
    kv_str_array, kv_u32, write_gguf)
from libsplinter_tpu_torch.utils import faults

pytestmark = pytest.mark.chaos

VEC_DIM = 16
PAGE = 8
HOT_PROMPT = "abcdefghijklmnopqrstuvw"
WORDS = [f"w{i}" for i in range(1019)]

# one RAG chain (tests/test_torch_pipeliner.py's): embed the query,
# search with its vector, complete on the top hit's text
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


# ------------------------------------------------------------ the files

def _nest(flat):
    tree = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")[1:]
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


def _encoder_file(path):
    """A tiny nomic-bert GGUF with a WordPiece vocab of WORDS."""
    cfg = tenc.EncoderConfig.tiny()
    src = tenc.Encoder(cfg)
    tenc.init_params(src, torch.Generator().manual_seed(3))
    export_encoder_gguf(_nest(tenc.params_to_jax(src)), cfg, path,
                        tokenizer_vocab=["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                         "[MASK]"] + WORDS)


def _decoder_file(path, kv_heads=1):
    """A tiny llama GGUF (vocab 300: the specials, the 256 byte pieces
    and control fillers, so text encodes a token per byte; heads of 32,
    the narrowest K5 serves on the card); kv_heads=2 splits over tp = 2."""
    cfg = tdec.DecoderConfig.tiny(vocab_size=300, heads=2,
                                  kv_heads=kv_heads)
    src = tdec.Decoder(cfg)
    tdec.init_params(src, torch.Generator().manual_seed(4))
    top = {"tok_emb.weight": "token_embd.weight",
           "ln_out.weight": "output_norm.weight",
           "lm_head.weight": "output.weight"}
    per_layer = {"ln_attn": "attn_norm", "ln_mlp": "ffn_norm",
                 "attn.q": "attn_q", "attn.k": "attn_k", "attn.v": "attn_v",
                 "attn.out": "attn_output", "gate": "ffn_gate",
                 "up": "ffn_up", "down": "ffn_down"}
    tensors = {}
    for key, arr in src.state_dict().items():
        if key in top:
            name = top[key]
        else:
            layer, rest = key.split(".", 1)
            name = (f"blk.{layer.split('_')[1]}."
                    f"{per_layer[rest.removesuffix('.weight')]}.weight")
        tensors[name] = (arr.float().numpy(), GGML_F32)
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [tgguf.TOKTYPE_UNKNOWN] + [tgguf.TOKTYPE_CONTROL] * 2 \
        + [tgguf.TOKTYPE_BYTE] * 256
    tokens += [f"<x{i}>" for i in range(300 - len(tokens))]
    types += [tgguf.TOKTYPE_CONTROL] * (300 - len(types))
    md = [kv_str("general.architecture", "llama"),
          kv_u32("llama.block_count", cfg.layers),
          kv_u32("llama.embedding_length", cfg.hidden),
          kv_u32("llama.attention.head_count", cfg.heads),
          kv_u32("llama.attention.head_count_kv", cfg.kv_heads),
          kv_u32("llama.feed_forward_length", cfg.mlp_dim),
          kv_u32("llama.context_length", cfg.max_len),
          kv_str("tokenizer.ggml.model", "llama"),
          kv_str_array("tokenizer.ggml.tokens", tokens),
          kv_f32_array("tokenizer.ggml.scores", [0.0] * len(tokens)),
          kv_i32_array("tokenizer.ggml.token_type", types),
          kv_u32("tokenizer.ggml.bos_token_id", 1),
          kv_u32("tokenizer.ggml.eos_token_id", 2),
          kv_u32("tokenizer.ggml.unknown_token_id", 0)]
    write_gguf(path, tensors, md)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lane-files")
    enc, dec = str(tmp / "enc.gguf"), str(tmp / "dec.gguf")
    _encoder_file(enc)
    _decoder_file(dec)
    return enc, dec


@pytest.fixture(scope="module")
def sharded_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp-files") / "dec-kv2.gguf")
    _decoder_file(path, kv_heads=2)
    return path


@pytest.fixture
def device():
    """Where the children run: the CPU here, the card with
    SPTPU_TEST_DEVICE=cuda."""
    dev = os.environ.get("SPTPU_TEST_DEVICE", "cpu")
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("SPTPU_TEST_DEVICE=cuda needs a CUDA card")
    return dev


@pytest.fixture
def cstore():
    name = f"/spt-tdrill-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=128, max_val=16384, vec_dim=VEC_DIM)
    yield st
    st.close()
    Store.unlink(name)


# ------------------------------------------------------------ the harness

@contextlib.contextmanager
def _supervised(st, lanes, lane_args, fault, monkeypatch, *, stop_after,
                **kw):
    """The port's Supervisor over `lanes` (real entry points) on a
    thread, SPTPU_FAULT armed for the first generation; stopped and
    every child gone on exit."""
    assert faults.registered_sites(fault)
    monkeypatch.setenv("SPTPU_FAULT", fault)
    sup = Supervisor(st.name, lanes=lanes, store=st, lane_args=lane_args,
                     backoff_base_ms=100, backoff_max_ms=2000,
                     breaker_threshold=8, breaker_window_s=240,
                     startup_grace_s=300, **kw)
    th = threading.Thread(target=sup.run,
                          kwargs={"poll_interval_s": 0.1,
                                  "stop_after": stop_after}, daemon=True)
    th.start()
    try:
        yield sup
    finally:
        sup.stop()
        th.join(timeout=60)
        assert not th.is_alive(), "the supervisor thread did not stop"
        pids = [ln.pid for reps in sup.replicas.values()
                for ln in reps.values()]
        assert not any(P.pid_alive(p) for p in pids if p)


def _wait(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.2)
    return pred()


def _lane_ok(sup, lane):
    ln = sup.lanes[lane]
    assert ln.restarts >= 1, f"{lane}: no restart observed ({ln})"
    assert ln.state != "down", f"{lane}: breaker open"


def _embed_args(files, device, *extra):
    return ["--device", device, "--weights", files[0], *extra]


def _complete_args(files, device, *extra):
    return ["--device", device, "--weights", files[1], "--template", "none",
            "--temp", "0", "--max-new-tokens", "8", *extra]


def _text(i):
    return " ".join(WORDS[(7 * i + 3 * j) % len(WORDS)]
                    for j in range(3 + i % 11))


def _request_embeds(st, keys):
    for i, key in enumerate(keys):
        st.set(key, _text(i))
        st.set_type(key, T_VARTEXT)
        st.label_or(key, P.LBL_EMBED_REQ | P.LBL_WAITING)
        st.bump(key)


def _reference_vectors(path, texts, vec_dim, device):
    """The file's model in-process, one Embedder over a scratch store:
    what a single replica commits for `texts`."""
    name = f"/spt-tdref-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=256, max_val=4096, vec_dim=vec_dim)
    try:
        with GgufFile(path) as gf:
            cfg = encoder_config_from_gguf(gf, out_dim=vec_dim)
            tok = load_tokenizer(gf)
        emb = Embedder(st, model=EmbeddingModel(cfg, weights=path,
                                                device=device),
                       tokenizer=tok, max_ctx=cfg.max_len)
        emb.attach()
        for key, text in texts.items():
            st.set(key, text)
            st.set_type(key, T_VARTEXT)
            st.label_or(key, P.LBL_EMBED_REQ | P.LBL_WAITING)
            st.bump(key)
        assert emb.run_once() == len(texts)
        return {key: st.vec_get(key).copy() for key in texts}
    finally:
        st.close()
        Store.unlink(name)


def _ask(st, key, prompt):
    st.set(key, prompt)
    st.label_clear(key, P.LBL_READY)
    st.label_or(key, P.LBL_INFER_REQ | P.LBL_WAITING)
    st.bump(key)


def _ready(st, keys):
    busy = P.LBL_INFER_REQ | P.LBL_WAITING | P.LBL_SERVICING
    return all(st.labels(k) & P.LBL_READY and not st.labels(k) & busy
               for k in keys)


def _no_aborts(st, key=P.KEY_COMPLETE_STATS):
    """The serving generation's heartbeat, published after this call,
    counts no aborted batch (an abort finalizes its rows READY with
    what they streamed, which the labels alone cannot tell apart)."""
    t0 = time.time()

    def fresh():
        try:
            hb = json.loads(st.get(key).rstrip(b"\0"))
        except (KeyError, ValueError):
            return None
        return hb if hb["ts"] > t0 else None

    assert _wait(lambda: fresh() is not None, 30), key
    hb = fresh()
    assert hb["aborts"] == 0, hb


# ----------------------------------------- crash at each lane site

SEARCHER_SITES = ("searcher.gather", "searcher.dispatch", "searcher.select",
                  "searcher.commit", "store.set")
EMBEDDER_SITES = ("embedder.drain", "embedder.encode", "embedder.commit",
                  "store.vec_commit")
COMPLETER_SITES = ("completer.render", "completer.generate",
                   "completer.commit")
# the JAX package's tier-1 representatives; the rest of each matrix is
# slow there and here
FAST = ("searcher.gather", "searcher.commit", "embedder.commit")


def _sites(sites):
    return [s if s in FAST else pytest.param(s, marks=pytest.mark.slow)
            for s in sites]


@pytest.mark.parametrize("site", _sites(SEARCHER_SITES))
def test_supervised_searcher_site_recovers(cstore, site, device,
                                           monkeypatch):
    st = cstore
    rng = np.random.default_rng(17)
    vecs = rng.normal(size=(24, VEC_DIM)).astype(np.float32)
    for i in range(24):
        st.set(f"doc/{i}", f"text {i}")
        st.vec_set(f"doc/{i}", vecs[i])
    staged = [f"__sqtmp_{i}" for i in range(2)]
    for j, key in enumerate(staged):
        st.set(key, json.dumps({"k": 3}))
        st.vec_set(key, vecs[j + 7])
        st.label_or(key, P.LBL_SEARCH_REQ | P.LBL_WAITING)
        st.bump(key)
    with _supervised(st, ("searcher",),
                     {"searcher": ["--device", device]},
                     f"{site}:crash@1", monkeypatch,
                     stop_after=150.0) as sup:
        st.set("__sq_live", "placeholder")
        st.vec_set("__sq_live", vecs[5])
        rec = submit_search(st, "__sq_live", 3, timeout_ms=120_000)
        assert rec is not None and rec["keys"][0] == "doc/5", rec
        consume_result(st, "__sq_live")
        _lane_ok(sup, "searcher")
        assert _wait(lambda: not st.enumerate_indices(P.LBL_SEARCH_REQ),
                     60)
        for j, key in enumerate(staged):
            assert not st.labels(key) & (P.LBL_SEARCH_REQ | P.LBL_WAITING)
            rec = json.loads(st.get(P.search_result_key(
                st.find_index(key))).rstrip(b"\0"))
            assert rec["keys"][0] == f"doc/{j + 7}", rec
            consume_result(st, key)
        leaked = [k for k in st.list()
                  if k.startswith(P.SEARCH_RESULT_PREFIX)]
        assert leaked == []


@pytest.mark.parametrize("site", _sites(EMBEDDER_SITES))
def test_supervised_embedder_site_recovers(cstore, files, site, device,
                                           monkeypatch):
    st = cstore
    keys = [f"txt/{i}" for i in range(4)]
    _request_embeds(st, keys)
    with _supervised(st, ("embedder",),
                     {"embedder": _embed_args(files, device)},
                     f"{site}:crash@1", monkeypatch,
                     stop_after=150.0) as sup:
        assert _wait(lambda: not any(st.labels(k) & P.LBL_EMBED_REQ
                                     for k in keys), 120), sup.lanes
        _lane_ok(sup, "embedder")
        # a request after the crash
        st.set("txt/late", _text(9))
        st.set_type("txt/late", T_VARTEXT)
        st.label_or("txt/late", P.LBL_EMBED_REQ | P.LBL_WAITING)
        st.bump("txt/late")
        assert _wait(lambda: not st.labels("txt/late") & P.LBL_EMBED_REQ,
                     60)
    want = _reference_vectors(
        files[0], {k: _text(i) for i, k in enumerate(keys)}
        | {"txt/late": _text(9)}, VEC_DIM, device)
    for key, vec in want.items():
        assert not st.labels(key) & (P.LBL_EMBED_REQ | P.LBL_WAITING)
        got = st.vec_get(key)
        if device == "cpu":
            assert np.array_equal(got, vec), key
        else:
            assert float(got @ vec) >= 0.999, key


@pytest.mark.slow
@pytest.mark.parametrize("site", COMPLETER_SITES)
def test_supervised_completer_site_recovers(cstore, files, site, device,
                                            monkeypatch):
    """A crash after the WAITING -> SERVICING claim strands the key; the
    restarted daemon's attach reclaim re-queues and serves it."""
    st = cstore
    _ask(st, "q", "ping?")
    with _supervised(st, ("completer",),
                     {"completer": _complete_args(files, device)},
                     f"{site}:crash@1", monkeypatch,
                     stop_after=150.0) as sup:
        assert _wait(lambda: _ready(st, ["q"]), 120), sup.lanes
        _lane_ok(sup, "completer")
        _ask(st, "q2", "again?")
        assert _wait(lambda: _ready(st, ["q2"]), 60)
        _no_aborts(st)
    for key, prompt in (("q", b"ping?"), ("q2", b"again?")):
        assert st.get(key).rstrip(b"\0").startswith(prompt)


def test_supervise_restores_sharded_completer_lane(cstore, sharded_file,
                                                  device, monkeypatch):
    """The tp = 2 continuous completer (--tp 2: a ShardedCompletionModel
    over two shards) crashes at its FIRST sharded paged dispatch; the
    supervisor observes the crash and restarts the lane without the
    fault, and both the stranded pre-crash request and a post-crash one
    converge to READY with the prompt kept."""
    st = cstore
    _ask(st, "q", "hello sharded pod")
    args = ["--device", device, "--weights", sharded_file, "--template",
            "none", "--temp", "0", "--max-new-tokens", "8", "--continuous",
            "--tp", "2", "--batch-cap", "4", "--page-size", str(PAGE)]
    with _supervised(st, ("completer",), {"completer": args},
                     "completer.sharded_dispatch:crash@1", monkeypatch,
                     stop_after=240.0) as sup:
        assert _wait(lambda: _ready(st, ["q"]), 180), sup.lanes
        _lane_ok(sup, "completer")
        _ask(st, "q2", "again, sharded")
        assert _wait(lambda: _ready(st, ["q2"]), 120)

        def sharded_beat():
            hb = json.loads(st.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
            return hb.get("tp") == 2 and set(hb.get("pages_shard", {})) \
                == {"0", "1"}

        assert _wait(sharded_beat, 30)
    assert st.get("q2").rstrip(b"\0").startswith(b"again, sharded")


@pytest.mark.slow
def test_supervise_restores_quantized_commit_crash(cstore, files, device,
                                                   monkeypatch):
    """The int8 pool's lane dies between its claim and the quantized
    commit of the prompt's K/V; the restarted lane's pool is built anew
    (no half-written page can serve) and its heartbeat shows every page
    free once both requests are READY."""
    st = cstore
    _ask(st, "q", "hello quantized pool")
    args = _complete_args(files, device, "--continuous", "--kv-dtype",
                          "int8", "--no-prefix-cache", "--batch-cap", "4",
                          "--page-size", str(PAGE))
    with _supervised(st, ("completer",), {"completer": args},
                     "completer.kv_quant_commit:crash@1", monkeypatch,
                     stop_after=240.0) as sup:
        assert _wait(lambda: _ready(st, ["q"]), 180), sup.lanes
        _lane_ok(sup, "completer")
        _ask(st, "q2", "again, quantized")
        assert _wait(lambda: _ready(st, ["q2"]), 120)
        _no_aborts(st)

        def clean():
            hb = json.loads(st.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
            return hb.get("kv_dtype") == "int8" and \
                hb.get("pages_used") == 0 and hb.get("completions") == 2

        assert _wait(clean, 30)
    assert st.get("q2").rstrip(b"\0").startswith(b"again, quantized")


# ------------------------------------------------ the pipeline lane

@pytest.mark.slow
def test_supervised_crash_reclaims_scripts(cstore, files, device,
                                           monkeypatch):
    """The whole stack as children; the pipeline lane dies at its 6th
    exec slice with scripts suspended on verbs, and the restarted lane
    re-runs every stranded script: zero admitted loss."""
    st = cstore
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(8, VEC_DIM)).astype(np.float32)
    for i in range(8):
        st.set(f"doc/{i}", _text(i))
        st.vec_set(f"doc/{i}", vecs[i] / np.linalg.norm(vecs[i]))
    lanes = ("embedder", "searcher", "completer", "pipeliner")
    args = {"embedder": _embed_args(files, device),
            "searcher": ["--device", device],
            "completer": _complete_args(files, device)}
    with _supervised(st, lanes, args, "pipeliner.exec:crash@6",
                     monkeypatch, stop_after=240.0) as sup:
        assert _wait(lambda: P.heartbeat_live(st, P.KEY_SCRIPT_STATS,
                                              max_age_s=30), 120)
        recs = {}

        def client(i):
            recs[i] = submit_script(
                st, f"rag/{i}", script=RAG,
                args=[f"__rq/{i}", _text(20 + i), 3, f"ans/{i}"],
                timeout_ms=150_000)

        ths = [threading.Thread(target=client, args=(i,))
               for i in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=170)
        assert not any(t.is_alive() for t in ths)
        _lane_ok(sup, "pipeliner")
        for lane in ("embedder", "searcher", "completer"):
            assert sup.lanes[lane].restarts == 0
        _no_aborts(st)
    for i in range(4):
        assert recs[i] is not None and recs[i].get("ok") is True, recs[i]
        hits, out = recs[i]["ret"]
        assert len(hits) == 3 and out.startswith("ctx: ")
        assert _ready(st, [f"ans/{i}"])


# ------------------------------------------------------ the KV tier

def _tier_args(files, device, pname):
    return _complete_args(files, device, "--continuous", "--batch-cap", "4",
                          "--page-size", str(PAGE), "--kv-tier-pages", "32",
                          "--kv-tier-persist", pname)


def _run_tier_drill(st, files, device, pname, fault, keys, monkeypatch):
    with _supervised(st, ("completer",),
                     {"completer": _tier_args(files, device, pname)},
                     fault, monkeypatch, stop_after=240.0) as sup:
        assert _wait(lambda: _ready(st, keys), 180), sup.lanes
        _lane_ok(sup, "completer")
        _ask(st, "c3", HOT_PROMPT)
        assert _wait(lambda: _ready(st, ["c3"]), 120)
        _no_aborts(st)


def _seed_warm_generation(st, files, device, pname):
    """Generation 0, in-process before any fault: the hot prompt served
    with persistence on, cold and then again over its resident prefix
    pages; retirement checkpoints the warm set the supervised child
    attaches from.  Returns the second serve's bytes: a readmission
    maps the same page bytes and prefills the same suffix, while a cold
    prefill of the whole prompt may round otherwise in bf16."""
    with GgufFile(files[1]) as gf:
        cfg = decoder_config_from_gguf(gf)
        tok = load_tokenizer(gf)
    comp = Completer(st, model=CompletionModel(cfg, weights=files[1],
                                               temp=0.0, device=device),
                     tokenizer=tok, max_new_tokens=8, template="none",
                     batch_cap=4, page_size=PAGE, kv_tier_pages=32,
                     kv_tier_persist=pname)
    comp.attach()
    _ask(st, "w0", HOT_PROMPT)
    th = threading.Thread(target=comp.run_continuous,
                          kwargs=dict(idle_timeout_ms=20, stop_after=60.0),
                          daemon=True)
    th.start()
    assert _wait(lambda: _ready(st, ["w0"]), 60)
    _ask(st, "w1", HOT_PROMPT)
    assert _wait(lambda: _ready(st, ["w1"]), 60)
    comp.stop()
    th.join(timeout=30)
    assert comp.stats.aborts == 0 and comp.prefix_cache.stats.hits >= 1
    assert comp._tier_store is not None and comp._tier_store.epoch >= 1
    comp._tier_store.close()
    return st.get("w1").rstrip(b"\0")


@pytest.fixture
def tier(cstore):
    pname = f"/spt-tdtier-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    TierPersist.unlink(pname)
    yield cstore, pname
    TierPersist.unlink(pname)


@pytest.mark.slow
def test_supervised_mid_spill_crash_strands_nothing(tier, files, device,
                                                    monkeypatch):
    st, pname = tier
    _ask(st, "c1", HOT_PROMPT)
    _ask(st, "c2", HOT_PROMPT)
    _run_tier_drill(st, files, device, pname, "tier.spill:crash@1",
                    ["c1", "c2"], monkeypatch)


@pytest.mark.slow
def test_supervised_mid_readmit_crash_strands_nothing(tier, files, device,
                                                      monkeypatch):
    st, pname = tier
    warm = _seed_warm_generation(st, files, device, pname)
    _ask(st, "c1", HOT_PROMPT)
    _run_tier_drill(st, files, device, pname, "tier.readmit:crash@1",
                    ["c1"], monkeypatch)
    assert st.get("c1").rstrip(b"\0") == warm


@pytest.mark.slow
def test_supervised_mid_restore_crash_attaches_warm(tier, files, device,
                                                    monkeypatch):
    st, pname = tier
    warm = _seed_warm_generation(st, files, device, pname)
    _ask(st, "r1", HOT_PROMPT)
    _run_tier_drill(st, files, device, pname, "tier.restore:crash@1",
                    ["r1"], monkeypatch)
    assert st.get("r1").rstrip(b"\0") == warm


# ------------------------------------------- the disaggregated lanes

def _no_handoff_keys(st):
    for idx in st.enumerate_indices(P.LBL_DEBUG):
        key = st.key_at(idx)
        if key is not None and key.startswith(P.HANDOFF_PREFIX):
            return False
    return True


@pytest.mark.slow
@pytest.mark.parametrize("fault,crashed", [
    ("prefill.handoff:crash@1", "prefill"),
    ("decode.adopt:crash@1", "decode"),
], ids=["prefill_handoff", "decode_adopt"])
def test_supervise_recovers_split_lane_crash(cstore, files, device, fault,
                                             crashed, monkeypatch):
    st = cstore
    _ask(st, "q", "hello disaggregated")
    split = _complete_args(files, device, "--batch-cap", "4",
                           "--page-size", str(PAGE))
    with _supervised(st, ("prefill", "decode"),
                     {"prefill": split, "decode": split}, fault,
                     monkeypatch, stop_after=240.0) as sup:
        assert _wait(lambda: _ready(st, ["q"]), 180), sup.lanes
        _lane_ok(sup, crashed)
        _ask(st, "q2", "again, disaggregated")
        assert _wait(lambda: _ready(st, ["q2"]), 120)
        _no_aborts(st, P.KEY_PREFILL_STATS)
        _no_aborts(st, P.KEY_DECODE_STATS)
    for key, prompt in (("q", b"hello disaggregated"),
                        ("q2", b"again, disaggregated")):
        assert st.get(key).rstrip(b"\0").startswith(prompt)
        assert not st.labels(key) & P.LBL_DECODE_READY
    assert _no_handoff_keys(st)


# ------------------------------------------- striped embedder replicas

def test_two_embedder_replicas_disjoint_and_byte_identical(cstore):
    """f32 on the CPU, in-process: R = 2 serves the request set of
    R = 1 with every request embedded exactly once, and every vector
    bit-equal to a single replica's."""
    cfg = tenc.EncoderConfig.tiny(dtype=torch.float32, out_dim=VEC_DIM)
    model = tenc.EmbeddingModel(cfg, seed=0, buckets=(16, 32, 64),
                                device="cpu")
    served = {0: [], 1: []}

    class Counting(Embedder):
        def run_once(self):
            n = super().run_once()
            served[self.replica].append(n)
            return n

    st = cstore
    P.write_stripe_map(st, "embedder", P.default_stripe_owners(2, 16))
    reps = [Counting(st, model=model, max_ctx=64, replica=r)
            for r in (0, 1)]
    for e in reps:
        e.attach()
    keys = [f"doc{i}" for i in range(24)]
    _request_embeds(st, keys)
    for _ in range(4):
        for e in reps:
            e.run_once()
    assert not st.enumerate_indices(P.LBL_EMBED_REQ)
    assert sum(served[0]) > 0 and sum(served[1]) > 0
    assert sum(served[0]) + sum(served[1]) == len(keys)
    name = f"/spt-tdone-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    one = Store.create(name, nslots=128, max_val=16384, vec_dim=VEC_DIM)
    try:
        single = Embedder(one, model=model, max_ctx=64)
        single.attach()
        _request_embeds(one, keys)
        assert single.run_once() == len(keys)
        for key in keys:
            assert np.array_equal(st.vec_get(key), one.vec_get(key)), key
    finally:
        one.close()
        Store.unlink(name)


@pytest.mark.slow
def test_supervised_embedder_scale_up_and_down(cstore, files, device,
                                               monkeypatch):
    """The embedder lane scaled to two replicas by a manual target and
    back to one: both replicas serve part of a burst, replica 1 drains
    and retires, nothing is stranded, and every vector equals a single
    in-process replica's on the file (bit-equal on the CPU)."""
    st = cstore
    with _supervised(st, ("embedder",),
                     {"embedder": _embed_args(files, device)},
                     "embedder.encode:crash@1", monkeypatch,
                     stop_after=240.0) as sup:
        assert _wait(lambda: P.heartbeat_live(st, P.KEY_EMBED_STATS), 120)
        P.write_scale_target(st, "embedder", 2, src="manual")

        def promoted():
            rec = P.read_stripe_map(st, "embedder")
            return rec is not None and "1" in rec["owners"] \
                and not rec.get("pending")

        assert _wait(promoted, 120), sup.replicas
        keys = [f"burst/{i}" for i in range(32)]
        _request_embeds(st, keys)
        assert _wait(lambda: not any(st.labels(k) & P.LBL_EMBED_REQ
                                     for k in keys), 120)

        def embedded(r):
            key = P.replica_stats_key(P.KEY_EMBED_STATS, r)
            return json.loads(st.get(key).rstrip(b"\0"))["embedded"]

        assert _wait(lambda: embedded(1) > 0 and
                     embedded(0) + embedded(1) >= len(keys), 30)
        P.write_scale_target(st, "embedder", 1, src="manual")
        assert _wait(lambda: sorted(sup.replicas["embedder"]) == [0], 60)
        assert sup.retired == 1 and sup.scale_events == 2
    want = _reference_vectors(files[0],
                              {k: _text(i) for i, k in enumerate(keys)},
                              VEC_DIM, device)
    for key, vec in want.items():
        assert not st.labels(key) & (P.LBL_EMBED_REQ | P.LBL_WAITING)
        if device == "cpu":
            assert np.array_equal(st.vec_get(key), vec), key
        else:
            assert float(st.vec_get(key) @ vec) >= 0.999, key
