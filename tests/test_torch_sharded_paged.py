"""The torch port's sharded continuous-batching lane, mirroring
tests/test_sharded_paged.py on the port: a tp = 2 ShardedCompletionModel
over two CPU shards against the port's own tp = 1 lanes on the same
weights, token-exact in f32.  (The JAX package's async paged chunk path
flakes on the CPU, ROADMAP Queue C, so the reference here is the port's
unsharded lane, itself held to the JAX package's dense lane elsewhere.)

The per-layer block pools are per-shard tensors of (n_blocks, KH/tp,
page, D) under one host-side page scheduler (models/decoder.PagedKVCache
over PagePools): placement, the meshless custom module's demotion,
token exactness against the single-shard paged lane and serial decode
(a mid-flight joiner and the K-deep async carry included), flat shape
counts after warmup, pool-exhaustion backpressure, int8 and int4 pools
at tp = 2, copy-on-write and the prefix cache through the daemon, the
heartbeat's tp and pages_shard with `spt metrics`' shard labels, and
the completer.sharded_dispatch fault contained."""
from __future__ import annotations

import contextlib
import io
import json
import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from libsplinter_tpu_torch import Store
from libsplinter_tpu_torch.engine import protocol as P
from libsplinter_tpu_torch.engine.completer import Completer
from libsplinter_tpu_torch.models.decoder import (CompletionModel,
                                                  DecoderConfig)
from libsplinter_tpu_torch.parallel import ShardedCompletionModel, make_mesh
from libsplinter_tpu_torch.utils import faults

CFG = DecoderConfig.tiny(dtype=torch.float32)      # heads=4, kv_heads=2


@pytest.fixture(scope="module")
def pair():
    """(single-shard model, tp = 2 model) over the SAME weights."""
    base = CompletionModel(CFG, buckets=(16, 32), temp=0.0, seed=1,
                           device="cpu")
    tp = ShardedCompletionModel(CFG, make_mesh(tp=2, device="cpu"),
                                params=base.module.state_dict(),
                                buckets=(16, 32), temp=0.0, seed=1)
    return base, tp


# ------------------------------------------------------- placement

@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"],
                         ids=["f32", "int8", "int4"])
def test_paged_supported_and_pools_sharded(pair, kv_dtype):
    """Each shard's pools hold every page at half the kv heads, each
    its own contiguous tensor (K5 takes contiguous pools), the scales of
    a quantized pool split with the heads they scale, and the pool's
    bytes are the single-shard pool's."""
    base, tp = pair
    assert tp.paged_supported is True
    cache = tp.init_paged(2, page=16, kv_dtype=kv_dtype)
    one = base.init_paged(2, page=16, kv_dtype=kv_dtype)
    assert len(cache.pools) == 2 and cache.head_shards == 2
    for pos, shard in enumerate(cache.pools):
        assert shard.head_pos == pos
        k = shard.k_pools[0]
        assert k.shape[:3] == (cache.n_blocks, 1, 16)
        assert k.shape[3] == one.k_pools[0].shape[3]
        assert k.is_contiguous() and k is not shard.k_pools[1]
        if kv_dtype is not None:
            assert shard.k_scales[0].shape == (cache.n_blocks, 1)
    assert cache.device_mb() == one.device_mb()


def test_meshless_custom_module_demotes_paged():
    """A module NOT built for the mesh runs whole on the mesh's first
    device with the paged lane off for that instance only; dense
    serving still works."""
    mesh = make_mesh(tp=2, device="cpu")
    base = CompletionModel(CFG, buckets=(16,), temp=0.0, seed=1,
                           device="cpu")
    tp = ShardedCompletionModel(CFG, mesh, module=base.module,
                                buckets=(16,), temp=0.0)
    assert tp.paged_supported is False
    assert ShardedCompletionModel.paged_supported is True
    prompt = np.array([3, 1, 4], np.int32)
    assert list(tp.generate_tokens(prompt, 5, chunk=4)) == \
        list(base.generate_tokens(prompt, 5, chunk=4))


# ------------------------------------------------- token exactness

def _paged_greedy(m, prompt, n, batch=2, page=16, kv_dtype=None):
    cache = m.init_paged(batch, page=page, kv_dtype=kv_dtype)
    lg = m.paged_prefill_row(cache, prompt, 0)
    t0 = int(np.argmax(lg))
    toks = np.zeros((batch,), np.int32)
    toks[0] = t0
    blk = m.paged_decode_chunk(cache, toks, n)
    out = [t0] + [int(x) for x in blk[0]]
    cache.reset()
    assert cache.used_pages == 0
    return out


def test_sharded_paged_token_exact_vs_single_vs_serial(pair):
    base, tp = pair
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    serial = list(base.generate_tokens(prompt, 9, chunk=8))
    base.reset()
    single = _paged_greedy(base, prompt, 8)
    sharded = _paged_greedy(tp, prompt, 8)
    assert single == sharded
    assert serial == sharded


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_pools_at_tp2(pair, kv_dtype):
    """int8 and int4 pools at tp = 2: each shard's appends grow its
    heads' scales exactly as the single pool's do (the rescale is per
    block and kv head), so greedy tokens equal the single-shard lane's
    over the same pool type, and the shards' scales are the single
    pool's, split by head."""
    base, tp = pair
    prompt = np.arange(2, 24, dtype=np.int32)       # two pages + decode
    assert _paged_greedy(tp, prompt, 12, kv_dtype=kv_dtype) == \
        _paged_greedy(base, prompt, 12, kv_dtype=kv_dtype)
    caches = []
    for m in (base, tp):
        cache = m.init_paged(2, page=16, kv_dtype=kv_dtype)
        m.paged_prefill_row(cache, prompt, 0)
        m.paged_decode_chunk(cache, np.array([1, 0]), 4)
        caches.append(cache)
    whole = caches[0].k_scales[1]
    split = torch.cat([p.k_scales[1] for p in caches[1].pools], dim=1)
    torch.testing.assert_close(split, whole, rtol=1e-5, atol=1e-7)


def test_midflight_joiner_token_exact(pair):
    base, tp = pair

    def run(m):
        cache = m.init_paged(2, page=16)
        lg = m.paged_prefill_row(cache,
                                 np.array([3, 1, 4, 1, 5], np.int32), 0)
        t0 = int(np.argmax(lg))
        blk = m.paged_decode_chunk(cache, np.array([t0, 0], np.int32), 4)
        lg2 = m.paged_prefill_row(cache, np.array([2, 7, 1], np.int32), 1)
        t1 = int(np.argmax(lg2))
        blk2 = m.paged_decode_chunk(
            cache, np.array([int(blk[0, -1]), t1], np.int32), 4)
        out = ([t0] + [int(x) for x in blk[0]] + [int(x) for x in blk2[0]],
               [t1] + [int(x) for x in blk2[1]])
        cache.reset()
        return out

    assert run(base) == run(tp)


def test_kdeep_async_carry_token_exact(pair):
    base, tp = pair

    def run(m):
        cache = m.init_paged(2, page=16)
        lg = m.paged_prefill_row(cache, np.array([5, 2, 9], np.int32), 0)
        toks = np.array([int(np.argmax(lg)), -1], np.int32)
        p1 = m.paged_decode_chunk_async(cache, toks, 4)
        p2 = m.paged_decode_chunk_async(
            cache, np.full((2,), -1, np.int32), 4, carry=p1.last)
        out = np.concatenate([p1.block(), p2.block()], axis=1)
        cache.reset()
        return out[0].tolist()

    assert run(base) == run(tp)


def test_warmup_pins_compile_count(pair):
    """A join/finish/join cycle after warmup_paged adds no new shape."""
    _, tp = pair
    cache = tp.init_paged(4, page=16)
    tp.warmup_paged(cache, chunk=4, max_prompt=30)
    c0 = tp.compile_count()
    lg = tp.paged_prefill_row(cache, np.ones((7,), np.int32), 0)
    tp.sample(lg)
    tp.paged_decode_chunk(cache, np.array([1, 0, 0, 0], np.int32), 4)
    cache.free_row(0)
    tp.paged_prefill_row(cache, np.ones((20,), np.int32), 1)
    tp.paged_decode_chunk(cache, np.array([0, 1, 0, 0], np.int32), 4)
    assert tp.compile_count() == c0
    cache.reset()


# ------------------------------------------------- pool pressure

def test_pool_exhaustion_backpressure_sharded(pair):
    _, tp = pair
    cache = tp.init_paged(2, page=16, pool_pages=8)
    assert cache.ensure(0, CFG.max_len)
    assert cache.free_pages == 0
    assert not cache.ensure(1, 16)               # nothing allocated
    assert cache.tables[1].max() == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        tp.paged_prefill_row(cache, np.ones((8,), np.int32), 1)
    cache.free_row(0)
    assert cache.free_pages == 8
    lg = tp.paged_prefill_row(cache, np.ones((8,), np.int32), 1)
    assert lg.shape[-1] == CFG.vocab_size
    cache.reset()


def test_cow_copies_every_shard(pair):
    """A shared page's copy-on-write copies the block in every shard's
    pool (one block id names the page everywhere)."""
    _, tp = pair
    cache = tp.init_paged(2, page=16)
    tp.paged_prefill_row(cache, np.arange(1, 21, dtype=np.int32), 0)
    src = int(cache.tables[0, 0])
    dst = cache._alloc_page()
    tp._cow_copy(cache, src, dst)
    for shard in cache.pools:
        for p in shard.tensors():
            assert torch.equal(p[dst], p[src])
    cache._decref(dst)
    cache.reset()


@pytest.mark.parametrize("kv_dtype", [None, "int4"], ids=["f32", "int4"])
def test_tier_page_round_trip_touches_every_shard(pair, kv_dtype):
    """The KV tier's demotion copy and readmission (export_page_bytes /
    import_page_bytes): a page exported from a tp = 2 pool is the tp = 1
    page's size, and importing it into another block fills that block
    in every shard's pool (values and scales) exactly."""
    base, tp = pair
    cache = tp.init_paged(2, page=16, kv_dtype=kv_dtype)
    tp.paged_prefill_row(cache, np.arange(1, 21, dtype=np.int32), 0)
    src = int(cache.tables[0, 0])
    buf, sbuf = tp.export_page_bytes(cache, src)
    assert len(buf) == base.page_wire_bytes(base.init_paged(
        2, page=16, kv_dtype=kv_dtype))
    dst = cache._alloc_page()
    tp.import_page_bytes(cache, dst, buf, sbuf)
    for shard in cache.pools:
        for p in shard.tensors():
            assert torch.equal(p[dst], p[src])
    cache._decref(dst)
    cache.reset()


# ------------------------------------------- the continuous lane

def _submit(st, key, prompt):
    st.set(key, prompt)
    st.label_or(key, P.LBL_INFER_REQ)
    st.bump(key)


def _await_ready(st, keys, timeout=90):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(st.labels(k) & P.LBL_READY for k in keys):
            return True
        time.sleep(0.02)
    return False


def _run_bg(comp, stop_after=120.0):
    th = threading.Thread(
        target=comp.run_continuous,
        kwargs=dict(idle_timeout_ms=20, stop_after=stop_after), daemon=True)
    th.start()
    return th


def _store(tag):
    name = f"/spt-tshp-{tag}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    return name, Store.create(name, nslots=128, max_val=4096, vec_dim=8)


def test_continuous_sharded_byte_identical_vs_single(pair):
    """run_continuous through the sharded model equals the single-shard
    model byte for byte, with prompts sharing a two-page prefix (the
    prefix cache maps shared pages and copy-on-write runs on every
    shard) and a request joining mid-run."""
    base, tp = pair
    stem = "a shared system preamble of several words "
    out = {}
    for tag, model in (("single", base), ("sharded", tp)):
        name, st = _store(tag)
        try:
            comp = Completer(st, model=model, max_new_tokens=10,
                             flush_tokens=4, template="none", batch_cap=4,
                             page_size=16)
            comp.attach()
            for i in range(3):
                _submit(st, f"q/{i}", f"{stem}then say {i} things")
            th = _run_bg(comp)
            assert _await_ready(st, ["q/0"]), comp.stats
            _submit(st, "q/join", f"{stem}and a late one")
            keys = [f"q/{i}" for i in range(3)] + ["q/join"]
            assert _await_ready(st, keys), comp.stats
            comp.stop()
            th.join(timeout=10)
            out[tag] = [st.get(k).rstrip(b"\0") for k in keys]
            assert comp.prefix_cache.stats.hits >= 1
        finally:
            st.close()
            Store.unlink(name)
    assert out["single"] == out["sharded"]


def test_heartbeat_and_metrics_shard_labels(pair):
    """The sharded completer's heartbeat carries tp and per-shard pool
    occupancy measured from the shards' tensors, and `spt metrics`
    renders the pages gauges with a shard label."""
    _, tp = pair
    name, st = _store("hb")
    try:
        comp = Completer(st, model=tp, max_new_tokens=8, flush_tokens=4,
                         template="none", batch_cap=2, page_size=16)
        comp.attach()
        comp._ensure_paged_cache()
        comp.publish_stats()
        snap = json.loads(st.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
        assert snap["tp"] == 2
        assert set(snap["pages_shard"]) == {"0", "1"}
        cache = comp._paged_cache
        half = round(cache.device_mb() / 2, 3)
        for occ in snap["pages_shard"].values():
            assert occ["used"] == 0
            assert occ["free"] == cache.free_pages
            assert occ["shard_mb"] == pytest.approx(half, rel=0.01)

        from libsplinter_tpu_torch.cli.main import COMMANDS, Session
        ses = Session(name)
        try:
            fn, _, _ = COMMANDS["metrics"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                fn(ses, [])
            text = buf.getvalue()
            assert "sptpu_completer_tp 2" in text
            assert 'sptpu_completer_pages_free{daemon="completer",' \
                   'shard="0"}' in text
            assert 'shard="1"' in text
        finally:
            ses.close()
    finally:
        st.close()
        Store.unlink(name)


def test_sharded_dispatch_fault_contained(pair):
    """A raise at completer.sharded_dispatch aborts the live batch (rows
    finalize with what they streamed, the pool is rebuilt) and the lane
    keeps serving: the next request completes normally."""
    _, tp = pair
    name, st = _store("fault")
    try:
        faults.arm("completer.sharded_dispatch:raise@1")
        comp = Completer(st, model=tp, max_new_tokens=8, flush_tokens=4,
                         template="none", batch_cap=2, page_size=16)
        comp.attach()
        _submit(st, "first", b"hello pod")
        th = _run_bg(comp)
        assert _await_ready(st, ["first"], timeout=60), comp.stats
        assert faults.stats()["completer.sharded_dispatch"]["fired"] == 1
        _submit(st, "second", b"still alive?")
        assert _await_ready(st, ["second"], timeout=60), comp.stats
        comp.stop()
        th.join(timeout=10)
        assert comp._paged_cache.used_pages == 0, "pages leaked"
        assert len(st.get("second").rstrip(b"\0")) > len(b"still alive?")
    finally:
        faults.disarm()
        st.close()
        Store.unlink(name)
