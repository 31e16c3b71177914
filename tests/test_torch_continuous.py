"""The torch port's continuous completion lane (Completer.run_continuous
over PagedKVCache + K5's plain version) on real stores, on the CPU, the
lane running in a thread as the JAX package's tests run it: staggered
arrivals and a mid-flight joiner, pool backpressure and recovery, zero
leaked pages after stop, prefix-cache hits with their heartbeat gauges,
a model failure caught and counted, int8/int4 pools, the compile count
after warmup_paged, and `main --continuous`.

Greedy (temp 0) outcomes are compared within the port — paged lane
against the port's dense lane and against itself with the prefix cache
off; the f32 tiny model's logits agree to ~1e-6 across those paths
(tests/test_torch_paged.py holds them to the JAX package)."""
import json
import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from libsplinter_tpu_torch import Store
from libsplinter_tpu_torch.engine import completer as tcomp
from libsplinter_tpu_torch.engine import protocol as P
from libsplinter_tpu_torch.engine.completer import Completer
from libsplinter_tpu_torch.models import CompletionModel, DecoderConfig

PAGE = 8
# 23 bytes + BOS = 24 tokens = 3 exact pages: a repeat is a full cover
HOT_PROMPT = "abcdefghijklmnopqrstuvw"


@pytest.fixture
def stores():
    made = []

    def make(max_val=4096):
        name = f"/spt-tq-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        st = Store.create(name, nslots=128, max_val=max_val, vec_dim=0)
        made.append((st, name))
        return st

    yield make
    for st, name in made:
        st.close()
        Store.unlink(name)


@pytest.fixture(scope="module")
def model():
    return CompletionModel(DecoderConfig.tiny(dtype=torch.float32),
                           buckets=(32, 64), temp=0.0, seed=1,
                           suffix_buckets=(8, 16), device="cpu")


def _submit(st, key, prompt):
    st.set(key, prompt)
    st.label_or(key, P.LBL_INFER_REQ)
    st.bump(key)


def _await_ready(st, keys, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(st.labels(k) & P.LBL_READY for k in keys):
            return True
        time.sleep(0.02)
    return False


def _run_bg(comp, stop_after=60.0):
    th = threading.Thread(target=comp.run_continuous,
                          kwargs=dict(idle_timeout_ms=20,
                                      stop_after=stop_after),
                          daemon=True)
    th.start()
    return th


def _stop(comp, th):
    comp.stop()
    th.join(timeout=30)
    assert not th.is_alive()


def _lane(st, model, **kw):
    kw.setdefault("max_new_tokens", 12)
    kw.setdefault("flush_tokens", 4)
    comp = Completer(st, model=model, template="none", batch_cap=4,
                     page_size=PAGE, **kw)
    comp.attach()
    return comp


def _check_pool_empty(comp):
    cache = comp._paged_cache
    assert cache.used_pages == 0, "pages leaked"
    assert sorted(cache._free) == list(range(1, cache.n_blocks))
    assert (cache.refcounts == 0).all()
    if comp.prefix_cache is not None:
        assert comp.prefix_cache.shared_pages() == 0


def test_staggered_arrivals_and_midflight_joiner(stores, model):
    """Two requests, then three more while they decode (one longer than
    the dense lane's join budget would allow): every key gets the full
    label protocol, the same greedy bytes as the port's dense lane, and
    the pool is empty after stop."""
    prompts = {"w1/0": "first wave zero", "w1/1": "first wave one",
               "w2/0": "second " * 6, "w2/1": "second wave x",
               "w2/2": "y"}
    dense = stores()
    dcomp = Completer(dense, model=model, template="none", batch_cap=8,
                      max_new_tokens=12, flush_tokens=4)
    dcomp.attach()
    for key, text in prompts.items():
        _submit(dense, key, text)
    assert dcomp.run_once() == len(prompts)

    st = stores()
    comp = _lane(st, model)
    th = _run_bg(comp)
    try:
        for key in ("w1/0", "w1/1"):
            _submit(st, key, prompts[key])
        deadline = time.time() + 30
        while time.time() < deadline and \
                st.value_len("w1/0") <= len(prompts["w1/0"]):
            time.sleep(0.005)               # first wave is streaming
        for key in ("w2/0", "w2/1", "w2/2"):
            _submit(st, key, prompts[key])
        assert _await_ready(st, list(prompts)), comp.stats
    finally:
        _stop(comp, th)
    for key, text in prompts.items():
        labels = st.labels(key)
        assert labels & P.LBL_READY
        assert not labels & (P.LBL_INFER_REQ | P.LBL_SERVICING
                             | P.LBL_WAITING)
        got = st.get(key).rstrip(b"\0")
        assert got.startswith(text.encode()) and len(got) > len(text)
        assert got == dense.get(key).rstrip(b"\0"), key
    assert comp.stats.completions == len(prompts)
    assert comp.stats.aborts == 0
    assert comp.stats.inflight_peak >= 1
    _check_pool_empty(comp)


def test_pool_backpressure_and_recovery(stores):
    """A pool of one window admits one worst-case row, backpressures the
    second (it stays WAITING, untouched) and serves it when the first
    finishes; nothing leaks."""
    st = stores()
    model = CompletionModel(DecoderConfig.tiny(max_len=128,
                                               dtype=torch.float32),
                            buckets=(16, 32), temp=0.0, device="cpu")
    comp = Completer(st, model=model, max_new_tokens=100, flush_tokens=4,
                     template="none", batch_cap=2, page_size=16,
                     pool_pages=8)
    comp.attach()
    th = _run_bg(comp, stop_after=120.0)
    try:
        _submit(st, "first", b"aaaa bbbb cccc dddd")
        _submit(st, "second", b"eeee ffff gggg hhhh")
        assert _await_ready(st, ["first", "second"], timeout=100), \
            comp.stats
    finally:
        _stop(comp, th)
    assert comp.stats.completions == 2
    assert comp.stats.join_backpressure > 0, comp.stats
    _check_pool_empty(comp)


def test_churn_with_shared_prefixes_leaks_nothing(stores, model):
    """Twelve requests through four rows — distinct prompts, partial
    prefix hits of several suffix lengths and exact repeats — with a
    small pool that must reclaim cached pages: after stop every page is
    back on the free list and no refcount is left."""
    st = stores()
    comp = _lane(st, model, max_new_tokens=6, pool_pages=40)
    th = _run_bg(comp)
    keys = []
    try:
        for i in range(12):
            key = f"c/{i}"
            keys.append(key)
            text = (HOT_PROMPT + "!" * (i % 4) * 5 if i % 3
                    else f"distinct request number {i}")
            _submit(st, key, text)
            time.sleep(0.01)
        assert _await_ready(st, keys), comp.stats
        pc = comp.prefix_cache
        assert pc.stats.hits >= 4 and pc.stats.cow_copies >= 1
    finally:
        _stop(comp, th)
    assert comp.stats.completions == 12
    _check_pool_empty(comp)


def test_prefix_hits_and_heartbeat_gauges(stores, model):
    """Three tenant-tagged identical prompts: the first prefills, the
    others map its three pages (full cover: copy-on-write of the tail).
    The heartbeat, read while the lane is live, carries the pool and
    prefix gauges and the tenant's residency."""
    st = stores()
    comp = _lane(st, model, max_new_tokens=4, flush_tokens=2)
    th = _run_bg(comp, stop_after=30.0)
    keys = [f"h/{i}" for i in range(3)]
    try:
        for k in keys:
            st.set(k, HOT_PROMPT)
            P.stamp_tenant(st, k, 2)
            st.label_or(k, P.LBL_INFER_REQ)
            st.bump(k)
        assert _await_ready(st, keys)
        comp.publish_stats()
        snap = json.loads(st.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
    finally:
        _stop(comp, th)
    assert snap["prefix_hits"] >= 1 and snap["prefix_misses"] >= 1
    assert snap["prefix_shared_pages"] >= 3
    assert snap["prefix_bytes_saved"] > 0
    assert snap["prefix_cow_copies"] >= 1
    for field in ("prefix_evictions", "prefix_hit_tokens",
                  "prefix_evictable", "pages_free", "pages_used",
                  "live_tokens", "pages_used_peak", "join_backpressure",
                  "inflight_depth", "bp_memo"):
        assert field in snap, field
    assert snap["kv_dtype"] == "f32"
    assert snap["pool_mb"] == comp._paged_cache.device_mb() > 0
    assert snap["tenants"]["2"]["prefix_pages"] >= 3
    assert snap["tenants"]["2"]["prefix_hit_pages"] >= 3
    _check_pool_empty(comp)


def test_midflight_full_cover_joiner_matches_cache_off(stores, model):
    """A joiner with the donor's exact prompt arrives while the donor
    decodes: with the prefix cache it maps the donor's live pages and
    replays into a copy-on-write page; its bytes equal serving with the
    cache off, and the donor's."""
    outs = {}
    for enable in (False, True):
        st = stores()
        comp = _lane(st, model, max_new_tokens=16, flush_tokens=2,
                     prefix_cache=enable)
        th = _run_bg(comp)
        try:
            _submit(st, "donor", HOT_PROMPT)
            deadline = time.time() + 30
            while time.time() < deadline and \
                    st.value_len("donor") <= len(HOT_PROMPT):
                time.sleep(0.002)
            _submit(st, "joiner", HOT_PROMPT)
            assert _await_ready(st, ["donor", "joiner"])
        finally:
            _stop(comp, th)
        outs[enable] = (st.get("donor").rstrip(b"\0"),
                        st.get("joiner").rstrip(b"\0"))
        if enable:
            assert comp.prefix_cache.stats.hits >= 1
            assert comp.prefix_cache.stats.cow_copies >= 1
    assert outs[True] == outs[False]
    assert outs[True][0] == outs[True][1]


def test_model_failure_is_counted_and_the_lane_recovers(stores, model,
                                                        monkeypatch):
    """A decode dispatch that raises: abort_all finalizes the live row
    with what it streamed (READY, nothing left SERVICING), counts one
    abort, rebuilds the pool, and the next request is served in full."""
    st = stores()
    comp = _lane(st, model)
    orig = model.paged_decode_chunk_async
    calls = []

    def fail_first(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected decode failure")
        return orig(*args, **kwargs)

    monkeypatch.setattr(model, "paged_decode_chunk_async", fail_first)
    th = _run_bg(comp)
    try:
        _submit(st, "hit", "first request")
        assert _await_ready(st, ["hit"]), comp.stats
        assert comp.stats.aborts == 1
        _submit(st, "after", "second request")
        assert _await_ready(st, ["after"]), comp.stats
    finally:
        _stop(comp, th)
    for key in ("hit", "after"):
        assert not st.labels(key) & (P.LBL_INFER_REQ | P.LBL_SERVICING
                                     | P.LBL_WAITING)
    assert comp.stats.aborts == 1 and comp.stats.completions == 2
    assert len(calls) > 1
    _check_pool_empty(comp)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_pools_serve(stores, model, kv_dtype):
    """--kv-dtype int8 / int4: the lane serves distinct prompts and a
    prefix hit over quantized pages; the heartbeat reports the storage
    and a pool of about 1/4 (int8) or 1/8 (int4) of the f32 bytes."""
    st = stores()
    comp = _lane(st, model, kv_dtype=kv_dtype)
    th = _run_bg(comp)
    keys = ["a", "b", "c"]
    try:
        for key, text in zip(keys, (HOT_PROMPT, "hello there",
                                    HOT_PROMPT + " again")):
            _submit(st, key, text)
        assert _await_ready(st, keys), comp.stats
        comp.publish_stats()
        snap = json.loads(st.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
    finally:
        _stop(comp, th)
    assert snap["kv_dtype"] == kv_dtype and snap["completions"] == 3
    f32_mb = model.init_paged(4, page=PAGE, kv_dtype="f32").device_mb()
    want = 0.25 if kv_dtype == "int8" else 0.125
    assert abs(snap["pool_mb"] / f32_mb - want) < 0.05
    assert comp.prefix_cache.stats.hits >= 1
    _check_pool_empty(comp)


def test_compile_count_flat_after_warmup_paged(stores, model):
    """warmup_paged runs the lane's whole program set against the pool
    it serves with: joins at several prompt lengths, a suffix prefill,
    a full-cover copy-on-write and decode chunks at any occupancy add
    no new shape afterwards."""
    st = stores()
    comp = _lane(st, model)
    comp.warmup_paged()
    base = model.compile_count()
    assert base > 0
    th = _run_bg(comp)
    keys = []
    try:
        for i, text in enumerate((HOT_PROMPT, "short", HOT_PROMPT,
                                  HOT_PROMPT + "tail", "x" * 40)):
            keys.append(f"k/{i}")
            _submit(st, keys[-1], text)
        assert _await_ready(st, keys), comp.stats
    finally:
        _stop(comp, th)
    assert comp.prefix_cache.stats.hits >= 2
    assert model.compile_count() == base


def test_main_continuous_on_the_cpu(stores, monkeypatch):
    """`main --device cpu --continuous --warmup` builds the full-width
    decoder at a short window, warms the paged program set and serves
    through run_continuous (stopped here once the request is READY)."""
    st = stores()
    _submit(st, "q", "hello")
    ran = {}
    orig = Completer.run_continuous

    def run_then_stop(self, **kw):
        ran["kv_dtype"] = self.kv_dtype
        th = threading.Thread(target=orig, args=(self,),
                              kwargs=dict(idle_timeout_ms=20,
                                          stop_after=300.0), daemon=True)
        th.start()
        ran["ready"] = _await_ready(st, ["q"], timeout=280)
        ran["compiles"] = self._model.compile_count()
        self.stop()
        th.join(timeout=60)

    monkeypatch.setattr(Completer, "run_continuous", run_then_stop)
    assert tcomp.main(["--store", st.name, "--device", "cpu",
                       "--continuous", "--warmup", "--n-ctx", "128",
                       "--max-new-tokens", "4", "--batch-cap", "2",
                       "--kv-dtype", "int8"]) == 0
    assert ran["ready"] and ran["kv_dtype"] == "int8"
    assert st.get("q").startswith(b"hello")
    assert st.labels("q") & P.LBL_READY
