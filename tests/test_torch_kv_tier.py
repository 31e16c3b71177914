"""The torch port's page wire and its host-DRAM KV tier, on the CPU.

The page wire (models/decoder.py: page_wire_bytes, export_row_pages,
export_page_bytes, import_page_bytes) against the JAX package's on
shared weights: the geometry and byte counts equal for bf16, f32, int8
and int4 pools, a prefilled page exported by both packages agreeing at
tests/test_torch_paged.py's bar for pools (f32 within 1e-5; codes equal
within one step where a rounding tie falls the other way, scales within
1e-5 relative), and export -> import byte round trips.

Then the port's counterparts of the JAX package's tier tests
(tests/test_kv_tier.py), engine/kv_tier.py being a verbatim copy: LRU
and capacity, write-through -> demote -> readmit with a decode over the
readmitted pages equal to a cold prefill's (greedy, within the port), a
stranded host chain pruned, tier on vs off byte-identical on the
continuous lane, the warm restart, every torn-snapshot class giving the
JAX package's typed reason (float and int4-packed pools), the geometry
mismatch, a raising restore falling back cold, and the reason reaching
the heartbeat.  The supervised crash drills (mid-spill, mid-readmit,
mid-restore) run the completer's entry point under the port's supervisor
in tests/test_torch_supervised_drills.py."""
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
from libsplinter_tpu_torch.engine.kv_tier import (INDEX_KEY, HostTier,
                                                  TierPersist, _entry_key,
                                                  _page_key, tier_geometry)
from libsplinter_tpu_torch.engine.prefix_cache import PrefixCache
from libsplinter_tpu_torch.models import decoder as tdec
from libsplinter_tpu_torch.utils import faults

PAGE = 8
# 23 bytes + BOS = 24 tokens = 3 exact pages: a repeat is a full cover
HOT_PROMPT = "abcdefghijklmnopqrstuvw"
# 24 tokens = 3 exact pages at PAGE = 8
PROMPT24 = (np.arange(1, 25, dtype=np.int32) % 200) + 1


@pytest.fixture(scope="module")
def model():
    return tdec.CompletionModel(tdec.DecoderConfig.tiny(dtype=torch.float32),
                                buckets=(32, 64), temp=0.0, seed=1,
                                suffix_buckets=(8, 16), device="cpu")


def _mkstore(tag, **kw):
    name = f"/spt-tt-{tag}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    kw.setdefault("nslots", 128)
    kw.setdefault("max_val", 4096)
    kw.setdefault("vec_dim", 8)
    return name, Store.create(name, **kw)


def _pname(tag):
    name = f"/spt-ttp-{tag}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    TierPersist.unlink(name)
    return name


def _attach_pc(cache):
    pc = PrefixCache(cache.page)
    pc.attach(cache)
    cache.prefix_cache = pc
    return pc


def _check_invariants(cache, pc):
    """Page accounting: refcounts equal the table references, no page is
    both free and tree-retained, none leaks, and the evictable counter
    matches a recount."""
    refs = np.zeros(cache.n_blocks, np.int64)
    for owned in cache._owned:
        for bid in owned:
            refs[bid] += 1
    assert np.array_equal(refs[1:], cache.refcounts[1:])
    free = set(cache._free)
    assert len(free) == len(cache._free), "free list duplicate"
    tree = {bid for bid in range(1, cache.n_blocks) if pc.retains(bid)}
    assert not free & tree, "page both free and tree-retained"
    for bid in range(1, cache.n_blocks):
        if refs[bid] > 0:
            assert bid not in free, f"page {bid} live AND free"
        else:
            assert bid in free or bid in tree, f"page {bid} leaked"
    assert pc.evictable_count() == sum(
        1 for bid in tree if cache.refcounts[bid] == 0)


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


def _bind(model, cache, pc, capacity=32):
    tier = HostTier(capacity)
    pc.bind_tier(
        tier,
        export_page=lambda bid: model.export_page_bytes(cache, bid),
        import_page=lambda bid, buf, sbuf: model.import_page_bytes(
            cache, bid, buf, sbuf))
    return tier


def _target(model, kvd=None):
    cache = model.init_paged(4, page=PAGE, kv_dtype=kvd)
    pc = _attach_pc(cache)
    return cache, pc, _bind(model, cache, pc)


def _seed_snapshot(model, pname, kvd=None):
    """One 3-page chain, write-through shadowed and checkpointed into a
    fresh persistent segment: the donor the torn-snapshot tests mangle
    (the completer's own capacity and window, so a lane keeps it)."""
    cache, pc, tier = _target(model, kvd)
    model.paged_prefill_row(cache, PROMPT24, 0)
    assert pc.insert(PROMPT24, cache, 0, tenant=3) == 3
    geom = tier_geometry(model, cache)
    persist = TierPersist(pname, capacity_pages=32,
                          max_len=model.cfg.max_len,
                          page_bytes=geom["page_bytes"])
    assert persist.save(pc, tier, geom)
    return persist, geom


def _run(comp, stop_after=60.0):
    th = threading.Thread(target=comp.run_continuous,
                          kwargs=dict(idle_timeout_ms=20,
                                      stop_after=stop_after), daemon=True)
    th.start()
    return th


# -- the page wire against the JAX package ----------------------------------

# the pool storages, under an f32 model: a bf16 pool holds the f32
# values rounded once, so both packages' pages compare element by element
KV_KINDS = ("bf16", "f32", "int8", "int4")


@pytest.fixture(scope="module")
def pair():
    """The JAX and the torch CompletionModel (f32) on the same random
    weights (tests/test_torch_paged.py's bridge)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    jdec = pytest.importorskip("libsplinter_tpu.models.decoder")
    cfg_j = jdec.DecoderConfig.tiny(dtype=jnp.float32)
    cfg_t = tdec.DecoderConfig.tiny(dtype=torch.float32)
    seed = 0
    params = jdec.Decoder(cfg_j).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
        jdec.init_cache(cfg_j, 1), jnp.int32(0))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(scale=0.05, size=x.shape).astype(np.float32), params)
    common = dict(buckets=(16, 32), temp=0.0, suffix_buckets=(8,))
    jm = jdec.CompletionModel(cfg_j, params=params, **common)
    tm = tdec.CompletionModel(cfg_t, params=tdec.params_from_jax(params,
                                                                 cfg_t),
                              device="cpu", **common)
    return jm, tm


@pytest.mark.parametrize("kind", KV_KINDS)
def test_wire_geometry_equals_the_jax_models(pair, kind):
    """page_wire_bytes, the wire dtype's name and tier_geometry equal the
    JAX model's for every pool storage (the tier's snapshots and the
    disaggregated handoff both key on them)."""
    from libsplinter_tpu.engine import kv_tier as jtier
    jm, tm = pair
    jc = jm.init_paged(2, page=PAGE, kv_dtype=kind)
    tc = tm.init_paged(2, page=PAGE, kv_dtype=kind)
    assert str(tm._page_wire_dtype(tc)) == str(jm._page_wire_dtype(jc))
    assert tm._page_wire_shape(tc) == jm._page_wire_shape(jc)
    assert tm.page_wire_bytes(tc) == jm.page_wire_bytes(jc)
    assert tier_geometry(tm, tc) == jtier.tier_geometry(jm, jc)
    want = {"bf16": "bfloat16", "f32": "float32", "int8": "int8",
            "int4": "uint8"}[kind]
    assert tier_geometry(tm, tc)["wire_dtype"] == want


def _wire_arrays(buf, sbuf, dtype, shape):
    """A wire page's k and v stacks (and scales) as f32 numpy; bf16 from
    its raw two bytes (numpy has no bfloat16)."""
    raw = np.frombuffer(buf, np.uint8).copy()
    if dtype == "bfloat16":
        vals = torch.from_numpy(raw).view(torch.bfloat16).float().numpy()
    else:
        vals = raw.view(dtype).astype(np.float32)
    vals = vals.reshape(2, *shape)
    scales = None if sbuf is None else np.frombuffer(
        sbuf, np.float32).reshape(2, shape[0], shape[1])
    return vals, scales


@pytest.mark.parametrize("kind", KV_KINDS)
def test_prefilled_page_exports_agree_with_jax(pair, kind):
    """The same prompt prefilled by both packages exports pages that
    agree at the pools' bar: f32 within 1e-5, bf16 within one bf16 step
    (2^-7 relative: a value near a rounding tie may round either way),
    quantized codes within one step with >= 99.9% equal and scales
    within 1e-5 relative."""
    jm, tm = pair
    jc = jm.init_paged(2, page=PAGE, kv_dtype=kind)
    tc = tm.init_paged(2, page=PAGE, kv_dtype=kind)
    prompt = np.random.default_rng(3).integers(3, 1024, 21).astype(np.int32)
    jm.paged_prefill_row(jc, prompt, 1)
    tm.paged_prefill_row(tc, prompt, 1)
    jp, js = jm.export_row_pages(jc, 1)
    tp, ts = tm.export_row_pages(tc, 1)
    assert len(tp) == len(jp) == 3
    dt = str(tm._page_wire_dtype(tc))
    shape = tm._page_wire_shape(tc)
    for p in range(3):
        assert len(tp[p]) == len(jp[p]) == tm.page_wire_bytes(tc)
        # the partial last page is exported whole; compare live slots
        live = min(PAGE, len(prompt) - p * PAGE)
        a, sa = _wire_arrays(jp[p], js[p], dt, shape)
        b, sb = _wire_arrays(tp[p], ts[p], dt, shape)
        a, b = a[..., :live, :], b[..., :live, :]
        if tc.quantized:
            assert (np.abs(a - b) <= 1).all() and (a == b).mean() > 0.999
            np.testing.assert_allclose(sb, sa, rtol=1e-5, atol=1e-7)
        elif kind == "f32":
            assert sa is None and sb is None
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
        else:
            assert sa is None and sb is None
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=2 ** -7)


@pytest.mark.parametrize("kind", KV_KINDS)
def test_export_import_round_trip_is_byte_exact(model, kind):
    """A page exported, imported into another block and exported again
    gives the same bytes; the import lands in every layer and side."""
    m = model
    cache = m.init_paged(3, page=PAGE, kv_dtype=kind)
    m.paged_prefill_row(cache, PROMPT24, 0)
    src = int(cache.tables[0, 1])
    buf, sbuf = m.export_page_bytes(cache, src)
    assert len(buf) == m.page_wire_bytes(cache)
    assert (sbuf is None) != cache.quantized
    dst = cache._alloc_page()
    m.import_page_bytes(cache, dst, buf, sbuf)
    assert m.export_page_bytes(cache, dst) == (buf, sbuf)
    for li in range(m.cfg.layers):
        assert torch.equal(cache.k_pools[li][dst], cache.k_pools[li][src])
        assert torch.equal(cache.v_pools[li][dst], cache.v_pools[li][src])
    pages, scales = m.export_row_pages(cache, 0)
    assert pages[1] == buf and scales[1] == sbuf
    assert m.paged_adopt_row(cache, 2, len(PROMPT24), pages, scales)
    assert m.export_row_pages(cache, 2) == (pages, scales)
    assert int(cache.lengths[2]) == len(PROMPT24)


def test_wire_size_errors_are_the_jax_packages(model):
    """Wrong sizes raise the JAX model's ValueError messages, and an
    adoption the pool cannot hold returns False with nothing allocated."""
    cache = model.init_paged(2, page=PAGE)
    want = model.page_wire_bytes(cache)
    with pytest.raises(ValueError, match=f"tier page holds 3 bytes, "
                                         f"expected {want}"):
        model.import_page_bytes(cache, 1, b"abc")
    with pytest.raises(ValueError, match="carries 1 pages, 3 needed"):
        model.paged_adopt_row(cache, 0, 24, [bytes(want)])
    with pytest.raises(ValueError, match="wire page 1 holds 5 bytes"):
        model.paged_adopt_row(cache, 0, 24, [bytes(want), b"12345",
                                             bytes(want)])
    q = model.init_paged(2, page=PAGE, kv_dtype="int8")
    sn = 2 * model.cfg.layers * model.cfg.kv_heads * 4
    with pytest.raises(ValueError, match=f"tier scales hold 0 bytes, "
                                         f"expected {sn}"):
        model.import_page_bytes(q, 1, bytes(model.page_wire_bytes(q)))
    small = model.init_paged(2, page=PAGE, pool_pages=16)
    assert small.ensure(1, 15 * PAGE)           # one page left
    assert not model.paged_adopt_row(small, 0, 24, [bytes(want)] * 3)
    assert small.free_pages == 1 and not small._owned[0]


# -- the host tier ---------------------------------------------------------

def test_host_tier_lru_capacity_and_dirty():
    t = HostTier(2)
    assert len(t) == 0 and not t.dirty
    assert t.put("a", b"AA", None) == []
    assert t.put("b", b"BB", b"s") == []
    assert t.dirty and t.bytes_held() == 5
    t.dirty = False
    assert t.has("a") and t.peek("a") == (b"AA", None)
    assert not t.dirty
    assert t.get("a") == (b"AA", None)       # LRU touch: "a" newest
    assert t.put("c", b"CC", None) == ["b"]  # so "b" is the victim
    assert t.capacity_drops == 1 and t.dirty
    t.drop("b")
    t.drop("a")
    assert not t.has("a") and len(t) == 1
    t.clear()
    assert len(t) == 0 and t.bytes_held() == 0


def _cold_tokens(model, kvd=None):
    cache = model.init_paged(4, page=PAGE, kv_dtype=kvd)
    lb = model.paged_prefill_row(cache, PROMPT24, 0)
    tb = np.full((4,), -1, np.int32)
    tb[0] = int(np.argmax(lb))
    out = model.paged_decode_chunk(cache, tb, 7)
    return [int(tb[0])] + [int(x) for x in out[0][:6]]


@pytest.mark.parametrize("kvd", [None, "int4"])
def test_write_through_demote_readmit_decodes_as_cold(model, kvd):
    """Insert takes the host shadow at once (write-through), eviction
    DEMOTES (the node stays, the page returns to the pool), a later hit
    readmits — and greedy decode over the readmitted pages equals a
    cold prefill's (int4: the packed bytes verbatim).  Page accounting
    holds at every step."""
    cache, pc, tier = _target(model, kvd)
    model.paged_prefill_row(cache, PROMPT24, 0)
    assert pc.insert(PROMPT24, cache, 0, tenant=1) == 3
    assert tier.spills == 3 and len(tier) == 3
    _check_invariants(cache, pc)
    cache.free_row(0)
    free_before = len(cache._free)
    assert pc.reclaim(3) == 3
    assert tier.demotions == 3 and pc.demoted_pages() == 3
    assert pc.shared_pages() == 0
    assert len(cache._free) == free_before + 3
    _check_invariants(cache, pc)
    bids, match, nodes = pc.lookup_tiered(PROMPT24)
    assert bids == [] and match == 0 and len(nodes) == 3
    got = pc.readmit(nodes, cache)
    assert len(got) == 3 and tier.readmits == 3
    assert pc.demoted_pages() == 0
    for b in got:
        cache._decref(b)
    _check_invariants(cache, pc)
    cache.map_shared(1, got)
    cache.lengths[1] = len(PROMPT24) - 1
    assert cache.ensure(1, 32)
    _check_invariants(cache, pc)
    toks = np.full((4,), -1, np.int32)
    toks[1] = int(PROMPT24[-1])              # the replay token
    out = model.paged_decode_chunk(cache, toks, 7)
    assert [int(x) for x in out[1]] == _cold_tokens(model, kvd)


def test_capacity_drop_prunes_stranded_dram_chain(model):
    """Host-tier LRU overflow: dropping a DRAM-resident node's shadow
    makes it unservable, so the cache prunes it and its subtree; the
    root's second-chance spill is counted."""
    cache, pc, _ = _target(model)
    tier = _bind(model, cache, pc, capacity=2)
    model.paged_prefill_row(cache, PROMPT24, 0)
    assert pc.insert(PROMPT24, cache, 0) == 3
    assert tier.spills == 3 and tier.capacity_drops == 1
    assert len(tier) == 2
    cache.free_row(0)
    assert pc.reclaim(3) == 3
    assert tier.spills == 4 and tier.capacity_drops == 2
    assert len(tier) == 1 and pc.demoted_pages() == 1
    _check_invariants(cache, pc)
    bids, match, nodes = pc.lookup_tiered(PROMPT24)
    assert bids == [] and match == 0 and len(nodes) == 1


# -- the continuous lane ------------------------------------------------------

def test_continuous_byte_identical_tier_on_vs_off(model):
    """Greedy bytes equal with the tier on and off: the tier is capacity
    machinery, never allowed to change served bytes."""
    outs = {}
    for tag, pages in (("off", 0), ("on", 32)):
        name, st = _mkstore(f"tier-{tag}")
        try:
            comp = Completer(st, model=model, max_new_tokens=24,
                             flush_tokens=2, template="none", batch_cap=4,
                             page_size=PAGE, kv_tier_pages=pages)
            comp.attach()
            _submit(st, "donor", HOT_PROMPT)
            th = _run(comp)
            assert _await_ready(st, ["donor"])
            _submit(st, "joiner", HOT_PROMPT)
            assert _await_ready(st, ["joiner"])
            comp.stop()
            th.join(timeout=15)
            outs[tag] = (st.get("donor").rstrip(b"\0"),
                         st.get("joiner").rstrip(b"\0"))
            if pages:
                assert comp.kv_tier is not None
                assert comp.kv_tier.spills >= 3
        finally:
            st.close()
            Store.unlink(name)
    assert outs["on"] == outs["off"]
    assert outs["on"][0] == outs["on"][1]


def test_lane_readmits_demoted_pages_with_the_same_bytes(model):
    """A pool too small to keep a finished prompt's pages: the next
    request's admission reclaims them (demoting to host RAM), and the
    prompt's repeat readmits them — tier_readmits > 0 in the heartbeat,
    and its completion byte-identical to the first."""
    name, st = _mkstore("tier-readmit")
    try:
        comp = Completer(st, model=model, max_new_tokens=8,
                         flush_tokens=4, template="none", batch_cap=2,
                         page_size=PAGE, pool_pages=16, kv_tier_pages=64)
        comp.attach()
        th = _run(comp)
        outs = {}
        for key, text in (("a", HOT_PROMPT), ("b", "z" * 90),
                          ("c", "y" * 90), ("a2", HOT_PROMPT)):
            _submit(st, key, text)
            assert _await_ready(st, [key])
            outs[key] = st.get(key).rstrip(b"\0")
        comp.publish_stats()
        snap = json.loads(st.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
        comp.stop()
        th.join(timeout=15)
        assert snap["tier_demotions"] >= 3 and snap["tier_readmits"] >= 3
        assert snap["prefix_hits"] >= 1
        assert outs["a2"] == outs["a"]
        assert comp._paged_cache.used_pages == 0
    finally:
        st.close()
        Store.unlink(name)


def test_warm_restart_restores_and_readmits(model):
    """Two lane generations over one persistent segment: generation 1
    boots cold (typed missing_record), spills write-through and its
    retirement checkpoints the warm set; generation 2 attaches WARM and
    serves the same prompt by readmission, every tier_* gauge in the
    heartbeat, the greedy bytes identical across the restart."""
    name, st = _mkstore("tier-warm", nslots=256)
    pname = _pname("warm")
    try:
        outs, snaps = {}, {}
        for gen in (1, 2):
            comp = Completer(st, model=model, max_new_tokens=8,
                             flush_tokens=4, template="none", batch_cap=4,
                             page_size=PAGE, kv_tier_pages=32,
                             kv_tier_persist=pname)
            comp.attach()
            key = f"g{gen}"
            _submit(st, key, HOT_PROMPT)
            th = _run(comp)
            assert _await_ready(st, [key])
            comp.publish_stats()
            snaps[gen] = json.loads(
                st.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
            comp.stop()
            th.join(timeout=15)
            if comp._tier_store is not None:
                comp._tier_store.close()
            outs[gen] = st.get(key).rstrip(b"\0")
        assert snaps[1]["tier_restored"] == 0
        assert snaps[1]["tier_restore_reason"] == "missing_record"
        assert snaps[1]["tier_spills"] >= 3
        assert snaps[2]["tier_restored"] >= 3
        assert snaps[2]["tier_readmits"] >= 3
        assert snaps[2]["prefix_hits"] >= 1
        assert "tier_restore_reason" not in snaps[2]
        assert snaps[2]["tier_snapshot_epoch"] >= 1
        for field in ("tier_pages", "tier_mb", "tier_demoted",
                      "tier_demotions", "tier_spill_failures",
                      "tier_readmit_failures", "tier_capacity_drops"):
            assert field in snaps[2]
        assert outs[1] == outs[2]
    finally:
        st.close()
        Store.unlink(name)
        TierPersist.unlink(pname)


# -- torn snapshots -----------------------------------------------------------

def _mangle_missing_record(st, epoch):
    st.unset(INDEX_KEY)


def _mangle_torn_header(st, epoch):
    st.set(INDEX_KEY, '{"v": 1, "epoch": ')


def _mangle_mid_page(st, epoch):
    buf = bytes(st.get(_page_key(epoch, 1)))
    st.set(_page_key(epoch, 1), buf[:len(buf) // 2])


def _mangle_missing_trailer(st, epoch):
    st.unset(_entry_key(epoch, 2))


MANGLES = [(_mangle_missing_record, "missing_record"),
           (_mangle_torn_header, "torn_header"),
           (_mangle_mid_page, "torn_page"),
           (_mangle_missing_trailer, "torn_page")]
MANGLE_IDS = ["missing-record", "torn-header", "mid-page",
              "missing-trailer"]


@pytest.mark.parametrize("kvd", [None, "int4"], ids=["float", "int4"])
@pytest.mark.parametrize("mangle,reason", MANGLES, ids=MANGLE_IDS)
def test_torn_snapshot_discarded_cold(model, mangle, reason, kvd):
    """Every byte-boundary class of a torn snapshot is detected, typed
    as the JAX package types it, and DISCARDED: nothing adopted, tree
    and tier empty (packed pages shift every boundary too)."""
    pname = _pname("torn")
    persist, geom = _seed_snapshot(model, pname, kvd)
    try:
        mangle(persist.store, persist.epoch)
        cache2, pc2, tier2 = _target(model, kvd)
        assert persist.load(pc2, tier2, geom) == (0, reason)
        assert pc2.demoted_pages() == 0 and len(tier2) == 0
        assert not pc2._children
        _check_invariants(cache2, pc2)
    finally:
        persist.close()
        TierPersist.unlink(pname)


def test_torn_reasons_equal_the_jax_packages(model):
    """The JAX package's TierPersist, loading the same mangled segments
    under the same geometry, gives the same typed reasons (the snapshot
    format is shared)."""
    jtier = pytest.importorskip("libsplinter_tpu.engine.kv_tier")
    for mangle, reason in MANGLES:
        pname = _pname("tornj")
        persist, geom = _seed_snapshot(model, pname)
        try:
            mangle(persist.store, persist.epoch)
            jp = jtier.TierPersist(pname, capacity_pages=32,
                                   max_len=model.cfg.max_len,
                                   page_bytes=geom["page_bytes"])
            got = jp.load(*_target(model)[1:], geom)
            jp.close()
            assert got == (0, reason) == persist.load(*_target(model)[1:],
                                                      geom)
        finally:
            persist.close()
            TierPersist.unlink(pname)


@pytest.mark.parametrize("kvd", [None, "int4"], ids=["float", "int4"])
def test_snapshot_geometry_mismatch_cold_then_warm(model, kvd):
    """A restored page is raw device bytes: any geometry drift refuses
    the whole snapshot, and the untouched snapshot still loads warm
    under the geometry it was taken with."""
    pname = _pname("geom")
    persist, geom = _seed_snapshot(model, pname, kvd)
    try:
        cache2, pc2, tier2 = _target(model, kvd)
        bad = dict(geom, page=PAGE * 2)
        assert persist.load(pc2, tier2, bad) == (0, "geometry_mismatch")
        assert pc2.demoted_pages() == 0 and len(tier2) == 0
        assert persist.load(pc2, tier2, geom) == (3, "")
        assert pc2.demoted_pages() == 3 and len(tier2) == 3
        assert tier2.restored == 3
        _check_invariants(cache2, pc2)
    finally:
        persist.close()
        TierPersist.unlink(pname)


def test_packed_snapshot_refuses_int8_geometry(model):
    """int8 and int4 snapshots are mutually unservable (wire dtype and
    page bytes differ): a typed geometry_mismatch, and the int4 snapshot
    still attaches warm under its own geometry."""
    pname = _pname("x48")
    persist, geom4 = _seed_snapshot(model, pname, "int4")
    try:
        c8, pc8, t8 = _target(model, "int8")
        geom8 = tier_geometry(model, c8)
        assert geom8 != geom4
        assert geom8["page_bytes"] == 2 * geom4["page_bytes"]
        assert persist.load(pc8, t8, geom8) == (0, "geometry_mismatch")
        assert pc8.demoted_pages() == 0 and len(t8) == 0
        cache2, pc2, tier2 = _target(model, "int4")
        assert persist.load(pc2, tier2, geom4) == (3, "")
        assert pc2.demoted_pages() == 3 and tier2.restored == 3
        _check_invariants(cache2, pc2)
    finally:
        persist.close()
        TierPersist.unlink(pname)


def test_restore_raise_falls_back_cold_typed(model):
    """The tier.restore fault site fires after validation, before
    adoption: a raise there gives a clean cold fallback (typed
    restore_failed) and leaves the snapshot for the next attach."""
    pname = _pname("raise")
    persist, geom = _seed_snapshot(model, pname)
    try:
        cache2, pc2, tier2 = _target(model)
        faults.arm("tier.restore:raise@1")
        try:
            assert persist.load(pc2, tier2, geom) == (0, "restore_failed")
        finally:
            faults.disarm()
        assert pc2.demoted_pages() == 0 and len(tier2) == 0
        assert not pc2._children
        assert persist.load(pc2, tier2, geom) == (3, "")
        assert pc2.demoted_pages() == 3
    finally:
        persist.close()
        TierPersist.unlink(pname)


def test_torn_snapshot_reason_reaches_heartbeat(model):
    """A lane that attached cold off a torn snapshot says why in its
    heartbeat (tier_restore_reason) and still serves, spilling fresh."""
    name, st = _mkstore("tier-torn-hb")
    pname = _pname("tornhb")
    persist, _ = _seed_snapshot(model, pname)
    _mangle_torn_header(persist.store, persist.epoch)
    persist.close()
    try:
        comp = Completer(st, model=model, max_new_tokens=4, flush_tokens=2,
                         template="none", batch_cap=4, page_size=PAGE,
                         kv_tier_pages=32, kv_tier_persist=pname)
        comp.attach()
        _submit(st, "t1", HOT_PROMPT)
        th = _run(comp, stop_after=30.0)
        assert _await_ready(st, ["t1"])
        comp.publish_stats()
        snap = json.loads(st.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
        comp.stop()
        th.join(timeout=15)
        if comp._tier_store is not None:
            comp._tier_store.close()
        assert snap["tier_restored"] == 0
        assert snap["tier_restore_reason"] == "torn_header"
        assert snap["tier_spills"] >= 3
    finally:
        st.close()
        Store.unlink(name)
        TierPersist.unlink(pname)


def test_main_serves_the_tier_on_the_cpu(monkeypatch):
    """`main --kv-tier-pages N --kv-tier-persist` (bare: <store>-kvtier)
    serves to READY on --device cpu with the tier bound and the
    snapshot segment named after the store."""
    from libsplinter_tpu_torch.engine import completer as tcomp
    name, st = _mkstore("tier-main")
    seen = {}
    orig = Completer.run_continuous

    def run_then_stop(self, **kw):
        th = threading.Thread(target=orig, args=(self,),
                              kwargs=dict(idle_timeout_ms=20,
                                          stop_after=300.0), daemon=True)
        th.start()
        seen["ready"] = _await_ready(st, ["q"], timeout=280)
        seen["tier"] = self.kv_tier
        seen["persist"] = self._tier_persist_name
        self.stop()
        th.join(timeout=60)
        if self._tier_store is not None:
            self._tier_store.close()

    monkeypatch.setattr(Completer, "run_continuous", run_then_stop)
    try:
        _submit(st, "q", "hello")
        assert tcomp.main(["--store", name, "--device", "cpu",
                           "--continuous", "--n-ctx", "128",
                           "--max-new-tokens", "4", "--batch-cap", "2",
                           "--kv-tier-pages", "16",
                           "--kv-tier-persist"]) == 0
        assert seen["ready"] and seen["tier"] is not None
        assert seen["persist"] == f"{name}-kvtier"
        assert st.get("q").startswith(b"hello")
    finally:
        st.close()
        Store.unlink(name)
        TierPersist.unlink(f"{name}-kvtier")
