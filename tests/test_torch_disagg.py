"""The torch port's disaggregated prefill/decode lanes on the CPU:
engine/disagg.py (a verbatim copy of the JAX package's) over the port's
Completer hooks and CompletionModel page wire (paged_adopt_row,
export_row_pages).

The port's counterparts of the JAX package's tests/test_disagg.py: greedy
bytes through the split equal to the unified lane's (a mid-burst joiner
included, f32 and int4-packed wires, and the re-prefill fallback when the
store cannot hold a wire page), the phase-aware deadlines, adoption
backpressure, and the two lanes' reclaim staying on their own side of
the DECODE_READY flip.  Then one cross-package handoff: the JAX
package's PrefillLane hands rows to the port's DecodeLane over one
store, the adopted rows' first decode logits within 1e-4 of the port's
own prefill (f32), which shows the two wire formats are one.  The
tensor-parallel case waits for the multi-GPU item of ROADMAP.md's Queue
A; the supervised crash drills (prefill handoff, decode adopt) run both
lanes' entry points under the port's supervisor in
tests/test_torch_supervised_drills.py."""
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
from libsplinter_tpu_torch.engine.disagg import DecodeLane, PrefillLane
from libsplinter_tpu_torch.models import decoder as tdec

KW = dict(max_new_tokens=8, flush_tokens=4, template="none",
          batch_cap=4, page_size=8)
PROMPTS = ["say one thing", "list two colors ok", "count to three"]
JOINER = "and a late joiner arrives"


@pytest.fixture(scope="module")
def model():
    return tdec.CompletionModel(tdec.DecoderConfig.tiny(dtype=torch.float32),
                                buckets=(32,), temp=0.0, seed=1,
                                suffix_buckets=(8,), device="cpu")


def _mkstore(tag, max_val=16384):
    # max_val 16384 > page_wire_bytes(tiny f32, page 8) = 4096: the wire
    # is the default path; 4096 forces the re-prefill fallback instead
    name = f"/spt-td-{tag}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    return name, Store.create(name, nslots=128, max_val=max_val, vec_dim=8)


def _submit(st, key, prompt, deadline=None):
    st.set(key, prompt)
    if deadline is not None:
        P.stamp_deadline(st, key, deadline)
    st.label_or(key, P.LBL_INFER_REQ | P.LBL_WAITING)
    st.bump(key)


def _await(st, keys, bit=P.LBL_READY, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(st.labels(k) & bit for k in keys):
            return True
        time.sleep(0.02)
    return False


def _run_bg(daemon, stop_after=180.0):
    th = threading.Thread(target=daemon.run_continuous,
                          kwargs=dict(idle_timeout_ms=20,
                                      stop_after=stop_after), daemon=True)
    th.start()
    return th


def _no_handoff_keys(st):
    """No `__ho_` record/page/scale key outlives its request (the wire
    keys ride LBL_DEBUG)."""
    for idx in st.enumerate_indices(P.LBL_DEBUG):
        key = st.key_at(idx)
        if key is not None and key.startswith(P.HANDOFF_PREFIX):
            return False
    return True


def _serve(tag, daemons_fn, model, prompts, joiner=None, max_val=16384):
    """Serve `prompts` (plus a joiner submitted once the first is READY)
    and return ({key: bytes}, each daemon's _lane_stats)."""
    name, st = _mkstore(tag, max_val=max_val)
    daemons = daemons_fn(st, model)
    ths = []
    try:
        for d in daemons:
            d.attach()
        ths = [_run_bg(d) for d in daemons]
        keys = []
        for i, prompt in enumerate(prompts):
            keys.append(f"q/{i}")
            _submit(st, keys[-1], prompt)
        if joiner is not None:
            assert _await(st, keys[:1]), "first completion never READY"
            keys.append("q/join")
            _submit(st, "q/join", joiner)
        assert _await(st, keys), [(k, hex(st.labels(k))) for k in keys]
        out = {k: st.get(k).rstrip(b"\0") for k in keys}
        for d in daemons:
            d.stop()
        for th in ths:
            th.join(timeout=30)
        assert _no_handoff_keys(st)
        return out, [dict(getattr(d, "_lane_stats", {})) for d in daemons]
    finally:
        for d in daemons:
            d.stop()
        for th in ths:
            th.join(timeout=30)
        st.close()
        Store.unlink(name)


def _lanes(**extra):
    kw = dict(KW, **extra)

    def unified(st, m):
        return [Completer(st, model=m, **kw)]

    def split(st, m):
        return [PrefillLane(st, model=m, **kw), DecodeLane(st, model=m, **kw)]

    return unified, split


@pytest.mark.parametrize("kv_dtype", [None, "int4"], ids=["f32", "int4"])
def test_split_matches_unified_with_midburst_joiner(model, kv_dtype):
    """Greedy bytes through the wire handoff equal the unified lane's,
    a joiner admitted mid-burst included; int4 pools hand their packed
    bytes over (half the int8 wire), so the split stays exact."""
    unified, split = _lanes(kv_dtype=kv_dtype)
    uni, _ = _serve("uni", unified, model, PROMPTS, joiner=JOINER)
    spl, stats = _serve("spl", split, model, PROMPTS, joiner=JOINER)
    assert spl == uni
    pf, dl = stats
    assert pf["handoffs"] >= 4 and pf["handoff_failed"] == 0
    assert dl["adopted"] == pf["handoffs"]
    assert dl["handoff_refill"] == 0          # the wire, not the fallback
    assert pf["handoff_wire_mb"] > 0
    if kv_dtype == "int4":
        c4 = model.init_paged(2, page=8, kv_dtype="int4")
        c8 = model.init_paged(2, page=8, kv_dtype="int8")
        assert str(model._page_wire_dtype(c4)) == "uint8"
        assert model.page_wire_bytes(c4) * 2 == model.page_wire_bytes(c8)


@pytest.mark.parametrize("kv_dtype", [None, "int4"], ids=["f32", "int4"])
def test_refill_fallback_matches_unified(model, kv_dtype):
    """A store too small for a wire page degrades the handoff to
    re-prefill-from-record, byte-identically to the unified lane."""
    wire = model.page_wire_bytes(model.init_paged(2, page=8,
                                                  kv_dtype=kv_dtype))
    unified, split = _lanes(kv_dtype=kv_dtype)
    uni, _ = _serve("uni4k", unified, model, PROMPTS, max_val=wire)
    spl, stats = _serve("spl4k", split, model, PROMPTS, max_val=wire)
    assert spl == uni
    pf, dl = stats
    assert pf["handoffs"] >= 3
    assert dl["handoff_refill"] == pf["handoffs"]
    assert pf["handoff_wire_mb"] == 0


def test_prefill_fast_fails_deadline_inside_prefill_wall(model):
    """A deadline inside the rolling prefill-wall slack dies typed at
    admission, before paying prefill; the sibling without one is handed
    off."""
    name, st = _mkstore("ff")
    pf = PrefillLane(st, model=model, **KW)
    th = None
    try:
        pf.attach()
        pf.qos_slack_s = 10.0
        _submit(st, "doomed", "expires in prefill",
                deadline=time.time() + 2.0)
        _submit(st, "live", "no deadline here")
        th = _run_bg(pf)
        assert _await(st, ["doomed"], timeout=60)
        rec = P.parse_error_payload(st.get("doomed"))
        assert rec["err"] == "deadline_expired"
        assert pf.stats.deadline_expired == 1
        assert _await(st, ["live"], bit=P.LBL_DECODE_READY, timeout=60)
        assert pf._lane_stats["handoffs"] == 1
    finally:
        pf.stop()
        if th:
            th.join(timeout=30)
        st.close()
        Store.unlink(name)


def test_decode_rejects_expired_handoff_before_adoption(model):
    """An expired DECODE_READY handoff dies typed at the adopt edge,
    before taking pool pages or a row, and its wire keys go with it."""
    name, st = _mkstore("exp")
    pf = PrefillLane(st, model=model, **KW)
    dl = DecodeLane(st, model=model, **KW)
    tp = td = None
    try:
        pf.attach()
        dl.attach()
        _submit(st, "q", "soon to expire", deadline=time.time() + 1.5)
        tp = _run_bg(pf)
        assert _await(st, ["q"], bit=P.LBL_DECODE_READY, timeout=60)
        pf.stop()
        tp.join(timeout=30)
        time.sleep(1.6)
        td = _run_bg(dl)
        assert _await(st, ["q"], timeout=60)
        rec = P.parse_error_payload(st.get("q"))
        assert rec["err"] == "deadline_expired"
        assert dl.stats.deadline_expired == 1
        assert dl._lane_stats["adopted"] == 0
        assert _no_handoff_keys(st)
    finally:
        pf.stop()
        dl.stop()
        for th in (tp, td):
            if th:
                th.join(timeout=30)
        st.close()
        Store.unlink(name)


def test_adopt_backpressure_keeps_row_decode_ready(model):
    """A decode pool that cannot cover the worst-case reservation leaves
    the handoff DECODE_READY (counted, never stranded); once pages
    return, it is adopted and finishes."""
    name, st = _mkstore("bp")
    pf = PrefillLane(st, model=model, **KW)
    dl = DecodeLane(st, model=model, **dict(KW, pool_pages=16))
    tp = td = None
    try:
        pf.attach()
        dl.attach()
        cache = dl._ensure_paged_cache()
        assert cache.ensure(KW["batch_cap"] - 1, 15 * KW["page_size"])
        _submit(st, "q", "too big for that pool")
        tp = _run_bg(pf)
        td = _run_bg(dl)
        assert _await(st, ["q"], bit=P.LBL_DECODE_READY, timeout=60)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline \
                and dl._lane_stats["adopt_backpressure"] < 2:
            time.sleep(0.05)
        assert dl._lane_stats["adopt_backpressure"] >= 2
        labels = st.labels("q")
        assert labels & P.LBL_DECODE_READY
        assert not labels & (P.LBL_SERVICING | P.LBL_READY)
        assert dl._lane_stats["adopted"] == 0
        cache.free_row(KW["batch_cap"] - 1)
        assert _await(st, ["q"], timeout=60)
        assert dl._lane_stats["adopted"] == 1
    finally:
        pf.stop()
        dl.stop()
        for th in (tp, td):
            if th:
                th.join(timeout=30)
        st.close()
        Store.unlink(name)


def _seed_handoff(st, key, *, servicing):
    """A handed-off row as the prefill lane leaves it: value, labels, a
    v1 record and one wire page."""
    st.set(key, "prompt bytes")
    st.label_or(key, P.LBL_DECODE_READY
                | (P.LBL_SERVICING if servicing else 0))
    idx = st.find_index(key)
    assert P.write_handoff_record(st, idx, {
        "len": 3, "ids": [1, 2, 3], "carry": 5, "n_tok": 1,
        "remaining": 7, "disp_left": 7, "plen": st.value_len(key),
        "t0": 0, "tenant": 0, "deadline": None, "wire_pages": 1,
        "quant": False})
    st.set(P.handoff_page_key(idx, 0), b"\x01" * 64)
    st.label_or(P.handoff_page_key(idx, 0), P.LBL_DEBUG)
    return idx


def test_prefill_reclaim_skips_decode_owned_rows(model):
    """A restarted prefill lane leaves a decode-owned row (SERVICING |
    DECODE_READY) alone, record and wire page included, and re-queues
    its own died-mid-prefill row."""
    name, st = _mkstore("pfskip")
    pf = PrefillLane(st, model=model, **KW)
    try:
        pf.attach()
        adopted = _seed_handoff(st, "adopted", servicing=True)
        st.set("mine", "died mid prefill")
        st.label_or("mine", P.LBL_SERVICING)
        assert pf._reclaim_stranded() == 1
        labels = st.labels("adopted")
        assert labels & P.LBL_DECODE_READY and labels & P.LBL_SERVICING
        assert P.read_handoff_record(st, adopted) is not None
        assert P.handoff_page_key(adopted, 0) in st
        labels = st.labels("mine")
        assert labels & P.LBL_WAITING and labels & P.LBL_INFER_REQ
        assert not labels & P.LBL_SERVICING
    finally:
        st.close()
        Store.unlink(name)


def test_decode_reclaim_skips_prefill_claims(model):
    """A decode lane's reclaim leaves SERVICING-only rows (a prefill
    lane's claims) alone and rolls its own dead adopter's row back to
    bare DECODE_READY, truncated to the handoff's byte length."""
    name, st = _mkstore("dlskip")
    dl = DecodeLane(st, model=model, **KW)
    try:
        dl.attach()
        st.set("claim", "being prefilled right now")
        st.label_or("claim", P.LBL_SERVICING)
        mine = _seed_handoff(st, "mine", servicing=True)
        plen = P.read_handoff_record(st, mine)["plen"]
        st.set("mine", "prompt bytes plus a dead adopter tail")
        st.label_or("mine", P.LBL_SERVICING | P.LBL_DECODE_READY)
        assert dl._reclaim_stranded() == 1
        labels = st.labels("claim")
        assert labels & P.LBL_SERVICING and not labels & P.LBL_WAITING
        labels = st.labels("mine")
        assert labels & P.LBL_DECODE_READY
        assert not labels & P.LBL_SERVICING
        assert st.value_len("mine") == plen
    finally:
        st.close()
        Store.unlink(name)


def test_decode_reclaim_record_vanished_requeues(model):
    """A DECODE_READY row whose record is gone goes back to WAITING."""
    name, st = _mkstore("dlvan")
    dl = DecodeLane(st, model=model, **KW)
    try:
        dl.attach()
        idx = _seed_handoff(st, "mine", servicing=True)
        P.clear_handoff(st, idx, pages=1)
        assert dl._reclaim_stranded() == 1
        labels = st.labels("mine")
        assert labels & P.LBL_WAITING and labels & P.LBL_INFER_REQ
        assert not labels & (P.LBL_SERVICING | P.LBL_DECODE_READY)
    finally:
        st.close()
        Store.unlink(name)


def test_handoff_survives_post_flip_bookkeeping_failure(model, monkeypatch):
    """An error after the DECODE_READY flip (spans.commit here) must not
    re-queue a row the decode lane already owns."""
    name, st = _mkstore("postflip")
    pf = PrefillLane(st, model=model, **KW)
    th = None

    def boom(*a, **k):
        raise OSError("spans ring full")

    try:
        pf.attach()
        monkeypatch.setattr(pf.spans, "commit", boom)
        _submit(st, "q", "post flip failure")
        th = _run_bg(pf)
        assert _await(st, ["q"], bit=P.LBL_DECODE_READY, timeout=60)
        idx = st.find_index("q")
        assert P.read_handoff_record(st, idx) is not None
        assert not st.labels("q") & (P.LBL_WAITING | P.LBL_SERVICING)
        assert pf._lane_stats["handoffs"] == 1
        assert pf._lane_stats["handoff_failed"] == 0
    finally:
        pf.stop()
        if th:
            th.join(timeout=30)
        st.close()
        Store.unlink(name)


# -- one wire between the packages -------------------------------------------

def _step_logits(tm, cache, row, tok):
    """Logits of one paged decode step of `row` fed `tok` (K5's plain
    version over the pool), (V,) f32."""
    toks = torch.zeros((cache.batch, 1), dtype=torch.int64)
    toks[row, 0] = int(tok)
    with torch.no_grad():
        out = tm.module(toks, cache.layers(), 0,
                        lengths=torch.from_numpy(cache.lengths.copy()),
                        tables=torch.from_numpy(cache.tables.copy()))
    return out[row, 0].numpy()


def test_jax_prefill_lane_hands_off_to_the_ports_decode_lane():
    """The JAX package's PrefillLane (its model) hands rows off over one
    store; the port's model adopts each row's wire pages and its first
    decode step's logits are within 1e-4 of the port's own prefill of
    the recorded ids + the same step (f32, TF32 off).  Then the port's
    DecodeLane serves every handoff to READY from the wire."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    jdec = pytest.importorskip("libsplinter_tpu.models.decoder")
    jdisagg = pytest.importorskip("libsplinter_tpu.engine.disagg")
    from libsplinter_tpu import Store as JStore
    cfg_j = jdec.DecoderConfig.tiny(dtype=jnp.float32)
    params = jdec.Decoder(cfg_j).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32),
        jdec.init_cache(cfg_j, 1), jnp.int32(0))
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    common = dict(buckets=(32,), temp=0.0, seed=1, suffix_buckets=(8,))
    jm = jdec.CompletionModel(cfg_j, params=params, **common)
    cfg_t = tdec.DecoderConfig.tiny(dtype=torch.float32)
    tm = tdec.CompletionModel(cfg_t, params=tdec.params_from_jax(params,
                                                                 cfg_t),
                              device="cpu", **common)
    name, st = _mkstore("xpkg")
    jst = JStore.open(name)
    keys = [f"x/{i}" for i in range(len(PROMPTS))]
    jpf = jdisagg.PrefillLane(jst, model=jm, **KW)
    th = None
    try:
        jpf.attach()
        for key, text in zip(keys, PROMPTS):
            _submit(st, key, text)
        th = threading.Thread(target=jpf.run_continuous,
                              kwargs=dict(idle_timeout_ms=20,
                                          stop_after=180.0), daemon=True)
        th.start()
        assert _await(st, keys, bit=P.LBL_DECODE_READY, timeout=180)
        jpf.stop()
        th.join(timeout=30)
        th = None
        worst = 0.0
        for key in keys:
            idx = st.find_index(key)
            rec = P.read_handoff_record(st, idx)
            assert rec["wire_pages"] > 0 and not rec["quant"]
            pages = [bytes(st.get(P.handoff_page_key(idx, j)))
                     for j in range(rec["wire_pages"])]
            adopt = tm.init_paged(2, page=KW["page_size"])
            assert tm.paged_adopt_row(adopt, 0, rec["len"], pages)
            got = _step_logits(tm, adopt, 0, rec["carry"])
            anchor = tm.init_paged(2, page=KW["page_size"])
            tm.paged_prefill_row(anchor, np.asarray(rec["ids"], np.int32),
                                 0)
            want = _step_logits(tm, anchor, 0, rec["carry"])
            worst = max(worst, float(np.abs(got - want).max()))
        assert worst <= 1e-4, worst
        dl = DecodeLane(st, model=tm, **KW)
        dl.attach()
        th = _run_bg(dl)
        assert _await(st, keys, timeout=120)
        dl.stop()
        th.join(timeout=30)
        th = None
        assert dl._lane_stats["adopted"] == len(keys)
        assert dl._lane_stats["handoff_refill"] == 0
        assert _no_handoff_keys(st)
        for key, text in zip(keys, PROMPTS):
            assert st.get(key).rstrip(b"\0").startswith(text.encode())
    finally:
        jpf.stop()
        if th is not None:
            th.join(timeout=30)
        jst.close()
        st.close()
        Store.unlink(name)


def test_main_phase_prefill_then_decode_on_the_cpu(monkeypatch):
    """`main --phase prefill` hands a request off (DECODE_READY) and
    `main --phase decode` adopts and finishes it, both on --device cpu
    (the phase implies --continuous)."""
    from libsplinter_tpu_torch.engine import completer as tcomp
    name, st = _mkstore("main")
    seen = {}

    def stopping(cls, bit):
        orig = cls.run_continuous

        def run_then_stop(self, **kw):
            th = threading.Thread(target=orig, args=(self,),
                                  kwargs=dict(idle_timeout_ms=20,
                                              stop_after=300.0),
                                  daemon=True)
            th.start()
            seen[cls.LANE] = (_await(st, ["q"], bit=bit, timeout=280),
                              type(self))
            self.stop()
            th.join(timeout=60)
        return run_then_stop

    monkeypatch.setattr(PrefillLane, "run_continuous",
                        stopping(PrefillLane, P.LBL_DECODE_READY))
    monkeypatch.setattr(DecodeLane, "run_continuous",
                        stopping(DecodeLane, P.LBL_READY))
    argv = ["--store", name, "--device", "cpu", "--n-ctx", "128",
            "--max-new-tokens", "4", "--batch-cap", "2", "--template",
            "none", "--phase"]
    try:
        _submit(st, "q", "hello")
        assert tcomp.main(argv + ["prefill"]) == 0
        assert seen["prefill"] == (True, PrefillLane)
        assert tcomp.main(argv + ["decode"]) == 0
        assert seen["decode"] == (True, DecodeLane)
        assert st.get("q").startswith(b"hello")
        assert _no_handoff_keys(st)
    finally:
        st.close()
        Store.unlink(name)
