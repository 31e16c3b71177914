"""Drills of the torch port's lanes that the JAX package drives through
its CLI's load generator or under supervision, on the CPU:

  - tests/test_elastic.py:859 TestSupervisedScaleDrill: the port's
    supervisor scales real pipeliner children 1 -> 3 -> 1 under load
    with a retiring replica crash-killed mid-drain: every admitted
    script ends ok;
  - tests/test_elastic.py:980 TestMidDecodeDeadline: the continuous
    lane kills a row whose deadline passes mid-decode at a chunk edge
    and frees its pages;
  - tests/test_prefix_cache.py:553,576: loadgen's --shared-prefix knob,
    and its prefix-cache report against a live continuous completer;
  - tests/test_pipeliner.py:725 test_script_chain_beats_client_chain:
    rag-churn as a stored script against the client-side chain.

The JAX package marks the scale drill, the deadline drill and the chain
bar slow. The two drills take a few seconds each on the CPU, so they
are tier-1; the chain bar stays slow (its docstring says why)."""
from __future__ import annotations

import json
import os
import signal
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from libsplinter_tpu_torch import Store
from libsplinter_tpu_torch.cli.loadgen import LoadGenerator, TenantSpec
from libsplinter_tpu_torch.engine import protocol as P
from libsplinter_tpu_torch.engine.completer import Completer
from libsplinter_tpu_torch.engine.embedder import Embedder
from libsplinter_tpu_torch.engine.pipeliner import Pipeliner, daemon_live
from libsplinter_tpu_torch.engine.searcher import Searcher
from libsplinter_tpu_torch.engine.supervisor import Supervisor
from libsplinter_tpu_torch.models import CompletionModel, DecoderConfig

PAGE = 8


@pytest.fixture
def store():
    name = f"/spt-tdrill-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=128, max_val=4096, vec_dim=8)
    yield st
    st.close()
    Store.unlink(name)


def _wait_for(cond, timeout=30.0, dt=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(dt)
    return False


@pytest.mark.chaos
def test_supervised_scale_up_down_with_crash_kill_strands_nothing(store):
    """Real pipeliner children (torch-free: restarts cost little) scale
    1 -> 3 under load, then back to 1, and a retiring replica is
    SIGKILLed while it holds scripts: the drain protocol and the
    straggler reclaim leave every admitted request with an ok result."""
    sup = Supervisor(store.name, lanes=("pipeliner",),
                     scale={"pipeliner": (1, 3)}, drain_deadline_s=6.0,
                     startup_grace_s=60, store=store)
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            try:
                sup.poll_once()
            except Exception:
                pass
            time.sleep(0.1)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    submitted: list[str] = []

    def submit(count, sleep_s=0.02):
        for _ in range(count):
            key = f"job{len(submitted) + 1}"
            store.set(key, json.dumps({
                "script": f"splinter.sleep({sleep_s}) "
                          f"return {len(submitted) + 1}"}))
            store.label_or(key, P.LBL_SCRIPT_REQ | P.LBL_WAITING)
            store.bump(key)
            submitted.append(key)

    def live_replicas():
        return [r for r, ln in sup.replicas["pipeliner"].items()
                if not ln.retiring and ln.pid and P.pid_alive(ln.pid)]

    try:
        assert _wait_for(lambda: daemon_live(store), 60), \
            "replica 0 never came up"
        submit(6)
        P.write_scale_target(store, "pipeliner", 3, src="manual")
        assert _wait_for(lambda: len(live_replicas()) == 3, 60), \
            "scale-up never reached 3 replicas"
        submit(36, sleep_s=0.05)
        time.sleep(0.4)
        P.write_scale_target(store, "pipeliner", 1, src="manual")
        assert _wait_for(lambda: any(
            ln.retiring for ln in sup.replicas["pipeliner"].values()),
            30), "no replica entered the drain protocol"
        victim = next(ln for ln in sup.replicas["pipeliner"].values()
                      if ln.retiring)
        os.kill(victim.pid, signal.SIGKILL)
        submit(6)
        assert _wait_for(
            lambda: sorted(sup.replicas["pipeliner"]) == [0], 60), \
            "scale-down never converged to replica 0"

        def all_done():
            return not any(store.labels(k) & P.LBL_SCRIPT_REQ
                           for k in submitted)

        assert _wait_for(all_done, 90), "requests still pending"
        lost = []
        for k in submitted:
            try:
                rec = json.loads(store.get(P.script_result_key(
                    store.find_index(k))).rstrip(b"\0"))
            except (KeyError, OSError, ValueError):
                lost.append(k)
                continue
            if not rec.get("ok"):
                lost.append((k, rec))
        assert not lost, f"admitted requests lost: {lost[:5]}"
        assert sup.retired == 2
        assert P.read_stripe_map(store, "pipeliner") is None
        assert f"{P.KEY_SCRIPT_STATS}.r1" not in store
        assert f"{P.KEY_SCRIPT_STATS}.r2" not in store
        assert P.replica_heartbeat_keys(store, P.KEY_SCRIPT_STATS) == \
            [(0, P.KEY_SCRIPT_STATS)]
    finally:
        stop.set()
        th.join(timeout=5)
        sup.shutdown()


def test_expired_row_killed_at_chunk_edge(store):
    """A row whose deadline passes mid-decode is retired with the typed
    DEADLINE_EXPIRED record, its pages return to the pool, and
    killed_mid_decode counts it; a sibling without a deadline streams
    to the end."""
    model = CompletionModel(DecoderConfig.tiny(max_len=128,
                                               dtype=torch.float32),
                            device="cpu")
    comp = Completer(store, model=model, max_new_tokens=110,
                     flush_tokens=1, template="none", batch_cap=4,
                     page_size=16)
    comp.warmup_paged()
    key, slow = "req-dl", "req-slow"
    store.set(key, "a prompt that will outlive its deadline")
    store.label_or(key, P.LBL_INFER_REQ | P.LBL_WAITING)
    assert P.stamp_deadline(store, key, time.time() + 0.12)
    store.bump(key)
    store.set(slow, "sibling without a deadline")
    store.label_or(slow, P.LBL_INFER_REQ | P.LBL_WAITING)
    store.bump(slow)
    th = threading.Thread(target=comp.run_continuous,
                          kwargs=dict(idle_timeout_ms=20, stop_after=30.0),
                          daemon=True)
    th.start()
    _wait_for(lambda: store.labels(key) & P.LBL_READY
              and store.labels(slow) & P.LBL_READY, 25, 0.05)
    comp.stop()
    th.join(timeout=30)
    assert store.labels(key) & P.LBL_READY
    rec = P.parse_error_payload(store.get(key))
    assert rec is not None and rec["err"] == P.ERR_DEADLINE
    assert comp.stats.killed_mid_decode >= 1
    assert store.labels(slow) & P.LBL_READY
    assert P.parse_error_payload(store.get(slow)) is None
    assert comp._paged_cache.used_pages == 0
    comp.publish_stats()
    snap = json.loads(store.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
    assert snap["killed_mid_decode"] >= 1


def test_loadgen_shared_prefix_knob_deterministic():
    def prompts(seed):
        gen = LoadGenerator(None, [TenantSpec(1, 10.0)], seed=seed,
                            scenario="shared-prefix",
                            shared_prefix=(0.9, 64))
        return [gen._complete_prompt() for _ in range(80)]

    a, b = prompts(3), prompts(3)
    assert a == b
    pooled = [p for p in a if len(p) == 64]
    assert len(set(pooled)) <= 4
    assert 0.75 <= len(pooled) / len(a) <= 1.0
    assert prompts(4) != a
    with pytest.raises(ValueError):
        LoadGenerator(None, [TenantSpec(1, 1.0)], shared_prefix=(1.5, 64))


def test_loadgen_shared_prefix_reports_hit_rate():
    """The shared-prefix scenario against the port's live continuous
    completer: the report carries the lane's prefix-cache hit rate and
    nothing is lost."""
    name = f"/spt-tdrill-pfx-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=256, max_val=4096, vec_dim=8)
    try:
        model = CompletionModel(DecoderConfig.tiny(dtype=torch.float32),
                                buckets=(32, 64), temp=0.0, seed=1,
                                suffix_buckets=(8, 16), device="cpu")
        comp = Completer(st, model=model, max_new_tokens=4,
                         flush_tokens=2, template="none", batch_cap=4,
                         page_size=PAGE)
        comp.attach()
        th = threading.Thread(target=comp.run_continuous,
                              kwargs=dict(idle_timeout_ms=10,
                                          stop_after=120.0), daemon=True)
        th.start()
        gen = LoadGenerator(st, [TenantSpec(1, 12.0, deadline_ms=20_000)],
                            duration_s=2.0, seed=5,
                            scenario="shared-prefix",
                            shared_prefix=(0.9, 3 * PAGE - 1),
                            drain_s=30.0)
        rep = gen.run()
        comp.publish_stats()
        pfx = gen._prefix_cache_report()
        comp.stop()
        th.join(timeout=15)
        assert rep["lost"] == 0
        assert rep["ok"] >= 1
        assert pfx is not None and pfx["hits"] >= 1
        assert pfx["hit_rate"] > 0.3
    finally:
        st.close()
        Store.unlink(name)


@pytest.mark.slow
def test_script_chain_beats_client_chain():
    """rag-churn as a stored script shows its p50 at least 30% below
    the client-side chain on the same in-process stack of the port's
    lanes.  Slow-marked as the JAX package's is: a wall-clock A/B whose
    steady-state ratio sits near the bar on a CPU host (script /
    client p50 ~0.69 for the port's lanes, ~0.66 for the JAX package's
    after their compiles), so it is a stress-tier check, not a tier-1 one."""
    name = f"/spt-tdrill-rag-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=256, max_val=1024, vec_dim=32)

    def enc(texts):
        out = np.zeros((len(texts), st.vec_dim), np.float32)
        for i, t in enumerate(texts):
            out[i, hash(t) % st.vec_dim] = 1.0
        return out

    daemons = (Embedder(st, encoder_fn=enc, max_ctx=64),
               Searcher(st, device="cpu"),
               Completer(st, generate_fn=lambda p: iter([b"answer"]),
                         template="none"),
               Pipeliner(st))
    for d in daemons:
        d.attach()
    ths = [threading.Thread(target=d.run,
                            kwargs=dict(idle_timeout_ms=10,
                                        stop_after=120.0), daemon=True)
           for d in daemons]
    for t in ths:
        t.start()
    try:
        def p50(scn):
            gen = LoadGenerator(
                st, [TenantSpec(1, 10.0, deadline_ms=8000)],
                duration_s=2.5, corpus=8, seed=11, scenario=scn)
            rep = gen.run()
            assert rep["lost"] == 0, (scn, rep)
            lane = "rag" if scn == "rag-churn" else "script"
            return float(np.median(gen.raw_ms[(1, lane)]))

        client = p50("rag-churn")
        script = p50("rag-churn-script")
        assert script <= 0.7 * client, (client, script)
    finally:
        for d in daemons:
            d.stop()
        for t in ths:
            t.join(timeout=15)
        st.close()
        Store.unlink(name)
