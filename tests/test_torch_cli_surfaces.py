"""The torch port's operator surfaces through its CLI, on the CPU: the
port's counterparts of the JAX package's tests that render `spt
metrics`, `metrics --history`, `top`, `health`, `scale`, `trace`, `lua`,
`wasm`, `pipeline` and `search`, or drive the load generator, over the
port's lanes (the Searcher on device="cpu", the Embedder and Completer
with fake model functions, the verbatim Pipeliner) in threads:

  - tests/test_supervisor.py:197, its `spt metrics` half;
  - tests/test_telemetry.py:123 TestOperatorSurfaces (4);
  - tests/test_elastic.py:714 (its `spt scale` half), :745
    TestReplicaSurfaces (3), :800 TestRateProfile (3);
  - tests/test_pipeliner.py:145 TestSleepClamp (2), :522 TestEndToEnd
    (6);
  - tests/test_lua.py:490, tests/test_wasm.py:302;
  - tests/test_qos.py:723-828 (the tenant series in `spt metrics`, the
    open-loop and rag-churn loadgen runs, the --tenants check);
  - tests/test_spans.py:526,571 (`trace show` / `trace export` of a
    stored script's tree, loadgen's trace sampling);
  - tests/test_obs.py:531 (`metrics` and `trace tail`);
  - tests/test_searcher.py:232,359,576 (the searcher's quantiles in
    `metrics`, `search` dispatched to the daemon, --local bypassing it).

The supervised drills and the loadgen tests of the completion lane are
in tests/test_torch_cli_drills.py."""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest

from libsplinter_tpu_torch import T_VARTEXT, Store
from libsplinter_tpu_torch.cli.main import (COMMANDS, CliError, Session,
                                            dispatch, main)
from libsplinter_tpu_torch.engine import protocol as P
from libsplinter_tpu_torch.engine.autoscaler import AutoScaler
from libsplinter_tpu_torch.engine.client import submit_embed
from libsplinter_tpu_torch.engine.completer import Completer
from libsplinter_tpu_torch.engine.embedder import Embedder
from libsplinter_tpu_torch.engine.pipeliner import (Pipeliner,
                                                    consume_script_result,
                                                    submit_script)
from libsplinter_tpu_torch.engine.searcher import (Searcher, daemon_live)
from libsplinter_tpu_torch.engine.supervisor import Supervisor
from libsplinter_tpu_torch.engine.telemetry import TelemetrySampler
from libsplinter_tpu_torch.obs import spans as S
from libsplinter_tpu_torch.scripting.library import (SCRIPT_LIBRARY,
                                                     seed_library)
from libsplinter_tpu_torch.scripting.sandbox import ScriptBudget
from libsplinter_tpu_torch.utils import faults
from libsplinter_tpu_torch.utils.trace import tracer


@pytest.fixture
def store():
    name = f"/spt-tsurf-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=256, max_val=1024, vec_dim=32)
    yield st
    st.close()
    Store.unlink(name)


@pytest.fixture(autouse=True)
def _no_faults():
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture
def traced():
    prev = tracer.enabled
    tracer.enabled = True
    tracer.reset()
    yield tracer
    tracer.enabled = prev
    tracer.reset()


def _cmd(store, name, args):
    """One command through the registry, its stdout returned."""
    ses = Session(store.name)
    ses._store = store
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            COMMANDS[name][0](ses, list(args))
    finally:
        ses._store = None             # the fixture owns the handle
        ses.close()
    return buf.getvalue()


def _enc(store):
    def enc(texts):
        out = np.zeros((len(texts), store.vec_dim), np.float32)
        for i, t in enumerate(texts):
            out[i, hash(t) % store.vec_dim] = 1.0
        return out
    return enc


def _stack(store, stop_after=90.0, pipeliner=True, **searcher_kw):
    """The port's lanes in threads: the embedder (one-hot fake encoder),
    the searcher on the CPU, a completer answering "answer" and the
    pipeliner; short heartbeat and sweep cadences so records land
    promptly."""
    emb = Embedder(store, encoder_fn=_enc(store), max_ctx=64)
    sr = Searcher(store, device="cpu", **searcher_kw)
    comp = Completer(store, generate_fn=lambda p: iter([b"answer"]),
                     template="none")
    daemons = [emb, sr, comp]
    if pipeliner:
        daemons.append(Pipeliner(store))
    for d in daemons:
        d.attach()
    kw = [dict(sweep_interval_s=0.25), dict(heartbeat_interval_s=0.25),
          {}, {}]
    ths = [threading.Thread(target=d.run,
                            kwargs=dict(idle_timeout_ms=10,
                                        stop_after=stop_after, **extra),
                            daemon=True)
           for d, extra in zip(daemons, kw)]
    for t in ths:
        t.start()
    return daemons, ths


@contextlib.contextmanager
def _running(store, **kw):
    daemons, ths = _stack(store, **kw)
    try:
        yield daemons
    finally:
        for d in daemons:
            d.stop()
        for t in ths:
            t.join(timeout=15)


def _seed_docs(store, n=8, prefix="lgd"):
    rng = np.random.default_rng(0)
    for i in range(n):
        k = f"{prefix}{i}"
        store.set(k, f"seed doc {i}")
        v = rng.standard_normal(store.vec_dim).astype(np.float32)
        store.vec_set(k, v / np.linalg.norm(v))


# ------------------------------------------------ supervisor metrics

def test_supervisor_metrics_exposition(store):
    """tests/test_supervisor.py:197, its `spt metrics` half: the
    restart and breaker counters of crash-looping children render as
    Prometheus lines."""
    def crasher(lane):
        return subprocess.Popen([sys.executable, "-c",
                                 "import sys; sys.exit(7)"])

    sup = Supervisor(store.name, lanes=("searcher", "embedder"),
                     spawn_fn=crasher, store=store, backoff_base_ms=5,
                     breaker_threshold=3, breaker_window_s=30,
                     breaker_cooldown_s=600)
    try:
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not all(
                ln.state == "down" for ln in sup.lanes.values()):
            sup.poll_once()
            time.sleep(0.02)
        assert all(ln.state == "down" for ln in sup.lanes.values())
        out = _cmd(store, "metrics", [])
    finally:
        sup.shutdown()
    assert 'sptpu_supervisor_lane_down{lane="searcher"} 1' in out
    assert 'sptpu_supervisor_lane_breaker_opens{lane="searcher"} 1' in out
    assert 'sptpu_supervisor_lane_restarts{lane="embedder"}' in out
    assert "sptpu_supervisor_polls" in out


# ------------------------------------------ telemetry operator surfaces

class TestOperatorSurfaces:
    def _sampled(self, store, monkeypatch):
        P.publish_heartbeat(store, P.KEY_EMBED_STATS,
                            {"shed": 1, "embedded": 9})
        P.publish_heartbeat(store, P.KEY_SEARCH_STATS,
                            {"shed": 0, "served": 4})
        tel = TelemetrySampler(store)
        tel.attach()
        for k in range(5):
            tel.sample_once(now=4000.0 + k)
        tel.publish_stats()
        monkeypatch.setenv("SPTPU_DEFAULT_STORE", store.name)
        monkeypatch.delenv("SPTPU_NS_PREFIX", raising=False)

    def test_metrics_history_renders_gauges(self, store, capsys,
                                            monkeypatch):
        self._sampled(store, monkeypatch)
        assert main(["metrics", "--history"]) == 0
        out = capsys.readouterr().out
        for lane in ("embedder", "searcher"):
            assert f"[{lane}]" in out
        assert out.count("queue_depth") >= 2
        assert "shed" in out and "progress" in out
        assert "last=" in out and "min=" in out

    def test_metrics_exposition_covers_telemetry_lane(
            self, store, capsys, monkeypatch):
        self._sampled(store, monkeypatch)
        assert main(["metrics"]) == 0
        out = capsys.readouterr().out
        assert "sptpu_telemetry_samples" in out
        assert "sptpu_telemetry_points" in out

    def test_top_once_renders_frame(self, store, capsys, monkeypatch):
        self._sampled(store, monkeypatch)
        assert main(["top", "--once"]) == 0
        out = capsys.readouterr().out
        assert "spt top" in out
        for lane in ("embedder", "searcher", "completer", "pipeliner"):
            assert lane in out
        assert "telemetry" in out
        assert "queue" in out

    def test_top_frames_loop(self, store, capsys, monkeypatch):
        self._sampled(store, monkeypatch)
        assert main(["top", "--frames", "2", "--interval", "0.05"]) == 0
        assert capsys.readouterr().out.count("spt top") == 2


# --------------------------------------------------- autoscaler / scale

def test_scale_status_set_and_auto(store):
    """tests/test_elastic.py:714, its `spt scale` half: the
    autoscaler's decision reads back through `scale status`; a manual
    target and its clearing go through `scale set`."""
    store.set(P.KEY_SCALE_POLICY, json.dumps(
        {"v": 1, "lanes": {"embedder": {"min": 1, "max": 4}}}))
    P.publish_heartbeat(store, P.KEY_SUPERVISOR_STATS,
                        {"polls": 1, "lanes": {"embedder": {
                            "state": "running", "r": 1}}})
    store.set(P.telemetry_key("embedder"), json.dumps(
        {"v": 1, "lane": "embedder", "interval_s": 0.1, "n": 1,
         "ts": time.time(), "gauges": {"queue_depth": [[100.0, 32.0]]}}))
    ctl = AutoScaler(store, up_threshold=8.0, up_consecutive=1,
                     cooldown_s=0.0)
    ctl.attach()
    ctl.decide_once(0.0)
    ctl.publish_stats()
    snap = json.loads(store.get(P.KEY_AUTOSCALER_STATS).rstrip(b"\0"))
    assert snap["lanes"]["embedder"]["target"] == 4
    out = _cmd(store, "scale", ["status"])
    assert "embedder" in out and "1:4" in out
    _cmd(store, "scale", ["set", "embedder=2"])
    tgt = P.read_scale_targets(store)["embedder"]
    assert tgt["r"] == 2 and tgt["src"] == "manual"
    _cmd(store, "scale", ["set", "embedder=auto"])
    assert "embedder" not in P.read_scale_targets(store)


class TestReplicaSurfaces:
    def test_metrics_renders_replica_blocks(self, store):
        P.publish_heartbeat(store, P.KEY_EMBED_STATS,
                            {"embedded": 4, "replica": 0})
        P.publish_heartbeat(store, f"{P.KEY_EMBED_STATS}.r1",
                            {"embedded": 6, "replica": 1,
                             "stripe": {"replica": 1, "epoch": 2,
                                        "width": 16, "stripes": 8}})
        out = _cmd(store, "metrics", [])
        assert "sptpu_embedder_embedded 4" in out
        assert "sptpu_embedder_r1_embedded 6" in out
        assert "sptpu_embedder_r1_stripe_stripes 8" in out

    def test_top_shows_replica_rows_and_dead_marker(self, store):
        P.publish_heartbeat(store, P.KEY_EMBED_STATS, {"embedded": 4})
        store.set(f"{P.KEY_EMBED_STATS}.r1", json.dumps(
            {"ts": time.time(), "pid": 2 ** 22 + 12345, "embedded": 6}))
        store.label_or(f"{P.KEY_EMBED_STATS}.r1", P.LBL_DEBUG)
        out = _cmd(store, "top", ["--once"])
        assert "1/2up" in out
        assert "├r0" in out and "├r1" in out
        assert "[DEAD" in out
        assert "10" in out

    def test_health_lists_replicas(self, store):
        P.publish_heartbeat(store, P.KEY_SEARCH_STATS, {"served": 1})
        P.publish_heartbeat(store, f"{P.KEY_SEARCH_STATS}.r2",
                            {"served": 2})
        assert "searcher.r2" in _cmd(store, "health", [])


# ------------------------------------------- loadgen rate profiles

class TestRateProfile:
    def test_parse(self):
        from libsplinter_tpu_torch.cli.loadgen import parse_rate_profile

        assert parse_rate_profile("1x:10,8x:20,1x:10") == [
            (1.0, 10.0), (8.0, 20.0), (1.0, 10.0)]
        assert parse_rate_profile("2:5") == [(2.0, 5.0)]
        for bad in ("", "1x", "x:5", "1x:0", "-1x:5"):
            with pytest.raises(ValueError):
                parse_rate_profile(bad)

    def test_schedule_steps_rate_deterministically(self, store):
        from libsplinter_tpu_torch.cli.loadgen import (LoadGenerator,
                                                       TenantSpec)

        def gen():
            return LoadGenerator(
                store, [TenantSpec(tenant=1, rate=10.0)],
                arrivals="fixed", seed=7,
                rate_profile=[(1.0, 1.0), (4.0, 1.0), (1.0, 1.0)])

        g = gen()
        assert g.duration_s == 3.0
        sched = g._schedule()
        by_phase: dict[int, int] = {}
        for when, _t, phase in sched:
            assert phase == g._phase_at(when)
            by_phase[phase] = by_phase.get(phase, 0) + 1
        assert 8 <= by_phase[0] <= 12
        assert 35 <= by_phase[1] <= 44
        assert 8 <= by_phase.get(2, 0) <= 12
        assert [w for w, _, _ in gen()._schedule()] == \
            [w for w, _, _ in sched]

    def test_report_carries_per_phase_sections(self, store):
        from libsplinter_tpu_torch.cli.loadgen import (LoadGenerator,
                                                       TenantSpec)

        gen = LoadGenerator(
            store, [TenantSpec(tenant=1, rate=30.0)],
            mix={"embed": 1.0}, arrivals="fixed", seed=1, drain_s=0.1,
            rate_profile=[(1.0, 0.3), (4.0, 0.3)])
        rep = gen.run()
        rows = rep["rate_profile"]
        assert [r["phase"] for r in rows] == [0, 1]
        assert rows[1]["issued"] > rows[0]["issued"] * 2
        assert sum(r["issued"] for r in rows) == rep["issued"]


# ------------------------------------------------------------- scripting

class TestSleepClamp:
    def test_lua_host_sleep_clamped(self, store):
        from libsplinter_tpu_torch.scripting.sandbox import \
            make_sandboxed_runtime
        rt = make_sandboxed_runtime(store, ScriptBudget(max_sleep_s=0.05))
        t0 = time.monotonic()
        rt.run("splinter.sleep(1e9)")
        assert time.monotonic() - t0 < 2.0

    def test_cli_lua_budget_knobs(self, store, capsys):
        from libsplinter_tpu_torch.cli.script import cmd_lua

        ses = Session(store.name)
        ses._store = store
        with pytest.raises(CliError, match="budget_exceeded"):
            cmd_lua(ses, ["--max-steps", "20000", "-e",
                          "while true do end"])
        t0 = time.monotonic()
        cmd_lua(ses, ["--max-sleep-s", "0.05", "-e",
                      "splinter.sleep(1e9) print('ok')"])
        assert time.monotonic() - t0 < 2.0
        assert "ok" in capsys.readouterr().out
        ses._store = None


def _bare_session(store):
    ses = Session.__new__(Session)
    ses.store_name = store.name
    ses.ns_prefix = ""
    ses.persistent = False
    ses._store = store
    ses._lanes = {}
    ses._lane = None
    ses.labels = {}
    return ses


def test_cli_lua_command(store, tmp_path, capsys):
    script = tmp_path / "s.lua"
    script.write_text('local bus = require("splinter")\n'
                      'bus.set(arg[1], "from cli lua")\n'
                      'print("wrote " .. arg[1])\n')
    dispatch(_bare_session(store), ["lua", str(script), "cli_key"])
    assert capsys.readouterr().out.strip() == "wrote cli_key"
    assert store.get("cli_key") == b"from cli lua"


def test_cli_wasm_command(store, tmp_path, capsys):
    from test_wasm import host_module

    mod = tmp_path / "m.wasm"
    mod.write_bytes(host_module())
    dispatch(_bare_session(store), ["wasm", str(mod), "run"])
    out = capsys.readouterr().out
    assert "hello wasm" in out and "10" in out
    assert store.get("wkey") == b"hello wasm"


def test_smoke_wasm_module_is_the_host_module():
    """chip_smoke.py carries the host module's bytes (it imports nothing
    of the JAX package's tests); they are tests/test_wasm.py's."""
    import importlib.util
    from pathlib import Path

    from test_wasm import host_module

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert bytes.fromhex(mod.WASM_HOST_MODULE) == host_module()


# ------------------------------------------------- pipeline end to end

class TestEndToEnd:
    def test_submit_embed_client_helper(self, store):
        with _running(store):
            assert submit_embed(store, "ce", "hello world", tenant=3,
                                deadline_ms=8000, timeout_ms=8000) is True
            assert np.abs(store.vec_get("ce")).max() > 0

    def test_inline_chain_and_stored_scenarios(self, store):
        _seed_docs(store)
        seed_library(store)
        with _running(store):
            rec = submit_script(store, "e2e", timeout_ms=20_000, script="""
                local ok, err = splinter.submit_embed("ed", "doc")
                if not ok then error(err) end
                local q = "eq"
                splinter.set(q, "scratch")
                splinter.set_embedding(q, splinter.get_embedding("ed"))
                local hits, serr = splinter.submit_search(q, 3)
                splinter.unset(q)
                if not hits then error(serr) end
                local out, cerr = splinter.submit_completion(
                    "ec", "ctx: " .. table.concat(hits, ","))
                if not out then error(cerr) end
                return #hits, out
            """)
            assert rec["ok"] is True
            assert rec["ret"][0] >= 1
            assert "answer" in rec["ret"][1]
            consume_script_result(store, "e2e")
            for name in SCRIPT_LIBRARY:
                rec = submit_script(store, f"e2e_{name}", name=name,
                                    args=[f"doc_{name}", 3],
                                    timeout_ms=20_000, tenant=1,
                                    deadline_ms=15_000)
                assert rec.get("ok") is True, (name, rec)
                consume_script_result(store, f"e2e_{name}")

    def test_loadgen_script_scenarios_end_to_end(self, store):
        from libsplinter_tpu_torch.cli.loadgen import (LoadGenerator,
                                                       TenantSpec)

        with _running(store):
            for scn in ("agent-loop", "multi-hop", "map-reduce"):
                gen = LoadGenerator(
                    store, [TenantSpec(1, 5.0, deadline_ms=8000)],
                    duration_s=1.2, corpus=8, seed=4, scenario=scn)
                rep = gen.run()
                assert rep["lost"] == 0, (scn, rep)
                assert rep["ok"] >= max(1, rep["issued"] - 1), (scn, rep)
                assert "p50_ms" in rep["per_tenant"]["1"]["script"]

    def test_unknown_scenario_lists_registry(self, store):
        from libsplinter_tpu_torch.cli.loadgen import (LoadGenerator,
                                                       TenantSpec)
        with pytest.raises(ValueError) as ei:
            LoadGenerator(store, [TenantSpec(1, 1.0)], scenario="nope")
        for name in ("rag-churn", "rag-churn-script", "agent-loop",
                     "multi-hop", "map-reduce"):
            assert name in str(ei.value)

    def test_cli_pipeline_store_management(self, store, capsys,
                                           tmp_path):
        from libsplinter_tpu_torch.cli.pipeline import cmd_pipeline

        ses = Session(store.name)
        ses._store = store
        f = tmp_path / "s.lua"
        f.write_text("return 1")
        cmd_pipeline(ses, ["put", "mine", str(f)])
        cmd_pipeline(ses, ["seed"])
        cmd_pipeline(ses, ["ls"])
        out = capsys.readouterr().out
        assert "mine" in out and "rag-churn" in out
        cmd_pipeline(ses, ["cat", "mine"])
        assert "return 1" in capsys.readouterr().out
        cmd_pipeline(ses, ["rm", "mine"])
        with pytest.raises(CliError):
            cmd_pipeline(ses, ["cat", "mine"])
        with pytest.raises(CliError, match="no live pipeline lane"):
            cmd_pipeline(ses, ["run", "-e", "return 1"])
        with pytest.raises(CliError, match="already given"):
            cmd_pipeline(ses, ["run", "@rag-churn", "-e", "return 1"])
        ses._store = None

    def test_cli_pipeline_run_against_live_lane(self, store, capsys):
        from libsplinter_tpu_torch.cli.pipeline import cmd_pipeline

        with _running(store) as daemons:
            daemons[-1].publish_stats()
            ses = Session(store.name)
            ses._store = store
            cmd_pipeline(ses, ["run", "-e", "return 40 + 2",
                               "--timeout-ms", "10000"])
            assert "ok: 42" in capsys.readouterr().out
            ses._store = None


# ---------------------------------------------------- qos: tenants + load

def _search_req(store, key, k=3, tenant=0):
    store.set(key, json.dumps({"k": k}))
    qv = np.zeros(store.vec_dim, np.float32)
    qv[0] = 1.0
    store.vec_set(key, qv)
    if tenant:
        P.stamp_tenant(store, key, tenant)
    store.label_or(key, P.LBL_SEARCH_REQ | P.LBL_WAITING)
    store.bump(key)


def test_metrics_renders_tenant_series(store):
    _seed_docs(store, prefix="doc")
    sr = Searcher(store, admit_cap=1, queue_high_water=0, device="cpu")
    sr.attach()
    for i in range(3):
        _search_req(store, f"q{i}", tenant=5)
    sr.run_once()
    sr.publish_stats()
    out = _cmd(store, "metrics", [])
    assert 'sptpu_searcher_tenant_admitted{' in out
    assert 'tenant="5"' in out
    assert "sptpu_searcher_shed" in out
    assert "sptpu_searcher_qos_retry_after_ms" in out


class TestLoadgen:
    def test_open_loop_mixed_run(self, store):
        from libsplinter_tpu_torch.cli.loadgen import (LoadGenerator,
                                                       TenantSpec,
                                                       evaluate_slo)

        with _running(store, pipeliner=False):
            gen = LoadGenerator(
                store, [TenantSpec(1, 12.0, deadline_ms=5000),
                        TenantSpec(2, 4.0, deadline_ms=5000)],
                duration_s=1.5, corpus=8, seed=3)
            rep = gen.run()
        assert rep["issued"] > 5
        assert rep["lost"] == 0
        assert rep["ok"] >= rep["issued"] * 0.8, rep
        t1 = rep["per_tenant"]["1"]
        assert any("p99_ms" in row for row in t1.values())
        assert evaluate_slo(rep, goodput=0.5) == []
        assert evaluate_slo(rep, p99_ms=0.0001) != []

    def test_rag_churn_scenario(self, store):
        from libsplinter_tpu_torch.cli.loadgen import (LoadGenerator,
                                                       TenantSpec)

        with _running(store, pipeliner=False):
            gen = LoadGenerator(
                store, [TenantSpec(1, 6.0, deadline_ms=6000)],
                duration_s=1.5, corpus=8, seed=5, scenario="rag-churn")
            rep = gen.run()
        assert rep["scenario"] == "rag-churn"
        assert rep["lost"] == 0
        assert rep["ok"] >= max(1, rep["issued"] - 1), rep

    def test_tenants_flag_validated_at_parse(self, store):
        from libsplinter_tpu_torch.cli.loadgen import cmd_loadgen

        ses = Session(store.name)
        ses._store = store
        with pytest.raises(CliError):
            cmd_loadgen(ses, ["--tenants", "16", "--duration", "0.1"])
        ses._store = None


# ---------------------------------------------------------------- traces

def _await_lanes(store, tid, want, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        recs = S.collect_spans(store, tid)
        if want <= {r["lane"] for r in recs}:
            return recs
        time.sleep(0.1)
    return S.collect_spans(store, tid)


def test_stored_script_trace_tree_and_cli(store, capsys, monkeypatch):
    """One stored script's tree rooted at the pipeliner's span, verbs
    beneath it; `trace show` renders it and `trace export` emits Chrome
    trace JSON."""
    _seed_docs(store)
    seed_library(store)
    with _running(store):
        tid = P.next_trace_id()
        rec = submit_script(store, "screq", name="rag-churn",
                            args=["sdoc", 1, 3], trace=(tid, 0),
                            timeout_ms=30_000)
        assert rec and rec.get("ok"), rec
        recs = _await_lanes(store, tid, {"pipeliner", "embedder",
                                         "searcher", "completer"})
        assert {"pipeliner", "embedder", "searcher", "completer"} <= \
            {r["lane"] for r in recs}, recs
        tree = S.assemble_tree(recs)
        root = tree["root"]
        assert root["span"]["lane"] == "pipeliner"
        assert len(root["children"]) >= 3
        for child in root["children"]:
            assert child["span"]["parent"] == root["span"]["span"]
        monkeypatch.setenv("SPTPU_DEFAULT_STORE", store.name)
        monkeypatch.delenv("SPTPU_NS_PREFIX", raising=False)
        assert main(["trace", "show", f"{tid:#x}"]) == 0
        out = capsys.readouterr().out
        assert "pipeliner" in out and "queue=" in out
        assert main(["trace", "export", f"{tid:#x}"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["traceEvents"]
        names = {e["args"]["name"] for e in doc["traceEvents"]
                 if e["ph"] == "M"}
        assert "lane:pipeliner" in names


def test_loadgen_trace_sample_reports_slowest(store):
    from libsplinter_tpu_torch.cli.loadgen import LoadGenerator, TenantSpec

    def gen(sample):
        return LoadGenerator(
            store, [TenantSpec(1, 12.0, deadline_ms=10_000)],
            duration_s=1.2, corpus=8, seed=3,
            mix={"embed": 1.0, "search": 1.0}, trace_sample=sample)

    with _running(store):
        rep = gen(1.0).run()
        rep2 = gen(0.0).run()
    assert rep["ok"] >= 1, rep
    slow = rep["per_tenant"]["1"]["slow_traces"]
    assert 1 <= len(slow) <= 3
    for row in slow:
        assert row["trace"].startswith("0x")
        assert row["ms"] > 0
    assert "slow_traces" not in rep2["per_tenant"]["1"]


def test_cli_metrics_and_trace_tail(traced, monkeypatch, capsys):
    name = f"/spt-tsurf-obs-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=128, max_val=4096, vec_dim=8)
    name2 = name + "-2"
    monkeypatch.setenv("SPTPU_DEFAULT_STORE", name)
    monkeypatch.delenv("SPTPU_NS_PREFIX", raising=False)
    try:
        emb = Embedder(st, encoder_fn=lambda ts: np.zeros(
            (len(ts), 8), np.float32), max_ctx=64)
        emb.attach()
        st.set("k", "metric me")
        st.set_type("k", T_VARTEXT)
        st.label_or("k", P.LBL_EMBED_REQ)
        st.bump("k")
        tid = P.stamp_trace(st, "k")
        emb.run_once()
        emb.publish_stats()
        assert main(["metrics"]) == 0
        out = capsys.readouterr().out
        assert "# TYPE sptpu_store_parse_failures counter" in out
        assert "sptpu_embedder_embedded 1" in out
        assert 'sptpu_stage_ms{daemon="embedder",stage="commit"' in out
        assert "sptpu_heartbeat_age_seconds" in out
        assert main(["trace", "tail", "4"]) == 0
        out = capsys.readouterr().out
        assert f"id={tid:#x}" in out
        assert "drain=" in out and "commit=" in out
        Store.create(name2, nslots=128, max_val=4096, vec_dim=8).close()
        monkeypatch.setenv("SPTPU_DEFAULT_STORE", name2)
        assert main(["trace", "tail"]) == 0
        assert "no traced requests" in capsys.readouterr().out
    finally:
        st.close()
        Store.unlink(name)
        Store.unlink(name2)


# ------------------------------------------------------------ the searcher

def _fill_docs(store, n, rng):
    vecs = rng.normal(size=(n, store.vec_dim)).astype(np.float32)
    for i in range(n):
        store.set(f"doc/{i}", f"text {i}")
        store.vec_set(f"doc/{i}", vecs[i])
    return vecs


def test_searcher_quantiles_in_metrics(traced):
    """tests/test_searcher.py:232, the heartbeat's SEARCH_STAGES
    quantiles and lane counters rendered by `spt metrics`."""
    name = f"/spt-tsurf-srhb-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    st = Store.create(name, nslots=256, max_val=4096, vec_dim=32)
    try:
        rng = np.random.default_rng(7)
        _fill_docs(st, 16, rng)
        sr = Searcher(st, device="cpu")
        sr.attach()
        assert not daemon_live(st)
        _search_req(st, "__sqtmp_q", k=5)
        assert sr.run_once() == 1
        sr.publish_stats()
        assert daemon_live(st)
        out = _cmd(st, "metrics", [])
        assert "sptpu_searcher_served 1" in out
        assert "sptpu_searcher_lane_full_uploads 1" in out
        # this process's kernel launches, one flat field per kernel
        # (none on the CPU: the plain versions ran)
        for name in ("fused_topk", "cosine_scores", "flash_fwd"):
            assert f"sptpu_searcher_kernel_{name} 0" in out
        for stage in P.SEARCH_STAGES:
            assert f'daemon="searcher",stage="{stage}"' in out, stage
    finally:
        st.close()
        Store.unlink(name)


def _search_with(store, vec, argv, *, searcher):
    """`search` with an embedder stand-in answering every text with
    `vec`, and (searcher=True) a live search daemon, whose heartbeat
    the test waits for before it searches."""
    sr = Searcher(store, device="cpu")
    sr.attach()
    emb = Embedder(store, encoder_fn=lambda texts: np.tile(
        vec, (len(texts), 1)))
    emb.attach()
    sr.publish_stats()                     # the heartbeat says "live"
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            emb.run_once()
            if searcher:
                sr.run_once()
                sr.publish_stats()
            time.sleep(0.005)

    t = threading.Thread(target=loop)
    t.start()
    ses = Session(store.name)
    try:
        deadline = time.monotonic() + 10
        while not daemon_live(store) and time.monotonic() < deadline:
            time.sleep(0.01)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            COMMANDS["search"][0](ses, argv)
        rows = json.loads(buf.getvalue())
    finally:
        stop.set()
        t.join()
        ses.close()
    return rows, sr, ses


def test_cli_search_dispatches_to_daemon(store):
    """tests/test_searcher.py:359: `search` routes through the live
    daemon; its dispatches prove the server-side path, and the CLI
    staged no lane of its own."""
    vecs = _fill_docs(store, 20, np.random.default_rng(11))
    rows, sr, ses = _search_with(
        store, vecs[7], ["--json", "--limit", "2", "find doc seven"],
        searcher=True)
    assert rows and rows[0]["key"] == "doc/7"
    assert rows[0]["similarity"] == pytest.approx(1.0, abs=1e-5)
    assert sr.stats.served >= 1
    assert sr.stats.dispatches >= 1
    assert ses._lane is None


def test_cli_search_local_flag_bypasses_daemon(store):
    """tests/test_searcher.py:576: --local scores client-side (here
    --cpu: K3's plain version) even with a fresh daemon heartbeat."""
    vecs = _fill_docs(store, 10, np.random.default_rng(12))
    rows, sr, _ = _search_with(
        store, vecs[2], ["--json", "--local", "--cpu", "--limit", "1",
                         "query"], searcher=False)
    assert rows and rows[0]["key"] == "doc/2"
    assert sr.stats.served == 0
    assert rows[0]["distance"] is not None
