"""The torch port's supervisor (libsplinter_tpu_torch/engine/supervisor.py)
on the CPU.

First the parity drill: the JAX package's Supervisor and the port's run
side by side on one scripted timeline (an injected clock, one seeded
backoff jitter, fake children whose exits, heartbeats and hangs the
script decides) through crashes with growing backoff, a hang, the breaker
opening, half-opening and closing, a scale-up and a scale-down with
crashes mid-drain and a straggler reclaim; every replica's snapshot, the
published __supervisor_stats, the stripe maps with their epochs and the
SERVICING row's labels are equal after every step, and so are the
children's argv up to the package prefix.

Then the port's counterparts of the JAX package's tests/test_supervisor.py
and the supervisor cases of tests/test_elastic.py, with real dummy
children (no torch import); the lane table naming only the port's lanes;
the chip pin (utils/device.py apply_chip_pin and the completer's main);
and `python -m libsplinter_tpu_torch.engine.supervisor` started from
another directory, stopped by SIGTERM with exit 0 and no child left.
The `spt metrics` rendering of the supervisor heartbeat is held by
tests/test_torch_cli_surfaces.py."""
from __future__ import annotations

import json
import logging
import os
import random
import signal
import subprocess
import sys
import time
import types
import uuid
from pathlib import Path

import pytest
import torch

import libsplinter_tpu
from libsplinter_tpu.engine import protocol as JP
from libsplinter_tpu.engine import supervisor as jsup

from libsplinter_tpu_torch import Store
from libsplinter_tpu_torch.engine import protocol as P
from libsplinter_tpu_torch.engine import supervisor as tsup
from libsplinter_tpu_torch.engine.supervisor import (LANES, LaneSpec,
                                                     Supervisor,
                                                     parse_chip_pins,
                                                     parse_scale_spec)
from libsplinter_tpu_torch.utils import device as tdevice

pytestmark = pytest.mark.chaos

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def sstore():
    name = f"/spt-tsup-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=128, max_val=4096, vec_dim=8)
    yield st
    st.close()
    Store.unlink(name)


def _crasher(code=7):
    def spawn(lane):
        return subprocess.Popen(
            [sys.executable, "-c", f"import sys; sys.exit({code})"])
    return spawn


def _sleeper():
    def spawn(lane):
        return subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(600)"])
    return spawn


def _poll_until(sup, cond, *, timeout=15.0, dt=0.02,
                between=None) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        sup.poll_once()
        if between is not None:
            between()
        if cond():
            return True
        time.sleep(dt)
    return False


# ------------------------------------------------------------ parity drill

class _FakeProc:
    """A child whose life the timeline scripts: alive until the script
    (or the supervisor's kill / terminate) sets its exit code."""

    def __init__(self, world, argv, env):
        world.pid += 1
        self.pid = world.pid
        self.argv, self.env = list(argv), dict(env)
        self.rc = None

    def poll(self):
        return self.rc

    def kill(self):
        if self.rc is None:
            self.rc = -signal.SIGKILL

    def terminate(self):
        if self.rc is None:
            self.rc = -signal.SIGTERM

    def wait(self, timeout=None):
        return self.rc


class _Side:
    """One package's Supervisor on its own store, its children spawned
    through the module's real _spawn_child with Popen faked."""

    def __init__(self, mod, proto, store_cls, monkeypatch, **kw):
        self.P = proto
        self.name = f"/spt-tpar-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.store = store_cls.create(self.name, nslots=128, max_val=4096,
                                      vec_dim=8)
        self.pid = 1000
        self.spawned: list[_FakeProc] = []

        def popen(argv, env=None, **_):
            proc = _FakeProc(self, argv, env or {})
            self.spawned.append(proc)
            return proc

        monkeypatch.setattr(mod, "subprocess",
                            types.SimpleNamespace(Popen=popen))
        self.sup = mod.Supervisor(self.name, store=self.store,
                                  clock=lambda: 0.0, **kw)
        self.sup._rng = random.Random(1234)

    def close(self):
        self.store.close()
        type(self.store).unlink(self.name)

    def act(self, ev):
        kind, *a = ev
        sup, P = self.sup, self.P
        if kind == "hb":
            lane, r = a
            P.publish_heartbeat(self.store,
                                sup.replicas[lane][r].heartbeat_key,
                                {"served": 0})
        elif kind == "exit":
            lane, r, code = a
            sup.replicas[lane][r].proc.rc = code
        elif kind == "scale":
            lane, r = a
            P.write_scale_target(self.store, lane, r, src="manual")
        elif kind == "claim":
            key, = a
            self.store.set(key, "prompt bytes")
            self.store.label_or(key, P.LBL_SERVICING)

    def state(self, claim_keys):
        sup, P = self.sup, self.P
        reps = {lane: {r: (ln.snapshot(), ln.state, ln.retiring,
                           ln.pending_stripes, ln.closed_stripes)
                       for r, ln in sorted(reps.items())}
                for lane, reps in sup.replicas.items()}
        stats = json.loads(self.store.get(
            P.KEY_SUPERVISOR_STATS).rstrip(b"\0"))
        stats.pop("ts")
        maps = {}
        for lane in sup.replicas:
            rec = P.read_stripe_map(self.store, lane)
            if rec is not None:
                rec.pop("ts")             # the write's wall clock
            maps[lane] = rec
        labels = {k: self.store.labels(k) for k in claim_keys}
        return reps, stats, maps, labels


def _r1_key(side):
    """A key whose slot falls in the completer's replica-1 stripes."""
    rec = side.P.read_stripe_map(side.store, "completer")
    owned = set(rec["owners"]["1"])
    for i in range(256):
        key = f"claim{i}"
        side.store.set(key, "x")
        idx = side.store.find_index(key)
        side.store.unset(key)
        if side.P.stripe_of(idx, rec["width"]) in owned:
            return key
    raise AssertionError("no key lands in replica 1's stripes")


def test_supervisor_parity_with_jax_package(monkeypatch):
    """The JAX package's Supervisor and the port's, one scripted
    timeline: every snapshot, the heartbeat, the stripe maps and their
    epochs equal after each step; argv equal up to the package."""
    monkeypatch.setenv("SPTPU_FAULT", "searcher.gather:crash@1")
    kw = dict(lanes=("embedder", "searcher", "completer"),
              lane_args={"completer": ["--device", "cpu"],
                         "embedder": ["--device", "cpu"]},
              backoff_base_ms=1000.0, backoff_max_ms=8000.0,
              breaker_threshold=3, breaker_window_s=100.0,
              breaker_cooldown_s=30.0, heartbeat_timeout_s=1e6,
              startup_grace_s=20.0, healthy_after_s=5.0,
              scale={"embedder": (1, 3), "completer": (1, 2)},
              scale_knobs={"up_threshold": 4.0}, drain_deadline_s=10.0,
              chip_pins={"completer": "0"})
    ref = _Side(jsup, JP, libsplinter_tpu.Store, monkeypatch, **kw)
    port = _Side(tsup, P, Store, monkeypatch, **kw)
    timeline = [
        (0, []),
        (1, [("hb", "embedder", 0), ("hb", "searcher", 0)]),
        (2, [("exit", "searcher", 0, 7)]),                 # backoff
        (4, []),                                           # respawn
        (5, [("exit", "searcher", 0, 7)]),                 # 2nd crash
        (9, []),
        (10, [("exit", "searcher", 0, 7)]),                # breaker opens
        (21, []),                  # the completer never beat: hung kill
        (23, []),
        (24, [("hb", "completer", 0)]),
        (41, []),                                          # half-open probe
        (42, [("hb", "searcher", 0)]),
        (48, []),                                          # breaker closes
        (50, [("scale", "embedder", 3)]),                  # 2 pending
        (51, [("hb", "embedder", 1), ("hb", "embedder", 2)]),  # promoted
        (52, [("scale", "completer", 2)]),
        (53, [("hb", "completer", 1)]),
        (54, ["claim"]),           # a SERVICING row in replica 1's stripes
        (55, [("scale", "embedder", 1), ("scale", "completer", 1)]),
        (56, [("exit", "embedder", 2, -9),                 # crash mid-drain
              ("exit", "completer", 1, -9)]),
        (67, []),                  # r1 past its drain deadline: reaped
        (68, []),
    ]
    claims = []
    seen = set()
    try:
        for t, events in timeline:
            for ev in events:
                if ev == "claim":
                    key = _r1_key(port)
                    claims.append(key)
                    ev = ("claim", key)
                for side in (ref, port):
                    side.act(ev)
            ref.sup.poll_once(now=float(t))
            port.sup.poll_once(now=float(t))
            want, got = ref.state(claims), port.state(claims)
            assert got == want, f"t={t}"
            for reps in port.sup.replicas.values():
                for ln in reps.values():
                    seen.add(ln.state)
        # the timeline went through every state and path it names
        emb = port.sup.replicas["embedder"]
        srch, comp = port.sup.lanes["searcher"], port.sup.lanes["completer"]
        assert {"starting", "running", "backoff", "down"} <= seen
        assert srch.breaker_opens == 1 and srch.consecutive == 0
        assert srch.state == "running" and srch.restarts == 3
        assert comp.hung_kills == 1 and comp.last_exit == -signal.SIGKILL
        assert sorted(emb) == [0] and port.sup.retired == 3
        assert port.sup.scale_events == 4
        lab = port.store.labels(claims[0])
        assert lab & P.LBL_WAITING and lab & P.LBL_INFER_REQ
        assert not lab & P.LBL_SERVICING
        # the children's argv: the same up to the package prefix
        assert len(port.spawned) == len(ref.spawned) == 10
        for a, b in zip(ref.spawned, port.spawned):
            assert a.argv[1:2] == b.argv[1:2] == ["-m"]
            assert b.argv[2].startswith("libsplinter_tpu_torch.engine.")
            assert [x.replace("libsplinter_tpu_torch.", "libsplinter_tpu.")
                    .replace(port.name, ref.name)
                    for x in b.argv[2:]] == a.argv[2:]
            for var in ("SPTPU_FAULT", "SPTPU_CHIP_PIN"):
                assert a.env.get(var) == b.env.get(var)
            assert b.env["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT)
        # generation 1 of each lane had the fault, respawns not
        assert sum("SPTPU_FAULT" in p.env for p in port.spawned) == 3
    finally:
        for side in (ref, port):
            side.sup.shutdown()
            side.close()


# -------------------------------------- the JAX package's supervisor tests

def test_crash_restarts_with_growing_backoff(sstore):
    sup = Supervisor(sstore.name, lanes=("searcher",),
                     spawn_fn=_crasher(), store=sstore,
                     backoff_base_ms=40, backoff_max_ms=10_000,
                     breaker_threshold=100, breaker_window_s=60)
    try:
        backoffs = []
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and len(backoffs) < 4:
            sup.poll_once()
            ln = sup.lanes["searcher"]
            if ln.state == "backoff" and (not backoffs
                                          or ln.backoff_ms != backoffs[-1]):
                backoffs.append(ln.backoff_ms)
            time.sleep(0.02)
        ln = sup.lanes["searcher"]
        assert ln.restarts >= 2
        assert ln.last_exit == 7
        assert len(backoffs) >= 4
        # crash k's backoff is base*2^(k-1)*U(0.5,1.5), so
        # backoff[k+2] > backoff[k] always
        for a, b in zip(backoffs, backoffs[2:]):
            assert b > a
    finally:
        sup.shutdown()


def test_breaker_opens_and_marks_lane_down(sstore):
    from libsplinter_tpu_torch.engine.searcher import daemon_live

    sup = Supervisor(sstore.name, lanes=("searcher",),
                     spawn_fn=_crasher(), store=sstore,
                     backoff_base_ms=5, breaker_threshold=3,
                     breaker_window_s=30, breaker_cooldown_s=600)
    try:
        ln = sup.lanes["searcher"]
        assert _poll_until(sup, lambda: ln.state == "down")
        assert ln.breaker_opens == 1
        # lane_down True, and daemon_live refuses dispatch even with a
        # fresh searcher heartbeat on the store
        assert P.lane_down(sstore, "searcher")
        P.publish_heartbeat(sstore, P.KEY_SEARCH_STATS, {"served": 0})
        assert not daemon_live(sstore)
        assert not P.lane_down(sstore, "embedder")
    finally:
        sup.shutdown()


def test_breaker_half_open_probe_closes_on_health(sstore):
    calls = {"n": 0}

    def spawn(lane):
        calls["n"] += 1
        if calls["n"] <= 3:
            return subprocess.Popen(
                [sys.executable, "-c", "import sys; sys.exit(9)"])
        return subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(600)"])

    sup = Supervisor(sstore.name, lanes=("searcher",), spawn_fn=spawn,
                     store=sstore, backoff_base_ms=5,
                     breaker_threshold=3, breaker_window_s=30,
                     breaker_cooldown_s=0.2, healthy_after_s=0.1,
                     startup_grace_s=600)
    try:
        ln = sup.lanes["searcher"]
        assert _poll_until(sup, lambda: ln.breaker_opens == 1)
        assert _poll_until(
            sup,
            lambda: (ln.state == "running" and not ln.half_open
                     and ln.consecutive == 0),
            between=lambda: P.publish_heartbeat(
                sstore, P.KEY_SEARCH_STATS, {}),
            dt=0.05)
        assert not P.lane_down(sstore, "searcher")
    finally:
        sup.shutdown()


def test_hung_heartbeat_gets_killed_and_restarted(sstore):
    sup = Supervisor(sstore.name, lanes=("embedder",),
                     spawn_fn=_sleeper(), store=sstore,
                     backoff_base_ms=5, breaker_threshold=50,
                     heartbeat_timeout_s=0.2, startup_grace_s=0.2)
    try:
        assert _poll_until(sup,
                           lambda: sup.lanes["embedder"].hung_kills >= 1,
                           timeout=10, dt=0.05)
        assert sup.lanes["embedder"].last_exit == -9
    finally:
        sup.shutdown()


def test_fault_env_stripped_from_respawns(sstore, monkeypatch):
    monkeypatch.setenv("SPTPU_FAULT", "searcher.gather:crash@1")
    sup = Supervisor(sstore.name, lanes=("searcher",),
                     spawn_fn=_crasher(), store=sstore)
    ln = sup.lanes["searcher"]
    ln.generation = 1
    assert "SPTPU_FAULT" in sup._child_env(ln)
    ln.generation = 2
    assert "SPTPU_FAULT" not in sup._child_env(ln)
    keep = Supervisor(sstore.name, lanes=("searcher",),
                      spawn_fn=_crasher(), store=sstore,
                      keep_faults=True)
    keep.lanes["searcher"].generation = 2
    assert "SPTPU_FAULT" in keep._child_env(keep.lanes["searcher"])


def test_supervisor_heartbeat(sstore):
    """Restart/backoff/breaker counters publish in __supervisor_stats
    (its `spt metrics` exposition: tests/test_torch_cli_surfaces.py)."""
    sup = Supervisor(sstore.name, lanes=("searcher", "embedder"),
                     spawn_fn=_crasher(), store=sstore,
                     backoff_base_ms=5, breaker_threshold=3,
                     breaker_window_s=30, breaker_cooldown_s=600)
    try:
        assert _poll_until(
            sup, lambda: all(ln.state == "down"
                             for ln in sup.lanes.values()))
        snap = json.loads(sstore.get(P.KEY_SUPERVISOR_STATS).rstrip(b"\0"))
        assert snap["pid"] == os.getpid()
        assert snap["polls"] == sup.polls
        for lane in ("searcher", "embedder"):
            sec = snap["lanes"][lane]
            assert sec["state"] == "down"
            assert sec["restarts"] >= 2
            assert sec["breaker_opens"] == 1
    finally:
        sup.shutdown()


def test_poll_fault_site_live_and_survivable(sstore):
    from libsplinter_tpu_torch.utils import faults

    sup = Supervisor(sstore.name, lanes=("searcher",),
                     spawn_fn=_sleeper(), store=sstore)
    faults.arm("supervisor.poll:raise@1")
    try:
        assert faults.registered_sites() == ("supervisor.poll",)
        with pytest.raises(faults.FaultInjected):
            sup.poll_once()
        sup.poll_once()
        assert sup.polls == 1
        assert sup.lanes["searcher"].proc is not None
    finally:
        faults.disarm()
        sup.shutdown()


def test_reclaim_closed_respects_handoff_sides(sstore):
    st = sstore
    sup = Supervisor(st.name, lanes=("prefill", "decode"),
                     spawn_fn=_sleeper(), store=st)
    all_stripes = tuple(range(P.DEFAULT_STRIPE_WIDTH))
    st.set("adopted", "prompt bytes")
    st.label_or("adopted", P.LBL_SERVICING | P.LBL_DECODE_READY)
    aidx = st.find_index("adopted")
    assert P.write_handoff_record(st, aidx, {
        "len": 3, "ids": [1, 2, 3], "carry": 5, "n_tok": 1,
        "remaining": 7, "disp_left": 7,
        "plen": st.value_len("adopted"), "t0": 0, "tenant": 0,
        "deadline": None, "wire_pages": 0, "quant": False})
    st.set("claim", "prompt bytes")
    st.label_or("claim", P.LBL_SERVICING)

    assert sup._reclaim_closed("prefill", all_stripes) == 1
    labels = st.labels("adopted")
    assert labels & P.LBL_SERVICING and labels & P.LBL_DECODE_READY
    assert P.read_handoff_record(st, aidx) is not None
    labels = st.labels("claim")
    assert labels & P.LBL_WAITING and not labels & P.LBL_SERVICING

    st.label_clear("claim", P.LBL_WAITING | P.LBL_INFER_REQ)
    st.label_or("claim", P.LBL_SERVICING)
    assert sup._reclaim_closed("decode", all_stripes) == 1
    labels = st.labels("claim")
    assert labels & P.LBL_SERVICING and not labels & P.LBL_WAITING
    labels = st.labels("adopted")
    assert labels & P.LBL_DECODE_READY
    assert not labels & P.LBL_SERVICING
    assert P.read_handoff_record(st, aidx) is not None


def test_unknown_lane_rejected(sstore):
    with pytest.raises(ValueError):
        Supervisor(sstore.name, lanes=("warp-drive",), store=sstore)


def test_shutdown_terminates_children(sstore):
    sup = Supervisor(sstore.name, lanes=("completer",),
                     spawn_fn=_sleeper(), store=sstore)
    sup.poll_once()
    pid = sup.lanes["completer"].pid
    assert pid and P.pid_alive(pid)
    sup.shutdown()
    deadline = time.monotonic() + 5
    while P.pid_alive(pid) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not P.pid_alive(pid)
    assert sup.lanes["completer"].state == "init"


# ------------------------------------ the supervisor cases of test_elastic

def test_lane_table_names_only_the_port():
    assert isinstance(LANES["embedder"], LaneSpec)
    assert set(LANES) == set(jsup.LANES)
    for name, spec in LANES.items():
        want = jsup.LANES[name]
        assert spec.module == want.module.replace(
            "libsplinter_tpu.", "libsplinter_tpu_torch.")
        assert (spec.heartbeat_key, spec.max_replicas, spec.args) == \
            (want.heartbeat_key, want.max_replicas, want.args)
    assert LANES["embedder"].max_replicas > 1
    assert LANES["telemetry"].max_replicas == 1
    assert LANES["prefill"].args == ("--phase", "prefill")
    assert LANES["decode"].args == ("--phase", "decode")


def test_parse_scale_spec():
    assert parse_scale_spec(["embedder=1:4"]) == {"embedder": (1, 4)}
    assert parse_scale_spec(["searcher=3"]) == {"searcher": (1, 3)}
    for bad in ("embedder", "embedder=", "embedder=4:1", "embedder=0:4",
                "=1:2", "embeder=1:4", "telemetry=1:2"):
        with pytest.raises(ValueError):
            parse_scale_spec([bad])


def test_parse_chip_pins():
    assert parse_chip_pins("prefill=0, decode=1") == {"prefill": "0",
                                                      "decode": "1"}
    assert parse_chip_pins("") == {}
    for bad in ("prefill", "prefill=", "=0", "warp=0"):
        with pytest.raises(ValueError):
            parse_chip_pins(bad)


def test_scale_up_spawns_and_stripes(sstore):
    store = sstore
    sup = Supervisor(store.name, lanes=("embedder",), spawn_fn=_sleeper(),
                     store=store, scale={"embedder": (1, 4)},
                     scale_knobs={"up_threshold": 4.0})
    try:
        pol = P.read_scale_policy(store)
        assert pol["lanes"]["embedder"] == {"min": 1, "max": 4,
                                            "signal": "queue"}
        assert pol["up_threshold"] == 4.0
        P.write_scale_target(store, "embedder", 3, src="manual")
        sup.poll_once()
        assert sorted(sup.replicas["embedder"]) == [0, 1, 2]
        for r, ln in sup.replicas["embedder"].items():
            assert ln.pid and ln.replica == r
        rec = P.read_stripe_map(store, "embedder")
        assert set(rec["owners"]) == {"0"}
        assert rec["closed"] == []
        assert set(rec["pending"]) == {"1", "2"}
        owned = {s for ss in rec["owners"].values() for s in ss}
        assert owned == set(range(rec["width"]))
        for r in (1, 2):
            P.publish_heartbeat(
                store, P.replica_stats_key(P.KEY_EMBED_STATS, r),
                {"embedded": 0})
        sup.poll_once()
        rec = P.read_stripe_map(store, "embedder")
        seen = sorted(s for ss in rec["owners"].values() for s in ss)
        assert seen == list(range(rec["width"]))
        assert set(rec["owners"]) == {"0", "1", "2"}
        snap = json.loads(store.get(P.KEY_SUPERVISOR_STATS).rstrip(b"\0"))
        assert snap["lanes"]["embedder"]["r"] == 3
        assert "1" in snap["lanes"]["embedder"]["replicas"]
        P.write_scale_target(store, "embedder", 99, src="manual")
        sup.poll_once()
        assert len(sup.replicas["embedder"]) == 4
    finally:
        sup.shutdown()


def test_scale_down_drain_then_reap(sstore):
    store = sstore
    sup = Supervisor(store.name, lanes=("embedder",), spawn_fn=_sleeper(),
                     store=store, scale={"embedder": (1, 4)},
                     drain_deadline_s=0.3)
    try:
        P.write_scale_target(store, "embedder", 3, src="manual")
        sup.poll_once()
        for r in (1, 2):
            P.publish_heartbeat(
                store, P.replica_stats_key(P.KEY_EMBED_STATS, r),
                {"embedded": 0})
        sup.poll_once()
        P.write_scale_target(store, "embedder", 1, src="manual")
        sup.poll_once()
        retiring = [ln for ln in sup.replicas["embedder"].values()
                    if ln.retiring]
        assert len(retiring) == 2
        rec = P.read_stripe_map(store, "embedder")
        closed = set(rec["closed"])
        owned = {s for ss in rec["owners"].values() for s in ss}
        assert closed and owned | closed == set(range(rec["width"]))
        assert not owned & closed
        assert _poll_until(sup, lambda: len(sup.replicas["embedder"]) == 1,
                           timeout=10, dt=0.05)
        assert sup.retired == 2
        assert P.read_stripe_map(store, "embedder") is None
    finally:
        sup.shutdown()


def test_reclaim_strands_nothing_on_crash_mid_scale_down(sstore):
    store = sstore
    sup = Supervisor(store.name, lanes=("completer",), spawn_fn=_sleeper(),
                     store=store, scale={"completer": (1, 4)},
                     drain_deadline_s=5.0)
    try:
        P.write_scale_target(store, "completer", 2, src="manual")
        sup.poll_once()
        P.publish_heartbeat(
            store, P.replica_stats_key(P.KEY_COMPLETE_STATS, 1),
            {"completions": 0})
        sup.poll_once()
        rec = P.read_stripe_map(store, "completer")
        r1_stripes = set(rec["owners"]["1"])
        key = None
        for i in range(64):
            store.set(f"k{i}", "prompt")
            idx = store.find_index(f"k{i}")
            if P.stripe_of(idx, rec["width"]) in r1_stripes:
                key = f"k{i}"
                break
            store.unset(f"k{i}")
        assert key is not None
        store.label_or(key, P.LBL_SERVICING)
        P.write_scale_target(store, "completer", 1, src="manual")
        sup.poll_once()
        ln = next(ln for ln in sup.replicas["completer"].values()
                  if ln.retiring)
        ln.proc.kill()
        assert _poll_until(sup,
                           lambda: len(sup.replicas["completer"]) == 1,
                           timeout=10, dt=0.05)
        labels = store.labels(key)
        assert not labels & P.LBL_SERVICING
        assert labels & P.LBL_INFER_REQ and labels & P.LBL_WAITING
    finally:
        sup.shutdown()


def test_retire_fault_site_live_and_survivable(sstore):
    from libsplinter_tpu_torch.utils import faults

    store = sstore
    sup = Supervisor(store.name, lanes=("embedder",), spawn_fn=_sleeper(),
                     store=store, scale={"embedder": (1, 3)},
                     drain_deadline_s=0.1)
    faults.arm("supervisor.retire:raise@1")
    try:
        P.write_scale_target(store, "embedder", 2, src="manual")
        sup.poll_once()
        assert len(sup.replicas["embedder"]) == 2
        P.write_scale_target(store, "embedder", 1, src="manual")
        with pytest.raises(faults.FaultInjected):
            sup.poll_once()
        sup.poll_once()
        assert _poll_until(sup, lambda: len(sup.replicas["embedder"]) == 1,
                           timeout=10, dt=0.05)
    finally:
        faults.disarm()
        sup.shutdown()


# ------------------------------------------------------------- chip pin

@pytest.mark.parametrize("spec", ["", "x", "1.5", "-1", None])
def test_chip_pin_unparsable_keeps_the_device(spec, monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda n: pytest.fail(
        "set_device called for a bad pin"))
    with caplog.at_level(logging.WARNING):
        assert tdevice.apply_chip_pin(spec, "cuda") == torch.device("cuda")
    assert "SPTPU_CHIP_PIN" in caplog.text


def test_chip_pin_out_of_range_keeps_default_card(monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda n: pytest.fail(
        "set_device called for an out-of-range pin"))
    with caplog.at_level(logging.WARNING):
        dev = tdevice.apply_chip_pin("3", "cuda")
    assert dev == torch.device("cuda")
    assert "out of range" in caplog.text


def test_chip_pin_valid_ordinal_sets_the_card(monkeypatch):
    picked = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    assert tdevice.apply_chip_pin(" 2 ", "cuda") == torch.device("cuda", 2)
    assert picked == [2]


def test_chip_pin_never_moves_a_lane_to_the_cpu(monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda n: pytest.fail(
        "set_device called for a CPU lane"))
    with caplog.at_level(logging.INFO):
        assert tdevice.apply_chip_pin("1", "cpu") == torch.device("cpu")
    assert "ignored" in caplog.text


def test_completer_main_applies_the_pin(sstore, monkeypatch):
    """completer.main reads SPTPU_CHIP_PIN before it builds its model and
    builds the model on the device the pin gives."""
    from libsplinter_tpu_torch.engine import completer as comp_mod
    from libsplinter_tpu_torch.models import decoder as tdec

    seen = {}

    def pin(spec, device):
        seen["pin"] = (spec, device)
        return torch.device("cpu")

    class Stop(Exception):
        pass

    def model(cfg, **kw):
        seen["device"] = kw["device"]
        raise Stop

    monkeypatch.setenv("SPTPU_CHIP_PIN", "0")
    monkeypatch.setattr(tdevice, "apply_chip_pin", pin)
    monkeypatch.setattr(tdec, "CompletionModel", model)
    import libsplinter_tpu_torch.models as models
    monkeypatch.setattr(models, "CompletionModel", model)
    with pytest.raises(Stop):
        comp_mod.main(["--store", sstore.name, "--device", "cuda",
                       "--oneshot"])
    assert seen == {"pin": ("0", "cuda"), "device": "cpu"}


# ------------------------------------------------------------- the daemon

def test_main_spawns_port_lanes_and_exits_zero_on_sigterm(sstore, tmp_path):
    """`python -m libsplinter_tpu_torch.engine.supervisor` started from a
    directory that does not hold the package: its torch-free lanes come
    up (they find the package through PYTHONPATH), and SIGTERM ends it
    with exit 0 and no child left."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("SPTPU_FAULT", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "libsplinter_tpu_torch.engine.supervisor",
         "--store", sstore.name, "--lanes", "telemetry,autoscaler",
         "--poll-interval-s", "0.1", "--telemetry-args",
         "--interval-s 0.2"],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        pids = {}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and len(pids) < 2:
            try:
                snap = json.loads(
                    sstore.get(P.KEY_SUPERVISOR_STATS).rstrip(b"\0"))
                pids = {n: s["pid"] for n, s in snap["lanes"].items()
                        if s["state"] in ("starting", "running")
                        and s["pid"]}
            except (KeyError, ValueError):
                pass
            time.sleep(0.2)
        assert len(pids) == 2, proc.stderr.read() if proc.poll() else pids
        for name, pid in pids.items():
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes().split(b"\0")
            assert cmd[1:3] == [
                b"-m", f"libsplinter_tpu_torch.engine.{name}".encode()]
        # both lanes heartbeat from their own processes
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                P.heartbeat_live(sstore, P.KEY_TELEMETRY_STATS)
                and P.heartbeat_live(sstore, P.KEY_AUTOSCALER_STATS)):
            time.sleep(0.2)
        assert P.heartbeat_live(sstore, P.KEY_TELEMETRY_STATS)
        assert P.heartbeat_live(sstore, P.KEY_AUTOSCALER_STATS)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        for pid in pids.values():
            assert not P.pid_alive(pid)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
