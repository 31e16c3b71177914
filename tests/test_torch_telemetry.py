"""The control-plane lanes copied verbatim from the JAX package into the
torch port, engine/telemetry.py and engine/autoscaler.py, held by the
port's counterparts of the JAX package's tests/test_telemetry.py (the
sampler's store-resident rings, the supervised restart keeping them, run
through the port's supervisor) and of the autoscaler cases of
tests/test_elastic.py (hysteresis, cooldown, stale samples, shed votes,
manual holds, the pool signal's readmit discount, the heartbeat).  The
cases that render through `spt metrics`, `spt top` and `spt scale` are
in tests/test_torch_cli_surfaces.py."""
import json
import os
import time
import uuid

import pytest

from libsplinter_tpu_torch import Store
from libsplinter_tpu_torch.engine import protocol as P
from libsplinter_tpu_torch.engine.autoscaler import AutoScaler
from libsplinter_tpu_torch.engine.telemetry import (SCRAPE_LANES,
                                                    TelemetrySampler,
                                                    read_history)


@pytest.fixture
def store():
    name = f"/spt-ttel-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=256, max_val=1024, vec_dim=32)
    yield st
    st.close()
    Store.unlink(name)


def _fake_heartbeat(store, key, **fields):
    P.publish_heartbeat(store, key, dict(fields))


class TestSampler:
    def test_rings_accumulate_counters_and_queue_depth(self, store):
        _fake_heartbeat(store, P.KEY_EMBED_STATS, shed=2, deferred=1,
                        deadline_expired=0, embedded=42)
        for i in range(3):
            store.set(f"q{i}", "waiting")
            store.label_or(f"q{i}", P.LBL_EMBED_REQ)
        tel = TelemetrySampler(store, interval_s=0.1)
        tel.attach()
        assert tel.sample_once() >= 1
        hist = read_history(store, "embedder")
        assert hist is not None
        g = hist["gauges"]
        assert g["queue_depth"][-1][1] == 3.0     # measured, not told
        assert g["shed"][-1][1] == 2.0
        assert g["progress"][-1][1] == 42.0       # embedded
        assert tel.stats.samples == 1
        # every scrape lane gets a ring (gauge floor: queue_depth)
        for lane in SCRAPE_LANES:
            assert read_history(store, lane) is not None

    def test_ring_len_bounded(self, store):
        _fake_heartbeat(store, P.KEY_SEARCH_STATS, shed=0, served=1)
        tel = TelemetrySampler(store, interval_s=0.1, ring_len=4)
        tel.attach()
        for k in range(10):
            tel.sample_once(now=1000.0 + k)
        g = read_history(store, "searcher")["gauges"]
        assert len(g["queue_depth"]) == 4
        assert g["queue_depth"][0][0] == 1006.0   # oldest retained

    def test_stage_p99_and_tenant_gauges(self, store):
        _fake_heartbeat(
            store, P.KEY_SCRIPT_STATS, scripts_completed=5,
            quantiles={"e2e": {"p99_ms": 12.5},
                       "exec": {"p99_ms": 3.25}},
            tenants={"1": {"admitted": 7, "served_tokens": 90}})
        tel = TelemetrySampler(store)
        tel.attach()
        tel.sample_once()
        g = read_history(store, "pipeliner")["gauges"]
        assert g["p99_e2e_ms"][-1][1] == 12.5
        assert g["p99_exec_ms"][-1][1] == 3.25
        assert g["tenant1_admitted"][-1][1] == 7.0
        assert g["tenant1_served_tokens"][-1][1] == 90.0

    def test_restart_resumes_rings_in_store(self, store):
        """The acceptance property: rings are STORE state — a new
        sampler generation appends to the history the dead one
        left."""
        _fake_heartbeat(store, P.KEY_EMBED_STATS, embedded=1)
        t1 = TelemetrySampler(store)
        t1.attach()
        for k in range(3):
            t1.sample_once(now=2000.0 + k)
        gen1 = t1.generation
        del t1                                    # the "crash"
        t2 = TelemetrySampler(store)
        t2.attach()                               # the restart
        assert t2.generation == gen1 + 1
        t2.sample_once(now=2010.0)
        ring = read_history(store, "embedder")["gauges"]["queue_depth"]
        assert len(ring) == 4                     # 3 old + 1 new
        assert ring[0][0] == 2000.0

    def test_oversized_ring_shrinks_not_drops(self, tmp_path):
        name = f"/spt-tele-{tmp_path.name}"
        Store.unlink(name)
        st = Store.create(name, nslots=64, max_val=256, vec_dim=0)
        try:
            _fake_heartbeat(st, P.KEY_EMBED_STATS, shed=1, deferred=2,
                            deadline_expired=3, embedded=4)
            tel = TelemetrySampler(st, ring_len=64)
            tel.attach()
            for k in range(40):
                tel.sample_once(now=3000.0 + k)
            hist = read_history(st, "embedder")
            assert hist is not None               # still renders
            assert tel.stats.shrinks > 0          # degraded, not lost
            assert tel.stats.write_errors == 0
            for ring in hist["gauges"].values():
                assert 1 <= len(ring) < 64
        finally:
            st.close()
            Store.unlink(name)

    def test_sampler_heartbeat_publishes(self, store):
        tel = TelemetrySampler(store)
        tel.attach()
        tel.sample_once()
        tel.publish_stats()
        snap = json.loads(
            store.get(P.KEY_TELEMETRY_STATS).rstrip(b"\0"))
        assert snap["samples"] == 1
        assert snap["generation"] == tel.generation
        assert snap["points"] > 0



_ring_ticks = iter(range(1, 1_000_000))


def _ring(store, lane, queue_vals, shed_vals=None):
    # every write is a FRESH sampler tick (distinct point ts): the
    # controller's stale-sample guard refuses to re-count a point
    base = float(next(_ring_ticks)) * 100.0
    gauges = {"queue_depth": [[base + i, float(v)]
                              for i, v in enumerate(queue_vals)]}
    if shed_vals is not None:
        gauges["shed"] = [[base + i, float(v)]
                          for i, v in enumerate(shed_vals)]
    store.set(P.telemetry_key(lane), json.dumps(
        {"v": 1, "lane": lane, "interval_s": 0.1, "n": 1,
         "ts": time.time(), "gauges": gauges}))


def _policy(store, lane="embedder", lo=1, hi=4):
    store.set(P.KEY_SCALE_POLICY, json.dumps(
        {"v": 1, "lanes": {lane: {"min": lo, "max": hi}}}))


def _pool_policy(store, lane="decode", lo=1, hi=4):
    store.set(P.KEY_SCALE_POLICY, json.dumps(
        {"v": 1, "lanes": {lane: {"min": lo, "max": hi,
                                  "signal": "pool"}}}))


def _pool_ring(store, lane, occ, readmits=None, used=60.0,
               free=40.0):
    """One fresh pool-signal sampler tick: occupancy plus the pool
    size gauges, and optionally a (prev, last) tier_readmits counter
    pair — the inputs of the PR 20 readmit discount."""
    base = float(next(_ring_ticks)) * 100.0
    gauges = {"queue_depth": [[base, 0.0]],
              "pool_occ": [[base, float(occ)]],
              "pages_used": [[base, float(used)]],
              "pages_free": [[base, float(free)]]}
    if readmits is not None:
        gauges["tier_readmits"] = [
            [base - 1.0, float(readmits[0])],
            [base, float(readmits[1])]]
    store.set(P.telemetry_key(lane), json.dumps(
        {"v": 1, "lane": lane, "interval_s": 0.1, "n": 1,
         "ts": time.time(), "gauges": gauges}))


def _sup_stats(store, lane="embedder", r=1):
    P.publish_heartbeat(store, P.KEY_SUPERVISOR_STATS,
                        {"polls": 1, "lanes": {lane: {
                            "state": "running", "r": r}}})


class TestAutoscaler:
    def test_scale_up_sizes_to_backlog_in_one_action(self, store):
        _policy(store)
        _sup_stats(store, r=1)
        ctl = AutoScaler(store, up_threshold=8.0, up_consecutive=2,
                         cooldown_s=0.0)
        _ring(store, "embedder", [32.0])
        assert ctl.decide_once(0.0) == 0     # streak 1: not yet
        _ring(store, "embedder", [32.0])     # a fresh sampler tick
        assert ctl.decide_once(1.0) == 1     # sustained: act
        tgt = P.read_scale_targets(store)["embedder"]
        assert tgt["r"] == 4 and tgt["src"] == "auto"  # ceil(32/8)
        assert ctl.stats.scale_ups == 1

    def test_no_flap_on_oscillating_input(self, store):
        """The hysteresis acceptance: a queue oscillating between
        pressure and idle every sample never moves the target."""
        _policy(store)
        _sup_stats(store, r=2)
        ctl = AutoScaler(store, up_threshold=8.0, down_threshold=1.0,
                         up_consecutive=2, down_consecutive=3,
                         cooldown_s=0.0)
        for i in range(12):
            _ring(store, "embedder",
                  [40.0 if i % 2 == 0 else 0.0])
            ctl.decide_once(float(i))
        assert ctl.stats.decisions == 0
        assert "embedder" not in P.read_scale_targets(store)

    def test_scale_down_slow_with_cooldown(self, store):
        _policy(store)
        _sup_stats(store, r=3)
        ctl = AutoScaler(store, up_threshold=8.0, down_threshold=1.0,
                         down_consecutive=3, cooldown_s=100.0)
        for i in range(8):
            _ring(store, "embedder", [0.0])
            ctl.decide_once(float(i))
        # one step down only (by ONE replica), then cooldown holds
        assert ctl.stats.scale_downs == 1
        assert P.read_scale_targets(store)["embedder"]["r"] == 2

    def test_stale_sample_never_recounted(self, store):
        """A controller ticking FASTER than the sampler must not
        turn one pressured telemetry point into a consecutive run —
        the streaks pause until a fresh sample lands."""
        _policy(store)
        _sup_stats(store, r=1)
        ctl = AutoScaler(store, up_threshold=8.0, up_consecutive=2,
                         cooldown_s=0.0)
        _ring(store, "embedder", [64.0])     # ONE pressured sample
        for i in range(6):                   # re-read 6x: no action
            assert ctl.decide_once(float(i)) == 0
        assert ctl.stats.decisions == 0
        _ring(store, "embedder", [64.0])     # the SECOND real sample
        assert ctl.decide_once(7.0) == 1     # now it is sustained

    def test_shed_movement_votes_up(self, store):
        _policy(store)
        _sup_stats(store, r=1)
        ctl = AutoScaler(store, up_threshold=100.0,  # queue never
                         up_consecutive=2, cooldown_s=0.0)
        _ring(store, "embedder", [2.0], shed_vals=[0.0])
        ctl.decide_once(0.0)
        _ring(store, "embedder", [2.0], shed_vals=[5.0])
        ctl.decide_once(1.0)
        _ring(store, "embedder", [2.0], shed_vals=[9.0])
        assert ctl.decide_once(2.0) == 1     # shed slope = overload
        assert P.read_scale_targets(store)["embedder"]["r"] == 2

    def test_manual_hold_respected(self, store):
        _policy(store)
        _sup_stats(store, r=1)
        P.write_scale_target(store, "embedder", 2, src="manual")
        ctl = AutoScaler(store, up_threshold=1.0, up_consecutive=1,
                         cooldown_s=0.0)
        _ring(store, "embedder", [50.0])
        for i in range(3):
            ctl.decide_once(float(i))
        assert ctl.stats.holds == 3
        assert P.read_scale_targets(store)["embedder"]["src"] == \
            "manual"

    def test_policy_floor_lifts_idle_lane(self, store):
        _policy(store, lo=2, hi=4)
        _sup_stats(store, r=1)
        ctl = AutoScaler(store, cooldown_s=0.0)
        _ring(store, "embedder", [0.0])
        assert ctl.decide_once(0.0) == 1
        assert P.read_scale_targets(store)["embedder"]["r"] == 2

    def test_no_telemetry_no_action(self, store):
        _policy(store)
        _sup_stats(store, r=1)
        ctl = AutoScaler(store)
        assert ctl.decide_once(0.0) == 0
        assert ctl.stats.no_data == 1

    @pytest.mark.chaos
    def test_decide_fault_site_live(self, store):
        """`autoscaler.decide` chaos reachability (splint SPL104)."""
        from libsplinter_tpu_torch.utils import faults

        _policy(store)
        ctl = AutoScaler(store)
        faults.arm("autoscaler.decide:raise@1")
        try:
            with pytest.raises(faults.FaultInjected):
                ctl.decide_once(0.0)
            ctl.decide_once(1.0)         # window passed: cycle runs
        finally:
            faults.disarm()

    def test_pool_readmit_discount_suppresses_warm_burst(self, store):
        """PR 20: a warm-restart readmit burst inflates pool_occ with
        pages that cost nothing to drop again — the discount keeps
        the (unchanged) hysteresis from voting scale-up on it, while
        the SAME occupancy with a quiet tier still scales up."""
        from libsplinter_tpu_torch.engine.autoscaler import (
            POOL_UP_THRESHOLD, READMIT_DISCOUNT_CAP)

        _pool_policy(store, "decode")
        _sup_stats(store, "decode", r=1)
        ctl = AutoScaler(store, up_consecutive=2, cooldown_s=0.0)
        # occupancy 0.85 >= 0.80, but 10 of the 100 pages were
        # readmitted this tick: effective 0.75 — never votes up
        for i in range(4):
            _pool_ring(store, "decode", 0.85,
                       readmits=(10.0 * i, 10.0 * (i + 1)),
                       used=85.0, free=15.0)
            assert ctl.decide_once(float(i)) == 0
        assert ctl.lanes["decode"].up_streak == 0
        assert ctl.lanes["decode"].readmit_discount == 0.1
        ctl.publish_stats()
        snap = json.loads(store.get(
            P.KEY_AUTOSCALER_STATS).rstrip(b"\0"))
        assert snap["lanes"]["decode"]["readmit_discount"] == 0.1
        # tier quiet (counter flat): the same occupancy is genuine
        # demand and the normal two-tick up vote fires
        for i in range(2):
            _pool_ring(store, "decode", 0.85,
                       readmits=(40.0, 40.0), used=85.0, free=15.0)
            ctl.decide_once(10.0 + i)
        assert ctl.stats.scale_ups == 1
        assert P.read_scale_targets(store)["decode"]["r"] == 2
        assert POOL_UP_THRESHOLD == 0.80          # band untouched
        assert READMIT_DISCOUNT_CAP == 0.5

    def test_pool_readmit_discount_capped_and_robust(self, store):
        """The discount is bounded (a pathological counter cannot
        hide saturation below the cap) and degrades to 0.0 on any
        missing/stale input instead of skipping the decision."""
        from libsplinter_tpu_torch.engine.autoscaler import AutoScaler as A

        # pure-input unit: missing rec / rings / flat counter -> 0
        assert A._readmit_discount(None) == 0.0
        assert A._readmit_discount({"gauges": {}}) == 0.0
        g = {"tier_readmits": [[1.0, 5.0], [2.0, 5.0]],
             "pages_used": [[2.0, 50.0]], "pages_free": [[2.0, 50.0]]}
        assert A._readmit_discount({"gauges": g}) == 0.0   # flat
        g["tier_readmits"] = [[1.0, 0.0], [2.0, 90.0]]
        assert A._readmit_discount({"gauges": g}) == 0.5   # capped
        g["pages_free"] = [[2.0, 0.0]]
        g["pages_used"] = [[2.0, 0.0]]
        assert A._readmit_discount({"gauges": g}) == 0.0   # no pool
        # capped end to end: occ 1.0 minus the 0.5 cap stays in the
        # dead band (no up vote, no down vote — streaks reset)
        _pool_policy(store, "decode")
        _sup_stats(store, "decode", r=2)
        ctl = AutoScaler(store, up_consecutive=1,
                         down_consecutive=1, cooldown_s=0.0)
        _pool_ring(store, "decode", 1.0, readmits=(0.0, 90.0),
                   used=100.0, free=0.0)
        assert ctl.decide_once(0.0) == 0
        assert ctl.lanes["decode"].readmit_discount == 0.5
        assert ctl.lanes["decode"].up_streak == 0
        assert ctl.lanes["decode"].down_streak == 0

    def test_heartbeat(self, store):
        _policy(store)
        _sup_stats(store, r=1)
        ctl = AutoScaler(store, up_threshold=8.0, up_consecutive=1,
                         cooldown_s=0.0)
        _ring(store, "embedder", [32.0])
        ctl.attach()
        ctl.decide_once(0.0)
        ctl.publish_stats()
        snap = json.loads(store.get(
            P.KEY_AUTOSCALER_STATS).rstrip(b"\0"))
        assert snap["lanes"]["embedder"]["target"] == 4
        assert snap["history"]


class TestSupervised:
    def test_registered_as_supervisable_lane(self):
        from libsplinter_tpu_torch.engine.supervisor import LANES

        spec = LANES["telemetry"]
        assert spec.module == "libsplinter_tpu_torch.engine.telemetry"
        assert spec.heartbeat_key == P.KEY_TELEMETRY_STATS
        assert spec.max_replicas == 1    # the sampler never stripes

    def test_supervised_restart_keeps_rings(self, store):
        """Acceptance: kill the live sampler child mid-run — the
        supervisor respawns it, the generation bumps, and the rings
        keep growing from where the dead generation left them.  The
        child is the supervisor's own spawn of `python -m
        libsplinter_tpu_torch.engine.telemetry`."""
        from libsplinter_tpu_torch.engine.supervisor import Supervisor

        _fake_heartbeat(store, P.KEY_EMBED_STATS, embedded=1)
        sup = Supervisor(store.name, lanes=("telemetry",),
                         lane_args={"telemetry": ["--interval-s", "0.1"]},
                         store=store,
                         backoff_base_ms=100, backoff_max_ms=1000,
                         breaker_threshold=10, breaker_window_s=60,
                         startup_grace_s=60, healthy_after_s=1.0)
        t0 = time.monotonic()

        def ring_len():
            h = read_history(store, "embedder")
            return len(h["gauges"]["queue_depth"]) if h else 0

        try:
            while ring_len() < 3 and time.monotonic() - t0 < 30:
                sup.poll_once()
                time.sleep(0.1)
            assert ring_len() >= 3, "sampler never produced history"
            n_before = ring_len()
            gen_before = sup.lanes["telemetry"].generation
            sup.lanes["telemetry"].proc.kill()    # the chaos moment
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                sup.poll_once()
                if sup.lanes["telemetry"].generation > gen_before \
                        and ring_len() > n_before:
                    break
                time.sleep(0.1)
            assert sup.lanes["telemetry"].generation > gen_before
            assert ring_len() > n_before          # rings intact AND
            # the ring still starts with pre-crash samples (intact,
            # not recreated) unless it wrapped
            snap = json.loads(
                store.get(P.KEY_TELEMETRY_STATS).rstrip(b"\0"))
            assert snap["generation"] >= 2        # growing
        finally:
            sup.shutdown()
