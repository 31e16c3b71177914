"""The scaling controller — QoS-driven replica counts for the
elastic lanes.

ROADMAP item 4's control loop: every interval it reads the telemetry
rings (engine/telemetry.py — queue depth measured from labels, shed /
deferred counters, stage p99s; PR 13 built them expressly as this
lane's input plane), computes per-lane pressure, and commands replica
counts through the supervisor by writing per-lane
`__scale_tgt_<lane>` target keys (the
supervisor applies them: spawn on scale-up, drain-protocol retire on
scale-down).  Deliberately jax-free and supervisable (`spt supervise
--scale lane=min:max` arms it automatically): its state of record is
the store — policy in `__scale_policy`, targets in per-lane
`__scale_tgt_<lane>` keys,
decisions in the `__autoscaler_stats` heartbeat — so a restarted
controller resumes from the live truth.

Hysteresis, because an open-loop arrival process is bursty and a
flapping replica set is worse than a slightly lazy one:

  - scale-UP is fast: `up_consecutive` (default 2) samples of queue
    pressure (queue depth / live replicas) at or above up_threshold —
    or a moving shed counter, the unambiguous overload signal — jump
    the target to ceil(queue / up_threshold), clamped to the bounds;
  - scale-DOWN is slow: `down_consecutive` (default 5) samples below
    down_threshold with shed flat step the target down by ONE;
  - a per-lane cooldown separates actions, so one burst cannot
    ratchet the set up and down inside a single drain cycle;
  - a `manual` target entry (`spt scale set`) is a
    hold: the controller leaves that lane alone until it is cleared
    back to auto.

Per-lane SIGNAL selection (the disaggregated lanes, PR 18): the
policy's per-lane `signal` field picks what pressure means.  `queue`
(the default) is the classic queue-depth-per-replica read above.
`pool` rates the lane by its paged-pool occupancy gauge instead —
the decode lane's backlog is KV residency of adopted rows, not queue
depth (a decode replica near pool exhaustion refuses adoption long
before any queue forms), so occupancy >= POOL_UP_THRESHOLD votes
scale-up one replica at a time and sustained occupancy below
POOL_DOWN_THRESHOLD votes scale-down.  This is how `spt supervise
--scale prefill=1:4 --scale decode=1:4` scales the two lanes
INDEPENDENTLY: a prefill burst moves queue pressure, not pool
occupancy, and vice versa.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import time
from collections import deque

from ..store import Store
from ..utils.faults import fault
from . import protocol as P
from .telemetry import read_history

log = logging.getLogger("libsplinter_tpu.autoscaler")

DEFAULT_INTERVAL_S = 2.0
DEFAULT_UP_THRESHOLD = 8.0      # queue depth per replica
DEFAULT_DOWN_THRESHOLD = 1.0    # queue depth per replica
DEFAULT_UP_CONSECUTIVE = 2
DEFAULT_DOWN_CONSECUTIVE = 5
DEFAULT_COOLDOWN_S = 6.0
# the `pool` signal's hysteresis band (occupancy fractions, 0..1):
# adoption backpressure starts well before 1.0, so the up vote fires
# at 80% and the lane is only surrendered once sustained below 30%
POOL_UP_THRESHOLD = 0.80
POOL_DOWN_THRESHOLD = 0.30
# PR 20: occupancy attributable to pages the KV tier READMITTED in
# the last sampler interval is discounted from the pool signal — a
# warm restart or a prefix-hot burst readmits whole chains in one
# tick, and those pages are restored capital (droppable again at
# zero recompute cost), not live demand.  The cap bounds how much a
# pathological ring can suppress genuine saturation: the hysteresis
# band itself (streaks, thresholds, cooldown) is untouched.
READMIT_DISCOUNT_CAP = 0.5


@dataclasses.dataclass
class AutoScalerStats:
    ticks: int = 0               # decision cycles completed
    decisions: int = 0           # targets written (up + down)
    scale_ups: int = 0
    scale_downs: int = 0
    holds: int = 0               # lanes skipped on a manual hold
    no_data: int = 0             # lanes skipped for missing rings


@dataclasses.dataclass
class _LaneCtl:
    """Per-lane hysteresis state."""
    up_streak: int = 0
    down_streak: int = 0
    last_action_mono: float = -1e9
    last_shed: float | None = None
    # the newest ring sample already counted into the streaks: a
    # controller ticking FASTER than the sampler must not count one
    # telemetry point N times (that would collapse up_consecutive /
    # down_consecutive to a single sample and re-open the flap door)
    last_sample_ts: float | None = None
    target: int | None = None    # last target this controller wrote
    pressure: float = 0.0
    # the pool-signal discount applied this tick (0.0 on queue lanes
    # and quiet tiers) — published so `spt scale status` can show WHY
    # a readmit burst did not vote scale-up
    readmit_discount: float = 0.0
    reason: str = "init"


class AutoScaler:
    """Drive with run() (blocking loop) or decide_once() (one
    decision cycle — tests and --oneshot)."""

    def __init__(self, store: Store, *,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 up_threshold: float = DEFAULT_UP_THRESHOLD,
                 down_threshold: float = DEFAULT_DOWN_THRESHOLD,
                 up_consecutive: int = DEFAULT_UP_CONSECUTIVE,
                 down_consecutive: int = DEFAULT_DOWN_CONSECUTIVE,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 history_len: int = 32):
        self.store = store
        self.interval_s = max(0.05, interval_s)
        self.up_threshold = max(0.1, up_threshold)
        self.down_threshold = max(0.0, down_threshold)
        self.up_consecutive = max(1, up_consecutive)
        self.down_consecutive = max(1, down_consecutive)
        self.cooldown_s = max(0.0, cooldown_s)
        self.stats = AutoScalerStats()
        self.lanes: dict[str, _LaneCtl] = {}
        # lane -> scaling signal ("queue"|"pool"), from the policy
        self.signals: dict[str, str] = {}
        # decision history: [ts, lane, from_r, to_r, reason] rows the
        # heartbeat publishes (and `spt scale status` renders) — the
        # flap/stuck triage read
        self.history: deque = deque(maxlen=max(4, history_len))
        self.generation = 0
        self._running = False

    # -- wiring ------------------------------------------------------------

    def attach(self) -> None:
        self.generation = P.bump_generation(self.store,
                                            P.KEY_AUTOSCALER_STATS)

    # -- inputs ------------------------------------------------------------

    def _policy(self) -> dict[str, tuple[int, int]]:
        """The supervisor-published per-lane bounds.  Controller
        knobs in the policy override the constructor defaults, so
        `spt supervise --scale-*` flags reach a supervised child
        without argv plumbing."""
        rec = P.read_scale_policy(self.store)
        if rec is None:
            return {}
        for field, attr in (("up_threshold", "up_threshold"),
                            ("down_threshold", "down_threshold"),
                            ("cooldown_s", "cooldown_s"),
                            ("interval_s", "interval_s")):
            v = rec.get(field)
            if isinstance(v, (int, float)) and v > 0:
                setattr(self, attr, max(0.05, float(v))
                        if attr == "interval_s" else float(v))
        out: dict[str, tuple[int, int]] = {}
        lanes = rec.get("lanes")
        if not isinstance(lanes, dict):
            return out
        for lane, b in lanes.items():
            if not isinstance(b, dict):
                continue
            try:
                lo = max(1, int(b.get("min", 1)))
                hi = max(lo, int(b.get("max", lo)))
            except (TypeError, ValueError):
                continue
            out[lane] = (lo, hi)
            sig = b.get("signal")
            self.signals[lane] = (sig if sig in ("queue", "pool")
                                  else "queue")
        return out

    def _live_r(self, lane: str) -> int:
        """The lane's currently-active replica count, from the
        supervisor heartbeat (the applier's truth — the controller
        must rate pressure against what is actually serving, not
        what it last asked for)."""
        try:
            snap = json.loads(self.store.get(
                P.KEY_SUPERVISOR_STATS).rstrip(b"\0"))
            r = snap["lanes"][lane].get("r", 1)
            return max(1, int(r))
        except (KeyError, OSError, ValueError, TypeError):
            ctl = self.lanes.get(lane)
            return max(1, ctl.target or 1) if ctl else 1

    @staticmethod
    def _ring_last(rec: dict | None, gauge: str
                   ) -> tuple[float, float] | None:
        """The newest (ts, value) point of a telemetry ring gauge."""
        if rec is None:
            return None
        ring = (rec.get("gauges") or {}).get(gauge)
        if not isinstance(ring, list) or not ring:
            return None
        p = ring[-1]
        if not isinstance(p, list) or len(p) != 2:
            return None
        return float(p[0]), float(p[1])

    @staticmethod
    def _readmit_discount(rec: dict | None) -> float:
        """The occupancy fraction attributable to pages the KV tier
        readmitted between the last two sampler ticks: the newest
        step of the `tier_readmits` counter ring, rated against the
        pool size from the same rings (pages_used + pages_free).
        Returns 0.0 whenever any input is missing or stale — the
        discount is an optimization on the pool signal, never a
        reason to skip a decision."""
        if rec is None:
            return 0.0
        gauges = rec.get("gauges") or {}

        def pt(g, i):
            ring = gauges.get(g)
            if not isinstance(ring, list) or len(ring) < -i:
                return None
            p = ring[i]
            if not isinstance(p, list) or len(p) != 2:
                return None
            try:
                return float(p[1])
            except (TypeError, ValueError):
                return None

        prev, last = pt("tier_readmits", -2), pt("tier_readmits", -1)
        if prev is None or last is None or last <= prev:
            return 0.0
        used, free = pt("pages_used", -1), pt("pages_free", -1)
        if used is None or free is None or used + free <= 0:
            return 0.0
        return min(READMIT_DISCOUNT_CAP, (last - prev) / (used + free))

    # -- the decision ------------------------------------------------------

    def decide_lane(self, lane: str, bounds: tuple[int, int],
                    queue_depth: float | None,
                    shed: float | None, live_r: int,
                    now_mono: float,
                    sample_ts: float | None = None,
                    signal: str = "queue") -> int | None:
        """One lane's hysteresis step.  Returns a NEW target replica
        count, or None (no action).  Pure against its inputs so the
        flapping unit tests can drive synthetic series.  `sample_ts`
        is the ring point's timestamp: a point already counted
        advances NO streak (a controller ticking faster than the
        sampler must not turn one sample into a consecutive run).

        `signal="pool"` reinterprets `queue_depth` as the lane's
        paged-pool occupancy fraction (0..1): the hysteresis band is
        the POOL_* constants, the fraction is NOT divided by the
        replica count (each replica owns its own pool; the telemetry
        gauge is already the fleet-worst view), and scale-up steps by
        ONE replica — occupancy says the pool is full, not how many
        replicas the backlog is worth."""
        ctl = self.lanes.setdefault(lane, _LaneCtl())
        lo, hi = bounds
        if queue_depth is None:
            ctl.reason = "no telemetry"
            self.stats.no_data += 1
            return None
        if sample_ts is not None:
            if sample_ts == ctl.last_sample_ts:
                ctl.reason = "awaiting fresh telemetry"
                return None           # streaks pause, never re-count
            ctl.last_sample_ts = sample_ts
        pooled = signal == "pool"
        if pooled:
            pressure = float(queue_depth)
            up_thr, down_thr = POOL_UP_THRESHOLD, POOL_DOWN_THRESHOLD
        else:
            pressure = queue_depth / max(1, live_r)
            up_thr, down_thr = self.up_threshold, self.down_threshold
        ctl.pressure = round(pressure, 3)
        shed_moved = (shed is not None and ctl.last_shed is not None
                      and shed > ctl.last_shed)
        if shed is not None:
            ctl.last_shed = shed
        if pressure >= up_thr or shed_moved:
            ctl.up_streak += 1
            ctl.down_streak = 0
        elif pressure < down_thr:
            ctl.down_streak += 1
            ctl.up_streak = 0
        else:
            # the dead band between the thresholds: streaks reset, so
            # an input oscillating across ONE threshold cannot bank
            # votes toward the other direction (the no-flap property)
            ctl.up_streak = 0
            ctl.down_streak = 0
        in_cooldown = (now_mono - ctl.last_action_mono
                       < self.cooldown_s)
        if ctl.up_streak >= self.up_consecutive and not in_cooldown:
            # scale-up sizes to the backlog in ONE action: a sustained
            # 8x step must not climb one replica per interval.  The
            # pool signal steps by one — a fraction has no backlog
            # magnitude to size from.
            want = live_r + 1 if pooled else \
                max(live_r + 1,
                    math.ceil(queue_depth / self.up_threshold))
            target = min(hi, want)
            if target > live_r:
                ctl.up_streak = 0
                ctl.last_action_mono = now_mono
                metric = "pool occ" if pooled else "queue/replica"
                ctl.reason = (f"{metric} {pressure:.2f} >= {up_thr:g}"
                              + (" + shed moving" if shed_moved
                                 else ""))
                return target
            ctl.reason = f"at max ({hi})"
            return None
        if ctl.down_streak >= self.down_consecutive \
                and not in_cooldown:
            target = max(lo, live_r - 1)
            if target < live_r:
                ctl.down_streak = 0
                ctl.last_action_mono = now_mono
                metric = "pool occ" if pooled else "queue/replica"
                ctl.reason = (f"idle: {metric} {pressure:.2f} < "
                              f"{down_thr:g} x"
                              f"{self.down_consecutive}")
                return target
            ctl.reason = f"at min ({lo})"
            return None
        ctl.reason = ("cooldown" if in_cooldown and
                      (ctl.up_streak or ctl.down_streak) else "steady")
        return None

    def decide_once(self, now_mono: float | None = None) -> int:
        """One decision cycle over every lane in the policy; returns
        targets written."""
        now_mono = time.monotonic() if now_mono is None else now_mono
        policy = self._policy()
        targets = P.read_scale_targets(self.store)
        wrote = 0
        for lane, bounds in policy.items():
            fault("autoscaler.decide")
            tgt = targets.get(lane)
            if isinstance(tgt, dict) and tgt.get("src") == "manual":
                self.stats.holds += 1
                ctl = self.lanes.setdefault(lane, _LaneCtl())
                ctl.reason = f"manual hold (r={tgt.get('r')})"
                continue
            rec = read_history(self.store, lane)
            signal = self.signals.get(lane, "queue")
            gauge = "pool_occ" if signal == "pool" else "queue_depth"
            q = self._ring_last(rec, gauge)
            shed = self._ring_last(rec, "shed")
            live_r = self._live_r(lane)
            occ = q[1] if q else None
            discount = 0.0
            if occ is not None and signal == "pool":
                # readmitted pages are restored capital, not demand:
                # discount this tick's readmissions out of the pool
                # signal BEFORE the (unchanged) hysteresis sees it
                discount = self._readmit_discount(rec)
                occ = max(0.0, occ - discount)
            target = self.decide_lane(
                lane, bounds, occ,
                shed[1] if shed else None, live_r, now_mono,
                sample_ts=q[0] if q else None, signal=signal)
            self.lanes[lane].readmit_discount = round(discount, 3)
            ctl = self.lanes[lane]
            if target is None:
                # bounds still apply with no action: a policy floor
                # raised above the live count must lift the lane
                lo, hi = bounds
                if live_r < lo:
                    target, ctl.reason = lo, f"below min ({lo})"
                elif live_r > hi:
                    target, ctl.reason = hi, f"above max ({hi})"
            if target is None or target == ctl.target == live_r:
                continue
            P.write_scale_target(self.store, lane, target, src="auto")
            ctl.target = target
            self.stats.decisions += 1
            if target > live_r:
                self.stats.scale_ups += 1
            elif target < live_r:
                self.stats.scale_downs += 1
            self.history.append(
                [round(time.time(), 2), lane, live_r, target,
                 ctl.reason])
            log.info("lane %s: %d -> %d replicas (%s)",
                     lane, live_r, target, ctl.reason)
            wrote += 1
        self.stats.ticks += 1
        return wrote

    # -- heartbeat ---------------------------------------------------------

    def publish_stats(self) -> None:
        payload = {**dataclasses.asdict(self.stats),
                   "interval_s": self.interval_s,
                   "up_threshold": self.up_threshold,
                   "down_threshold": self.down_threshold,
                   "cooldown_s": self.cooldown_s,
                   "generation": self.generation,
                   "lanes": {
                       ln: {"target": ctl.target,
                            "pressure": ctl.pressure,
                            "signal": self.signals.get(ln, "queue"),
                            "readmit_discount": ctl.readmit_discount,
                            "reason": ctl.reason,
                            "up_streak": ctl.up_streak,
                            "down_streak": ctl.down_streak}
                       for ln, ctl in self.lanes.items()},
                   "history": [list(row) for row in self.history]}
        P.publish_heartbeat(self.store, P.KEY_AUTOSCALER_STATS,
                            payload)

    # -- lifecycle ---------------------------------------------------------

    def run(self, *, stop_after: float | None = None,
            heartbeat_interval_s: float = 5.0,
            idle_timeout_ms: int | None = None) -> None:
        """The control loop.  `idle_timeout_ms` is accepted (and
        ignored) so the supervisor's generic lane argv works
        unchanged."""
        self._running = True
        deadline = (time.monotonic() + stop_after) if stop_after \
            else None
        next_beat = 0.0
        next_decide = 0.0
        while self._running:
            now = time.monotonic()
            try:
                if now >= next_decide:
                    self.decide_once(now)
                    next_decide = now + self.interval_s
                if now >= next_beat:
                    # heartbeat on its OWN cadence, never floored by
                    # a long decision interval: a supervised
                    # controller with --scale-interval-s above the
                    # supervisor's heartbeat timeout would otherwise
                    # read as hung and get kill-looped
                    self.publish_stats()
                    next_beat = now + heartbeat_interval_s
            except Exception:
                log.exception("decision cycle failed; continuing")
            if deadline and time.monotonic() > deadline:
                break
            wake = min(next_decide, next_beat)
            time.sleep(min(0.25, max(wake - time.monotonic(), 0.01)))

    def stop(self) -> None:
        self._running = False


def main(argv: list[str] | None = None) -> int:
    """CLI entry: python -m libsplinter_tpu.engine.autoscaler
    --store NAME.  jax-free — supervised restarts cost ms."""
    import argparse

    ap = argparse.ArgumentParser(
        description="splinter-tpu scaling controller (reads the "
                    "telemetry rings, writes __scale_tgt_<lane> targets for "
                    "supervisor's replica sets)")
    ap.add_argument("--store", required=True)
    ap.add_argument("--persistent", action="store_true")
    ap.add_argument("--oneshot", action="store_true")
    ap.add_argument("--interval-s", type=float,
                    default=DEFAULT_INTERVAL_S,
                    help="decision cadence (default 2s)")
    ap.add_argument("--up-threshold", type=float,
                    default=DEFAULT_UP_THRESHOLD,
                    help="queue depth per replica that votes "
                         "scale-up (default 8)")
    ap.add_argument("--down-threshold", type=float,
                    default=DEFAULT_DOWN_THRESHOLD,
                    help="queue depth per replica below which "
                         "sustained idle votes scale-down (default 1)")
    ap.add_argument("--up-consecutive", type=int,
                    default=DEFAULT_UP_CONSECUTIVE)
    ap.add_argument("--down-consecutive", type=int,
                    default=DEFAULT_DOWN_CONSECUTIVE)
    ap.add_argument("--cooldown-s", type=float,
                    default=DEFAULT_COOLDOWN_S,
                    help="minimum seconds between actions per lane")
    ap.add_argument("--idle-timeout-ms", type=int, default=None,
                    help="accepted for supervisor argv parity; unused")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    store = Store.open(args.store, persistent=args.persistent)
    ctl = AutoScaler(store, interval_s=args.interval_s,
                     up_threshold=args.up_threshold,
                     down_threshold=args.down_threshold,
                     up_consecutive=args.up_consecutive,
                     down_consecutive=args.down_consecutive,
                     cooldown_s=args.cooldown_s)
    ctl.attach()
    ctl.publish_stats()
    if args.oneshot:
        n = ctl.decide_once()
        ctl.publish_stats()
        log.info("oneshot wrote %d targets", n)
        return 0
    try:
        ctl.run()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
