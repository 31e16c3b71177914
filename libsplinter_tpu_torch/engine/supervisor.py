"""Daemon supervisor — crash-only process management for the port's
lanes, and the replica-set owner of the elastic-lane subsystem.

The PyTorch port of libsplinter_tpu/engine/supervisor.py: the same
replica sets, backoff, breaker, hang detector, drain protocol and
fault-stripping contract, over the torch lanes
(`libsplinter_tpu_torch.engine.*`).  The model lanes run on the card
unless their argv says `--device cpu` (`--<lane>-args "--device cpu"`);
`--pin-chips` reaches them as SPTPU_CHIP_PIN, which the completer binds
with utils.device.apply_chip_pin before it builds its model.

The store survives hostile clients because every interaction is a
lock-free slot protocol; the daemons themselves, though, are single
processes — one CUDA out-of-memory past the firewalls, one injected
`crash`, one OOM kill, and a lane is gone until an operator
notices.  This module is the missing layer of the serving fault model
("Crash-Only Software": recovery IS startup, so make restart the
first-class path):

  - each lane (embedder / completer / searcher / ...) runs as a CHILD
    process (`python -m libsplinter_tpu_torch.engine.<lane> --store
    ...`), started wherever the caller runs: the child's PYTHONPATH
    leads with this package's parent directory;
  - the supervisor watches pids (waitpid-level truth) AND heartbeats
    (a live pid with a stale heartbeat is a hung daemon — it gets
    SIGKILLed and restarted, the crash-only remedy);
  - crashes restart with jittered exponential backoff (base doubling
    per consecutive crash, 0.5–1.5x jitter so a pod of supervisors
    never thunders back in lockstep);
  - a circuit breaker (N crashes inside a window) marks the lane DOWN
    in the supervisor heartbeat instead of burning CPU on a crash
    loop; CLI clients consult that marker (protocol.lane_down via
    daemon_live) and skip dispatch instead of timing out.  After a
    cooldown the breaker half-opens: one probe child — surviving
    closes the breaker, crashing re-opens it.

Elastic lanes (ROADMAP item 4): beyond "restart N fixed children",
the supervisor owns each lane's REPLICA SET.  A lane may run up to
`LANES[lane].max_replicas` striped replicas (each drains a disjoint
slot-index stripe — protocol.StripeView); desired counts arrive
through per-lane `__scale_tgt_<lane>` store keys (written by the autoscaler
lane or `spt scale set`), and the supervisor applies them:

  - scale-UP spawns replica N with `--replica N` and re-stripes the
    lane over the enlarged set in one epoch-bumped map write;
  - scale-DOWN is a drain protocol: the retiring replica's stripes
    are marked CLOSED (no replica claims new work from them), the
    child finishes its in-flight work and exits on its own when it
    sees itself assigned nothing (the run loops' poll_retired check)
    — or is reaped at the drain deadline — and only THEN are the
    closed stripes reclaimed (stranded SERVICING rows re-queued via
    the existing stranded-request machinery) and re-assigned to the
    survivors.  A replica crash-killed mid-scale-down takes the same
    path: retiring + dead = retired, reclaim runs, nothing strands.

Chaos drills: when SPTPU_FAULT is set in the supervisor's
environment, it is handed to each lane's FIRST child only and
stripped from respawns (a drill asserts the restart recovers — an
inherited crash@1 would re-fire in every generation and prove
nothing).  --keep-faults opts back into inheriting, which is how you
demo the breaker.

Usage: `python -m libsplinter_tpu_torch.engine.supervisor --store
NAME`.  SIGTERM (or ^C) stops it: every child is terminated and the
process exits 0.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from pathlib import Path
from typing import NamedTuple

from ..store import Store
from ..utils.faults import fault
from . import protocol as P

log = logging.getLogger("libsplinter_tpu_torch.supervisor")

# the directory that holds the package: children import it from there
_PKG_PARENT = str(Path(__file__).resolve().parents[2])


class LaneSpec(NamedTuple):
    """One supervisable lane: child module, canonical heartbeat key,
    the hard replica ceiling (1 = the lane cannot stripe), and the
    baked-in argv the lane type always passes its children (user
    --<lane>-args append after these)."""
    module: str
    heartbeat_key: str
    max_replicas: int = 1
    args: tuple = ()


# lane name -> LaneSpec.  The lane names are the public vocabulary:
# supervisor heartbeat sections, `spt metrics` labels, stripe-map
# keys, and protocol.lane_down all use them.  max_replicas bounds
# what any scale target (auto or manual) may request.
LANES: dict[str, LaneSpec] = {
    "embedder": LaneSpec("libsplinter_tpu_torch.engine.embedder",
                         P.KEY_EMBED_STATS, 8),
    "completer": LaneSpec("libsplinter_tpu_torch.engine.completer",
                          P.KEY_COMPLETE_STATS, 4),
    "searcher": LaneSpec("libsplinter_tpu_torch.engine.searcher",
                         P.KEY_SEARCH_STATS, 8),
    # the pipeline lane (server-side scripted chains): torch-free, so
    # a supervised restart costs milliseconds, not a model load
    "pipeliner": LaneSpec("libsplinter_tpu_torch.engine.pipeliner",
                          P.KEY_SCRIPT_STATS, 8),
    # the telemetry sampler (heartbeat-history rings): torch-free; its
    # rings live in the STORE, so a restart resumes them intact
    "telemetry": LaneSpec("libsplinter_tpu_torch.engine.telemetry",
                          P.KEY_TELEMETRY_STATS, 1),
    # the scaling controller (QoS-driven replica counts): torch-free;
    # its decisions land in __scale_tgt_<lane> keys, its state in the store —
    # a restarted controller resumes from the live policy + rings
    "autoscaler": LaneSpec("libsplinter_tpu_torch.engine.autoscaler",
                           P.KEY_AUTOSCALER_STATS, 1),
    # disaggregated serving (engine/disagg.py): the completer daemon
    # split into its two phases behind the same label protocol.  The
    # autoscaler drives them on DIFFERENT signals — prefill on queue
    # pressure, decode on paged-pool occupancy (_publish_policy) —
    # and --pin-chips lands their replicas on disjoint chips.
    "prefill": LaneSpec("libsplinter_tpu_torch.engine.completer",
                        P.KEY_PREFILL_STATS, 4,
                        ("--phase", "prefill")),
    "decode": LaneSpec("libsplinter_tpu_torch.engine.completer",
                       P.KEY_DECODE_STATS, 4,
                       ("--phase", "decode")),
}


@dataclasses.dataclass
class LaneProc:
    """One supervised lane replica's runtime state."""

    name: str
    module: str
    heartbeat_key: str
    replica: int = 0
    proc: object | None = None
    pid: int = 0
    state: str = "init"          # starting|running|backoff|down|retiring
    generation: int = 0          # spawn count
    restarts: int = 0            # respawns after a crash/hang
    consecutive: int = 0         # crashes since the last healthy run
    backoff_ms: float = 0.0      # the live backoff, for the heartbeat
    backoff_until: float = 0.0   # monotonic deadline
    breaker_opens: int = 0
    breaker_until: float = 0.0   # monotonic half-open probe time
    half_open: bool = False      # probing after a breaker cooldown
    hung_kills: int = 0          # stale-heartbeat SIGKILLs
    retiring: bool = False       # scale-down drain in progress
    retire_deadline: float = 0.0  # monotonic: reap past this
    # the stripe set this replica owned when its retire began: parked
    # CLOSED until the post-reap reclaim (recomputing it from a later
    # assignment would hand a still-draining replica's rows away)
    closed_stripes: tuple = ()
    # two-phase scale-UP: the share destined for a freshly-spawned
    # replica parks CLOSED until its first heartbeat proves attach is
    # over — attach runs the stripe-scoped stranded-SERVICING reclaim,
    # and a new replica that owned stripes at attach could "reclaim"
    # a live incumbent's re-striped in-flight row (double-serve)
    pending_stripes: tuple = ()
    last_exit: int | None = None
    spawn_mono: float = 0.0
    spawn_wall: float = 0.0
    crash_times: deque = dataclasses.field(default_factory=deque)

    def snapshot(self) -> dict:
        """The per-replica heartbeat section (what `spt metrics`
        renders and protocol.lane_down consults)."""
        return {"state": self.state, "pid": self.pid,
                "generation": self.generation,
                "restarts": self.restarts,
                "consecutive_crashes": self.consecutive,
                "backoff_ms": round(self.backoff_ms, 1),
                "breaker_opens": self.breaker_opens,
                "hung_kills": self.hung_kills,
                "last_exit": self.last_exit}


class Supervisor:
    """Drive with run() (blocking loop) or poll_once() (one
    supervision step — tests and deterministic drills).

    spawn_fn and clock are injectable: tests supervise dummy children
    (no torch import) on a compressed timeline."""

    def __init__(self, store_name: str, *,
                 lanes=("embedder", "completer", "searcher"),
                 persistent: bool = False,
                 lane_args: dict[str, list[str]] | None = None,
                 backoff_base_ms: float = 500.0,
                 backoff_max_ms: float = 30_000.0,
                 breaker_threshold: int = 5,
                 breaker_window_s: float = 60.0,
                 breaker_cooldown_s: float = 30.0,
                 heartbeat_timeout_s: float = 30.0,
                 startup_grace_s: float = 60.0,
                 healthy_after_s: float = 30.0,
                 keep_faults: bool = False,
                 scale: dict[str, tuple[int, int]] | None = None,
                 scale_knobs: dict | None = None,
                 drain_deadline_s: float = 5.0,
                 chip_pins: dict[str, str] | None = None,
                 spawn_fn=None, clock=None,
                 store: Store | None = None):
        self.store_name = store_name
        self.persistent = persistent
        self.lane_args = lane_args or {}
        # per-lane device pin (--pin-chips): children see it as
        # SPTPU_CHIP_PIN and set their CUDA device before they build a
        # model, so e.g. prefill and decode replicas land on disjoint
        # cards
        self.chip_pins = dict(chip_pins or {})
        self.backoff_base_ms = backoff_base_ms
        self.backoff_max_ms = backoff_max_ms
        self.breaker_threshold = breaker_threshold
        self.breaker_window_s = breaker_window_s
        self.breaker_cooldown_s = breaker_cooldown_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        # a fresh child pays the torch import, the kernel library
        # load, a CUDA context and the model build (and its warm-up)
        # before its first heartbeat: the hang detector must not eat
        # the startup
        self.startup_grace_s = startup_grace_s
        self.healthy_after_s = healthy_after_s
        self.keep_faults = keep_faults
        # scale-down drain budget: a retiring replica gets this long
        # to finish in-flight work after its stripes close before the
        # supervisor reaps it (voluntary exit is the fast path)
        self.drain_deadline_s = drain_deadline_s
        self._spawn_fn = spawn_fn or self._spawn_child
        self._clock = clock or time.monotonic
        self._rng = random.Random()
        self.store = store or Store.open(store_name,
                                         persistent=persistent)
        unknown = [ln for ln in lanes if ln not in LANES]
        if unknown:
            raise ValueError(f"unknown lanes {unknown} "
                             f"(supervisable: {sorted(LANES)})")
        # replica sets: replicas[lane][r] -> LaneProc.  self.lanes
        # keeps the replica-0 view (the canonical replica every
        # pre-elastic caller — tests, lane_down, spt health — reads).
        self.replicas: dict[str, dict[int, LaneProc]] = {
            name: {0: LaneProc(name, LANES[name].module,
                               LANES[name].heartbeat_key)}
            for name in lanes}
        self.lanes = {name: reps[0]
                      for name, reps in self.replicas.items()}
        # per-lane scaling bounds (min, max), from --scale; a lane
        # absent here still accepts MANUAL targets clamped to
        # (1, max_replicas)
        self.scale: dict[str, tuple[int, int]] = {}
        for lane, (lo, hi) in (scale or {}).items():
            if lane not in LANES:
                raise ValueError(f"--scale names unknown lane {lane!r}")
            cap = LANES[lane].max_replicas
            if cap <= 1:
                raise ValueError(
                    f"lane {lane!r} is not scalable (max_replicas 1)")
            lo = max(1, int(lo))
            hi = min(cap, max(lo, int(hi)))
            self.scale[lane] = (lo, hi)
        self.retired = 0             # replicas drained + reaped
        self.scale_events = 0        # applied target changes
        self.polls = 0
        self._running = False
        if self.scale:
            self._publish_policy(scale_knobs or {})

    # -- scaling policy ----------------------------------------------------

    def _publish_policy(self, knobs: dict) -> None:
        """Write the scaling policy the autoscaler lane reads: the
        per-lane bounds plus the controller knobs `spt supervise`
        was given.  Store state, so `spt scale status` and a
        restarted controller both read the same truth."""
        # per-lane scaling SIGNAL: the disaggregated decode lane is
        # paced by paged-pool occupancy (its backlog is adopted rows'
        # KV residency, not queue depth); every other lane scales on
        # the classic queue-pressure signal
        rec = {"v": 1,
               "lanes": {ln: {"min": lo, "max": hi,
                              "signal": ("pool" if ln == "decode"
                                         else "queue")}
                         for ln, (lo, hi) in self.scale.items()}}
        for k in ("interval_s", "up_threshold", "down_threshold",
                  "cooldown_s"):
            if knobs.get(k) is not None:
                rec[k] = knobs[k]
        try:
            self.store.set(P.KEY_SCALE_POLICY, json.dumps(rec))
        except (KeyError, OSError):
            pass

    # -- spawning ----------------------------------------------------------

    def _child_env(self, lane: LaneProc) -> dict:
        env = dict(os.environ)
        if (lane.generation > 1 or lane.replica > 0) \
                and not self.keep_faults:
            # chaos-drill contract: injected faults hit the FIRST
            # generation of the canonical replica only; respawns and
            # scale-up replicas must prove clean service
            env.pop("SPTPU_FAULT", None)
        pin = self.chip_pins.get(lane.name)
        if pin:
            env["SPTPU_CHIP_PIN"] = pin
        # `python -m libsplinter_tpu_torch...` must resolve whatever
        # the child's working directory is
        path = env.get("PYTHONPATH")
        env["PYTHONPATH"] = (_PKG_PARENT + os.pathsep + path if path
                             else _PKG_PARENT)
        return env

    def _spawn_child(self, lane: LaneProc):
        argv = [sys.executable, "-m", lane.module,
                "--store", self.store_name]
        if self.persistent:
            argv.append("--persistent")
        if lane.replica > 0:
            argv += ["--replica", str(lane.replica)]
        argv += list(LANES[lane.name].args)
        argv += self.lane_args.get(lane.name, [])
        return subprocess.Popen(argv, env=self._child_env(lane))

    def _spawn(self, lane: LaneProc, now: float) -> None:
        lane.generation += 1
        if lane.generation > 1:
            lane.restarts += 1
        lane.spawn_mono = now
        lane.spawn_wall = time.time()
        lane.backoff_until = 0.0
        try:
            lane.proc = self._spawn_fn(lane)
            lane.pid = getattr(lane.proc, "pid", 0)
            lane.state = "starting"
            log.info("lane %s: spawned pid %d (generation %d)",
                     self._display(lane), lane.pid, lane.generation)
        except Exception as ex:
            # a spawn that cannot even exec counts as an instant crash
            log.error("lane %s: spawn failed: %s",
                      self._display(lane), ex)
            lane.proc = None
            lane.pid = 0
            self._crashed(lane, -1, now)

    @staticmethod
    def _display(lane: LaneProc) -> str:
        return (lane.name if lane.replica == 0
                else f"{lane.name}.r{lane.replica}")

    # -- crash bookkeeping -------------------------------------------------

    def _crashed(self, lane: LaneProc, code: int, now: float) -> None:
        lane.proc = None
        lane.pid = 0
        lane.last_exit = code
        lane.consecutive += 1
        lane.crash_times.append(now)
        while (lane.crash_times
               and now - lane.crash_times[0] > self.breaker_window_s):
            lane.crash_times.popleft()
        log.warning("lane %s: exited %s (crash %d in window)",
                    self._display(lane), code, len(lane.crash_times))
        if (lane.half_open
                or len(lane.crash_times) >= self.breaker_threshold):
            # breaker: a half-open probe crashing re-opens instantly;
            # otherwise N crashes / window trip it
            lane.state = "down"
            lane.half_open = False
            lane.breaker_opens += 1
            lane.breaker_until = now + self.breaker_cooldown_s
            lane.crash_times.clear()
            lane.backoff_ms = 0.0
            log.error("lane %s: circuit breaker OPEN for %.1fs",
                      self._display(lane), self.breaker_cooldown_s)
            return
        lane.state = "backoff"
        base = min(self.backoff_base_ms * 2 ** (lane.consecutive - 1),
                   self.backoff_max_ms)
        lane.backoff_ms = base * self._rng.uniform(0.5, 1.5)
        lane.backoff_until = now + lane.backoff_ms / 1e3

    def _heartbeat_age(self, lane: LaneProc) -> float | None:
        """Seconds since the lane's OWN child published a heartbeat;
        None when no heartbeat from this generation exists yet."""
        try:
            snap = json.loads(
                self.store.get(lane.heartbeat_key).rstrip(b"\0"))
            ts = float(snap.get("ts", 0.0))
        except (KeyError, OSError, ValueError, AttributeError):
            return None
        if ts < lane.spawn_wall:
            return None              # a previous generation's snapshot
        return time.time() - ts

    # -- the supervision step ----------------------------------------------

    def poll_once(self, now: float | None = None) -> None:
        """One step: reap exits, enforce backoff/breaker/retire
        timers, hang-check heartbeats, respawn, apply scale targets,
        publish."""
        fault("supervisor.poll")
        now = self._clock() if now is None else now
        self.polls += 1
        for lane_name, reps in self.replicas.items():
            for lane in list(reps.values()):
                if lane.retiring:
                    self._watch_retiring(lane_name, lane, now)
                    continue
                if lane.proc is not None:
                    rc = lane.proc.poll()
                    if rc is not None:
                        self._crashed(lane, rc, now)
                    else:
                        self._watch_live(lane, now)
                if lane.proc is None:
                    if lane.state == "down":
                        if now >= lane.breaker_until:
                            lane.half_open = True
                            log.warning("lane %s: breaker half-open, "
                                        "probing", self._display(lane))
                            self._spawn(lane, now)
                    elif lane.state in ("init", "backoff"):
                        if now >= lane.backoff_until:
                            self._spawn(lane, now)
        self._apply_scale(now)
        self.publish()

    def _watch_live(self, lane: LaneProc, now: float) -> None:
        age = self._heartbeat_age(lane)
        uptime = now - lane.spawn_mono
        if age is not None and age < self.heartbeat_timeout_s:
            if lane.state == "starting":
                lane.state = "running"
            if lane.pending_stripes:
                # scale-up phase 2: the first heartbeat means attach
                # (and its stranded reclaim) finished — hand the
                # parked share over now
                lane.pending_stripes = ()
                self._restripe(lane.name)
                log.info("lane %s: promoted into the stripe map",
                         self._display(lane))
            if (lane.consecutive or lane.half_open) \
                    and uptime >= self.healthy_after_s:
                # survived long enough: close the breaker / reset the
                # backoff ladder
                lane.consecutive = 0
                lane.half_open = False
                lane.backoff_ms = 0.0
                lane.crash_times.clear()
            return
        stale = (uptime > self.startup_grace_s
                 if age is None
                 else age > self.heartbeat_timeout_s
                 and uptime > self.heartbeat_timeout_s)
        if stale:
            # live pid, dead heartbeat: a hung daemon serves nobody —
            # SIGKILL (crash-only: the restart path IS the recovery
            # path) and let the normal crash machinery restart it
            log.error("lane %s: heartbeat stale (age %s, uptime "
                      "%.1fs) — killing pid %d", self._display(lane),
                      f"{age:.1f}s" if age is not None else "never",
                      uptime, lane.pid)
            lane.hung_kills += 1
            try:
                lane.proc.kill()
                lane.proc.wait(timeout=10)
            except Exception:
                pass
            self._crashed(lane, -signal.SIGKILL, now)

    # -- elastic scaling ---------------------------------------------------

    def _active_ids(self, lane_name: str) -> list[int]:
        """Replica ids currently serving (not retiring)."""
        return sorted(r for r, ln in self.replicas[lane_name].items()
                      if not ln.retiring)

    def _desired_r(self, lane_name: str,
                   targets: dict[str, dict]) -> int | None:
        """The clamped desired replica count for a lane, or None (no
        target — leave the lane alone).  `targets` is one
        read_scale_targets snapshot shared across the whole
        _apply_scale pass (the read walks the keyspace — once per
        poll, not once per lane)."""
        spec = LANES[lane_name]
        if spec.max_replicas <= 1:
            return None
        tgt = targets.get(lane_name)
        if not isinstance(tgt, dict):
            return None
        try:
            r = int(tgt.get("r", 0))
        except (TypeError, ValueError):
            return None
        if r < 1:
            return None
        lo, hi = self.scale.get(lane_name, (1, spec.max_replicas))
        return max(lo, min(hi, r))

    def _restripe(self, lane_name: str) -> None:
        """One epoch-bumped stripe-map write: READY replicas (active,
        past their scale-up handoff) own everything except the parked
        stripes — retiring replicas' closed shares plus spawning
        replicas' pending shares.  With only replica 0 ready and
        nothing parked, the map clears back to the single-replica
        default.  Stripes may move between live RUNNING replicas here
        (a promotion reshapes the round-robin): that is safe — only
        ATTACH-time reclaim may touch SERVICING rows, and every
        running replica is past its attach."""
        reps = self.replicas[lane_name]
        ready = sorted(r for r, ln in reps.items()
                       if not ln.retiring and not ln.pending_stripes)
        closed = sorted(
            {s for ln in reps.values() if ln.retiring
             for s in ln.closed_stripes})
        # pending section: a spawning replica reads it to know it is
        # awaiting promotion, NOT retired (StripeView.retired).  Its
        # planned share stays OWNED by the incumbents meanwhile —
        # the lane keeps full coverage through the child's whole
        # startup (and forever, if the child crash-loops and never
        # heartbeats); only retiring replicas' closed shares are
        # unserved, and those are deadline-bounded.
        pend = {r: list(ln.pending_stripes)
                for r, ln in reps.items()
                if ln.pending_stripes and not ln.retiring}
        if ready == [0] and not closed and not pend:
            P.clear_stripe_map(self.store, lane_name)
            return
        width = P.DEFAULT_STRIPE_WIDTH
        owners = P.default_stripe_owners(ready or [0], width)
        if closed:
            cset = set(closed)
            owners = {r: [s for s in ss if s not in cset]
                      for r, ss in owners.items()}
        P.write_stripe_map(self.store, lane_name, owners,
                           width=width, closed=closed,
                           pending=pend)

    def _apply_scale(self, now: float) -> None:
        """Reconcile each lane's replica set with its desired count:
        spawn-then-promote up (two-phase), drain-protocol down."""
        targets = P.read_scale_targets(self.store)
        for lane_name in list(self.replicas):
            desired = self._desired_r(lane_name, targets)
            if desired is None:
                continue
            active = self._active_ids(lane_name)
            if desired > len(active):
                spec = LANES[lane_name]
                reps = self.replicas[lane_name]
                new_ids = []
                while len(self._active_ids(lane_name)) < desired:
                    r = next(i for i in range(spec.max_replicas + 1)
                             if i not in reps)
                    reps[r] = LaneProc(
                        lane_name, spec.module,
                        P.replica_stats_key(spec.heartbeat_key, r),
                        replica=r)
                    new_ids.append(r)
                    self._spawn(reps[r], now)
                # scale-up phase 1: the new replicas are recorded
                # PENDING — incumbents keep serving their planned
                # shares until each one's first heartbeat proves
                # attach (and its stripe-scoped stranded reclaim) is
                # over.  An attach that already owned stripes could
                # reclaim a live incumbent's re-striped in-flight
                # SERVICING row as "stranded" and double-serve it;
                # holding the share with the incumbents instead of
                # parking it closed also means full lane coverage
                # through the child's whole startup.  The promotion
                # in _watch_live hands the share over.
                full = P.default_stripe_owners(
                    sorted(set(active) | set(new_ids)),
                    P.DEFAULT_STRIPE_WIDTH)
                for r in new_ids:
                    reps[r].pending_stripes = tuple(full.get(r, ()))
                self._restripe(lane_name)
                self.scale_events += 1
                log.info("lane %s: scaled up to %d replicas "
                         "(pending until first heartbeat)",
                         lane_name, desired)
            elif desired < len(active):
                # retire highest replica ids first; replica 0 (the
                # canonical heartbeat) never retires
                for r in sorted(active, reverse=True)[
                        : len(active) - desired]:
                    if r == 0:
                        continue
                    self._retire_replica(lane_name,
                                         self.replicas[lane_name][r],
                                         now)
                self.scale_events += 1

    def _retire_replica(self, lane_name: str, lane: LaneProc,
                        now: float) -> None:
        """Scale-down phase 1: close the replica's stripes (nobody —
        including the retiring replica — claims NEW work from them),
        then let the child drain its in-flight work to the deadline.
        The replica's run loop sees itself assigned nothing and exits
        voluntarily; _watch_retiring reaps stragglers."""
        fault("supervisor.retire")
        # the stripes this replica owns RIGHT NOW (from the live map;
        # its default share if a map never landed) park closed
        rec = P.read_stripe_map(self.store, lane_name)
        if rec is not None and isinstance(rec.get("owners"), dict):
            closing = [int(s) for s in
                       rec["owners"].get(str(lane.replica), [])]
        else:
            full = P.default_stripe_owners(
                self._active_ids(lane_name), P.DEFAULT_STRIPE_WIDTH)
            closing = full.get(lane.replica, [])
        lane.retiring = True
        lane.state = "retiring"
        lane.retire_deadline = now + self.drain_deadline_s
        lane.closed_stripes = tuple(closing)
        self._restripe(lane_name)
        log.info("lane %s: retiring (stripes %s closed, drain "
                 "deadline %.1fs)", self._display(lane), closing,
                 self.drain_deadline_s)

    def _watch_retiring(self, lane_name: str, lane: LaneProc,
                        now: float) -> None:
        """Scale-down phase 2: reap the drained (or expired, or
        crash-killed) replica, reclaim stragglers from its closed
        stripes, and re-assign them to the survivors."""
        rc = lane.proc.poll() if lane.proc is not None else -1
        if rc is None:
            if now < lane.retire_deadline:
                return                # still draining in-flight work
            # drain deadline passed: reap (TERM then KILL) — the
            # straggler reclaim below re-queues whatever it held
            log.warning("lane %s: drain deadline passed — reaping "
                        "pid %d", self._display(lane), lane.pid)
            try:
                lane.proc.terminate()
                lane.proc.wait(timeout=2)
            except Exception:
                try:
                    lane.proc.kill()
                    lane.proc.wait(timeout=5)
                except Exception:
                    pass
        self.replicas[lane_name].pop(lane.replica, None)
        self.retired += 1
        self._reclaim_closed(lane_name, lane.closed_stripes)
        self._restripe(lane_name)     # closed stripes -> survivors
        self._drop_replica_keys(lane)
        log.info("lane %s: retired (replica set now %s)",
                 self._display(lane), self._active_ids(lane_name))

    def _drop_replica_keys(self, lane: LaneProc) -> None:
        """Retire a replica's suffixed heartbeat / trace / generation
        keys with it — discovery-based readers (`spt top`, `spt
        metrics`, the telemetry sampler) enumerate these, and a
        leftover key would render a permanently-[DEAD] replica the
        supervisor will never restart.  Replica 0's canonical keys
        always stay (the lane itself lives on)."""
        if lane.replica == 0:
            return
        keys = [lane.heartbeat_key, lane.heartbeat_key + "_gen"]
        if "_stats" in lane.heartbeat_key:
            keys.append(lane.heartbeat_key.replace("_stats",
                                                   "_trace"))
        for k in keys:
            try:
                self.store.unset(k)
            except (KeyError, OSError):
                pass

    def _reclaim_closed(self, lane_name: str,
                        closed: tuple | list) -> int:
        """The straggler reclaim: once a retiring replica is REAPED,
        any request it died holding sits in ITS closed stripes with
        nobody left to finish it.  WAITING rows (embedder / searcher
        / pipeliner requests keep their request label until commit)
        need nothing — the re-stripe hands them to a survivor's next
        drain.  Completer rows flipped to SERVICING are re-queued to
        WAITING here, exactly the existing stranded-request recovery
        (Completer._reclaim_stranded), run from the supervisor
        because the owning process no longer exists.  Only the
        reaped replica's OWN stripes are touched — a sibling replica
        still draining its closed share keeps its in-flight rows.

        The disaggregated lanes reclaim per their handoff contract
        (engine/disagg.py): a dead PREFILL replica's SERVICING rows
        drop any half-written handoff wire state and re-queue to
        WAITING (the request re-prefills — nothing was streamed from
        a handed-off row yet); a dead DECODE replica's adopted rows
        (SERVICING with DECODE_READY still set and an intact handoff
        record) roll BACK to bare DECODE_READY with the slot
        truncated to the record's prompt length, so a surviving
        decode replica re-adopts from the carry token instead of
        replaying partial output into the stream.

        Known bound: a claim that PREDATES an earlier re-stripe can
        sit in a stripe this replica no longer owned at retire time
        and is not swept here — the window is one in-flight request
        spanning two scale actions (cooldown-separated), and
        claim-owner stamping is the follow-up that would close it."""
        if lane_name not in ("completer", "prefill", "decode") \
                or not closed:
            return 0
        rec = P.read_stripe_map(self.store, lane_name)
        closed = set(closed)
        st = self.store
        width = (P.DEFAULT_STRIPE_WIDTH if rec is None
                 else int(rec.get("width", P.DEFAULT_STRIPE_WIDTH)))
        n = 0
        try:
            servicing = st.enumerate_indices(P.LBL_SERVICING)
        except (KeyError, OSError):
            return 0
        for idx in servicing:
            if P.stripe_of(idx, width) not in closed:
                continue
            try:
                key = st.key_at(idx)
                if key is None:
                    continue
                labels = st.labels_at(idx)
                if lane_name == "decode":
                    if not labels & P.LBL_DECODE_READY:
                        # SERVICING-only: a live prefill replica's
                        # in-flight claim (decode ownership always
                        # carries SERVICING|DECODE_READY) — not this
                        # lane's to reclaim
                        continue
                    hrec = P.read_handoff_record(st, idx)
                    if hrec is None:
                        # adopted row whose handoff record vanished:
                        # nothing to resume from — full re-prefill
                        st.label_clear(
                            key,
                            P.LBL_SERVICING | P.LBL_DECODE_READY)
                        st.label_or(
                            key, P.LBL_INFER_REQ | P.LBL_WAITING)
                    else:
                        plen = int(hrec.get("plen", 0))
                        if plen and st.value_len(key) > plen:
                            st.set(key, st.get(key)[:plen])
                        st.label_clear(key, P.LBL_SERVICING)
                    st.bump(key)
                    n += 1
                    continue
                if lane_name == "prefill":
                    if labels & P.LBL_DECODE_READY:
                        # past the handoff flip: the row (and its
                        # record + wire pages) now belongs to the
                        # decode lane — a live decode replica may be
                        # mid-decode on it
                        continue
                    P.clear_handoff(st, idx)
                st.label_clear(key, P.LBL_SERVICING)
                st.label_or(key, P.LBL_INFER_REQ | P.LBL_WAITING)
                n += 1
            except (KeyError, OSError):
                continue
        if n:
            log.info("lane %s: reclaimed %d stranded SERVICING rows "
                     "from closed stripes", lane_name, n)
        return n

    # -- heartbeat ---------------------------------------------------------

    def publish(self) -> None:
        lanes_sec = {}
        for name, reps in self.replicas.items():
            sec = reps[0].snapshot() if 0 in reps else {
                "state": "retired"}
            extra = {str(r): ln.snapshot()
                     for r, ln in sorted(reps.items()) if r > 0}
            if extra:
                sec["replicas"] = extra
            sec["r"] = len(self._active_ids(name))
            if name in self.scale:
                lo, hi = self.scale[name]
                sec["scale_min"], sec["scale_max"] = lo, hi
            lanes_sec[name] = sec
        payload = {
            "polls": self.polls,
            "retired": self.retired,
            "scale_events": self.scale_events,
            "lanes": lanes_sec,
        }
        P.publish_heartbeat(self.store, P.KEY_SUPERVISOR_STATS, payload)

    # -- lifecycle ---------------------------------------------------------

    def run(self, *, poll_interval_s: float = 0.5,
            stop_after: float | None = None) -> None:
        """Supervise until stop(), `stop_after` seconds or, on the main
        thread, SIGTERM (`python -m ...supervisor` and `spt supervise`
        alike); every child is terminated before this returns."""
        self._running = True
        deadline = (self._clock() + stop_after) if stop_after else None
        prev = None
        if threading.current_thread() is threading.main_thread():
            prev = signal.signal(signal.SIGTERM, lambda *_: self.stop())
        try:
            while self._running:
                try:
                    self.poll_once()
                except Exception:
                    # the supervisor of the crash-safe layer must hold
                    # itself to the same standard
                    log.exception("supervision step failed; continuing")
                if deadline and self._clock() > deadline:
                    break
                time.sleep(poll_interval_s)
        finally:
            self.shutdown()
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)

    def stop(self) -> None:
        self._running = False

    def shutdown(self, *, grace_s: float = 5.0) -> None:
        """Terminate every child: SIGTERM, bounded wait, SIGKILL."""
        procs = [ln for reps in self.replicas.values()
                 for ln in reps.values()]
        for lane in procs:
            if lane.proc is None:
                continue
            try:
                lane.proc.terminate()
            except Exception:
                pass
        for lane in procs:
            if lane.proc is None:
                continue
            try:
                lane.proc.wait(timeout=grace_s)
            except Exception:
                try:
                    lane.proc.kill()
                    lane.proc.wait(timeout=grace_s)
                except Exception:
                    pass
            lane.proc = None
            lane.pid = 0
            lane.state = "init"
        for name, reps in self.replicas.items():
            for r in [r for r in reps if r > 0]:
                self._drop_replica_keys(reps.pop(r))
            P.clear_stripe_map(self.store, name)
        self.publish()


def arm_scale(lanes: list[str], scale_specs,
              knobs: dict | None,
              lane_args: dict[str, list[str]]
              ) -> dict[str, tuple[int, int]]:
    """The ONE --scale plumbing both `spt supervise` and
    supervisor.main() share: parse the bounds, auto-arm the
    control-plane lanes (the controller needs the telemetry rings
    and something to write targets), and forward the controller
    knobs to the autoscaler child's argv (belt to the policy key's
    suspenders — the child honors the policy values either way).
    Mutates `lanes`/`lane_args` in place; returns the bounds dict
    for Supervisor(scale=...).  Raises ValueError on a malformed
    spec."""
    scale = parse_scale_spec(scale_specs)
    for extra in ("telemetry", "autoscaler"):
        if extra not in lanes:
            lanes.append(extra)
    knobs = knobs or {}
    ctl_args = lane_args.setdefault("autoscaler", [])
    for flag, knob in (("--interval-s", "interval_s"),
                       ("--up-threshold", "up_threshold"),
                       ("--down-threshold", "down_threshold"),
                       ("--cooldown-s", "cooldown_s")):
        if knobs.get(knob) is not None:
            ctl_args += [flag, str(knobs[knob])]
    return scale


def parse_scale_spec(specs) -> dict[str, tuple[int, int]]:
    """`--scale lane=min:max` (or lane=max, min defaulting to 1) into
    Supervisor's bounds dict.  Raises ValueError on malformed input —
    a typo'd lane or bound must fail at parse, not mid-run."""
    out: dict[str, tuple[int, int]] = {}
    for spec in specs:
        lane, sep, rng = spec.partition("=")
        lane = lane.strip()
        if not sep or not lane:
            raise ValueError(
                f"--scale wants LANE=MIN:MAX, got {spec!r}")
        if lane not in LANES:
            raise ValueError(
                f"--scale names unknown lane {lane!r} "
                f"(supervisable: {sorted(LANES)})")
        if LANES[lane].max_replicas <= 1:
            raise ValueError(
                f"--scale: lane {lane!r} is not scalable "
                f"(max_replicas 1)")
        lo_s, sep2, hi_s = rng.partition(":")
        try:
            if sep2:
                lo, hi = int(lo_s), int(hi_s)
            else:
                lo, hi = 1, int(lo_s)
        except ValueError:
            raise ValueError(
                f"--scale wants LANE=MIN:MAX, got {spec!r}") from None
        if lo < 1 or hi < lo:
            raise ValueError(
                f"--scale {spec!r}: want 1 <= MIN <= MAX")
        out[lane.strip()] = (lo, hi)
    return out


def parse_chip_pins(spec: str) -> dict[str, str]:
    """Parse --pin-chips "prefill=0,decode=1" -> {"prefill": "0",
    "decode": "1"}.  The value is an opaque device ordinal forwarded
    to children as SPTPU_CHIP_PIN (utils.device.apply_chip_pin sets
    the CUDA device to it, degrading to a warning when the host has
    fewer cards — so one invocation works on both a multi-card host
    and a one-card box).  A malformed spec fails
    startup: a typo must never silently co-locate the lanes."""
    out: dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        lane, sep, dev = part.partition("=")
        lane, dev = lane.strip(), dev.strip()
        if not sep or not lane or not dev:
            raise ValueError(
                f"--pin-chips wants LANE=DEVICE, got {part!r}")
        if lane not in LANES:
            raise ValueError(
                f"--pin-chips names unknown lane {lane!r} "
                f"(supervisable: {sorted(LANES)})")
        out[lane] = dev
    return out


def main(argv: list[str] | None = None) -> int:
    """CLI entry: python -m libsplinter_tpu_torch.engine.supervisor
    --store NAME [--lanes embedder,searcher] [child flags via
    --embedder-args/--completer-args/--searcher-args, e.g.
    --embedder-args "--device cpu"].  Exits 0 on SIGTERM or ^C after
    terminating every child."""
    import argparse
    import shlex

    ap = argparse.ArgumentParser(
        description="splinter-tpu daemon supervisor, PyTorch port "
                    "(child-process lanes, heartbeat+pid watch, "
                    "jittered-backoff restart, circuit breaker, "
                    "striped replica sets)")
    ap.add_argument("--store", required=True)
    ap.add_argument("--persistent", action="store_true")
    ap.add_argument("--lanes", default="embedder,completer,searcher",
                    help="comma-separated lanes to supervise")
    # tunables default to None here so Supervisor.__init__ (and
    # Supervisor.run) stay the single source of truth for defaults —
    # only user-set flags are forwarded
    ap.add_argument("--poll-interval-s", type=float, default=None)
    ap.add_argument("--backoff-base-ms", type=float, default=None)
    ap.add_argument("--backoff-max-ms", type=float, default=None)
    ap.add_argument("--breaker-threshold", type=int, default=None,
                    help="crashes inside --breaker-window-s that trip "
                         "the breaker (lane marked down)")
    ap.add_argument("--breaker-window-s", type=float, default=None)
    ap.add_argument("--breaker-cooldown-s", type=float, default=None)
    ap.add_argument("--heartbeat-timeout-s", type=float, default=None)
    ap.add_argument("--startup-grace-s", type=float, default=None,
                    help="seconds a fresh child may take to its first "
                         "heartbeat (torch import, kernel library "
                         "load, CUDA context, model build and any "
                         "--warmup) before it counts as hung")
    ap.add_argument("--stop-after", type=float, default=None)
    ap.add_argument("--keep-faults", action="store_true",
                    help="keep SPTPU_FAULT armed for respawned "
                         "children too (default: first generation "
                         "only — the chaos-drill contract)")
    ap.add_argument("--scale", action="append", default=[],
                    metavar="LANE=MIN:MAX",
                    help="elastic bounds for a lane's replica set "
                         "(repeatable); arms the autoscaler policy")
    ap.add_argument("--scale-interval-s", type=float, default=None,
                    help="autoscaler decision cadence")
    ap.add_argument("--scale-up-threshold", type=float, default=None,
                    help="queue depth per replica that votes scale-up")
    ap.add_argument("--scale-down-threshold", type=float,
                    default=None,
                    help="queue depth per replica below which "
                         "sustained idle votes scale-down")
    ap.add_argument("--scale-cooldown-s", type=float, default=None,
                    help="minimum seconds between scaling actions "
                         "per lane")
    ap.add_argument("--drain-deadline-s", type=float, default=None,
                    help="scale-down: seconds a retiring replica "
                         "gets to finish in-flight work")
    ap.add_argument("--tier-pages", type=int, default=0,
                    metavar="N",
                    help="arm the host-DRAM KV spill tier on every "
                         "serving lane (completer/prefill/decode "
                         "children get --kv-tier-pages N): evicted "
                         "prefix pages demote to host RAM and readmit "
                         "without a re-prefill (engine/kv_tier.py)")
    ap.add_argument("--tier-persist", action="store_true",
                    help="with --tier-pages: checkpoint the warm set "
                         "into a file-backed persistent segment "
                         "(children get bare --kv-tier-persist, i.e. "
                         "<store>-kvtier) so supervised restarts and "
                         "scale-up replicas attach WARM.  Replica 0 "
                         "of each lane writes the snapshot; every "
                         "spawn — restart or scale-up — loads it")
    ap.add_argument("--pin-chips", default="",
                    metavar="LANE=DEV[,LANE=DEV]",
                    help="per-lane device pin, e.g. "
                         "'prefill=0,decode=1' lands the two "
                         "disaggregated lanes on disjoint chips "
                         "(children see SPTPU_CHIP_PIN and set that "
                         "CUDA device; off-range pins degrade to a "
                         "warning on small hosts; a --device cpu lane "
                         "ignores its pin)")
    for lane in LANES:
        ap.add_argument(f"--{lane}-args", default="",
                        help=f"extra argv for the {lane} child "
                             "(shell-quoted)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    lane_args = {lane: shlex.split(getattr(args, f"{lane}_args"))
                 for lane in LANES}
    if args.tier_persist and not args.tier_pages:
        ap.error("--tier-persist requires --tier-pages N")
    if args.tier_pages:
        # tier convenience flags fan out to every serving lane; an
        # explicit per-lane --kv-tier-pages in --<lane>-args wins
        # (argparse keeps the last occurrence)
        for ln in ("completer", "prefill", "decode"):
            if ln in lane_args:
                extra = ["--kv-tier-pages", str(args.tier_pages)]
                if args.tier_persist:
                    extra.append("--kv-tier-persist")
                lane_args[ln] = extra + lane_args[ln]
    sup_kw = {name: val for name in
              ("backoff_base_ms", "backoff_max_ms",
               "breaker_threshold", "breaker_window_s",
               "breaker_cooldown_s", "heartbeat_timeout_s",
               "startup_grace_s", "drain_deadline_s")
              if (val := getattr(args, name)) is not None}
    if args.keep_faults:
        sup_kw["keep_faults"] = True
    if args.pin_chips:
        try:
            sup_kw["chip_pins"] = parse_chip_pins(args.pin_chips)
        except ValueError as ex:
            ap.error(str(ex))
    lanes = [ln.strip() for ln in args.lanes.split(",") if ln.strip()]
    if args.scale:
        knobs = {"interval_s": args.scale_interval_s,
                 "up_threshold": args.scale_up_threshold,
                 "down_threshold": args.scale_down_threshold,
                 "cooldown_s": args.scale_cooldown_s}
        try:
            sup_kw["scale"] = arm_scale(lanes, args.scale, knobs,
                                        lane_args)
        except ValueError as ex:
            ap.error(str(ex))
        sup_kw["scale_knobs"] = knobs
    run_kw = {}
    if args.poll_interval_s is not None:
        run_kw["poll_interval_s"] = args.poll_interval_s
    if args.stop_after is not None:
        run_kw["stop_after"] = args.stop_after
    sup = Supervisor(
        args.store,
        lanes=tuple(lanes),
        persistent=args.persistent,
        lane_args=lane_args,
        **sup_kw)
    # SIGTERM ends run() like ^C does: its finally terminates every
    # child before the process exits 0
    try:
        sup.run(**run_kw)
    except KeyboardInterrupt:
        sup.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
