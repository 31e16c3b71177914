"""The telemetry sampler — heartbeat history for the elastic-lane
signal plane.

Every lane publishes a point-in-time heartbeat; nothing keeps
history, so the questions the scaling controller of ROADMAP item 4
must answer — is queue depth trending up? did shed counters move when
the offered rate stepped? what was the p99 a minute ago? — have no
data.  This lane scrapes every lane heartbeat on its cadence into
FIXED-SIZE time-series rings stored IN the store (one `__tele_<lane>`
key per lane), so:

  - the rings survive the sampler itself (a supervised restart picks
    up where the dead generation left off — the rings are store
    state, not process state);
  - any client renders history with plain store reads (`spt top`,
    `spt metrics --history`) — no sidecar database, the reference's
    "everything is a key" discipline;
  - the sampler is supervisable (`spt supervise --lanes ...,telemetry`)
    and deliberately jax-free: restarts cost milliseconds.

Gauges per lane: queue depth (labelled-request count — measured from
the store, not trusted from the heartbeat), shed / deferred /
deadline_expired counters, the lane's main progress counter, stage
p99s when tracing is on, pool occupancy on the completer, and
per-tenant admitted counts.  Ring write degrades by halving its
length when the snapshot outgrows max_val — shorter history beats
none (the publish_trace_ring discipline).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import time

from ..store import Store
from . import protocol as P

log = logging.getLogger("libsplinter_tpu.telemetry")

# lane -> (heartbeat key, request label for the queue-depth gauge)
SCRAPE_LANES: dict[str, tuple[str, int]] = {
    "embedder": (P.KEY_EMBED_STATS, P.LBL_EMBED_REQ),
    "completer": (P.KEY_COMPLETE_STATS, P.LBL_INFER_REQ),
    "searcher": (P.KEY_SEARCH_STATS, P.LBL_SEARCH_REQ),
    "pipeliner": (P.KEY_SCRIPT_STATS, P.LBL_SCRIPT_REQ),
    # the disaggregated completer phases (engine/disagg.py): prefill's
    # queue is the classic waiting-request backlog; decode's "queue"
    # is the handed-off rows awaiting adoption — and its scaling
    # signal is the pool_occ gauge derived below, not queue depth
    "prefill": (P.KEY_PREFILL_STATS, P.LBL_INFER_REQ),
    "decode": (P.KEY_DECODE_STATS, P.LBL_DECODE_READY),
}

# heartbeat counters copied into the rings when present (beyond the
# always-sampled queue_depth); one progress counter per lane so
# goodput is derivable from any two samples.  PROGRESS_FIELDS is
# shared with `spt top` — one table, so a new lane cannot appear in
# one surface and silently miss the other.
_COUNTER_GAUGES = ("shed", "deferred", "deadline_expired")
PROGRESS_FIELDS = {"embedder": "embedded",
                   "completer": "completions",
                   "searcher": "served",
                   "pipeliner": "scripts_completed",
                   "prefill": "handoffs",
                   "decode": "completions"}
_EXTRA = {"completer": ("pages_free", "pages_used", "tokens",
                        "prefix_hits", "prefix_shared_pages",
                        "pool_mb", "pool_mb_peak",
                        "pages_used_peak", "compile_events",
                        "tier_pages", "tier_readmits",
                        "tier_restored"),
          "embedder": ("compile_count", "compile_events"),
          "searcher": ("compile_events",),
          "pipeliner": ("scripts_active",),
          "prefill": ("handoff_failed", "handoff_wire_mb",
                      "prefix_hits", "prefill_wall_ema_ms",
                      "compile_events", "tier_pages",
                      "tier_readmits"),
          "decode": ("pages_free", "pages_used", "tokens",
                     "adopted", "readopted", "adopt_backpressure",
                     "handoff_refill", "compile_events",
                     "tier_pages", "tier_readmits")}

DEFAULT_INTERVAL_S = 2.0
DEFAULT_RING_LEN = 64


@dataclasses.dataclass
class TelemetryStats:
    samples: int = 0             # sampler ticks completed
    lanes_seen: int = 0          # lanes with a readable heartbeat, last tick
    points: int = 0              # gauge points appended, lifetime
    write_errors: int = 0        # ring writes that failed outright
    shrinks: int = 0             # ring writes that had to halve history


class TelemetrySampler:
    """Drive with run() (blocking loop) or sample_once() (one tick —
    tests and --oneshot)."""

    def __init__(self, store: Store, *,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 ring_len: int = DEFAULT_RING_LEN):
        self.store = store
        self.interval_s = max(0.05, interval_s)
        self.ring_len = max(4, ring_len)
        self.stats = TelemetryStats()
        self.generation = 0
        self._running = False

    # -- wiring ------------------------------------------------------------

    def attach(self) -> None:
        self.generation = P.bump_generation(self.store,
                                            P.KEY_TELEMETRY_STATS)

    # -- sampling ----------------------------------------------------------

    def _read_heartbeat(self, key: str) -> dict | None:
        try:
            snap = json.loads(self.store.get(key).rstrip(b"\0"))
        except (KeyError, OSError, ValueError):
            return None
        return snap if isinstance(snap, dict) else None

    def _read_lane_snaps(self, base: str,
                         disc: dict | None = None) -> list[dict]:
        """Every replica heartbeat of a lane (elastic lanes publish
        replica-suffixed keys — base, base.r1, ...), in replica
        order.  `disc` is a shared replica_heartbeat_map result so
        one tick pays one discovery enumeration."""
        rows = (disc or P.replica_heartbeat_map(
            self.store, (base,)))[base]
        out = []
        for _r, key in rows:
            snap = self._read_heartbeat(key)
            if snap is not None:
                out.append(snap)
        return out

    def _gauges_for(self, lane: str,
                    snaps: list[dict] | dict | None) -> dict:
        """One tick's gauge values for a lane.  queue_depth is always
        measured (label enumeration over the WHOLE lane — the store
        is the truth, a stale heartbeat is not, and under striped
        replicas no single replica's view covers the queue); the rest
        come from the replica heartbeats when any exist — counters
        and progress SUM across replicas, stage p99s take the worst
        replica, and a `replicas` gauge counts live publishers so the
        controller and `spt top` can see R move."""
        _, label = SCRAPE_LANES[lane]
        out: dict[str, float] = {
            "queue_depth": float(len(
                self.store.enumerate_indices(label)))}
        if isinstance(snaps, dict):
            snaps = [snaps]
        if not snaps:
            return out
        live = sum(1 for s in snaps
                   if not isinstance(s.get("pid"), int)
                   or P.pid_alive(s["pid"]))
        if len(snaps) > 1 or any("replica" in s for s in snaps):
            out["replicas"] = float(live)
        prog = PROGRESS_FIELDS.get(lane)
        for snap in snaps:
            for g in _COUNTER_GAUGES + _EXTRA.get(lane, ()):
                v = snap.get(g)
                if isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    out[g] = out.get(g, 0.0) + float(v)
            if prog is not None and isinstance(snap.get(prog),
                                               (int, float)):
                out["progress"] = out.get("progress", 0.0) \
                    + float(snap[prog])
            # paged-pool occupancy fraction — the decode lane's
            # scaling signal (autoscaler `signal: "pool"`).  Each
            # replica owns its own pool, so the fleet-WORST replica
            # is the scaling truth (one exhausted pool refuses
            # adoption no matter how empty its siblings are).
            pu, pf = snap.get("pages_used"), snap.get("pages_free")
            if isinstance(pu, (int, float)) \
                    and isinstance(pf, (int, float)) and pu + pf > 0:
                out["pool_occ"] = max(out.get("pool_occ", 0.0),
                                      float(pu) / float(pu + pf))
            # stage p99s (tracing on): e2e + every published stage —
            # the quantiles section carries prefix-stripped stage
            # names; across replicas the WORST p99 is the SLO truth
            q = snap.get("quantiles")
            if isinstance(q, dict):
                for stage, row in q.items():
                    if isinstance(row, dict) and "p99_ms" in row:
                        k = f"p99_{stage}_ms"
                        out[k] = max(out.get(k, 0.0),
                                     float(row["p99_ms"]))
            # per-tenant goodput inputs (admitted is the open-loop
            # admission truth; served_tokens where the lane meters
            # tokens)
            tenants = snap.get("tenants")
            if isinstance(tenants, dict):
                for t, row in tenants.items():
                    if not isinstance(row, dict):
                        continue
                    for f in ("admitted", "served_tokens"):
                        v = row.get(f)
                        if isinstance(v, (int, float)):
                            k = f"tenant{t}_{f}"
                            out[k] = out.get(k, 0.0) + float(v)
        return out

    def _append(self, lane: str, gauges: dict, now: float) -> None:
        """Read-modify-write the lane's ring key, bounded to ring_len
        samples per gauge; an oversized snapshot halves its history
        until it fits."""
        st = self.store
        key = P.telemetry_key(lane)
        try:
            rec = json.loads(st.get(key).rstrip(b"\0"))
            if not isinstance(rec, dict) or rec.get("v") != 1:
                rec = {}
        except (KeyError, OSError, ValueError):
            rec = {}
        rings = rec.get("gauges")
        if not isinstance(rings, dict):
            rings = {}
        ts = round(now, 1)
        for name, val in gauges.items():
            ring = rings.get(name)
            if not isinstance(ring, list):
                ring = rings[name] = []
            ring.append([ts, round(float(val), 3)])
            del ring[:-self.ring_len]
            self.stats.points += 1
        body = {"v": 1, "lane": lane, "interval_s": self.interval_s,
                "n": int(rec.get("n", 0)) + 1, "ts": ts,
                "gauges": rings}
        keep = self.ring_len
        while True:
            try:
                st.set(key, json.dumps(body))
                return
            except OSError:
                keep //= 2
                if keep < 1:
                    self.stats.write_errors += 1
                    return
                self.stats.shrinks += 1
                body["gauges"] = {g: r[-keep:]
                                  for g, r in rings.items()}
            except KeyError:
                self.stats.write_errors += 1
                return

    def sample_once(self, now: float | None = None) -> int:
        """One tick over every scrape lane; returns lanes sampled."""
        now = time.time() if now is None else now
        seen = 0
        disc = P.replica_heartbeat_map(
            self.store, [hb for hb, _ in SCRAPE_LANES.values()])
        for lane, (hb_key, _) in SCRAPE_LANES.items():
            try:
                snaps = self._read_lane_snaps(hb_key, disc)
                if snaps:
                    seen += 1
                self._append(lane, self._gauges_for(lane, snaps), now)
            except Exception:        # telemetry must never wedge: a
                log.exception("sampling %s failed; continuing", lane)
        self.stats.samples += 1
        self.stats.lanes_seen = seen
        return seen

    # -- heartbeat ---------------------------------------------------------

    def publish_stats(self) -> None:
        payload = {**dataclasses.asdict(self.stats),
                   "interval_s": self.interval_s,
                   "ring_len": self.ring_len,
                   "generation": self.generation}
        P.publish_heartbeat(self.store, P.KEY_TELEMETRY_STATS, payload)

    # -- lifecycle ---------------------------------------------------------

    def run(self, *, stop_after: float | None = None,
            heartbeat_interval_s: float = 5.0,
            idle_timeout_ms: int | None = None) -> None:
        """The sampler loop.  `idle_timeout_ms` is accepted (and
        ignored) so the supervisor's generic lane argv works
        unchanged."""
        self._running = True
        deadline = (time.monotonic() + stop_after) if stop_after \
            else None
        next_beat = 0.0
        while self._running:
            t0 = time.monotonic()
            try:
                self.sample_once()
                if t0 >= next_beat:
                    self.publish_stats()
                    next_beat = t0 + heartbeat_interval_s
            except Exception:
                log.exception("sampler tick failed; continuing")
            if deadline and time.monotonic() > deadline:
                break
            elapsed = time.monotonic() - t0
            time.sleep(max(self.interval_s - elapsed, 0.01))

    def stop(self) -> None:
        self._running = False


def read_history(store, lane: str) -> dict | None:
    """A lane's telemetry ring, or None: {"gauges": {name: [[ts, v],
    ...]}, ...} — what `spt top` / `spt metrics --history` render."""
    try:
        rec = json.loads(store.get(P.telemetry_key(lane)).rstrip(b"\0"))
    except (KeyError, OSError, ValueError):
        return None
    if not isinstance(rec, dict) or rec.get("v") != 1:
        return None
    return rec


def main(argv: list[str] | None = None) -> int:
    """CLI entry: python -m libsplinter_tpu.engine.telemetry
    --store NAME.  jax-free — supervised restarts cost ms."""
    import argparse

    ap = argparse.ArgumentParser(
        description="splinter-tpu telemetry sampler (heartbeat "
                    "history rings for spt top / spt metrics "
                    "--history / the scaling controller)")
    ap.add_argument("--store", required=True)
    ap.add_argument("--persistent", action="store_true")
    ap.add_argument("--oneshot", action="store_true")
    ap.add_argument("--interval-s", type=float,
                    default=DEFAULT_INTERVAL_S,
                    help="scrape cadence (default 2s)")
    ap.add_argument("--ring-len", type=int, default=DEFAULT_RING_LEN,
                    help="samples kept per gauge (default 64)")
    ap.add_argument("--idle-timeout-ms", type=int, default=None,
                    help="accepted for supervisor argv parity; unused")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    store = Store.open(args.store, persistent=args.persistent)
    tel = TelemetrySampler(store, interval_s=args.interval_s,
                           ring_len=args.ring_len)
    tel.attach()
    tel.publish_stats()
    if args.oneshot:
        n = tel.sample_once()
        tel.publish_stats()
        log.info("oneshot sampled %d lanes", n)
        return 0
    try:
        tel.run()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
