"""`spt metrics` + `spt trace` — the operator-facing obs surface.

`metrics` renders everything observable from OUTSIDE the daemons as
Prometheus text exposition (obs/prom.py): store header diagnostics
(used slots, global epoch, parse_failures), daemon heartbeat counters
(__embedder_stats / __completer_stats / __searcher_stats scalars),
heartbeat ages, the histogram-sourced per-stage quantile summaries the
daemons publish under SPTPU_TRACE=1 (PIPELINE_STAGES, INFER_STAGES,
and the search daemon's SEARCH_STAGES), and flight-recorder
accounting.  Pipe it to a
node_exporter textfile collector or curl-style scrape wrapper and the
SLO dashboards come for free.

`trace tail [N]` dumps the daemons' flight-recorder rings
(__embedder_trace / __completer_trace / __searcher_trace): one line
per traced request —
trace id, key, wall ms, and the ordered stage event sequence
(PIPELINE_STAGES / INFER_STAGES names) — reconstructing any single
wake->commit journey cross-process.  Clients opt a request in with
engine/protocol.stamp_trace(store, key) — after set+label, before
the bump, so a racing daemon can't service the row stampless.

`trace show <id>` assembles the CROSS-LANE span tree for one trace id
from the shared span ring (obs/spans.py) — per hop: lane, key,
queue-wait vs service-time split, status, restart gap.  `trace
export [<id>]` emits Chrome/Perfetto trace-event JSON for the whole
ring (or one trace), loadable in ui.perfetto.dev / chrome://tracing.

`metrics --history` renders the telemetry sampler's time-series
rings (engine/telemetry.py) — per lane, per gauge sparklines of
queue depth, shed counters, stage p99s — instead of the exposition.
"""
from __future__ import annotations

import json
import sys
import time

from ..engine import protocol as P
from ..obs.prom import PromWriter
from .main import CliError, command

_HEARTBEATS = (("embedder", P.KEY_EMBED_STATS),
               ("completer", P.KEY_COMPLETE_STATS),
               ("searcher", P.KEY_SEARCH_STATS),
               ("pipeliner", P.KEY_SCRIPT_STATS),
               ("telemetry", P.KEY_TELEMETRY_STATS),
               ("autoscaler", P.KEY_AUTOSCALER_STATS),
               ("prefill", P.KEY_PREFILL_STATS),
               ("decode", P.KEY_DECODE_STATS))
_TRACE_KEYS = (("embedder", P.KEY_EMBED_TRACE),
               ("completer", P.KEY_COMPLETE_TRACE),
               ("searcher", P.KEY_SEARCH_TRACE),
               ("pipeliner", P.KEY_SCRIPT_TRACE))


def _heartbeat_rows(store) -> list[tuple[str, str]]:
    """The heartbeat keys to render: every base key plus any
    replica-suffixed keys a scaled lane published (discovered via
    protocol.replica_heartbeat_keys / replica_heartbeat_map in ONE
    debug-label enumeration, never hardcoded) — a scaled lane shows
    one exposition block per replica, replica 0 under the classic
    daemon name, replica N as `<daemon>_rN`."""
    disc = P.replica_heartbeat_map(store,
                                   [b for _, b in _HEARTBEATS])
    rows: list[tuple[str, str]] = []
    for daemon, base in _HEARTBEATS:
        for r, key in disc[base]:
            rows.append((daemon if r == 0 else f"{daemon}_r{r}", key))
    return rows


def _read_json(store, key: str) -> dict | None:
    try:
        raw = store.get(key)
    except (KeyError, OSError):
        return None
    try:
        snap = json.loads(raw.rstrip(b"\0"))
    except ValueError:
        return None
    return snap if isinstance(snap, dict) else None


_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(vals: list[float], width: int = 32) -> str:
    """Unicode mini-chart of a gauge's ring (newest right)."""
    vals = vals[-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[0] * len(vals)
    return "".join(_SPARK[int((v - lo) / (hi - lo)
                              * (len(_SPARK) - 1))] for v in vals)


def render_history(store, out=None) -> int:
    """`spt metrics --history`: the telemetry rings as per-gauge
    sparklines.  Returns gauges rendered (0 = no sampler ran)."""
    from ..engine.telemetry import SCRAPE_LANES, read_history

    out = out if out is not None else sys.stdout
    shown = 0
    now = time.time()
    for lane in SCRAPE_LANES:
        rec = read_history(store, lane)
        if rec is None:
            continue
        age = now - float(rec.get("ts", 0.0))
        print(f"[{lane}] sampled every {rec.get('interval_s')}s, "
              f"last {age:.1f}s ago", file=out)
        for gauge, ring in sorted((rec.get("gauges") or {}).items()):
            if not isinstance(ring, list) or not ring:
                continue
            vals = [float(p[1]) for p in ring if isinstance(p, list)
                    and len(p) == 2]
            if not vals:
                continue
            print(f"  {gauge:<24} last={vals[-1]:<10g} "
                  f"min={min(vals):<10g} max={max(vals):<10g} "
                  f"{sparkline(vals)}", file=out)
            shown += 1
    if not shown:
        print("no telemetry history (run the sampler: `spt supervise "
              "--lanes ...,telemetry` or `python -m "
              "libsplinter_tpu.engine.telemetry --store ...`)",
              file=out)
    return shown


@command("metrics", "metrics [--history]",
         "Prometheus text exposition of store + daemon telemetry "
         "(--history: the sampler's time-series rings instead)")
def cmd_metrics(ses, args):
    if args and args[0] == "--history":
        render_history(ses.store)
        return
    st = ses.store
    w = PromWriter()

    h = st.header()
    w.metric("sptpu_store_used_slots", h.used_slots,
             help_="live keys at snapshot time")
    w.metric("sptpu_store_nslots", h.nslots)
    w.metric("sptpu_store_max_val_bytes", h.max_val)
    w.metric("sptpu_store_global_epoch", h.global_epoch,
             mtype="counter")
    w.metric("sptpu_store_parse_failures", h.parse_failures,
             mtype="counter",
             help_="client-reported value parse failures "
                   "(spt_report_parse_failure)")
    w.metric("sptpu_store_last_failure_epoch", h.last_failure_epoch)

    now = time.time()
    for daemon, key in _heartbeat_rows(st):
        snap = _read_json(st, key)
        if snap is None:
            continue
        lab = {"daemon": daemon}
        ts = snap.pop("ts", None)
        if ts:
            w.metric("sptpu_heartbeat_age_seconds", now - ts, lab,
                     help_="seconds since the daemon's last heartbeat")
        quantiles = snap.pop("quantiles", None) or {}
        recorder = snap.pop("recorder", None) or {}
        slow = snap.pop("slow_log", None) or []
        snap.pop("spans", None)       # superseded by the quantiles
        lane = snap.pop("lane", None)  # searcher: StagedLane counters
        if isinstance(lane, dict):
            w.scalars(f"sptpu_{daemon}_lane", lane)
        disp = snap.pop("dispatch", None)  # PR-7 overlap gauges: their
        if isinstance(disp, dict):         # own (size-droppable)
            w.scalars(f"sptpu_{daemon}", disp)  # section, flat names
        sp = snap.pop("spans_obs", None)  # span-capture accounting
        if isinstance(sp, dict):          # (obs/spans.py), flat names
            w.scalars(f"sptpu_{daemon}_spans", sp)
        stripe = snap.pop("stripe", None)  # elastic lanes: the
        if isinstance(stripe, dict):       # replica's stripe view
            w.scalars(f"sptpu_{daemon}_stripe", stripe)
        ctl_lanes = snap.pop("lanes", None)  # autoscaler: per-lane
        if isinstance(ctl_lanes, dict):      # decision state
            for lane_name, row in ctl_lanes.items():
                if not isinstance(row, dict):
                    continue
                lab_l = {"lane": str(lane_name)}
                for field in ("target", "pressure", "up_streak",
                              "down_streak"):
                    v = row.get(field)
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        w.metric(f"sptpu_{daemon}_lane_{field}", v,
                                 lab_l,
                                 help_="scaling-controller per-lane "
                                       "state (engine/autoscaler.py: "
                                       "target replica count, queue "
                                       "pressure, hysteresis streaks)")
        snap.pop("history", None)  # decision log: `spt scale status`
        verbs = snap.pop("verbs", None)  # pipeline lane: per-verb
        if isinstance(verbs, dict):      # dispatch counters
            for verb, n in verbs.items():
                if not isinstance(n, (int, float)):
                    continue
                w.metric(f"sptpu_{daemon}_verb_total", n,
                         {"daemon": daemon, "verb": str(verb)},
                         mtype="counter",
                         help_="async splinter verbs dispatched by "
                               "scripts, per verb name "
                               "(engine/pipeliner.py)")
        shards = snap.pop("pages_shard", None)  # pod-sharded pool
        if isinstance(shards, dict):            # occupancy (PR 8)
            # on the sharded lane the pages_{free,used} family renders
            # ONLY with shard labels: leaving the flat copies in too
            # would put labeled and unlabeled samples in one family
            # and a sum() over it would read (tp+1)x the true count
            snap.pop("pages_free", None)
            snap.pop("pages_used", None)
            for shard, occ in shards.items():
                if not isinstance(occ, dict):
                    continue
                lab_s = {"daemon": daemon, "shard": str(shard)}
                for field in ("free", "used"):
                    w.metric(f"sptpu_{daemon}_pages_{field}",
                             occ.get(field, 0), lab_s,
                             help_="paged KV pool occupancy; one "
                                   "series per tp shard backing the "
                                   "pages (host-global count — read "
                                   "max(), not sum())")
                if "shard_mb" in occ:
                    w.metric(f"sptpu_{daemon}_pool_shard_mb",
                             occ["shard_mb"], lab_s,
                             help_="measured on-device pool bytes "
                                   "per tp shard (k+v, all layers) — "
                                   "a missing shard key or inflated "
                                   "MB means the placement broke")
        kvd = snap.pop("kv_dtype", None)  # paged-pool storage dtype
        if isinstance(kvd, str):
            # info-style gauge: the dtype rides a label (Prometheus
            # has no string samples); pool_mb next to it is the
            # measured-bytes evidence that the dtype actually took
            w.metric(f"sptpu_{daemon}_kv_pool_info", 1,
                     {"daemon": daemon, "kv_dtype": kvd},
                     help_="paged KV pool storage dtype (int8 = "
                           "quantized pool with per-page scales); "
                           "see sptpu_completer_pool_mb for the "
                           "measured on-device bytes")
        qos = snap.pop("qos", None)  # admission-control config
        if isinstance(qos, dict):
            w.scalars(f"sptpu_{daemon}_qos", qos)
        tenants = snap.pop("tenants", None)  # per-tenant QoS ledger
        if isinstance(tenants, dict):
            for tenant, row in tenants.items():
                if not isinstance(row, dict):
                    continue
                for field, v in row.items():
                    if not isinstance(v, (int, float)):
                        continue
                    w.metric(f"sptpu_{daemon}_tenant_{field}", v,
                             {"daemon": daemon,
                              "tenant": str(tenant)},
                             mtype="counter",
                             help_="per-tenant QoS accounting "
                                   "(admitted / shed / "
                                   "deadline_expired / served_tokens "
                                   "— engine/qos.py TenantLedger)")
        devtime = snap.pop("devtime", None)  # named-program device
        if isinstance(devtime, dict):        # windows + compile ledger
            for prog, row in devtime.items():
                if not isinstance(row, dict):
                    continue
                lab_p = {"daemon": daemon, "program": str(prog)}
                for field in ("n", "compiles", "runtime_compiles"):
                    v = row.get(field)
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        w.metric(f"sptpu_{daemon}_devtime_{field}",
                                 v, lab_p, mtype="counter",
                                 help_="named-program device windows "
                                       "observed / compile events "
                                       "(obs/devtime.py; "
                                       "runtime_compiles must stay 0 "
                                       "after warmup)")
                for field in ("p50_ms", "p99_ms"):
                    v = row.get(field)
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        w.metric(f"sptpu_{daemon}_devtime_{field}",
                                 v, lab_p,
                                 help_="dispatch->collect wall "
                                       "quantiles per named program "
                                       "(ms; device window, zero new "
                                       "host syncs)")
        flt = snap.pop("faults", None)  # armed SPTPU_FAULT accounting
        if isinstance(flt, dict):
            for site, counts in flt.items():
                if not isinstance(counts, dict):
                    continue
                for field in ("hits", "fired"):
                    w.metric(f"sptpu_fault_{field}",
                             counts.get(field, 0),
                             {"daemon": daemon, "site": site},
                             mtype="counter",
                             help_="fault-injection site accounting "
                                   "(SPTPU_FAULT armed)")
        for field in ("prefix_hits", "prefix_misses",
                      "prefix_hit_tokens", "prefix_evictions",
                      "prefix_cow_copies", "prefix_bytes_saved"):
            # the continuous lane's prefix-sharing counters
            # (engine/prefix_cache.py) — typed as counters so rate()
            # works; the shared/evictable page residency next to them
            # stays a gauge via the generic loop below
            v = snap.pop(field, None)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                w.metric(f"sptpu_{daemon}_{field}", v,
                         mtype="counter",
                         help_="cross-request prefix cache: radix-"
                               "tree hits/misses, tokens served from "
                               "shared pages, LRU evictions, copy-on-"
                               "write page copies, and KV bytes not "
                               "re-prefilled")
        for field, v in snap.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            w.metric(f"sptpu_{daemon}_{field}", v)
        for stage, q in quantiles.items():
            if isinstance(q, dict):
                w.summary("sptpu_stage_ms", q,
                          {"daemon": daemon, "stage": stage},
                          help_="per-stage wall time quantiles "
                                "(histogram-sourced, ms)")
        for field, v in recorder.items():
            w.metric(f"sptpu_{daemon}_trace_{field}", v, mtype=(
                "gauge" if field.endswith("_ms") else "counter"))
        w.metric(f"sptpu_{daemon}_slow_log_entries", len(slow))

    # supervisor heartbeat: per-lane process state (engine/supervisor)
    snap = _read_json(st, P.KEY_SUPERVISOR_STATS)
    if snap is not None:
        ts = snap.get("ts")
        if ts:
            w.metric("sptpu_heartbeat_age_seconds", now - ts,
                     {"daemon": "supervisor"})
        w.metric("sptpu_supervisor_polls", snap.get("polls", 0),
                 mtype="counter")
        w.metric("sptpu_supervisor_retired",
                 snap.get("retired", 0), mtype="counter",
                 help_="replicas drained and reaped by scale-down")
        w.metric("sptpu_supervisor_scale_events",
                 snap.get("scale_events", 0), mtype="counter")
        for lane_name, ln in (snap.get("lanes") or {}).items():
            if not isinstance(ln, dict):
                continue
            lab = {"lane": lane_name}
            w.metric("sptpu_supervisor_lane_up",
                     1 if ln.get("state") == "running" else 0, lab,
                     help_="1 when the supervised lane is running "
                           "with a fresh heartbeat")
            w.metric("sptpu_supervisor_lane_down",
                     1 if ln.get("state") == "down" else 0, lab,
                     help_="1 when the lane's circuit breaker is "
                           "open (clients skip dispatch)")
            for field in ("generation", "restarts",
                          "consecutive_crashes", "breaker_opens",
                          "hung_kills"):
                w.metric(f"sptpu_supervisor_lane_{field}",
                         ln.get(field, 0), lab, mtype=(
                             "gauge" if field == "consecutive_crashes"
                             else "counter"))
            w.metric("sptpu_supervisor_lane_backoff_ms",
                     ln.get("backoff_ms", 0), lab)
            if "r" in ln:
                # elastic lanes: the ACTIVE replica count the
                # supervisor is running (the autoscaler's target is
                # sptpu_autoscaler_lane_target — divergence beyond
                # one poll means scaling is stuck)
                w.metric("sptpu_supervisor_lane_replicas",
                         ln.get("r", 1), lab,
                         help_="active (non-retiring) replicas in "
                               "the lane's striped replica set")

    lane = ses._lane                  # only if a search staged one
    if lane is not None:
        w.scalars("sptpu_staged_lane", lane.counters())

    sys.stdout.write(w.render())


def _parse_tid(s: str) -> int:
    try:
        return int(s, 0)          # 0x... or decimal
    except ValueError:
        raise CliError(f"bad trace id {s!r} (hex 0x... or decimal)") \
            from None


def _trace_show(ses, args) -> None:
    from ..obs import spans as S

    if not args:
        raise CliError("usage: trace show <trace_id>")
    tid = _parse_tid(args[0])
    recs = S.collect_spans(ses.store, tid)
    if not recs:
        print(f"no spans for trace {tid:#x} (span capture needs a "
              "stamped request — protocol.stamp_trace or `spt "
              "loadgen --trace-sample p`; old spans rotate out of "
              "the bounded ring)")
        return
    for line in S.render_tree(S.assemble_tree(recs)):
        print(line)


def _trace_export(ses, args) -> None:
    from ..obs import spans as S

    out_path = None
    rest = []
    it = iter(args)
    for a in it:
        if a == "--out":
            try:
                out_path = next(it)
            except StopIteration:
                raise CliError("--out requires a path") from None
        else:
            rest.append(a)
    tid = _parse_tid(rest[0]) if rest else None
    recs = S.collect_spans(ses.store, tid)
    # compile events ride their own instant track beside the spans
    from ..obs.devtime import collect_compile_events
    compiles = collect_compile_events(ses.store)
    doc = S.to_chrome_trace(recs, compile_events=compiles)
    body = json.dumps(doc, indent=1)
    if out_path:
        with open(out_path, "w") as f:
            f.write(body)
        print(f"wrote {len(recs)} spans + {len(compiles)} compile "
              f"events to {out_path} "
              "(load in ui.perfetto.dev or chrome://tracing)")
    else:
        print(body)


@command("trace", "trace tail [N] | show <id> | export [<id>] "
         "[--out FILE]",
         "flight recorders (tail), the cross-lane span tree of one "
         "trace (show), or Chrome/Perfetto trace-event JSON (export)")
def cmd_trace(ses, args):
    if args and args[0] == "show":
        return _trace_show(ses, args[1:])
    if args and args[0] == "export":
        return _trace_export(ses, args[1:])
    if not args or args[0] != "tail":
        raise CliError(
            "usage: trace tail [N] | show <id> | export [<id>]")
    try:
        n = int(args[1]) if len(args) > 1 else 16
    except ValueError:
        raise CliError("usage: trace tail [N] (N must be an integer)")
    st = ses.store
    shown = 0
    # replica-suffixed rings included (a scaled lane's extra
    # replicas publish their own flight recorders)
    disc = P.replica_heartbeat_map(st, [b for _, b in _TRACE_KEYS])
    rows = [(d if r == 0 else f"{d}.r{r}", key)
            for d, base in _TRACE_KEYS
            for r, key in disc[base]]
    for daemon, key in rows:
        snap = _read_json(st, key)
        recs = (snap or {}).get("trace") or []
        age = time.time() - snap["ts"] if snap and "ts" in snap else 0
        if recs and age > 30:
            # a ring the daemon could not refresh (daemon stopped, or
            # the payload outgrew max_val) must not read as current
            print(f"[{daemon}] ring published {age:.0f}s ago — "
                  f"records below may be stale")
        for rec in (recs[-n:] if n > 0 else []):
            events = " ".join(
                f"{name}={ms:.3f}ms" for name, ms in
                rec.get("events", []))
            tid = rec.get("id", 0)
            extra = ""
            if rec.get("script"):     # pipeline-lane chain identity:
                extra = f" script={rec['script']}"  # correlates with
            if rec.get("span"):       # `spt trace show <id>`
                extra += f" span={rec['span']:#x}"
            if rec.get("verbs"):
                extra += " verbs=" + ",".join(
                    f"{v}:{c}" for v, c in sorted(
                        rec["verbs"].items()))
            print(f"[{daemon}] id={tid:#x} pid={tid >> 24} "
                  f"key={rec.get('key')!r} wall={rec.get('wall_ms')}ms "
                  f"{events}{extra}")
            shown += 1
    if not shown:
        print("no traced requests recorded (daemons publish their "
              "rings under SPTPU_TRACE=1; clients opt requests in "
              "via protocol.stamp_trace)")
