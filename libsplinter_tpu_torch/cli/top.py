"""`spt top` — the live serving TUI.

One screen, refreshed in place, answering the on-call glance
questions: is each lane alive, how deep is its queue, is it shedding,
where are the p99s — with short history sparklines from the
telemetry sampler's rings (engine/telemetry.py) when one is running,
so a spike that just ended is still visible.  `--once` renders a
single frame (tests, `watch -n`-style wrappers); Ctrl-C stops the
loop.
"""
from __future__ import annotations

import time

from ..engine import protocol as P
from .main import CliError, command
from .metrics import _read_json, sparkline

# gauges whose ring history earns a sparkline column, in preference
# order (first two that exist render; prefix_hits rides the completer
# ring when the continuous lane's prefix cache is live)
_SPARK_GAUGES = ("queue_depth", "pool_mb", "prefix_hits",
                 "p99_e2e_ms", "shed",
                 "progress")


def render_frame(store, out_lines: list[str]) -> None:
    # the lane tables are the telemetry sampler's — ONE definition,
    # so a lane added there cannot silently miss this dashboard
    from ..engine.telemetry import (PROGRESS_FIELDS, SCRAPE_LANES,
                                    read_history)

    now = time.time()
    h = store.header()
    out_lines.append(
        f"spt top — {h.used_slots}/{store.nslots} slots, "
        f"epoch {h.global_epoch}, {time.strftime('%H:%M:%S')}")
    out_lines.append(
        f"{'lane':<10} {'state':<7} {'queue':>5} {'done':>8} "
        f"{'shed':>6} {'expired':>7} {'p99 e2e':>9}  history")
    disc = P.replica_heartbeat_map(
        store, [hb for hb, _ in SCRAPE_LANES.values()])
    for lane, (hb_key, label) in SCRAPE_LANES.items():
        # replica-suffixed heartbeat discovery (elastic lanes): one
        # row per replica plus a lane aggregate when R > 1 — a dead
        # replica shows [DEAD pid], never a stale merge
        reps = [(r, _read_json(store, key))
                for r, key in disc[hb_key]]
        queue = len(store.enumerate_indices(label))
        live = [(r, s) for r, s in reps if s is not None]
        if not live:
            out_lines.append(f"{lane:<10} {'—':<7} {queue:>5} "
                             f"{'—':>8} {'—':>6} {'—':>7} {'—':>9}")
            continue

        def row_of(snap):
            age = now - float(snap.get("ts", 0.0))
            pid = snap.get("pid")
            dead = isinstance(pid, int) and not P.pid_alive(pid)
            state = ("DEAD" if dead else
                     "stale" if age > 30 else "up")
            done = snap.get(PROGRESS_FIELDS[lane], 0)
            shed = snap.get("shed", 0)
            exp = snap.get("deadline_expired", 0)
            p99 = 0.0
            q = snap.get("quantiles")
            if isinstance(q, dict) and isinstance(q.get("e2e"), dict):
                p99 = float(q["e2e"].get("p99_ms", 0))
            return state, dead, pid, done, shed, exp, p99

        parsed = [(r, *row_of(s)) for r, s in live]
        # lane aggregate: counters sum, p99 worst, state healthiest-
        # pessimistic (any DEAD replica taints the lane marker)
        agg_done = sum(p[4] for p in parsed)
        agg_shed = sum(p[5] for p in parsed)
        agg_exp = sum(p[6] for p in parsed)
        agg_p99 = max(p[7] for p in parsed)
        n_dead = sum(1 for p in parsed if p[2])
        agg_state = (f"{len(parsed) - n_dead}/{len(parsed)}up"
                     if len(parsed) > 1 else parsed[0][1])
        spark = ""
        hist = read_history(store, lane)
        if hist is not None:
            rings = hist.get("gauges") or {}
            for g in _SPARK_GAUGES:
                ring = rings.get(g)
                if isinstance(ring, list) and len(ring) >= 2:
                    vals = [float(p[1]) for p in ring
                            if isinstance(p, list) and len(p) == 2]
                    spark += f"{g}:{sparkline(vals, 16)} "
                if len(spark) > 48:
                    break
        p99_s = f"{agg_p99:.2f}ms" if agg_p99 else "—"
        out_lines.append(
            f"{lane:<10} {agg_state:<7} {queue:>5} {agg_done:>8} "
            f"{agg_shed:>6} {agg_exp:>7} {p99_s:>9}  {spark}")
        if len(parsed) > 1:
            for r, state, dead, pid, done, shed, exp, p99 in parsed:
                name = f" ├r{r}"
                mark = f"[DEAD {pid}]" if dead else state
                p99_s = f"{p99:.2f}ms" if p99 else "—"
                out_lines.append(
                    f"{name:<10} {mark:<10} {'':>2} {done:>8} "
                    f"{shed:>6} {exp:>7} {p99_s:>9}")
    # supervisor + telemetry one-liners: the control plane's health
    sup = _read_json(store, P.KEY_SUPERVISOR_STATS)
    if sup is not None:
        lanes = sup.get("lanes") or {}
        bits = " ".join(
            f"{n}:{ln.get('state')}(g{ln.get('generation')}"
            + (f",r{ln['r']}" if ln.get("r", 1) > 1 else "") + ")"
            for n, ln in lanes.items() if isinstance(ln, dict))
        out_lines.append(f"supervisor {bits}")
    ctl = _read_json(store, P.KEY_AUTOSCALER_STATS)
    if ctl is not None:
        lane_bits = " ".join(
            f"{n}:r{row.get('target') or '?'}"
            f"@{row.get('pressure', 0)}"
            for n, row in (ctl.get("lanes") or {}).items()
            if isinstance(row, dict))
        out_lines.append(
            f"autoscaler ticks={ctl.get('ticks')} "
            f"ups={ctl.get('scale_ups')} "
            f"downs={ctl.get('scale_downs')} {lane_bits}")
    tel = _read_json(store, P.KEY_TELEMETRY_STATS)
    if tel is not None:
        out_lines.append(
            f"telemetry  samples={tel.get('samples')} "
            f"lanes_seen={tel.get('lanes_seen')} "
            f"points={tel.get('points')} "
            f"every {tel.get('interval_s')}s")
    else:
        out_lines.append("telemetry  not running (spt supervise "
                         "--lanes ...,telemetry)")


@command("top", "top [--interval S] [--once] [--frames N]",
         "live serving dashboard: per-lane queue depth, progress, "
         "shed/expired, p99, telemetry-ring sparklines")
def cmd_top(ses, args):
    interval = 2.0
    frames = None
    once = False
    it = iter(args)
    for a in it:
        if a == "--interval":
            try:
                interval = float(next(it))
            except (StopIteration, ValueError):
                raise CliError("--interval wants seconds") from None
        elif a == "--once":
            once = True
        elif a == "--frames":
            try:
                frames = int(next(it))
            except (StopIteration, ValueError):
                raise CliError("--frames wants an integer") from None
        else:
            raise CliError(f"unknown flag {a!r} (see `help top`)")
    st = ses.store
    n = 0
    try:
        while True:
            lines: list[str] = []
            render_frame(st, lines)
            if not once:
                # clear + home: redraw in place, no scrollback spam
                print("\x1b[2J\x1b[H", end="")
            print("\n".join(lines), flush=True)
            n += 1
            if once or (frames is not None and n >= frames):
                break
            time.sleep(interval)
    except KeyboardInterrupt:
        pass
